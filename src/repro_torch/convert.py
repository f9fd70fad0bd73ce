"""Parameter conversion from the JAX reference to the port.

``params_from_jax(tree, cfg)`` takes the reference's parameter pytree
already turned into numpy arrays (``jax.device_get``) and returns the
port's nested dict of torch tensors.  Layouts agree leaf for leaf (a dense
weight is (K, N) in both), so this is a structural copy; bfloat16 arrays
(numpy's ml_dtypes type) are carried over bit for bit.  Imports no jax.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def tree_from_numpy(x, device="cpu"):
    """A nested dict/list of numpy arrays as the same tree of tensors."""
    if isinstance(x, dict):
        return {k: tree_from_numpy(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [tree_from_numpy(v, device) for v in x]
    return _leaf(x, device)


def params_from_jax(tree, cfg, device="cpu") -> dict:
    """The port's parameters of model ``cfg`` from a numpy copy of the
    reference's parameter pytree (unstacked layers: ``scan_layers`` off)."""
    params = tree_from_numpy(tree, device)
    layers = params.get("layers")
    if not isinstance(layers, list) or len(layers) != cfg.n_layers:
        raise ValueError(f"expected a list of {cfg.n_layers} per-layer "
                         "parameter dicts (scan_layers=False)")
    return params
