"""Parameter conversion from the JAX reference to the port.

``params_from_jax(tree, cfg)`` takes the reference's parameter pytree
already turned into numpy arrays (``jax.device_get``) and returns the
port's nested dict of torch tensors; ``resnet_params_from_jax`` does the
same for the ResNet of `models.resnet`.  Layouts agree leaf for leaf (a dense
weight is (K, N) in both), so this is a structural copy; bfloat16 arrays
(numpy's ml_dtypes type) are carried over bit for bit.  Imports no jax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod


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


def params_from_jax(tree, cfg, device=None, pol=None) -> dict:
    """The port's parameters of model ``cfg`` on ``device`` (None: CUDA)
    from a numpy copy of the reference's parameter pytree, made under the
    policy ``pol`` (None: the config alone decides the layout).  A
    decoder's tree has ``layers``: one dict a layer (``ln1``, ``ln2``,
    the mixer's subtree ``attn``, ``mamba`` or ``timemix``, none for a
    shared-attention site, and the FFN's ``mlp``, ``moe`` or ``chanmix``,
    none for a mixer-only layer), or, exactly where the reference stacks
    (`models.transformer._can_scan(cfg, pol)`: ``scan_layers`` on a
    homogeneous stack), one such dict whose leaves carry a leading layer
    axis of ``n_layers``;
    ``shared_attn`` exactly when a layer is a shared-attention site,
    ``adapter`` exactly when it has a stub frontend and ``lm_head``
    exactly when its embeddings are not tied; an enc-dec
    tree has ``adapter``, ``embed``, ``enc_norm``, ``final_norm``,
    ``lm_head``, ``encoder`` (n_enc_layers dicts) and ``decoder``
    (n_layers dicts, each with ``xattn`` and ``ln_x``)."""
    params = tree_from_numpy(tree, device_mod.resolve(device))
    if cfg.family == "encdec":
        _check_list(params, "encoder", cfg.n_enc_layers or cfg.n_layers)
        _check_list(params, "decoder", cfg.n_layers)
        want = {"adapter", "embed", "enc_norm", "final_norm", "lm_head",
                "encoder", "decoder"}
        if set(params) != want or any(
                "xattn" not in lp or "ln_x" not in lp
                for lp in params["decoder"]):
            raise ValueError(f"enc-dec parameter tree with {sorted(params)}"
                             f", expected {sorted(want)} and decoder "
                             "layers with xattn and ln_x")
        return params
    from repro_torch.models.transformer import (_can_scan, _ffn_kind,
                                                _has_shared)
    if _can_scan(cfg, pol):
        _check_stacked(params.get("layers"), cfg)
        layers = [params["layers"]]
    else:
        _check_list(params, "layers", cfg.n_layers)
        layers = params["layers"]
    for name, want in (("adapter", cfg.frontend is not None),
                       ("lm_head", not cfg.tie_embeddings),
                       ("shared_attn", _has_shared(cfg))):
        if (name in params) != want:
            raise ValueError(f"{cfg.name}: the parameter tree "
                             f"{'lacks' if want else 'has'} {name!r}")
    for i, lp in enumerate(layers):
        want = {"ln1", "ln2", _MIXER_LEAF[cfg.mixer_at(i)],
                _FFN_LEAF[_ffn_kind(cfg, i)]} - {None}
        if set(lp) != want:
            raise ValueError(f"{cfg.name}: layer {i} has {sorted(lp)}, "
                             f"expected {sorted(want)}")
    return params


# the subtree of each mixer and FFN kind in a decoder layer (the shared
# attention block's weights live at the top, under "shared_attn")
_MIXER_LEAF = {"attn": "attn", "shared_attn": None, "mamba2": "mamba",
               "rwkv6": "timemix"}
_FFN_LEAF = {"swiglu": "mlp", "moe": "moe", "rwkv_cm": "chanmix",
             "none": None}


def _check_list(params: dict, name: str, n: int) -> None:
    layers = params.get(name)
    if not isinstance(layers, list) or len(layers) != n:
        raise ValueError(f"expected a list of {n} per-layer parameter "
                         f"dicts under {name!r} (the unrolled layout)")


def _check_stacked(layers, cfg) -> None:
    """A stacked layer tree: a dict whose every leaf has a leading axis of
    ``cfg.n_layers``."""
    if not isinstance(layers, dict):
        raise ValueError(f"{cfg.name}: expected the stacked layout under "
                         "'layers' (scan_layers on a homogeneous stack), "
                         f"got a {type(layers).__name__}")

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif t.dim() == 0 or t.shape[0] != cfg.n_layers:
            raise ValueError(f"{cfg.name}: stacked leaf {path} of shape "
                             f"{tuple(t.shape)}, expected a leading axis "
                             f"of {cfg.n_layers} layers")
    walk(layers, "layers")


def resnet_params_from_jax(tree, cfg, device=None) -> dict:
    """The port's ResNet parameters of ``cfg`` (`configs.resnet20_cifar`)
    on ``device`` (None: CUDA) from a numpy copy of the reference's tree
    (``stem``, ``stem_bn``, ``blocks[i].{conv1, bn1, conv2, bn2, proj?}``,
    ``head``), checked against `models.resnet.noise_sites`."""
    from repro_torch.models import resnet
    params = tree_from_numpy(tree, device_mod.resolve(device))
    sites = ["stem"] + [
        f"s{i // cfg.blocks_per_stage}b{i % cfg.blocks_per_stage}.{name}"
        for i, blk in enumerate(params.get("blocks", []))
        for name in ("conv1", "conv2", "proj") if name in blk] + ["head"]
    if sites != resnet.noise_sites(cfg) or "stem_bn" not in params:
        raise ValueError(f"ResNet parameter tree with sites {sites}, "
                         f"expected {resnet.noise_sites(cfg)}")
    for blk in params["blocks"]:
        if "bn1" not in blk or "bn2" not in blk:
            raise ValueError("ResNet block without bn1 / bn2")
    return params
