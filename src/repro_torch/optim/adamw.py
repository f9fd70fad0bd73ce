"""AdamW with global-norm clipping and a warmup-cosine schedule (port of
`repro/optim/adamw.py`).

Plain torch over the nested parameter dict, with the reference's leaf
paths ("layers/0/attn/wq/s_w", ...) deciding which leaves skip weight
decay, and float32 moments.  The reference's ZeRO-1 sharding is a mesh
annotation and has no counterpart on one card.

`apply_updates` updates the parameters and both moments in place, where
the reference returns new trees from a jitted step that donates its
inputs: the same values, without holding two copies of the parameters
and moments (for qwen3-8b, 4 bytes x 3 per parameter) at once.  The step
count and every schedule value stay device tensors, so an update never
waits for the device.  On DTensor parameters a gradient that autograd
left partial or in another layout is redistributed to its parameter's
placements first (the data-parallel reduce-scatter of a sharded step).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import TrainCfg


@dataclasses.dataclass
class OptState:
    step: torch.Tensor          # () int32 on the parameters' device
    mu: dict
    nu: dict


def tree_leaves_with_path(tree, prefix: str = "") -> list:
    """[(path, leaf)] in the reference's flattening order (dict keys
    sorted, list entries in order), paths joined by "/"."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_leaves_with_path(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_leaves_with_path(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def init_opt_state(params) -> OptState:
    leaves = tree_leaves_with_path(params)
    dev = leaves[0][1].device if leaves else None
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params))


def lr_schedule(step: torch.Tensor, cfg: TrainCfg) -> torch.Tensor:
    """Linear warmup, then cosine decay to 10% of ``cfg.lr``; float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup)
                    / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` in ``p``'s DTensor placements (as it is for plain tensors)."""
    pl = getattr(p, "placements", None)
    if pl is None or tuple(g.placements) == tuple(pl):
        return g
    return g.redistribute(p.device_mesh, pl)


def global_norm(tree) -> torch.Tensor:
    leaves = [l for _, l in tree_leaves_with_path(tree)]
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


def _is_decay_param(path: str) -> bool:
    """No weight decay on norms, biases, scalar quant steps, per-head gains."""
    skip = ("scale", "bias", "s_a", "s_w", "s_wi", "s_wg", "s_wo", "mu",
            "dt_bias", "a_log", "d_skip", "u", "w0", "ln_x")
    leaf = path.split("/")[-1]
    return leaf not in skip


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: TrainCfg
                  ) -> tuple[dict, OptState, dict]:
    """One AdamW step on ``params`` (in place, see the module docstring).
    Returns (params, state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    trees = [tree_leaves_with_path(t) for t in (params, grads, state.mu,
                                                state.nu)]
    # in-place ops in the reference's order of roundings (a product or sum
    # of two operands rounds once either way round)
    for (path, p), (_, g), (_, m), (_, v) in zip(*trees):
        g = _placed_like(g, p).to(torch.float32) * clip
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.mul(1 - b2).mul_(g))
        del g
        delta = m.div(bc1).div_(v.div(bc2).sqrt_().add_(cfg.eps))
        if _is_decay_param(path):
            delta.add_(p.to(torch.float32) * cfg.weight_decay)
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.to(torch.float32).sub_(delta))
    state.step = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
