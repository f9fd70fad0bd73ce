"""ResNet20-family CNN, the paper's own noise-tolerance network (port of
`repro/models/resnet.py`; Fig. 10 uses LSQ-4bit ResNet20/CIFAR10).

Convolutions are im2col + matmul, so they route through the TD simulator
with chain length k*k*C_in: a 3x3x64 conv is the paper's 576-long baseline
chain.  Batch norm uses the batch's statistics (ddof 0), at eval too, as
the reference does.

`forward_lanes` runs P probes of the batched noise search in one pass over
one batch of images: each probe (a lane) has its own per-site sigma and
key, every td conv is one td_vmm launch over all lanes, and batch norm
takes each lane's own statistics.  Lane p gives the logits that `forward`
gives at probe p's per-site policies and key, bit for bit: its per-lane
reductions are the same reductions on the same tensors, and a clean
prefix shared by all lanes is the single pass's own.
"""
from __future__ import annotations

import math

import torch

from repro_torch import device as device_mod
from repro_torch.configs.resnet20_cifar import ResNetCfg
from repro_torch.kernels.td_vmm import ref as td_ref
from repro_torch.models import common
from repro_torch.quant import lsq
from repro_torch.tdsim import td_linear


def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """x (..., H, W, C) -> (..., Ho, Wo, k*k*C) patches (SAME padding), the
    (di, dj) offsets major and the channel minor."""
    h, w = x.shape[-3:-1]
    pad = k // 2
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    return torch.cat([xp[..., di:di + h:stride, dj:dj + w:stride, :]
                      for di in range(k) for dj in range(k)], dim=-1)


def conv_init(gen, k, c_in, c_out, pol, dtype=torch.float32, device=None):
    return td_linear.init_linear(gen, k * k * c_in, c_out, pol, dtype=dtype,
                                 scale=(2.0 / (k * k * c_in)) ** 0.5,
                                 device=device)


def conv(params, x, k, stride, pol, key=None):
    return td_linear.linear(params, _im2col(x, k, stride), pol, key)


def _bn_init(c, dtype=torch.float32, device=None):
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def _bn(params, x, eps=1e-5):
    mu = x.mean((0, 1, 2), keepdim=True)
    var = x.var((0, 1, 2), keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]


def init_params(gen: torch.Generator, cfg: ResNetCfg, pol,
                dtype=torch.float32, device=None) -> dict:
    """Seeded parameters on ``device`` (None: CUDA), drawn from ``gen`` (a
    generator of that device) in the reference's order of layers."""
    dev = device_mod.resolve(device)
    kw = dict(dtype=dtype, device=dev)
    p: dict = {"stem": conv_init(gen, 3, 3, cfg.stages[0], pol, **kw),
               "stem_bn": _bn_init(cfg.stages[0], **kw)}
    blocks = []
    c_prev = cfg.stages[0]
    for stride, c in zip(block_strides(cfg), _block_widths(cfg)):
        blk = {"conv1": conv_init(gen, 3, c_prev, c, pol, **kw),
               "bn1": _bn_init(c, **kw),
               "conv2": conv_init(gen, 3, c, c, pol, **kw),
               "bn2": _bn_init(c, **kw)}
        if stride != 1 or c_prev != c:
            blk["proj"] = conv_init(gen, 1, c_prev, c, pol, **kw)
        blocks.append(blk)
        c_prev = c
    p["blocks"] = blocks
    p["head"] = td_linear.init_linear(gen, c_prev, cfg.classes, pol,
                                      bias=True, **kw)
    return p


def block_strides(cfg: ResNetCfg) -> list[int]:
    return [2 if (si > 0 and bi == 0) else 1
            for si in range(len(cfg.stages))
            for bi in range(cfg.blocks_per_stage)]


def _block_widths(cfg: ResNetCfg) -> list[int]:
    return [c for c in cfg.stages for _ in range(cfg.blocks_per_stage)]


def _sites(cfg: ResNetCfg) -> list[tuple[str, int]]:
    """(name, fold index of the site's key) of every matmul site, in
    `forward`'s order."""
    sites = [("stem", 0)]
    c_prev = cfg.stages[0]
    for i, (stride, c) in enumerate(zip(block_strides(cfg),
                                        _block_widths(cfg))):
        si, bi = divmod(i, cfg.blocks_per_stage)
        sites += [(f"s{si}b{bi}.conv1", 2 * i + 1),
                  (f"s{si}b{bi}.conv2", 2 * i + 2)]
        if stride != 1 or c_prev != c:
            sites.append((f"s{si}b{bi}.proj", 2 * i + 2000))
        c_prev = c
    sites.append(("head", 999))
    return sites


def noise_sites(cfg: ResNetCfg) -> list[str]:
    """Ordered names of the network's matmul sites: the per-layer axis of
    the batched noise-tolerance search (`forward` accepts one policy per
    site in this order)."""
    return [name for name, _ in _sites(cfg)]


def site_seeds(cfg: ResNetCfg, keys) -> list[list[int]]:
    """The td_vmm noise seed of every (probe, site): ``derive_seed`` of the
    probe's key folded as `forward` folds it at that site."""
    folds = [f for _, f in _sites(cfg)]
    return [[td_ref.derive_seed(common.fold_key(tuple(k), f)) for f in folds]
            for k in keys]


def _site_policies(cfg: ResNetCfg, pol) -> list:
    n_sites = len(_sites(cfg))
    if not isinstance(pol, (list, tuple)):
        return [pol] * n_sites
    if len(pol) != n_sites:
        raise ValueError(f"{len(pol)} per-site policies for a network "
                         f"with {n_sites} sites (noise_sites order)")
    return list(pol)


def _walk(params: dict, x: torch.Tensor, cfg: ResNetCfg, site, bn, pool):
    """The network's one walk, shared by `forward` and `forward_lanes`:
    ``site(s, p, h, k, stride)`` computes site s of `_sites(cfg)` (a k x k
    conv of h, or the head's linear of the pooled h where k is None),
    ``bn(p, h)`` normalizes and ``pool(h)`` averages over H and W."""
    s = iter(range(len(_sites(cfg))))
    h = torch.relu(bn(params["stem_bn"],
                      site(next(s), params["stem"], x, 3, 1)))
    for blk, stride in zip(params["blocks"], block_strides(cfg)):
        y = torch.relu(bn(blk["bn1"],
                          site(next(s), blk["conv1"], h, 3, stride)))
        y = bn(blk["bn2"], site(next(s), blk["conv2"], y, 3, 1))
        sc = h if "proj" not in blk else site(next(s), blk["proj"], h, 1,
                                              stride)
        h = torch.relu(y + sc)
        del y, sc
    pooled = pool(h)
    del h
    return site(next(s), params["head"], pooled, None, 1)


def forward(params: dict, x: torch.Tensor, cfg: ResNetCfg, pol,
            key=None) -> torch.Tensor:
    """x (B, H, W, 3) -> logits (B, classes).

    ``pol`` is one policy for every matmul, or a sequence with one policy
    per site in `noise_sites(cfg)` order.  ``key`` is a raw two-word PRNG
    key (`repro_torch.prng`) or None."""
    pols = _site_policies(cfg, pol)
    folds = [f for _, f in _sites(cfg)]

    def site(s, p, h, k, stride):
        key_s = common.fold_key(key, folds[s])
        if k is None:
            return td_linear.linear(p, h, pols[s], key_s)
        return conv(p, h, k, stride, pols[s], key_s)

    return _walk(params, x, cfg, site, _bn, lambda h: h.mean((1, 2)))


# ---------------------------------------------------------------------------
# P probes in one pass
# ---------------------------------------------------------------------------
def _per_lane(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of each lane of x (P, ...) alone, stacked: the reductions of
    `forward` on the same tensors, so a lane's bits are a single pass's."""
    return torch.stack([fn(x[p]) for p in range(x.shape[0])])


def _bn_lanes(params, x, eps=1e-5):
    """`_bn` with each lane's own statistics over its (B, H, W)."""
    mu = _per_lane(lambda a: a.mean((0, 1, 2), keepdim=True), x)
    var = _per_lane(lambda a: a.var((0, 1, 2), keepdim=True, correction=0),
                    x)
    return (x - mu) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]


def _conv_lanes(params, x, k, stride, pol, sigma, tdc_q, seeds):
    """`conv` over the lanes of x (P, B, H, W, C).  In td mode the patches
    are quantized and freed before the td_vmm launch."""
    if pol.mode != "td":
        return td_linear.linear_lanes(params, _im2col(x, k, stride), pol,
                                      sigma, tdc_q, seeds)
    x_int = lsq.lsq_quantize_int(_im2col(x, k, stride), params["s_a"],
                                 pol.bits_a, signed=True)
    return td_linear.td_codes_lanes(
        x_int, params["w"], params["s_a"], params["s_w"], pol, sigma,
        tdc_q, seeds, torch.promote_types(x.dtype, params["w"].dtype))


@torch.no_grad()
def forward_lanes(params: dict, x: torch.Tensor, cfg: ResNetCfg, base_pol,
                  sigma: torch.Tensor, keys) -> torch.Tensor:
    """P probes in one pass: x (B, H, W, 3) shared, ``sigma`` (P, n_sites)
    each probe's noise std per site (on x's device), ``keys`` P raw PRNG
    keys.  Every site runs ``base_pol`` at its lane's sigma.  Returns
    (P, B, classes); lane p equals ``forward(params, x, cfg,
    [base_pol.replace(sigma_chain=sigma[p, s]) ...], keys[p])``.

    The sites before the first one where any lane's sigma is nonzero run
    once for all lanes: at sigma 0 the noise term is exactly zero, so
    their outputs do not depend on the lane.  The per-site search's probes
    of a late site share that clean prefix.  Reading it costs one copy of
    ``sigma`` to the host a call."""
    n_sites = len(_sites(cfg))
    p_lanes = len(keys)
    if sigma.shape != (p_lanes, n_sites):
        raise ValueError(f"sigma {tuple(sigma.shape)} for {p_lanes} keys "
                         f"and {n_sites} sites")
    noisy = (sigma != 0).any(0).tolist()
    first = noisy.index(True) if any(noisy) else n_sites
    dev = x.device
    seeds = torch.tensor(site_seeds(cfg, keys), dtype=torch.int64,
                         device=dev)
    tdc_q = torch.full((p_lanes,), float(base_pol.tdc_q),
                       dtype=torch.float32, device=dev)
    clean = base_pol.replace(sigma_chain=0.0)

    def site(s, p, h, k, stride):
        if s < first:                        # one pass serves every lane
            if k is not None:
                return conv(p, h, k, stride, clean)
            return td_linear.linear(p, h, clean).expand(p_lanes, -1, -1)
        if h.dim() == (x.dim() if k is not None else 2):
            h = h.expand(p_lanes, *h.shape)
        if k is None:
            return td_linear.linear_lanes(p, h, base_pol, sigma[:, s], tdc_q,
                                          seeds[:, s])
        return _conv_lanes(p, h, k, stride, base_pol, sigma[:, s], tdc_q,
                           seeds[:, s])

    def bn(p, h):
        return _bn_lanes(p, h) if h.dim() > x.dim() else _bn(p, h)

    def pool(h):
        if h.dim() > x.dim():
            return _per_lane(lambda a: a.mean((1, 2)), h)
        return h.mean((1, 2))

    return _walk(params, x, cfg, site, bn, pool)


def make_synthetic_cifar(gen: torch.Generator, n: int, cfg: ResNetCfg,
                         noise: float = 0.35):
    """Separable synthetic image classes (class-dependent frequency
    patterns plus noise), the reference's generator, drawn with ``gen`` on
    its device: (images (n, img, img, 3) f32, labels (n,) int64)."""
    dev = gen.device
    labels = torch.randint(0, cfg.classes, (n,), generator=gen, device=dev)
    ar = torch.arange(cfg.img, dtype=torch.float32, device=dev) / cfg.img
    ii, jj = ar[:, None, None], ar[None, :, None]
    ch = torch.arange(3, dtype=torch.float32, device=dev)[None, None, :] / 3.0
    f = (1.0 + labels.to(torch.float32))[:, None, None, None]
    imgs = torch.sin(2 * math.pi * f * ii + ch * 2) \
        * torch.cos(2 * math.pi * f * jj - ch)
    imgs = imgs + noise * torch.randn(imgs.shape, generator=gen, device=dev)
    return imgs, labels
