"""Port parity: the dry run's exact counts, the collective link model and
the roofline (`repro_torch.launch.dryrun`, `repro_torch.roofline`)
against the reference's, and the counter's own rules.

* For every cell of `cells(include_skips=False)`: the parameter count of
  the port's fake parameters, the active parameters, the model FLOPs and
  the analytic attention counts (`_scan_corrections`) equal the
  reference's (`repro/launch/dryrun.py`; imported with its XLA_FLAGS
  side effect undone, so this process keeps one host device).
* `CollectiveStats` built from the collectives of the reference's test
  HLO (tests/test_distribution.py:79-104) equals `parse_collectives`;
  `make_roofline` at the reference's rates (both link terms at 200 GB/s,
  197 TFLOP/s, 819 GB/s) equals the reference's terms, dominance and MFU.
* The counter: a matmul's FLOPs and bytes; the kernels' entry points
  recorded analytically (not run, their plain versions not counted);
  the wkv6 scan counted as one step times the trip count, backward too.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import importlib
import math
import os

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import common as jcommon
from repro.models import get_api as jget_api
from repro.roofline import hlo_parse
from repro.roofline import model as jroof
import repro_torch.configs as tcfgs
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import specs as tspecs
from repro_torch.models import common as tcommon
from repro_torch.models import get_api as tget_api
from repro_torch.roofline import counter as tcounter
from repro_torch.roofline import model as troof


def _reference_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


jdr = _reference_dryrun()


def _n_params(name):
    jarch, tarch = jcfgs.get(name), tcfgs.get(name)
    jp = jax.eval_shape(lambda: jget_api(jarch.model)["init"](
        jax.random.key(0), jarch.model, jcommon.resolve_arch_policy(jarch)))
    with tspecs.fake_mode():
        tp = tget_api(tarch.model)["init"](
            0, tarch.model, tcommon.resolve_arch_policy(tarch, device="cpu"),
            device="cpu")
    return jdr._count_params(jp), tdr._count_params(tp)


@pytest.mark.parametrize("name", jcfgs.ARCH_NAMES)
def test_counts_match_reference_every_cell(name):
    want_n, got_n = _n_params(name)
    assert got_n == want_n
    jarch, tarch = jcfgs.get(name), tcfgs.get(name)
    assert tdr._active_params(tarch, got_n) == \
        jdr._active_params(jarch, want_n)
    act = tdr._active_params(tarch, got_n)
    cells = [c for c in tcfgs.cells(include_skips=False) if c[0] == name]
    assert cells == [c for c in jcfgs.cells(include_skips=False)
                     if c[0] == name]
    for _, shape, _ in cells:
        jsh, tsh = jcfgs.SHAPES[shape], tcfgs.SHAPES[shape]
        assert tdr._scan_corrections(tarch, tsh) == \
            jdr._scan_corrections(jarch, jsh)
        tokens = tsh.global_batch * (tsh.seq_len if tsh.kind != "decode"
                                     else 1)
        if tsh.kind == "train":
            assert troof.model_flops_train(act, tokens) == \
                jroof.model_flops_train(act, tokens)
        else:
            assert troof.model_flops_serve(act, tokens) == \
                jroof.model_flops_serve(act, tokens)


# the reference's test HLO (tests/test_distribution.py:80-85)
HLO = """
  %ag = f32[256,1024]{1,0} all-gather(f32[16,1024]{1,0} %p0), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}
  %ar = bf16[512,512]{1,0} all-reduce(bf16[512,512]{1,0} %p1), replica_groups=[16,32]<=[512], to_apply=%add
  %rs = f32[16,1024]{1,0} reduce-scatter(f32[256,1024]{1,0} %p2), replica_groups={{0,1}}, dimensions={0}
  %cp = f32[8,8]{1,0} collective-permute(f32[8,8]{1,0} %p3), source_target_pairs={{0,1}}
"""


def test_collective_stats_match_reference_hlo():
    want = hlo_parse.parse_collectives(HLO)
    got = tcounter.CollectiveStats.empty()
    got.add("all-gather", 16 * 1024 * 4, 256 * 1024 * 4, 16)
    got.add("all-reduce", 512 * 512 * 2, 512 * 512 * 2, 32)
    got.add("reduce-scatter", 256 * 1024 * 4, 16 * 1024 * 4, 2)
    got.add("collective-permute", 8 * 8 * 4, 8 * 8 * 4, 2)
    assert got.counts == want.counts
    assert got.operand_bytes == pytest.approx(want.operand_bytes)
    assert got.link_bytes == pytest.approx(want.link_bytes, rel=1e-15)
    assert got.total_link_bytes == pytest.approx(want.total_link_bytes)


@pytest.mark.parametrize("totals", [(1e18, 1e15, 1e13, 5e17),
                                    (1e15, 1e16, 1e12, 1e15),
                                    (1e14, 1e13, 5e15, 2e14)])
def test_make_roofline_at_reference_rates(totals):
    f, b, c, m = totals
    want = jroof.make_roofline("a", "s", "m", 256, flops_total=f,
                               bytes_total=b, coll_link_bytes_total=c,
                               model_flops=m)
    got = troof.make_roofline("a", "s", "m", 256, f, b, c, m,
                              coll_model_bytes_total=0.3 * c,
                              peak_flops=jroof.PEAK_FLOPS,
                              hbm_bw=jroof.HBM_BW,
                              nvlink_bw=jroof.LINK_BW * jroof.N_LINKS,
                              ib_bw=jroof.LINK_BW * jroof.N_LINKS)
    for k in ("compute_s", "memory_s", "collective_s", "step_s", "mfu",
              "useful_flops_ratio"):
        assert getattr(got, k) == pytest.approx(getattr(want, k),
                                                rel=1e-12), k
    assert got.dominant == want.dominant


def test_h100_roofline_terms():
    rl = troof.make_roofline("a", "s", "m", 8, 8e15, 8e12, 8e11, 4e15,
                             coll_model_bytes_total=4e11,
                             int8_ops_total=8e15)
    assert rl.compute_s == pytest.approx(1e15 / 989e12 + 1e15 / 1979e12)
    assert rl.memory_s == pytest.approx(1e12 / 3.35e12)
    assert rl.collective_s == pytest.approx(5e10 / 450e9 + 5e10 / 50e9)
    assert rl.dominant == "compute"
    assert rl.mfu == pytest.approx(4e15 / (rl.step_s * 8 * 989e12))


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------
def test_counter_matmul_flops_and_bytes():
    with tspecs.fake_mode():
        a, b = torch.zeros(32, 64), torch.zeros(64, 16)
        c = tcounter.Counter()
        with c:
            y = a @ b
            z = y.view(-1)              # a view: no bytes
        del z
    assert c.flops == 2 * 32 * 64 * 16
    assert c.bytes == 4 * (32 * 64 + 64 * 16 + 32 * 16)
    assert c.op_bytes == {"mm": 4 * 32 * 16}
    assert c.peak_bytes == 4 * 32 * 16


def test_kernels_recorded_not_run():
    from repro_torch.kernels.decode_gqa.ops import decode_attention
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.td_vmm import ops as td_ops
    from repro_torch.tdsim.policy import TDPolicy
    b, sq, hq, hkv, d, skv = 2, 16, 8, 2, 32, 64
    with tspecs.fake_mode():
        q = torch.zeros(b, sq, hq, d, dtype=torch.bfloat16,
                        requires_grad=True)
        k = torch.zeros(b, sq, hkv, d, dtype=torch.bfloat16,
                        requires_grad=True)
        v = torch.zeros(b, sq, hkv, d, dtype=torch.bfloat16,
                        requires_grad=True)
        qd = torch.zeros(b, hq, d, dtype=torch.bfloat16)
        kc = torch.zeros(b, skv, hkv, d, dtype=torch.bfloat16)
        x = torch.zeros(24, 96, dtype=torch.int32)
        w = torch.zeros(96, 40, dtype=torch.int32)
        pol = TDPolicy(mode="td", bits_a=4, bits_w=4, n_chain=96,
                       sigma_chain=0.5, tdc_q=1)
        c = tcounter.Counter()
        with c:
            o = flash_attention(q, k, v)
            o.float().sum().backward()
            od = decode_attention(qd, kc, kc, torch.full((b,), skv))
            y = td_ops.td_vmm_seeded(x, w, pol, 7)
    assert o.shape == q.shape and od.shape == qd.shape
    assert y.shape == (24, 40) and y.dtype == torch.float32
    assert c.op_flops == {}                 # no plain version ran
    fa = 4.0 * b * sq * sq * hq * d
    assert c.kernels["flash_attn"]["flops"] == fa
    assert c.kernels["flash_attn_bwd"]["flops"] == 2 * fa
    assert c.kernels["flash_attn"]["bytes"] == \
        2 * b * (2 * sq * hq * d + 2 * sq * hkv * d)
    assert c.kernels["decode_gqa"]["flops"] == 4.0 * b * skv * hq * d
    assert c.kernels["td_vmm"]["int_ops"] == 2.0 * 24 * 96 * 40 * 4
    assert c.kernels["td_vmm"]["bytes"] == 24 * 96 + 96 * 40 + 4 * 24 * 40


def test_wkv6_scan_counted_once_times_trip():
    from repro_torch.models import rwkv6
    b, s, h, hd = 2, 50, 3, 8
    with tspecs.fake_mode():
        r, k, v, w = (torch.zeros(b, s, h, hd, requires_grad=True)
                      for _ in range(4))
        u = torch.zeros(h, hd)
        c = tcounter.Counter()
        with c:
            y, state = rwkv6.wkv6_scan(r, k, v, w, u)
        fwd = c.op_flops["bmm"]
        with c:
            y.sum().backward()
    assert y.shape == (b, s, h, hd) and state.shape == (b, h, hd, hd)
    assert c.scans == {"wkv6": s}
    assert fwd == s * 2 * b * h * hd * hd
    # the backward recomputes the step and takes its two gradients
    assert c.op_flops["bmm"] == fwd + s * 3 * 2 * b * h * hd * hd


def test_wkv6_scan_unchanged_without_counter():
    from repro_torch.models import rwkv6
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 5, 2, 4, generator=g) for _ in range(3))
    w = torch.rand(1, 5, 2, 4, generator=g)
    u = torch.randn(2, 4, generator=g)
    y, st = rwkv6.wkv6_scan(r, k, v, w, u)
    state = torch.zeros(1, 2, 4, 4)
    for t in range(5):
        y_t = (r[:, t, :, :, None] * (state + (u[None] * k[:, t])[..., None]
                                      * v[:, t, :, None, :])).sum(-2)
        assert torch.allclose(y[:, t], y_t, atol=1e-5)
        state = w[:, t, :, :, None] * state \
            + k[:, t, :, :, None] * v[:, t, :, None, :]
    assert torch.allclose(st, state, atol=1e-6)
    assert math.isfinite(float(y.sum()))
    assert np.isfinite(st.numpy()).all()
