"""flash_attn at head dim 64, the tensor-core route's new head dim, held
against the reference's Pallas kernel (`flash_attn_pallas`, interpreted
as the reference's own tests run it off a TPU): the port's entry point on
the CPU (`flash_attn`, which runs `flash_attn_plain` there), and the
plain version of the route's key split and merge
(`flash_attn_split_plain`) at 1 to 8 parts.  Cases: one query row over
65 to 300 keys at g 1 (the enc-dec cross-attention's decode), g 2 causal
with q_offset (the MoE's prefill), ragged kv_len with a row of no live
key, and Sq 31 / 32 / 33 at g 2 (the edge of a 32-position query tile).
Then `flash_plan` at the long cross decode and zamba2's long prefill.

Tolerances as in test_torch_attention.py: f32 atol 1e-5 (sums in
another order), bf16 atol 2e-2 (one bf16 ulp at the outputs' magnitude).
Rows with no live key are exactly 0.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attn.flash_attn import flash_attn_pallas
from repro_torch.kernels.flash_attn import flash_attn as tflash

D = 64
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

CASES = {
    # name: (B, Sq, Skv, Hq, Hkv, kv_len, q_offset, causal)
    "decode g1 Skv 65": (2, 1, 65, 4, 4, [65, 64], 0, False),
    "decode g1 Skv 128": (2, 1, 128, 4, 4, [128, 1], 0, False),
    "decode g1 Skv 300, ragged, a dead row": (3, 1, 300, 4, 4,
                                              [300, 0, 191], 0, False),
    "g2 causal, q_offset 7": (2, 20, 90, 8, 4, [90, 27], 7, True),
    "g2 causal, ragged, a dead row": (2, 24, 150, 8, 4, [0, 150], 40, True),
    "g2 Sq 31": (1, 31, 31, 8, 4, [31], 0, True),
    "g2 Sq 32": (2, 32, 100, 8, 4, [100, 70], 68, True),
    "g2 Sq 33": (1, 33, 200, 8, 4, [200], 5, False),
}
_want: dict = {}


def _inputs(name: str, dt: str):
    b, sq, skv, hq, hkv, kv_len, q_off, causal = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, D), (b, skv, hkv, D), (b, skv, hkv, D))]
    jx = [jnp.asarray(a).astype(JDT[dt]) for a in arrs]
    tx = [torch.from_numpy(a).to(TDT[dt]) for a in arrs]
    key = (name, dt)
    if key not in _want:
        _want[key] = np.asarray(flash_attn_pallas(
            *jx, jnp.asarray(kv_len, jnp.int32), jnp.asarray(q_off, jnp.int32),
            causal=causal, interpret=True).astype(jnp.float32))
    lens = torch.tensor(kv_len, dtype=torch.int32)
    off = torch.tensor([q_off], dtype=torch.int32)
    return tx, lens, off, causal, _want[key]


def _check(got, want, dt, kv_len):
    assert got.dtype == TDT[dt]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL[dt])
    for bi, n in enumerate(kv_len):
        if n == 0:
            assert not got[bi].any()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_flash_attn_d64_matches_pallas(name, dt):
    (q, k, v), lens, off, causal, want = _inputs(name, dt)
    got = tflash.flash_attn(q, k, v, lens, off, causal=causal)
    assert got.shape == q.shape
    _check(got, want, dt, CASES[name][5])


@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["decode g1 Skv 300, ragged, a dead row",
                                  "g2 causal, ragged, a dead row",
                                  "g2 Sq 33"])
def test_split_plain_matches_pallas(name, dt, split):
    (q, k, v), lens, off, causal, want = _inputs(name, dt)
    got = tflash.flash_attn_split_plain(q, k, v, lens, off, causal=causal,
                                        kv_split=split)
    _check(got, want, dt, CASES[name][5])


def test_flash_plan_fills_the_card_at_d64_shapes():
    """The long cross decode (B 4, 16 heads, Sq 1 over 2048 frames: 64
    query tiles of 32 key tiles) splits 8 ways, 512 blocks of 4 key tiles;
    zamba2's long prefill (B 1, Sq 4096, 32 heads: 2048 query tiles) fills
    the card unsplit; a split never exceeds the key tiles."""
    assert tflash.flash_plan(4, 1, 16, 16, 2048) == 8
    assert 4 * 16 * 8 >= tflash.SMS
    assert tflash.flash_plan(1, 4096, 32, 32, 4100) == 1
    assert 1 * 32 * 4096 // 64 >= tflash.SMS
    assert tflash.flash_plan(4, 1, 16, 16, 64) == 1       # one key tile
    assert tflash.flash_plan(4, 1, 16, 16, 128) == 2      # two
    assert tflash.flash_plan(4, 128, 16, 8, 144) == 2     # the MoE prefill
    for skv in (1, 64, 65, 300, 2048, 32768):
        s = tflash.flash_plan(1, 1, 8, 8, skv)
        assert s in (1, 2, 4, 8) and s <= max(1, -(-skv // 64))


def test_tensor_core_route_by_dtype_and_head_dim():
    def route(qdt, kdt, d):
        return tflash.tensor_core_route(torch.zeros(1, 1, 1, d, dtype=qdt),
                                        torch.zeros(1, 1, 1, d, dtype=kdt))
    bf, f32 = torch.bfloat16, torch.float32
    assert route(bf, bf, 64) and route(bf, bf, 128)
    assert not route(bf, bf, 16) and not route(bf, bf, 96)
    assert not route(bf, f32, 64) and not route(f32, f32, 64)
