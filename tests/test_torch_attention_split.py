"""Port parity for the H100 designs of the attention kernels: the host-side
plans (`decode_gqa.split_plan`, `flash_attn.flash_plan`), the plain
PyTorch version of the split-cache decode (per-chunk partials, then the
log-sum-exp combine), and flash cases at the edges of the query tiles.

The JAX side is `decode_gqa_pallas` / `flash_attn_pallas`, interpreted off
a TPU as the reference's own tests run them; `decode_gqa_pallas` runs with
its block size set to the port's chunk, so both walk the cache in the same
blocks.  Tolerances as in test_torch_attention.py: f32 atol 1e-5 (sums in
another order), bf16 atol 2e-2 (one bf16 ulp at the outputs' magnitude).
Rows with no live key are exactly 0.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.decode_gqa.decode_gqa import decode_gqa_pallas
from repro.kernels.flash_attn.flash_attn import flash_attn_pallas
from repro_torch.kernels.decode_gqa import decode_gqa as tdec
from repro_torch.kernels.flash_attn import flash_attn as tflash

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rand(rng, shape, dt):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(JDT[dt]), torch.from_numpy(a).to(TDT[dt])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# --------------------------------------------------------------- planners
@pytest.mark.parametrize("s", [1, 31, 32, 33, 100, 144, 4096, 32768])
@pytest.mark.parametrize("b,hkv", [(1, 8), (4, 8), (64, 8), (2, 1), (1, 1)])
def test_split_plan_covers_the_cache_in_key_tiles(s, b, hkv):
    n_split, chunk = tdec.split_plan(s, b, hkv)
    assert chunk % tdec.KEY_TILE == 0 and chunk > 0
    assert n_split * chunk >= s
    assert (n_split - 1) * chunk < s        # no split empty by construction
    assert n_split <= tdec.MAX_SPLIT
    assert b * hkv * n_split <= max(b * hkv, tdec.BLOCKS_PER_SM * tdec.SMS)


@pytest.mark.parametrize("s", [144, 4096, 32768])
def test_split_plan_fills_the_card_at_the_serve_batch(s):
    """B 4, Hkv 8: B * Hkv = 32 blocks alone would leave 100 of the 132 SMs
    idle; the split gives at least one block per SM."""
    n_split, chunk = tdec.split_plan(s, 4, 8)
    assert 4 * 8 * n_split >= tdec.SMS
    assert tdec.split_plan(s, 4, 8) == (n_split, chunk)   # shapes only


def test_flash_plan_fills_the_card():
    """64-row query tiles; where they alone leave SMs idle (the train
    microbatch: 8 tiles x 8 kv heads = 64 blocks), two blocks share each
    tile's keys."""
    tiles = lambda b, sq, g: b * 8 * -(-sq // (64 // g))
    assert tiles(4, 128, 4) >= tflash.SMS
    assert tflash.flash_plan(4, 128, 32, 8) == 1          # serve prefill
    assert tflash.flash_plan(1, 4096, 32, 8) == 1         # train_4k
    assert tflash.flash_plan(1, 128, 32, 8) == 2          # train microbatch
    assert 2 * tiles(1, 128, 4) >= 0.95 * tflash.SMS
    assert tflash.flash_plan(1, 128, 64 * 8, 8) == 1      # g = 64: 1024
    with pytest.raises(ValueError):
        tflash.flash_plan(1, 128, 65 * 8, 8)


# ------------------------------------------- plain split-and-combine decode
S_DEC, B_DEC, HQ_DEC, HKV_DEC, D_DEC = 100, 2, 8, 2, 16
CHUNK = tdec.split_plan(S_DEC, B_DEC, HKV_DEC)[1]
LENGTHS = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, S_DEC, S_DEC + 9]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", LENGTHS)
def test_decode_split_plain_matches_pallas_blocks(length, dt):
    assert S_DEC > 2 * CHUNK          # the Pallas kernel runs several blocks
    rng = np.random.default_rng(length + 7)
    qj, qt = _rand(rng, (B_DEC, HQ_DEC, D_DEC), dt)
    kj, kt = _rand(rng, (B_DEC, S_DEC, HKV_DEC, D_DEC), dt)
    vj, vt = _rand(rng, (B_DEC, S_DEC, HKV_DEC, D_DEC), dt)
    lens = [length, S_DEC // 2]
    want = decode_gqa_pallas(qj, kj, vj, jnp.asarray(lens, jnp.int32),
                             bs=CHUNK, interpret=True)
    lt = torch.tensor(lens, dtype=torch.int32)
    got = tdec.decode_gqa_split_plain(qt, kt, vt, lt, CHUNK)
    assert got.dtype == TDT[dt] and got.shape == qt.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=TOL[dt])
    np.testing.assert_allclose(
        _f32(got), _f32(tdec.decode_gqa_plain(qt, kt, vt, lt)), rtol=0,
        atol=TOL[dt])
    if length == 0:
        assert not got[0].any()


@pytest.mark.parametrize("lens", [[0, 0], [1, 64], [100, 109]])
def test_split_partials_plain(lens):
    """Empty chunks are (NEG_INF, 0, 0); each live chunk's (m, l, acc) is
    the masked softmax of that chunk alone; a row with length 0 combines to
    exactly 0."""
    rng = np.random.default_rng(sum(lens))
    _, q = _rand(rng, (B_DEC, HQ_DEC, D_DEC), "float32")
    _, k = _rand(rng, (B_DEC, S_DEC, HKV_DEC, D_DEC), "float32")
    _, v = _rand(rng, (B_DEC, S_DEC, HKV_DEC, D_DEC), "float32")
    lt = torch.tensor(lens, dtype=torch.int32)
    m, l, acc = tdec.split_partials_plain(q, k, v, lt, CHUNK)
    n = -(-S_DEC // CHUNK)
    assert m.shape == l.shape == (B_DEC, HQ_DEC, n)
    assert acc.shape == (B_DEC, HQ_DEC, n, D_DEC)
    g = HQ_DEC // HKV_DEC
    for bi, ln in enumerate(lens):
        ln = min(ln, S_DEC)
        for i in range(n):
            lo, hi = i * CHUNK, min((i + 1) * CHUNK, ln)
            if lo >= hi:
                assert bool((m[bi, :, i] == -1e30).all())
                assert not l[bi, :, i].any() and not acc[bi, :, i].any()
                continue
            for h in range(HQ_DEC):
                sc = (k[bi, lo:hi, h // g] @ q[bi, h]) * D_DEC ** -0.5
                p = torch.exp(sc - sc.max())
                torch.testing.assert_close(m[bi, h, i], sc.max(), rtol=0,
                                           atol=1e-5)
                torch.testing.assert_close(l[bi, h, i], p.sum(), rtol=0,
                                           atol=1e-5)
                torch.testing.assert_close(acc[bi, h, i],
                                           p @ v[bi, lo:hi, h // g],
                                           rtol=0, atol=1e-5)
    out = tdec.combine_plain(m, l, acc)
    for bi, ln in enumerate(lens):
        if ln == 0:
            assert not out[bi].any()


# ------------------------------------------------ flash at the tile edges
FLASH_EDGE_CASES = [
    # (B, Sq, Skv, Hq, Hkv, kv_len, q_offset): Sq off the query tiles
    # (16 and 8 positions at g = 4), g = 1, 2, 4, 8
    (2, 9, 14, 8, 2, [14, 9], 5),       # g 4, Sq 9
    (1, 17, 17, 8, 2, [17], 0),         # g 4, Sq 17
    (2, 23, 30, 8, 2, [30, 11], 7),     # g 4, Sq 23
    (2, 13, 13, 4, 4, [13, 0], 0),      # g 1, a fully masked row
    (2, 11, 15, 8, 4, [15, 6], 4),      # g 2
    (1, 7, 9, 16, 2, [9], 2),           # g 8, Sq 7
]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_EDGE_CASES)
def test_flash_attn_tile_edges_match_pallas(case, dt):
    b, sq, skv, hq, hkv, kv_len, q_off = case
    d = 16
    rng = np.random.default_rng(sq * 31 + hq)
    qj, qt = _rand(rng, (b, sq, hq, d), dt)
    kj, kt = _rand(rng, (b, skv, hkv, d), dt)
    vj, vt = _rand(rng, (b, skv, hkv, d), dt)
    want = flash_attn_pallas(qj, kj, vj, jnp.asarray(kv_len, jnp.int32),
                             jnp.asarray(q_off, jnp.int32), causal=True)
    got = tflash.flash_attn(qt, kt, vt, torch.tensor(kv_len,
                                                     dtype=torch.int32),
                            torch.tensor([q_off], dtype=torch.int32))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=TOL[dt])
    for bi, n in enumerate(kv_len):
        if n == 0:
            assert not got[bi].any()
