"""Port parity: the attention engines of `repro_torch` against `repro`.

The JAX side is the production `flash_attn_pallas` / `decode_gqa_pallas`,
interpreted off a TPU as the reference's own tests run them; the port's
side is the kernel wrappers on CPU tensors (their plain versions).
Tolerances: f32 atol 1e-5 (sums in another order; the interpreted kernel
runs one whole-sequence tile), bf16 atol 2e-2 (one bf16 ulp at the
outputs' magnitude, which stays below 2).  Rows with no live key are 0 in
both, exactly.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.kernels.decode_gqa.decode_gqa import decode_gqa_pallas
from repro.kernels.flash_attn.flash_attn import flash_attn_pallas
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch.convert import tree_from_numpy
from repro_torch.kernels.decode_gqa import decode_gqa as tdec
from repro_torch.kernels.decode_gqa.ops import decode_attention
from repro_torch.kernels.flash_attn import flash_attn as tflash
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models import attention as tattn
from repro_torch.tdsim.policy import quant_policy as tquant

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


FLASH_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, kv_len, q_offset, causal)
    (2, 8, 8, 4, 2, 16, [8, 5], 0, True),        # ragged kv_len, GQA g=2
    (2, 5, 12, 4, 1, 16, [12, 9], 7, True),      # rectangular, q_offset>0
    (1, 6, 10, 6, 3, 8, [10], 0, False),         # non-causal
    (3, 4, 9, 8, 2, 32, [9, 0, 4], 2, True),     # row 1 fully masked
    (1, 3, 7, 2, 2, 16, [7], 0, True),           # MHA (g=1)
    # the LM sweep's attention layouts (f32 on the card's CUDA-core
    # route): granite-8b g 4 at D 128, granite-moe g 2 and zamba2's shared
    # block g 1 at D 64; Sq = Skv 32, causal
    (2, 32, 32, 16, 4, 128, [32, 32], 0, True),
    (2, 32, 32, 8, 4, 64, [32, 32], 0, True),
    (2, 32, 32, 4, 4, 64, [32, 32], 0, True),
]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attn_matches_pallas(case, dt):
    b, sq, skv, hq, hkv, d, kv_len, q_off, causal = case
    rng = np.random.default_rng(sq * skv + d)
    qj, qt = _rand(rng, (b, sq, hq, d), dt)
    kj, kt = _rand(rng, (b, skv, hkv, d), dt)
    vj, vt = _rand(rng, (b, skv, hkv, d), dt)
    want = flash_attn_pallas(qj, kj, vj, jnp.asarray(kv_len, jnp.int32),
                             jnp.asarray(q_off, jnp.int32), causal=causal)
    launches = tflash.launches
    got = tflash.flash_attn(qt, kt, vt, torch.tensor(kv_len, dtype=torch.int32),
                            torch.tensor([q_off], dtype=torch.int32),
                            causal=causal)
    assert tflash.launches == launches
    assert got.dtype == TDT[dt] and got.shape == qt.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=TOL[dt])
    for bi, n in enumerate(kv_len):
        if n == 0:
            assert not got[bi].any()


def test_flash_attn_mixed_dtypes_and_defaults():
    """f32 queries against a bf16 cache (the f32-compute prefill)."""
    rng = np.random.default_rng(0)
    qj, qt = _rand(rng, (2, 6, 4, 16), "float32")
    kj, kt = _rand(rng, (2, 6, 2, 16), "bfloat16")
    vj, vt = _rand(rng, (2, 6, 2, 16), "bfloat16")
    want = flash_attn_pallas(qj, kj, vj)
    got = flash_attention(qt, kt, vt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [[0, 3, 17], [20, 25, 1], [7, 20, 0]])
def test_decode_gqa_matches_pallas(lengths, dt):
    b, s, hq, hkv, d = 3, 20, 8, 2, 16
    rng = np.random.default_rng(sum(lengths))
    qj, qt = _rand(rng, (b, hq, d), dt)
    kj, kt = _rand(rng, (b, s, hkv, d), dt)
    vj, vt = _rand(rng, (b, s, hkv, d), dt)
    want = decode_gqa_pallas(qj, kj, vj, jnp.asarray(lengths, jnp.int32))
    launches = tdec.launches
    got = decode_attention(qt, kt, vt, torch.tensor(lengths,
                                                     dtype=torch.int32))
    assert tdec.launches == launches
    assert got.dtype == TDT[dt] and got.shape == qt.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=TOL[dt])
    for bi, n in enumerate(lengths):
        if n == 0:
            assert not got[bi].any()


def test_wrappers_reject_bad_operands():
    q = torch.zeros((1, 4, 4, 8))
    k = torch.zeros((1, 4, 2, 8))
    lens = torch.tensor([4], dtype=torch.int32)
    off = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError):
        tflash.flash_attn(q, k, k, lens.long(), off)
    with pytest.raises(TypeError):
        tflash.flash_attn(q.double(), k.double(), k.double(), lens, off)
    with pytest.raises(ValueError):
        tflash.flash_attn(q, torch.zeros((1, 4, 3, 8)),
                          torch.zeros((1, 4, 3, 8)), lens, off)
    with pytest.raises(ValueError):
        tflash.flash_attn(q.transpose(1, 2), k, k, lens, off)
    with pytest.raises(ValueError):
        tdec.decode_gqa(q[:, 0], k, k, torch.tensor([1, 2],
                                                    dtype=torch.int32))


def test_attention_layer_prefill_then_decode_matches_reference():
    """`models.attention` with a KV cache: a prefill over a prompt, then
    two single-token decode steps (the decode_gqa route), f32 compute
    against the reference's bf16 cache."""
    arch = jcfgs.get_smoke("qwen3-8b")
    cfg, tcfg = arch.model, tcfgs.get_smoke("qwen3-8b").model
    jp = jattn.attn_init(jax.random.PRNGKey(3), cfg, jquant())
    tp = tree_from_numpy(jax.device_get(jp))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    jc = jattn.init_cache(2, 12, cfg)
    tc = tattn.init_cache(2, 12, tcfg, device="cpu")
    yj, jc = jattn.attention(jp, jnp.asarray(x), cfg, jquant(),
                             jnp.arange(7), cache=jc)
    yt, tc = tattn.attention(tp, torch.from_numpy(x), tcfg, tquant(),
                             torch.arange(7), cache=tc)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    for step in range(2):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        pos = 7 + step
        yj, jc = jattn.attention(jp, jnp.asarray(xs), cfg, jquant(),
                                 jnp.asarray([pos]), cache=jc)
        yt, tc = tattn.attention(tp, torch.from_numpy(xs), tcfg, tquant(),
                                 torch.tensor([pos]), cache=tc)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
        assert tc["idx"] == int(jc["idx"])
    np.testing.assert_array_equal(_f32(tc["k"]), _f32(jc["k"]))


def test_td_attention_not_ported_raises():
    """TD attention is ported (tests/test_torch_td_attention.py) except on
    the per-row ragged cache, which raises the reference's ValueError;
    a scalar-index cache takes it."""
    tcfg = tcfgs.get_smoke("qwen3-8b").model
    heads = (tquant(),) * tcfg.n_heads
    ragged = tattn.init_cache(1, 4, tcfg, device="cpu", per_row_idx=True)
    with pytest.raises(ValueError, match="per-slot ragged caches"):
        tattn.attention({}, torch.zeros((1, 1, tcfg.d_model)), tcfg,
                        tquant(), torch.zeros((1, 1)), cache=ragged,
                        attn_pols=heads)
    tp = tree_from_numpy(jax.device_get(jattn.attn_init(
        jax.random.PRNGKey(0), jcfgs.get_smoke("qwen3-8b").model,
        jquant())))
    cache = tattn.init_cache(1, 4, tcfg, device="cpu")
    y, cache = tattn.attention(tp, torch.ones((1, 2, tcfg.d_model)), tcfg,
                               tquant(), torch.arange(2), cache=cache,
                               attn_pols=heads)
    assert y.shape == (1, 2, tcfg.d_model) and cache["idx"] == 2
    assert bool(torch.isfinite(y).all())


def test_rope_and_rmsnorm_match_reference():
    from repro_torch.models import common as tcommon
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(4, 13)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    scale = rng.standard_normal(16).astype(np.float32)
    want = jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = tcommon.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
