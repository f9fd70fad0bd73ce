"""The td_vmm kernel's route plan and the split route's plain version.

`td_vmm_plan` picks the kernel's route from the shapes alone: the split
route (grid split over segments, partials combined in segment order) for
decode's few rows, the block route (segments walked inside a block) for
prefill and training.  `td_vmm_split_plain` is the split route in plain
PyTorch: each split computes its own segments from its slice of the
contraction into a scratch laid out as the kernel's, then the combine adds
them in order.  Tolerances:

* bit-exact against the Pallas kernel (interpret mode, as
  `test_torch_td_vmm.py` runs it) at sigma = 0 for tdc_q 1 to 3: every
  partial is an integer and the order of float additions is the Pallas
  kernel's;
* bit-identical to `td_vmm_plain` with noise: the same noise indices, the
  same float operations in the same order.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.td_vmm import ref as tref
from repro_torch.kernels.td_vmm import td_vmm as tkern
from test_torch_td_vmm import SEED, SHAPES, _codes, _pallas

# qwen3-8b's td matmuls: (M, K, N) at decode (batch 4), prefill (4 x 128)
# and in a training microbatch (1 x 128)
DECODE = [(4, 4096, 1024), (4, 4096, 4096), (4, 4096, 12288),
          (4, 12288, 4096), (4, 4096, 151936)]
WIDE = [(512, 4096, 12288), (512, 12288, 4096), (128, 4096, 12288),
        (128, 4096, 151936)]


def _split(plan):
    """The split route for any shape: one split a segment."""
    return dataclasses.replace(plan, route="split")


@pytest.mark.parametrize("m,k,n,n_chain", [
    *[(m, k, n, 576) for m, k, n in DECODE + WIDE],
    *SHAPES, (9, 161, 13, 576), (1, 1, 1, 16), (8, 0, 5, 48)])
@pytest.mark.parametrize("bits_a", [1, 4, 8])
def test_plan_covers_every_segment_once(m, k, n, n_chain, bits_a):
    plan = tkern.td_vmm_plan(m, k, n, n_chain, bits_a)
    assert plan.n_seg == max(1, -(-k // n_chain))
    # the segments' slices tile the contraction, each position once
    covered = [i for s in range(plan.n_seg)
               for i in range(s * n_chain, min((s + 1) * n_chain, k))]
    assert covered == list(range(k))
    assert (plan.n_seg - 1) * n_chain < max(k, 1)   # no segment past K
    assert plan.route == ("split" if m <= tkern.SPLIT_MAX_M else "block")


@pytest.mark.parametrize("m,k,n", DECODE)
def test_plan_splits_segments_at_decode(m, k, n):
    plan = tkern.td_vmm_plan(m, k, n, 576, 4)
    assert plan.route == "split"
    assert plan.n_seg == -(-k // 576) > 1


@pytest.mark.parametrize("m,k,n", WIDE)
@pytest.mark.parametrize("bits_a", [4, 8])
def test_plan_keeps_segments_in_block_at_large_m(m, k, n, bits_a):
    plan = tkern.td_vmm_plan(m, k, n, 576, bits_a)
    assert plan.route == "block"
    assert plan.n_seg == -(-k // 576)


def test_plan_depends_on_shapes_alone():
    a = tkern.td_vmm_plan(4, 4096, 12288, 576, 4)
    b = tkern.td_vmm_plan(4, 4096, 12288, 576, 4)
    assert a == b and hash(a) == hash(b)
    assert tkern.td_vmm_plan(8, 4096, 12288, 576, 4).route == "split"
    assert tkern.td_vmm_plan(9, 4096, 12288, 576, 4).route == "block"


def _split_plain(x, w, sigma, q, n_chain, bits_a, bits_w, k_true=None):
    m, k = x.shape
    plan = _split(tkern.td_vmm_plan(m, k, w.shape[1], n_chain, bits_a))
    return tkern.td_vmm_split_plain(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.tensor([sigma, q], dtype=torch.float32),
        torch.tensor([SEED], dtype=torch.int64), bits_a=bits_a,
        bits_w=bits_w, n_chain=n_chain, k_true=k_true, plan=plan).numpy()


@pytest.mark.parametrize("tdc_q", [1, 2, 3])
@pytest.mark.parametrize("n_chain", [576, 48, 16])
@pytest.mark.parametrize("m,k,n", [s[:3] for s in SHAPES])
def test_split_plain_sigma0_bit_exact_against_pallas(m, k, n, n_chain,
                                                     tdc_q):
    rng = np.random.default_rng(m * k + n + n_chain)
    x, w = _codes(rng, (m, k), 4), _codes(rng, (k, n), 4)
    got = _split_plain(x, w, 0.0, tdc_q, n_chain, 4, 4)
    np.testing.assert_array_equal(got, _pallas(x, w, 0.0, tdc_q, n_chain,
                                               4, 4))
    if tdc_q == 1:
        np.testing.assert_array_equal(got, (x @ w).astype(np.float32))


def _plain(x, w, sigma, q, n_chain, bits_a, bits_w, k_true=None):
    return tkern.td_vmm_plain(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.tensor([sigma, q], dtype=torch.float32),
        torch.tensor([SEED], dtype=torch.int64), bits_a=bits_a,
        bits_w=bits_w, n_chain=n_chain, k_true=k_true).numpy()


@pytest.mark.parametrize("sigma,tdc_q", [(0.7, 1), (1.9179178476333618, 2),
                                         (0.55, 6)])
@pytest.mark.parametrize("m,k,n,n_chain", SHAPES)
def test_split_plain_noisy_bit_identical_to_plain(m, k, n, n_chain, sigma,
                                                  tdc_q):
    rng = np.random.default_rng(int(sigma * 100) + m)
    x, w = _codes(rng, (m, k), 4), _codes(rng, (k, n), 4)
    for k_true in (k, k - 7):        # a masked tail, in the last segment
        got = _split_plain(x, w, sigma, tdc_q, n_chain, 4, 4, k_true)
        np.testing.assert_array_equal(
            got, _plain(x, w, sigma, tdc_q, n_chain, 4, 4, k_true))
    assert (got != (x @ w)).mean() > 0.05       # the noise is there


@pytest.mark.parametrize("bits_a,bits_w", [(8, 8), (2, 3), (1, 4)])
def test_split_plain_other_widths(bits_a, bits_w):
    rng = np.random.default_rng(bits_a * 10 + bits_w)
    x, w = _codes(rng, (5, 100), bits_a), _codes(rng, (100, 70), bits_w)
    for sigma, q in ((0.0, 3), (0.9, 2)):
        np.testing.assert_array_equal(
            _split_plain(x, w, sigma, q, 16, bits_a, bits_w),
            _plain(x, w, sigma, q, 16, bits_a, bits_w))
    np.testing.assert_array_equal(
        _split_plain(x, w, 0.0, 1, 16, bits_a, bits_w),
        tref.td_vmm_signed_ref(torch.from_numpy(x), torch.from_numpy(w),
                               bits_a=bits_a, bits_w=bits_w, n_chain=16,
                               sigma=0.0, tdc_q=1, seed=SEED).numpy())


def test_split_plain_dead_segments_keep_their_noise():
    """Segments wholly past k_true add noise only, as in the Pallas kernel
    (each segment's noise scale counts at least one live cell)."""
    rng = np.random.default_rng(3)
    x, w = _codes(rng, (4, 96), 4), _codes(rng, (96, 9), 4)
    got = _split_plain(x, w, 0.8, 2, 16, 4, 4, k_true=20)
    np.testing.assert_array_equal(got, _plain(x, w, 0.8, 2, 16, 4, 4, 20))
    quiet = _split_plain(x, w, 0.0, 1, 16, 4, 4, k_true=20)
    np.testing.assert_array_equal(quiet,
                                  (x[:, :20] @ w[:20]).astype(np.float32))
    assert (got != quiet).any()
