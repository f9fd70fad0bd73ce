"""The reference agrees with the port at smoke size, its TD product with
the port's oracle bit for bit, and its control comes out not correct."""
import time

import pytest
import torch

from tdbench import harness
from tdbench.reference import td
from tdbench.tests import smoke


@pytest.mark.parametrize("m,k,n,n_chain,sigma", [
    (7, 50, 13, 16, 0.4), (5, 100, 9, 32, 0.9), (12, 64, 20, 16, 0.1554),
    (3, 600, 11, 576, 0.166)])
def test_td_product_equals_the_port_oracle(m, k, n, n_chain, sigma):
    from repro_torch.kernels.td_vmm import ref as port_ref
    g = torch.Generator().manual_seed(m * 1000 + k)
    x = torch.randint(-8, 8, (m, k), generator=g).to(torch.float32)
    w = torch.randint(-8, 8, (k, n), generator=g).to(torch.float32)
    seed = td.derive_seed(0, 0)
    assert seed == port_ref.derive_seed((0, 0))
    want = port_ref.td_vmm_signed_ref(
        x.to(torch.int32), w.to(torch.int32), bits_a=4, bits_w=4,
        n_chain=n_chain, sigma=sigma, tdc_q=1.0, seed=seed)
    mac = td.TDMacro(4, 4, n_chain, sigma, 1, seed, "cpu")
    assert torch.equal(mac.product(x, w, torch.arange(m), m), want)
    sub = torch.tensor([m - 1, 0])
    assert torch.equal(mac.product(x[sub], w, sub, m), want[sub])


def test_noise_book_covers_the_rounding_edges():
    """Large sigma puts many elements near a half-integer: the book's
    edge path decides them from P, as the hardware does."""
    from repro_torch.kernels.td_vmm import ref as port_ref
    g = torch.Generator().manual_seed(5)
    x = torch.randint(-8, 8, (40, 48), generator=g).to(torch.float32)
    w = torch.randint(-8, 8, (48, 30), generator=g).to(torch.float32)
    mac = td.TDMacro(4, 4, 16, 2.5, 1, 77, "cpu")
    bk = mac.book(48, 30, 40)
    bk.ensure(torch.arange(40))
    assert bk.edges()[1].numel() > 0
    want = port_ref.td_vmm_signed_ref(
        x.to(torch.int32), w.to(torch.int32), bits_a=4, bits_w=4,
        n_chain=16, sigma=2.5, tdc_q=1.0, seed=77)
    assert torch.equal(mac.product(x, w, torch.arange(40), 40), want)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_reference_agrees_with_the_port_and_the_control_fails(moe):
    res, lines = harness.run_cell(smoke.cell(moe=moe), 2 ** 31 + 17, 4.0,
                                  False, torch.device("cpu"),
                                  time.monotonic(), control=True)
    info = res["info"]
    limits = smoke.LIMITS
    assert info["judged_tokens"] >= 4
    # the program's own readings are within every limit ...
    assert all(info["program_" + k] <= lim for k, lim in limits.items())
    # ... and the control (the reference at float8), judged in its place,
    # misses one: the harness's own comparison says not correct
    assert res["correct"] is False, lines
    assert any(res["checks"][k]["value"] > lim for k, lim in limits.items())
    assert lines[0].startswith("check ")


def test_the_program_alone_is_correct():
    res, lines = harness.run_cell(smoke.cell(), 2 ** 31 + 18, 4.0, False,
                                  torch.device("cpu"), time.monotonic())
    assert res["correct"] is True, lines
