"""The frozen work arithmetic against hand counts at the cells' shapes."""
import json
import os

import pytest

from tdbench import harness, work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _mc(name):
    return harness.model_dims(json.load(open(os.path.join(
        ROOT, "tdbench", "configs", name + ".json"))))


def test_qwen3_prefill_by_hand():
    mc = _mc("qwen3-8b")
    w = work.prefill_work(mc, 224)
    # q, k, v, o and the three MLP products: 4096 x 47104 MACs a token and
    # layer; lm_head for the one next-token row
    per_token = 4096 * (4096 + 1024 + 1024 + 4096 + 3 * 12288)
    assert per_token == 4096 * 47104
    assert w.td_ops == pytest.approx(
        2 * 4 * (224 * 36 * per_token + 4096 * 151936))
    # flash: 4 D flops a kept (query, key) pair a head, causal
    assert w.flash_flops == pytest.approx(36 * 4 * 128 * 32 * 224 * 225 / 2)
    assert w.flash_bytes == pytest.approx(
        36 * 2 * 128 * (2 * 224 * 32 + 2 * 224 * 8))
    # least bytes of one mlp.wi product: 4-bit codes in, bf16 out
    ops, nb, t = work.td_call(224, 4096, 12288, 4, 4)
    assert nb == 224 * 4096 / 2 + 4096 * 12288 / 2 + 224 * 12288 * 2
    assert t == max(ops / 1979e12, nb / 3.35e12)
    assert w.decode_flops == 0 and w.router_flops == 0


def test_qwen3_decode_by_hand():
    mc = _mc("qwen3-8b")
    w = work.decode_work(mc, [100, 200, 300])
    assert w.td_ops == pytest.approx(
        2 * 4 * 3 * (36 * 4096 * 47104 + 4096 * 151936))
    assert w.decode_flops == pytest.approx(36 * 4 * 128 * 32 * 600)
    assert w.decode_bytes == pytest.approx(
        36 * 2 * 128 * (2 * 3 * 32 + 2 * 600 * 8))
    assert w.flash_flops == 0
    assert w.peak_seconds() == pytest.approx(
        w.td_ops / 1979e12 + w.decode_flops / 989e12)


def test_dbrx_moe_by_hand():
    mc = _mc("dbrx-132b.8of40")
    w = work.prefill_work(mc, 100)
    attn = 6144 * (6144 + 1024 + 1024 + 6144)
    experts = 100 * 4 * 3 * 6144 * 10752          # tokens x top-4 routed
    assert w.td_ops == pytest.approx(
        2 * 4 * (8 * (100 * attn + experts) + 6144 * 100352))
    assert w.router_flops == pytest.approx(8 * 2 * 100 * 6144 * 16)
    # each expert's weights once a call: 16 stacks of 4-bit codes a product
    ops, nb, _ = work.td_call(400, 6144, 10752, 4, 4, lanes_weights=16)
    assert nb == 400 * 6144 / 2 + 16 * 6144 * 10752 / 2 + 400 * 10752 * 2


def test_shares_stay_under_the_peak():
    """At the cells' shapes a product's least time is no less than its
    operations at the peak: a share computed from it cannot pass 100% for
    a kernel that takes at least that long."""
    for name, m in (("qwen3-8b", 384), ("qwen3-8b", 16),
                    ("dbrx-132b.8of40", 32)):
        w = work.prefill_work(_mc(name), m)
        assert w.td_min_s >= w.td_ops / work.PEAK_INT8_OPS * (1 - 1e-12)
        assert w.td_min_s >= w.td_bytes / work.HBM_BYTES_PER_S * (1 - 1e-12)
