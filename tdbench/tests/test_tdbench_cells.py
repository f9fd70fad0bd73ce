"""Cells, configurations, traffic mixes and metrics are found by name,
BENCHMARK.json keeps to its contract, and a cell added as files alone is
picked up."""
import json
import os
import re
import shutil

import pytest

from tdbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden", "intermediate", "d_model", "ffn_hidden_size",
          "head_dim", "num_experts_per_tok", "moe_top_k")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.config["model_cfg"]["n_layers"] >= 1
    assert c.traffic["clients"] >= c.traffic["capacity"]
    assert c.spec["limits"]
    assert set(c.spec["limits"]) <= {"median_logit_gap", "mean_logit_gap",
                                     "widest_logit_gap", "off_best_share",
                                     "kv_mismatch"}
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert os.path.exists(os.path.join(ROOT, "tdbench", "metrics",
                                           m["name"] + ".py"))


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        for w in m["workloads"]:
            ms = e2e[m["moves"]]
            assert "workloads" not in ms or w in ms["workloads"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_files_state_their_cuts(cfg):
    ent = next(c for c in BENCH["configs"] if c["name"] == cfg)
    f = json.load(open(os.path.join(ROOT, ent["file"])))
    assert f["reduced"] == ent["reduced"]
    assert not any(w in k for k in ent["reduced"] for w in WIDTHS)
    for k in ent["reduced"]:
        assert k in f and k in f.get("published", {})
    mc = f["model_cfg"]
    # the port's sizes are the source's keys as run
    hf = {"qwen3": ("hidden_size", "num_attention_heads",
                    "num_key_value_heads", "intermediate_size",
                    "vocab_size", "num_hidden_layers"),
          "dbrx": ("d_model", "n_heads", None, None, "vocab_size",
                   "n_layers")}[f["model_type"]]
    port = ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "n_layers")
    for a, b in zip(hf, port):
        if a is not None:
            assert f[a] == mc[b], (a, b)


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "tdbench"), root / "tdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    root = _checkout(tmp_path)
    bench = json.loads(json.dumps(BENCH))
    (root / "tdbench" / "traffic" / "tiny.json").write_text(json.dumps(
        {**json.load(open(os.path.join(ROOT, "tdbench", "traffic",
                                       "long_prompt.json"))),
         "prompt_len": {"median": 24, "sigma": 0.5, "min": 16, "max": 32},
         "prompt_pad": 32}))
    (root / "tdbench" / "workloads" / "qwen3-8b.td.tiny.json").write_text(
        json.dumps({"check": {"slots": 3},
                    "limits": {"off_best_share": 0.5}}))
    (root / "tdbench" / "metrics" / "tiny_count.py").write_text(
        "def read(ctx):\n    return float(ctx['first_tokens'])\n")
    # a configuration whose file the benchmark already holds
    bench["configs"].append({"name": "qwen3-8b",
                             "source": "https://huggingface.co/Qwen/Qwen3-8B",
                             "file": "tdbench/configs/qwen3-8b.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "qwen3-8b.td.tiny",
                               "config": "qwen3-8b", "traffic": "tiny",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "tiny_count", "unit": "1",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "ttft_p90_ms",
                               "workloads": ["qwen3-8b.td.tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "ttft_p90_ms":
            m["workloads"].append("qwen3-8b.td.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.load_cell(str(root), "qwen3-8b.td.tiny")
    assert c.config["model_cfg"]["n_layers"] == 36
    assert c.traffic["prompt_pad"] == 32
    assert [m["name"] for m in c.per_layer] == ["tiny_count"]
    assert "ttft_p90_ms" in {m["name"] for m in c.end_to_end}
    assert harness.read_metric(str(root), "tiny_count",
                               {"first_tokens": 7}) == 7.0
    gen = harness.load_traffic(str(root), c.traffic, 1000, 5)
    assert all(16 <= len(p) <= 32 for _, p, _ in gen.start())


BURST = '''"""Open loop in steps: ``first`` requests at set-up, then ``each`` more
after every engine step, whatever has finished."""
import numpy as np


class Traffic:
    def __init__(self, mix, vocab, seed):
        self.mix, self.vocab, self.sent = mix, vocab, 0
        self.rng = np.random.default_rng(seed)
        self.max_context = mix["prompt"] + mix["output"]

    def _asks(self, n):
        out = []
        for _ in range(n):
            p = self.rng.integers(1, self.vocab, self.mix["prompt"])
            out.append((self.sent, p.astype(np.int32), self.mix["output"]))
            self.sent += 1
        return out

    def start(self):
        return self._asks(self.mix["first"])

    def after_step(self, now, finished):
        return self._asks(self.mix["each"])
'''


def test_a_traffic_generator_added_as_a_file_drives_a_cell(tmp_path):
    """A generator that no file of the harness names, added as one file
    beside the mixes, drives a smoke cell's engine from set-up to the
    check."""
    import time

    import torch

    from tdbench.tests import smoke
    root = _checkout(tmp_path)
    (root / "tdbench" / "traffic" / "burst.py").write_text(BURST)
    mix = {"generator": "burst", "capacity": 4, "prompt_pad": 12,
           "prompt": 10, "output": 5, "first": 2, "each": 1}
    res, lines = harness.run_cell(
        smoke.cell(traffic=mix, root=str(root)), 2 ** 31 + 3, 2.0, False,
        torch.device("cpu"), time.monotonic())
    assert res["correct"] is True, lines
    assert res["attempted"] >= 3
    assert res["metrics"]["prompt_tokens_per_s"]["value"] > 0
