"""The device trace of a traced run: `torch.profiler` over a steady
sub-window of the measured window, reduced to device busy time, kernel
time by family, the top device operations and the idle gaps labelled by
the host span that was open across them.

The trace is written as Chrome JSON to a fixed file inside the checkout,
read back and deleted.  The sub-window is ``PROFILE_LEN_S`` from the
profiler's start, which set-up has warmed up (`warm_up`).  The sub-window is the host span "bench.window";
every engine step in it ends in a host sync, so no device work of it
runs past the span's end.
"""
from __future__ import annotations

import json
import os
import re

# kernel families by name (the port's CUDA kernels, `csrc/*.cu`)
FAMILIES = {"td_vmm": ("td_vmm_block", "td_vmm_split"),
            "flash_attn": ("flash_wg", "flash_cc"),
            "decode_gqa": ("decode_split",)}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("sched.prefill", "sched.insert", "sched.decode",
              "bench.traffic")


def short_name(name: str) -> str:
    """A kernel's name without its namespace, argument list and return
    type."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name.split("(")[0])
    return name[:120]


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(path: str) -> dict:
    """Everything the per-layer readers take from the trace, in seconds:
    ``window_s``, ``busy_s``, ``family_s`` {family: device seconds},
    ``device_ops`` and ``idle_gaps`` (lists of [name, seconds])."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == "bench.window"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, spans = [], []
    by_name: dict[str, float] = {}
    fam = {k: 0.0 for k in FAMILIES}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            nm = short_name(e.get("name", "?"))
            by_name[nm] = by_name.get(nm, 0.0) + (b - a)
            for f_name, keys in FAMILIES.items():
                if any(k in nm for k in keys):
                    fam[f_name] += b - a
        elif cat == "user_annotation" and e.get("name") in HOST_SPANS:
            spans.append((a, b, e["name"]))
    busy = _union(dev)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = next((nm for s0, s1, nm in spans if s0 <= mid <= s1),
                     "host outside the engine's spans")
        idle[label] = idle.get(label, 0.0) + (b - a)
    us = 1e-6
    return {
        "window_s": (w1 - w0) * us,
        "busy_s": sum(b - a for a, b in busy) * us,
        "family_s": {k: v * us for k, v in fam.items()},
        "device_ops": [[k, v * us] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[f"idle in {k}", v * us] for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def warm_up() -> None:
    """Start and stop the profiler once on nothing, so that a later
    start records from its first step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1).add_(1)


class Profile:
    """The profiler over the sub-window: ``start()`` before a step,
    ``stop()`` after one; ``result()`` reduces the trace and removes the
    file."""

    def __init__(self, path: str):
        self.path = path
        self.prof = None
        self.span = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = torch.profiler.record_function("bench.window")
        self.span.__enter__()

    def stop(self) -> None:
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    @property
    def started(self) -> bool:
        return self.prof is not None

    def result(self) -> dict:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        try:
            return reduce_trace(self.path)
        finally:
            os.remove(self.path)
