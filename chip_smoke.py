"""GPU smoke run of the PyTorch port (`src/repro_torch`), for one H100.

    python3 chip_smoke.py

1. builds the three CUDA kernels of the serve path from `src/repro_torch/
   csrc` (one nvcc per source, all at once) and prints ptxas's register and
   spill report;
2. prints the card's name and power limit (nvidia-smi);
3. runs the port's smoke model on the card and on the CPU (plain versions
   of the kernels) and compares tokens and logits;
4. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (qwen3-8b at full width, batch 4, prompt 128), and
   times kernel, plain version and, where one exists, the PyTorch library
   call computing the same function, with CUDA events after a warm-up;
5. serves full-width qwen3-8b in td mode (random seeded weights, bf16,
   batch 4, prompt 128, 16 new tokens) through `repro_torch.launch.serve.
   run`, with every launch counter set to 0 just before, and checks that
   each kernel ran, as often as the path calls it, and that the tokens are
   in range.

Prints one JSON line describing every kernel, then, last, the result line
`{"ok": true, "device": {...}}`.  Exits non-zero, printing no result, on
any failure, with no CUDA device, or without the repository's `src/`.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}

SERVE = dict(batch=4, prompt_len=128, gen=16)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def import_port():
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch
    except ImportError as e:
        fail(f"cannot import repro_torch from {ROOT / 'src'}: {e}")
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT):
        fail(f"repro_torch comes from {repro_torch.__file__}, not {ROOT}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(bytes_moved: float, ops: float, op_type: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import build
    t0 = time.monotonic()
    reports = build.build()
    print(f"[build] {len(reports)} kernel libraries built in "
          f"{time.monotonic() - t0:.1f} s into {build.BUILD_DIR}")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_small_reference():
    """The port's smoke model, f32 compute, td at sigma = 0: the card (the
    CUDA kernels) against the CPU (their plain versions)."""
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.configs.base import ShapeCfg, TDExecCfg, TrainCfg
    from repro_torch.launch import serve, steps
    from repro_torch.models import common, get_api
    from repro_torch.tdsim.policy import TDPolicy

    arch = cfgs.get_smoke("qwen3-8b").replace(
        td=TDExecCfg(mode="td", n_chain=48),
        train=TrainCfg(compute_dtype="float32"))
    cfg = arch.model
    pol = TDPolicy(mode="td", n_chain=48)
    params = get_api(cfg)["init"](0, cfg, pol, device="cpu")
    toks = torch.from_numpy(serve.prompts(1, 2, 8, cfg.vocab))
    shape = ShapeCfg("serve", 14, 2, "decode")
    results = {}
    # the steps resolve their policy from the arch; sigma = 0 is built here
    solve = common.resolve_arch_policy
    common.resolve_arch_policy = lambda a: pol
    try:
        pre = steps.build_prefill_step(arch, shape)
        srv = steps.build_serve_step(arch, shape)
    finally:
        common.resolve_arch_policy = solve
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        with torch.inference_mode():
            logits, state = pre(p, {"tokens": toks.to(dev)})
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            out = [tok]
            for _ in range(5):
                tok, state = srv(p, tok, state)
                out.append(tok)
        results[dev] = (logits.float().cpu(), torch.cat(out, 1).cpu())
    err = float((results["cpu"][0] - results["cuda"][0]).abs().max())
    same = bool(torch.equal(results["cpu"][1], results["cuda"][1]))
    print(f"[small] smoke model td sigma=0 f32, card vs CPU: tokens equal "
          f"{same}, max |logit diff| {err:.3e} (tolerance 1e-3)")
    if not same or not err <= 1e-3:
        fail("smoke model on the card disagrees with the CPU run")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
def phase_td_vmm(rows: list):
    import torch
    from repro_torch.kernels.td_vmm import td_vmm as tv
    from repro_torch.tdsim.policy import solved_td_policy

    pol = solved_td_policy(4, 4, 576, None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    seed = torch.tensor([33350994], dtype=torch.int64, device="cuda")
    cases = [  # (label, M, K, N): prefill and decode shapes of qwen3-8b
        ("prefill mlp.wi", 512, 4096, 12288),
        ("prefill mlp.wo", 512, 12288, 4096),
        ("decode attn.wk", 4, 4096, 1024),
        ("decode mlp.wi", 4, 4096, 12288),
        ("decode lm_head", 4, 4096, 151936),
    ]
    main = None
    max_err = 0.0                   # over every case, shape and policy
    for label, m, k, n in cases:
        x = torch.randint(-8, 8, (m, k), generator=gen, device="cuda",
                          dtype=torch.int32)
        w = torch.randint(-8, 8, (k, n), generator=gen, device="cuda",
                          dtype=torch.int32)
        kw = dict(bits_a=4, bits_w=4, n_chain=576)
        for sigma, q in ((0.0, 1.0), (0.0, 3.0), (pol.sigma_chain,
                                                 float(pol.tdc_q))):
            par = torch.tensor([sigma, q], dtype=torch.float32, device="cuda")
            got = tv.td_vmm(x, w, par, seed, **kw)
            want = tv.td_vmm_plain(x, w, par, seed, **kw)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = float(diff.max())
            max_err = max(max_err, err)
            frac = float((diff != 0).float().mean())
            print(f"[td_vmm] {label} M={m} K={k} N={n} sigma={sigma:.4f} "
                  f"q={q:g}: max |kernel - plain| {err:g}, differing "
                  f"{frac:.2e}")
            if sigma == 0.0 and err != 0.0:
                fail(f"td_vmm not bit-exact at sigma=0 ({label}, q={q})")
            # with noise: a z within ulps of a rounding boundary may flip one
            # plane's TDC step (q * 2^b); allow 1e-4 of the entries
            if sigma != 0.0 and (frac > 1e-4 or bool(
                    torch.any(torch.remainder(got - want, q) != 0))):
                fail(f"td_vmm noisy outputs disagree ({label})")
            del want
        par = torch.tensor([pol.sigma_chain, float(pol.tdc_q)],
                           dtype=torch.float32, device="cuda")
        ms = time_ms(lambda: tv.td_vmm(x, w, par, seed, **kw), reps=5)
        plain_ms = time_ms(lambda: tv.td_vmm_plain(x, w, par, seed, **kw),
                           reps=2, warmup=1)
        k_pad = -(-k // 576) * 576
        b_ms, b_by = bound_ms(4 * (m * k + k * n + m * n),
                              2 * m * k_pad * n * 4, "int8")
        print(f"[td_vmm] {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by})")
        if main is None:
            main = dict(shape=f"{label} M={m} K={k} N={n}", ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        del x, w
    rows.append(dict(name="td_vmm", route="cuda",
                     source="src/repro_torch/csrc/td_vmm.cu",
                     replaces="src/repro/kernels/td_vmm/td_vmm.py:110",
                     max_abs_err=max_err, library_ms=None, **main))


def _sdpa(q, k, v, causal):
    """The library call beside the attention kernels (timed, never used by
    the port): SDPA on (B, H, S, D) tensors with grouped KV heads."""
    import torch
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)


def phase_flash(rows: list):
    import torch
    from repro_torch.kernels.flash_attn import flash_attn as fa
    b, sq, s_cache, hq, hkv, d = 4, SERVE["prompt_len"], \
        SERVE["prompt_len"] + SERVE["gen"], 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((b, sq, hq, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((b, s_cache, hkv, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn((b, s_cache, hkv, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kv_len = torch.full((b,), sq, dtype=torch.int32, device="cuda")
    off = torch.zeros((1,), dtype=torch.int32, device="cuda")
    errs = []
    for case_len, case_off, causal in ((kv_len, off, True),
                                       (torch.tensor([sq, 0, 77, s_cache],
                                                     dtype=torch.int32,
                                                     device="cuda"),
                                        torch.tensor([5], dtype=torch.int32,
                                                     device="cuda"), True),
                                       (kv_len, off, False)):
        got = fa.flash_attn(q, k, v, case_len, case_off, causal=causal)
        want = fa.flash_attn_plain(q, k, v, case_len, case_off,
                                   causal=causal)
        errs.append(float((got.float() - want.float()).abs().max()))
    print(f"[flash_attn] max |kernel - plain| per case {errs} "
          f"(tolerance 2e-2, bf16)")
    if not max(errs) <= 2e-2:
        fail("flash_attn disagrees with its plain version")
    ms = time_ms(lambda: fa.flash_attn(q, k, v, kv_len, off), reps=20)
    plain_ms = time_ms(lambda: fa.flash_attn_plain(q, k, v, kv_len, off),
                       reps=5)
    qt = q.transpose(1, 2).contiguous()
    kt = k[:, :sq].transpose(1, 2).contiguous()
    vt = v[:, :sq].transpose(1, 2).contiguous()
    lib_out = _sdpa(qt, kt, vt, True).transpose(1, 2)
    lib_err = float((lib_out.float() - fa.flash_attn(
        q, k, v, kv_len, off).float()).abs().max())
    lib_ms = time_ms(lambda: _sdpa(qt, kt, vt, True), reps=20)
    pairs = b * hq * sq * (sq + 1) // 2          # causal live (query, key)
    b_ms, b_by = bound_ms(2 * (2 * b * sq * hq * d + 2 * b * sq * hkv * d),
                          4 * pairs * d, "bf16")
    print(f"[flash_attn] B={b} Sq={sq} cache={s_cache} Hq={hq} Hkv={hkv} "
          f"D={d}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms (|kernel - sdpa| {lib_err:.3e}), bound "
          f"{b_ms:.5f} ms ({b_by})")
    rows.append(dict(name="flash_attn", route="cuda",
                     source="src/repro_torch/csrc/flash_attn.cu",
                     replaces="src/repro/kernels/flash_attn/flash_attn.py:55",
                     max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     shape=f"prefill B={b} Sq={sq} S_cache={s_cache} "
                     f"Hq={hq} Hkv={hkv} D={d} causal"))


def phase_decode(rows: list):
    import torch
    from repro_torch.kernels.decode_gqa import decode_gqa as dg
    b, s_cache, hq, hkv, d = 4, SERVE["prompt_len"] + SERVE["gen"], 32, 8, \
        128
    length = SERVE["prompt_len"] + SERVE["gen"] // 2
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn((b, hq, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((b, s_cache, hkv, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn((b, s_cache, hkv, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    lens = torch.full((b,), length, dtype=torch.int32, device="cuda")
    errs = []
    for case in (lens, torch.tensor([0, 1, length, s_cache + 9],
                                    dtype=torch.int32, device="cuda")):
        got = dg.decode_gqa(q, k, v, case)
        want = dg.decode_gqa_plain(q, k, v, case)
        errs.append(float((got.float() - want.float()).abs().max()))
    print(f"[decode_gqa] max |kernel - plain| per case {errs} "
          f"(tolerance 2e-2, bf16)")
    if not max(errs) <= 2e-2:
        fail("decode_gqa disagrees with its plain version")
    ms = time_ms(lambda: dg.decode_gqa(q, k, v, lens), reps=50)
    plain_ms = time_ms(lambda: dg.decode_gqa_plain(q, k, v, lens), reps=20)
    qt = q[:, :, None].contiguous()
    kt = k[:, :length].transpose(1, 2).contiguous()
    vt = v[:, :length].transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: _sdpa(qt, kt, vt, False), reps=50)
    b_ms, b_by = bound_ms(2 * (2 * b * hq * d + 2 * b * length * hkv * d),
                          4 * b * hq * length * d, "bf16")
    print(f"[decode_gqa] B={b} S={s_cache} length={length} Hq={hq} "
          f"Hkv={hkv} D={d}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    rows.append(dict(name="decode_gqa", route="cuda",
                     source="src/repro_torch/csrc/decode_gqa.cu",
                     replaces="src/repro/kernels/decode_gqa/decode_gqa.py:45",
                     max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     shape=f"decode B={b} S={s_cache} length={length} "
                     f"Hq={hq} Hkv={hkv} D={d}"))


def phase_serve(rows: list):
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.configs.base import TDExecCfg
    from repro_torch.kernels.decode_gqa import decode_gqa as dg
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.td_vmm import td_vmm as tv
    from repro_torch.launch import serve

    arch = cfgs.get("qwen3-8b")
    arch = arch.replace(td=TDExecCfg(mode="td", n_chain=min(
        576, arch.model.d_model)))
    cfg = arch.model
    mods = {"td_vmm": tv, "flash_attn": fa, "decode_gqa": dg}
    for m in mods.values():
        m.launches = 0
    stats: dict = {}
    t0 = time.monotonic()
    ids = serve.run(arch, SERVE["batch"], SERVE["prompt_len"], SERVE["gen"],
                    seed=0, stats=stats)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = {n: m.launches for n, m in mods.items()}
    steps = SERVE["gen"] - 1                 # decode steps after prefill
    expected = {"td_vmm": (7 * cfg.n_layers + 1) * (1 + steps),
                "flash_attn": cfg.n_layers,
                "decode_gqa": cfg.n_layers * steps}
    print(f"[serve] qwen3-8b td, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, batch {SERVE['batch']}, prompt "
          f"{SERVE['prompt_len']}, gen {SERVE['gen']}: wall {wall:.1f} s "
          f"(init included), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(f"[serve] prefill {stats['prefill_ms']:.1f} ms; decode median "
          f"{statistics.median(stats['decode_ms']):.1f} ms/token "
          f"(all: {[round(t, 1) for t in stats['decode_ms']]})")
    print(f"[serve] launches {counts}, expected {expected}")
    for n, c in counts.items():
        if c == 0 or c != expected[n]:
            fail(f"{n} launched {c} times on the main path, expected "
                 f"{expected[n]}")
    ids_cpu = ids.cpu()
    if ids_cpu.shape != (SERVE["batch"], SERVE["gen"]) or \
            int(ids_cpu.min()) < 0 or int(ids_cpu.max()) >= cfg.vocab:
        fail(f"bad tokens {ids_cpu.shape} in [{int(ids_cpu.min())}, "
             f"{int(ids_cpu.max())}]")
    print(f"[serve] tokens[0]: {ids_cpu[0].tolist()}")
    for r in rows:
        r["launches"] = counts[r["name"]]
    return stats


def phase_profile():
    """Where the time goes: one more (shorter) serve run under
    torch.profiler, each kernel assigned by its device timestamps to the
    "serve.prefill" / "serve.decode" span that ran it.  Diagnostic only:
    if the profiler cannot trace the card here, this says so and the run
    goes on."""
    import collections
    import traceback
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.configs.base import TDExecCfg
    from repro_torch.launch import serve
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    arch = cfgs.get("qwen3-8b")
    arch = arch.replace(td=TDExecCfg(mode="td", n_chain=576))
    gen = 4
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve.run(arch, SERVE["batch"], SERVE["prompt_len"], gen,
                      seed=0)
        events = prof.events()
        names = ("serve.prefill", "serve.decode")
        # a span also shows up as a device-side range of the same name:
        # take spans from the host side and kernels from the device side
        spans = [(e.name, e.time_range.start, e.time_range.end)
                 for e in events
                 if e.name in names and e.device_type == DeviceType.CPU]
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and e.name not in names]
        for span in ("serve.prefill", "serve.decode"):
            ranges = [(a, b) for n, a, b in spans if n == span]
            wall = sum(b - a for a, b in ranges)
            by_name = collections.Counter()
            count = collections.Counter()
            for k in kernels:
                t = k.time_range.start
                if any(a <= t <= b for a, b in ranges):
                    by_name[k.name] += k.time_range.end - k.time_range.start
                    count[k.name] += 1
            busy = sum(by_name.values())
            if not wall or not busy:
                print(f"[profile] {span}: device time not measured "
                      f"(wall {wall} us, kernels {busy} us)")
                continue
            print(f"[profile] {span} x{len(ranges)}: wall {wall / 1e3:.1f} "
                  f"ms, kernels {busy / 1e3:.1f} ms, device idle "
                  f"{1 - busy / wall:.3f}")
            for name, us in by_name.most_common(8):
                print(f"[profile]   {us / 1e3:9.2f} ms {us / busy:6.1%} "
                      f"x{count[name]:<5d} {name[:110]}")
    except Exception:          # diagnostic phase: report, do not fail
        traceback.print_exc()
        print("[profile] not measured: the profiler failed (traceback on "
              "stderr)")


def main() -> None:
    import_port()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}")
    phase_build()
    print(gpu_line())
    phase_small_reference()
    rows: list = []
    phase_td_vmm(rows)
    phase_flash(rows)
    phase_decode(rows)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phase_serve(rows)
    torch.cuda.empty_cache()
    phase_profile()
    for r in rows:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err",
                    "library_ms"):
            if r[key] is not None and not math.isfinite(r[key]):
                fail(f"{r['name']}: {key} is {r[key]}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
