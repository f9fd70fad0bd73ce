"""GPU smoke run of the PyTorch port (`src/repro_torch`), for one H100.

    python3 chip_smoke.py

1. builds the four CUDA kernels of the serve and train paths from
   `src/repro_torch/csrc` (one nvcc per source, all at once) and prints
   ptxas's register and spill report;
2. prints the card's name and power limit (nvidia-smi);
3. runs the port's smoke model on the card and on the CPU (plain versions
   of the kernels): serving (tokens and logits) and two train steps
   (losses, gradient norms, parameters);
4. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (qwen3-8b at full width: serve batch 4, prompt 128;
   train microbatch 1 x 128 and every weight of the 4-layer model), and
   times kernel, plain version and, where one exists, the PyTorch library
   call computing the same function, with CUDA events after a warm-up;
5. serves full-width qwen3-8b in td mode (random seeded weights, bf16,
   36 layers, batch 4, prompt 128, 16 new tokens) through
   `repro_torch.launch.serve.run`, then trains full-width qwen3-8b cut to
   4 layers (the memory reason is in PERF.md §4) through
   `repro_torch.launch.train.run`: 3 steps in td mode, then 1 in quant
   mode, global batch 8 x 128 in 8 microbatches.  Every launch counter is
   set to 0 just before each run and read just after; each kernel of the
   path must have run exactly as often as the path calls it, the tokens
   must be in range and the losses finite;
6. profiles a shorter serve run and a td train step under torch.profiler
   and prints where the device time goes; a profiler failure fails the run.

Prints one JSON line describing every kernel, then, last, the result line
`{"ok": true, "device": {...}}`.  Exits non-zero, printing no result, on
any failure, with no CUDA device, or without the repository's `src/`.
"""
from __future__ import annotations

import dataclasses
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
TRAIN = dict(layers=4, seq=128, batch=8, td_steps=3, quant_steps=1)


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
    """A copy of a nested dict/list of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev, copy=True)


def phase_train_small():
    """Two train steps of the port's smoke model, td at the solved policy
    (noise on), f32 compute, 2 microbatches, remat full: the card (CUDA
    kernels, cuBLAS) against the CPU (plain versions), from the same
    parameters and batches.

    Tolerances: losses rtol 1e-4 and gradient norms rtol 1e-3 (f32 sums in
    another order can move an activation across an LSQ rounding boundary,
    which changes one code); parameters within 1e-6 + 1e-5 relative except
    at most 1% of entries, which may differ by AdamW's sign flip (at most
    2 lr a step, bounded here by 2.5 * sum(lr))."""
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.configs.base import ShapeCfg, TrainCfg
    from repro_torch.data.synthetic import DataCfg, SyntheticStream
    from repro_torch.launch import steps, td_cli
    from repro_torch.models import common, get_api
    from repro_torch.optim import adamw

    arch = td_cli.apply_td_args(cfgs.get_smoke("qwen3-8b"), "td").replace(
        train=TrainCfg(n_microbatches=2, compute_dtype="float32"))
    cfg = arch.model
    shape = ShapeCfg("t", 16, 4, "train")
    params = get_api(cfg)["init"](0, cfg, common.resolve_arch_policy(arch),
                                  device="cpu")
    stream = SyntheticStream(DataCfg(vocab=cfg.vocab, seq_len=16,
                                     global_batch=4, seed=0))
    res = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        opt = adamw.init_opt_state(p)
        step = steps.build_train_step(arch, shape)
        losses, gns, lrs = [], [], []
        for i in range(2):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in stream.batch(i).items()}
            p, opt, m = step(p, opt, batch, i)
            losses.append(float(m["loss"]))
            gns.append(float(m["grad_norm"]))
            lrs.append(float(m["lr"]))
        res[dev] = (losses, gns, lrs, [t.cpu() for _, t in
                                       adamw.tree_leaves_with_path(p)])
    (lc, gc, lrs, pc), (lg, gg, _, pg) = res["cpu"], res["cuda"]
    flip = 2.5 * sum(lrs)
    n_all = n_far = 0
    d_max = 0.0
    for a, b in zip(pc, pg):
        d = (a - b).abs()
        d_max = max(d_max, float(d.max()))
        n_far += int((d > 1e-6 + 1e-5 * a.abs()).sum())
        n_all += d.numel()
    print(f"[train_small] smoke model td solved policy f32, 2 steps, card "
          f"vs CPU: losses {lg} vs {lc}, grad norms {gg} vs {gc}, params "
          f"max |diff| {d_max:.3e} (flip bound {flip:.3e}), entries beyond "
          f"1e-6 + 1e-5 rel: {n_far} of {n_all}")
    ok = all(math.isfinite(x) for x in lg) and all(
        abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lg, lc)) and all(
        abs(a - b) <= 1e-3 * abs(b) for a, b in zip(gg, gc)) and \
        d_max <= flip + 1e-6 and n_far <= 0.01 * n_all
    if not ok:
        fail("smoke model training on the card disagrees with the CPU run")


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
        ("train mlp.wi", 128, 4096, 12288),      # one microbatch of 128
        ("train lm_head", 128, 4096, 151936),
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


def _bits_equal(a, b) -> bool:
    """Same bit patterns, every NaN counted equal to every NaN."""
    import torch
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    it = torch.int32 if a.dtype == torch.float32 else torch.int16
    return bool(torch.equal(torch.where(nan, 0, a.view(it)),
                            torch.where(nan, 0, b.view(it))))


def phase_lsq_quant(rows: list):
    """lsq_quant against its plain version at the train path's shapes:
    every weight of the 4-layer qwen3-8b model (lm_head included), the two
    activation widths of a microbatch, and a length that is not a multiple
    of the vector width (with NaN and infinities); f32 and bf16; step sizes
    with exact .5 ties, a random one and one below the 1e-8 floor.  Must
    be bit-exact (max_abs_err 0)."""
    import torch
    from repro_torch.kernels.lsq_quant import lsq_quant as lq
    from repro_torch.kernels.lsq_quant.ref import lsq_quant_ref

    d, f, v = 4096, 12288, 151936
    shapes = [("attn.wq/wo", (d, d)), ("attn.wk/wv", (d, 1024)),
              ("mlp.wi/wg", (d, f)), ("mlp.wo", (f, d)), ("lm_head", (d, v)),
              ("act d_model", (1, 128, d)), ("act d_ff", (1, 128, f)),
              ("odd length", (1_000_003,))]
    cases = [(0.25, -8, 7), (0.0371, 0, 255), (1e-9, -8, 7)]
    gen = torch.Generator(device="cuda").manual_seed(3)
    n_cases = 0
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape in shapes:
            for s_val, qn, qp in cases:
                x = torch.randn(shape, generator=gen, device="cuda") * 2.0
                ties = (torch.randint(-20, 20, shape, generator=gen,
                                      device="cuda") + 0.5) * 0.25
                x = torch.where(torch.rand(shape, generator=gen,
                                           device="cuda") < 1 / 3, ties, x)
                if label == "odd length":
                    x[:3] = torch.tensor([math.nan, math.inf, -math.inf])
                x = x.to(dtype)
                s = torch.tensor(s_val, device="cuda").to(dtype)
                got = lq.lsq_quant(x, s, qn, qp)
                want = lsq_quant_ref(x, s, qn, qp)
                torch.cuda.synchronize()
                n_cases += 1
                if not _bits_equal(got, want):
                    fin = torch.isfinite(want) & torch.isfinite(got)
                    err = float((got.float() - want.float())[fin].abs().max())
                    max_err = max(max_err, err if err > 0 else math.inf)
                    print(f"[lsq_quant] {label} {tuple(shape)} {dtype} "
                          f"s={s_val} [{qn}, {qp}]: differs, max |kernel - "
                          f"plain| {err:g}")
                del x, ties, got, want
    print(f"[lsq_quant] {n_cases} cases (8 shapes x 2 dtypes x 3 step "
          f"sizes): max |kernel - plain| {max_err:g} (tolerance 0, bit "
          f"patterns compared)")
    if max_err != 0.0:
        fail("lsq_quant is not bit-exact with its plain version")

    timed = {}
    for label, shape in (("lm_head", (d, v)), ("mlp.wi", (d, f))):
        x = (torch.randn(shape, generator=gen, device="cuda") * 0.1).to(
            torch.bfloat16)
        s = torch.tensor(0.0371, device="cuda").to(torch.bfloat16)
        ms = time_ms(lambda: lq.lsq_quant(x, s, -8, 7), reps=20)
        plain_ms = time_ms(lambda: lsq_quant_ref(x, s, -8, 7), reps=5)
        b_ms, b_by = bound_ms(2 * x.numel() * x.element_size(), 0, "bf16")
        timed[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, x=x, s=s)
        print(f"[lsq_quant] {label} {tuple(shape)} bf16: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    main = timed.pop("lm_head")
    x, s = main.pop("x"), main.pop("s")
    del timed
    # the library yardstick multiplies by 1/scale (not the same function);
    # timed in bf16 where the installed torch takes it, else in f32 over
    # the same element count
    lib_in, lib_dtype, s_f = x, "bf16", float(s)
    try:
        torch.fake_quantize_per_tensor_affine(lib_in, s_f, 0, -8, 7)
    except RuntimeError as e:
        print(f"[lsq_quant] fake_quantize_per_tensor_affine refuses bf16 "
              f"({str(e).splitlines()[0][:80]}); timed in f32")
        lib_in, lib_dtype = x.float(), "f32"
    lib_ms = time_ms(lambda: torch.fake_quantize_per_tensor_affine(
        lib_in, s_f, 0, -8, 7), reps=20)
    print(f"[lsq_quant] lm_head: torch.fake_quantize_per_tensor_affine "
          f"({lib_dtype}) {lib_ms:.4f} ms")
    rows.append(dict(name="lsq_quant", route="cuda",
                     source="src/repro_torch/csrc/lsq_quant.cu",
                     replaces="src/repro/kernels/lsq_quant/lsq_quant.py:14",
                     max_abs_err=max_err, library_ms=lib_ms,
                     shape=f"lm_head weight {d} x {v} bf16", **main))
    del x, s, lib_in


def kernel_modules() -> dict:
    from repro_torch.kernels.decode_gqa import decode_gqa as dg
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.lsq_quant import lsq_quant as lq
    from repro_torch.kernels.td_vmm import td_vmm as tv
    return {"td_vmm": tv, "flash_attn": fa, "decode_gqa": dg,
            "lsq_quant": lq}


def check_launches(path: str, counts: dict, expected: dict) -> None:
    print(f"[{path}] launches {counts}, expected {expected}")
    for n, c in counts.items():
        if c != expected[n]:
            fail(f"{n} launched {c} times on the {path} path, expected "
                 f"{expected[n]}")


def phase_serve(launches: dict):
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.launch import serve, td_cli

    arch = td_cli.apply_td_args(cfgs.get("qwen3-8b"), "td")
    cfg = arch.model
    mods = kernel_modules()
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
                "decode_gqa": cfg.n_layers * steps, "lsq_quant": 0}
    print(f"[serve] qwen3-8b td, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, batch {SERVE['batch']}, prompt "
          f"{SERVE['prompt_len']}, gen {SERVE['gen']}: wall {wall:.1f} s "
          f"(init included), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(f"[serve] prefill {stats['prefill_ms']:.1f} ms; decode median "
          f"{statistics.median(stats['decode_ms']):.1f} ms/token "
          f"(all: {[round(t, 1) for t in stats['decode_ms']]})")
    check_launches("serve", counts, expected)
    ids_cpu = ids.cpu()
    if ids_cpu.shape != (SERVE["batch"], SERVE["gen"]) or \
            int(ids_cpu.min()) < 0 or int(ids_cpu.max()) >= cfg.vocab:
        fail(f"bad tokens {ids_cpu.shape} in [{int(ids_cpu.min())}, "
             f"{int(ids_cpu.max())}]")
    print(f"[serve] tokens[0]: {ids_cpu[0].tolist()}")
    launches["serve"] = counts


def train_arch(mode: str):
    """qwen3-8b at its published widths and train settings, cut to
    TRAIN["layers"] layers, in ``--td mode``."""
    import repro_torch.configs as cfgs
    from repro_torch.launch import td_cli
    arch = cfgs.get("qwen3-8b")
    arch = arch.replace(model=dataclasses.replace(
        arch.model, n_layers=TRAIN["layers"]))
    return td_cli.apply_td_args(arch, mode)


def train_expected(cfg, n_micro: int, mode: str) -> dict:
    """Launches of one train step: per microbatch the forward runs every
    dense (7 a layer + lm_head) and, under remat, each layer's 7 denses and
    its attention again in the backward; a td dense's STE backward runs
    lsq_quant on x and w, a quant dense runs it in each forward."""
    dense, rerun = 7 * cfg.n_layers + 1, 7 * cfg.n_layers
    out = {"flash_attn": n_micro * 2 * cfg.n_layers, "decode_gqa": 0}
    if mode == "td":
        out.update(td_vmm=n_micro * (dense + rerun),
                   lsq_quant=n_micro * 2 * dense)
    else:
        out.update(td_vmm=0, lsq_quant=n_micro * 2 * (dense + rerun))
    return out


def phase_train(launches: dict):
    """The train main path: `launch.train.run` on full-width qwen3-8b cut
    to 4 layers, 3 steps in td mode, then 1 step in quant mode."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import train

    shape = ShapeCfg("cli", TRAIN["seq"], TRAIN["batch"], "train")
    mods = kernel_modules()
    for mode in ("td", "quant"):
        steps = TRAIN[f"{mode}_steps"]
        arch = train_arch(mode)
        cfg = arch.model
        n_micro = arch.microbatches_for(shape.name)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for m in mods.values():
            m.launches = 0
        stats: dict = {}
        t0 = time.monotonic()
        _, losses = train.run(arch, shape, steps, None, log_every=1, seed=0,
                              stats=stats)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = {n: m.launches for n, m in mods.items()}
        per_step = train_expected(cfg, n_micro, mode)
        step_ms = [round(t * 1e3, 1) for t in stats["step_s"]]
        steady = (f"{statistics.median(step_ms[1:]):.1f} ms" if steps > 1
                  else "not measured (one step)")
        print(f"[train] qwen3-8b {mode}, {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, batch "
              f"{shape.global_batch} x {shape.seq_len} in {n_micro} "
              f"microbatches, remat {arch.train.remat}, "
              f"{arch.train.compute_dtype} compute: wall {wall:.1f} s (init "
              f"included), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        print(f"[train] {mode}: step ms {step_ms}, median after the first "
              f"{steady}; losses {losses}; grad norms {stats['grad_norm']}")
        check_launches(f"train_{mode}", counts,
                       {n: c * steps for n, c in per_step.items()})
        if len(losses) != steps or not all(math.isfinite(x) for x in
                                           losses):
            fail(f"train {mode}: losses {losses}")
        launches[f"train_{mode}"] = counts


def _span_report(prof, span: str, which: slice, side: str = "host") -> None:
    """Device time of the kernels that start inside the ranges of ``span``
    (the ranges picked by ``which``), by kernel name.  A span also shows up
    as a device-side range of the same name: ``side="host"`` reads the
    host range, right for a span that ends at a device sync; "device" the
    device range, for a span whose kernels may run after its host range
    ends.  Fails when the trace holds no device time for the span."""
    import collections
    from torch.autograd import DeviceType
    events = prof.events()
    dt = DeviceType.CPU if side == "host" else DeviceType.CUDA
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == span and e.device_type == dt][which]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("serve.", "train."))]
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
        fail(f"profile {span}: no device time in the trace (wall {wall} "
             f"us, kernels {busy} us)")
    print(f"[profile] {span} x{len(ranges)}: wall {wall / 1e3:.1f} ms, "
          f"kernels {busy / 1e3:.1f} ms in {sum(count.values())} launches, "
          f"device idle {1 - busy / wall:.3f}")
    kinds = collections.Counter()
    for name, us in by_name.items():
        kind = next((k for k in ("td_vmm", "lsq_quant", "flash_attn",
                                 "decode_gqa") if f"{k}_kernel" in name), None)
        if kind is None:
            kind = ("matmul (cuBLAS)" if any(
                t in name for t in ("gemm", "cutlass", "xmma", "nvjet"))
                else "other (elementwise, copies, reductions)")
        kinds[kind] += us
    print(f"[profile] {span} by kind: " + ", ".join(
        f"{k} {us / 1e3:.2f} ms ({us / busy:.1%})"
        for k, us in kinds.most_common()))
    for name, us in by_name.most_common(10):
        print(f"[profile]   {us / 1e3:9.2f} ms {us / busy:6.1%} "
              f"x{count[name]:<5d} {name[:110]}")


def phase_profile():
    """Where the time goes: a shorter serve run (gen 4) and a 2-step td
    train run under torch.profiler, each kernel assigned by its device
    timestamp to the "serve.prefill" / "serve.decode" / "train.step" span
    that ran it, and the AdamW update to "train.optimizer" (the train
    reports read the second, steady step).  A
    profiler failure, or a trace without device time, fails the run."""
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import serve, td_cli, train
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    arch = td_cli.apply_td_args(cfgs.get("qwen3-8b"), "td")
    with profile(activities=acts) as prof:
        serve.run(arch, SERVE["batch"], SERVE["prompt_len"], 4, seed=0)
    for span in ("serve.prefill", "serve.decode"):
        _span_report(prof, span, slice(None))
    del prof
    torch.cuda.empty_cache()
    shape = ShapeCfg("cli", TRAIN["seq"], TRAIN["batch"], "train")
    with profile(activities=acts) as prof:
        train.run(train_arch("td"), shape, 2, None, seed=0)
    _span_report(prof, "train.step", slice(-1, None))
    _span_report(prof, "train.optimizer", slice(-1, None), side="device")


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
    phase_train_small()
    rows: list = []
    phase_td_vmm(rows)
    phase_flash(rows)
    phase_decode(rows)
    phase_lsq_quant(rows)
    launches: dict = {}
    for phase in (phase_serve, phase_train):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        phase(launches)
    torch.cuda.empty_cache()
    phase_profile()
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in launches.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["launches"] == 0:
            fail(f"{r['name']} never launched on a main path")
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err",
                    "library_ms"):
            if r[key] is not None and not math.isfinite(r[key]):
                fail(f"{r['name']}: {key} is {r[key]}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launches_by_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
