"""GPU smoke run of the PyTorch port (`src/repro_torch`), for one H100.

    python3 chip_smoke.py

1. builds the four CUDA kernels of the serve, train and noise-loop paths from
   `src/repro_torch/csrc` (one nvcc per source, all at once) and prints
   ptxas's register and spill report;
2. prints the card's name and power limit (nvidia-smi) and the floor of
   the device-time yardstick (an event pair around an empty kernel);
   then runs the design-space engine on the card: the golden fixture
   (`tests/fixtures/design_space_golden.json`) through `sweep_batched`
   and `design_space.evaluate`, and the dense scenario (414,720 points)
   at tt, ff and ss on the card and on this host's CPU, integer decisions
   and winners equal (a float32 tie printed and counted), floats within
   rtol 1e-4, the sweep timed and its launches profiled, the explorer's
   memo hits timed; the explorer's refinement, disk store and corner
   fan-out (`phase_explorer`: `benchmarks/bench_explorer.py`'s parity
   case, refine bit-identical to the dense oracle on the card and equal
   to the CPU's; its resolution case, >= 1e7 effective points from <=
   2e5 evaluated; a disk round trip across two services under build/;
   the fan-out against the serial loop, bit-identical, both walls); and
   `solve_td_policy` on the card at the eight rows of `POLICY_ROWS` (the
   reference's solutions);
3. runs the port's smoke model on the card and on the CPU (plain versions
   of the kernels): serving (tokens and logits), the continuous-batching
   engine on ragged requests at capacities 3 and 9 (tokens, steps and
   completion order) and two train steps (losses, gradient norms,
   parameters);
4. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (qwen3-8b at full width: serve batch 4, prompt 128;
   the engine's admissions over its prompt bucket and its decode steps at
   its capacity, with ragged per-row lengths; train microbatch 1 x 128
   and every weight of the 4-layer model; lsq_quant also at the noise
   loops' f32 shapes, ResNet20's and granite-8b's), at
   the attention kernels' edge cases (query tiles, split chunks, masked
   rows) and at one long shape each (flash_attn at train_4k's microbatch,
   Sq 4096; decode_gqa at decode_32k's length, S 32768), holding the
   attention kernels also to a bf16 ulp of each output and to a share of
   differing outputs (see `_cmp`); times kernel, plain version and, where
   one exists, the PyTorch library call computing the same function, in
   turns, as device time (see `device_ms`), decode_gqa with a cold L2;
   prints host us per call and, for attention, the kernels' own CUPTI
   time;
5. serves full-width qwen3-8b in td mode (random seeded weights, bf16,
   36 layers, batch 4, prompt 128, 16 new tokens) through
   `repro_torch.launch.serve.run`; serves it again through the
   continuous-batching engine (`launch.scheduler`) on two traffics: 16
   ragged requests of 64-128 prompt and 8-16 new tokens into 8 slots of
   192 tokens, and the reference's serving gate (`bench_serving`: 256
   streams of 8-16 prompt and 16-32 new tokens into 16 slots of 64
   tokens; qwen3-8b cut to 4 layers, its lockstep baseline too), each
   also in lockstep (``continuous=False``) for its step
   count and tokens/s; serves the first traffic once more with per-layer
   budgets (exact, 1.0, 2.0 cycled over the layers) at the vdd-opt
   scenario's ss corner; each path prints J/token in the three domains
   (the paper's circuit model) and, on the engine, holds the meter's
   per-request rows to its total and the total to rate x tokens (1e-9);
   then trains full-width qwen3-8b cut to 4 layers (the memory
   reason is in PERF.md §4) through `repro_torch.launch.train.run`: 3
   steps in td mode, then 1 in quant mode, global batch 8 x 128 in 8
   microbatches.  Every launch counter is set to 0 just before each run
   and read just after; each kernel of the path must have run exactly as
   often as the path calls it, the tokens must be in range, every
   request finished, slot recycling must save decode steps on the
   serving gate's traffic, and the losses must be finite;
   then the MoE decoder (`phase_moe`): granite-moe-1b-a400m at its
   published widths and depth (24 layers, 32 experts top-8, each
   projection of the experts one td_vmm launch over 32 lanes, w a lane),
   td, served in the fixed batch above (host syncs a step counted), two
   identical prefills bit-equal, the continuous-batching engine on the
   first traffic (J/token, the meter's rows equal to its total), trained
   on the batch above at the config's 2 microbatches and remat "dots" (3
   td steps, 1 quant), then 2 td steps each at remat none and full (the
   same losses and gradient norms; peak memory and step ms of the
   three), one step's gradients summed in bf16 against the f32 sum cast
   to bf16 (one bf16 ulp a leaf), the smoke MoE on the card against the
   CPU (serve tokens, train losses), and the kernels at this path's
   shapes: td_vmm's 32-lane expert calls at M 160, 60 and 8 bit for bit
   against the plain version and 32 single launches, flash_attn at D 64
   in bf16 (the tensor cores) and decode_gqa at D 64, g 2, timed
   against SDPA; then `phase_dense_configs`: qwen2.5-3b and qwen3-4b at
   their published widths and depths (36 layers each) served in a fixed
   batch of 4 x 128 prompts and 8 new tokens, decode_gqa at g 8, D 128
   (timed against SDPA) and td_vmm at their ragged contractions (K 2560,
   9728, 11008) against the plain versions; then `phase_encdec`:
   seamless-m4t-large-v2 at its published widths and depth (24 encoder
   + 24 decoder layers, 2.04B parameters), td, served in the fixed batch
   above with 64 frames of stub audio embeddings, then over a long
   memory of 4 x 2048 frames (prompt 128, 8 decode steps:
   cross-attention at Skv 2048, Sq 1) through the prefill and serve
   steps, trained at its 4 microbatches and remat full (3 td steps, 1
   quant; 16 frames a row), the smoke model on the card against the CPU,
   and the kernels at its shapes (td_vmm at lm_head's N 256256 and over
   B x frames rows; flash_attn at D 64, g 1: the encoder, the decoder,
   the cross-attention at Sq 128 and 1, the training's f32 encoder and
   bf16-against-f32 cross-attention; decode_gqa at D 64, g 1; lsq_quant
   on the 1024 x 256256 lm_head weight), host syncs a step counted in
   every serve and train step; then `phase_frontend`: internvl2-26b's
   backbone at its published widths and depth (48 layers, 19.9B
   parameters, bf16), td, served with 64 patches of stub vision
   embeddings (8 new tokens), one prefill of 4 x (1024 patches + 128
   tokens), trained cut to 2 layers (1 td step, 1 quant step, its 16
   microbatches over a batch of 16 x 128), the smoke model and qwen3-8b's
   smoke model with tied embeddings on the card against the CPU, and the
   kernels at its shapes (td_vmm at the adapter, K 3200, and lm_head, N
   92672; flash_attn and decode_gqa at D 128, g 6); then `phase_zamba2`
   and `phase_rwkv6`: zamba2-1.2b (38 layers: 32 mamba2 mixers, the
   shared attention block at 6 sites, run at the top-level policy) and
   rwkv6-1.6b (24 layers of time and channel mix) at their published
   widths and depths, td, served in the fixed batch above, then through
   the prefill and serve steps at B 1 x 128 and B 1 x 4096 prompt tokens
   (4 decode steps each: decode ms against context), their scans
   (`ssd_chunked`, `wkv6_scan`) timed alone at the prefill shapes
   (kernels a call, device time, event pair, host enqueue) beside the
   kernels of one prefill and one decode step, trained at the configs' 4
   microbatches and remat full (2 td steps, 1 quant; zamba2 not cut,
   rwkv6 cut to 8 of 24 layers: `SSM_TRAIN_LAYERS`), the smoke
   models on the card against the CPU, and the kernels at their shapes
   (td_vmm at mamba2's in_proj, N 8384, and both lm_heads, N 32000 and
   65536, bit for bit with noise; flash_attn and decode_gqa at D 64, g
   1, zamba2 only, timed against SDPA; lsq_quant on the new weights);
   flash_attn and decode_gqa must show no launch on rwkv6's paths; then
   `phase_dbrx`: dbrx-132b at its published widths (6144, 48/8 heads of
   128, 16 experts top-4 of 10752, vocab 100352) cut to 2 of 40 layers,
   bf16, td, served (4 x 128, 16 new tokens; 0 host syncs a step), its
   smoke model on the card against the CPU, td_vmm's 16 expert lanes at
   the prefill's and decode's capacities bit for bit with noise,
   flash_attn (wgmma, g 6) and decode_gqa at its shapes against SDPA;
   then runs the paper's noise loop on full-width ResNet20-CIFAR
   (`phase_noise_loop`, 22 sites, n_chain 576): 150 quant-mode SGD steps
   on 512 synthetic images, the per-site batched sigma_max search (286
   probes in 22 chunks of 13, every probe's conv a lane of one td_vmm
   launch a site a chunk: 484 launches) on 512 eval images, the site-0
   scalar search within one grid step of it and slower than it x 22 (the
   reference bench's two gates), the network-level sweep and the per-site
   policy solve on the card; then holds td_vmm's lane axis to its plain
   version and to single-lane launches bit for bit (noise included) and
   times it at the stage-0 conv2 at 13 lanes, and checks
   `simulate_chain_errors` (1e6 x 576 cells) against `chain_stats`;
   then runs TD attention (`phase_td_attention`): full-width qwen3-8b
   served as above with ``--td-attn td`` and again with ``quant`` (36
   layers; QK^T and PV are two td_vmm lane launches a layer a step over
   B x Hq = 128 lanes, one w a lane, and flash_attn and decode_gqa must
   not run) and trained as above with ``--td-attn td``; holds those lane
   calls at the paths' own shapes (prefill, decode, training) to the plain
   version and to single-lane launches bit for bit at the solved and at a
   heterogeneous per-head policy and times the prefill and decode ones;
   the STE gradient against the clean-attention gradient bit for bit; the
   reference bench's sigma check and a clean head beside a noisy one at
   full head widths; and the smoke model's td-attention serve on the card
   against the CPU; then the LM per-layer noise sweep
   (`phase_lm_noise_sweep`) on full-width granite-8b cut to 4 layers, f32:
   60 quant-mode SGD steps, the per-layer batched search
   (`transformer.forward_lanes`, 52 probes in 4 chunks of 13, 7 td_vmm
   lane launches a layer a chunk), lanes equal to single forwards, a
   noisy lane's logits apart from the clean lane's, and the layer-0
   scalar search equal to the batched one, the network sweep, the
   per-layer policy solve and its file read back by ``--td-per-layer``;
   then holds the sweep's kernels to their plain versions at its shapes
   (td_vmm's 13 lanes of M 256 over a shared w at every dense's K and N,
   bit for bit; flash_attn's f32 path at batch 8, 24 and 104); then the
   same recipe on the other families (`phase_lm_sweep_families`:
   granite-moe-1b-a400m cut to 4 layers, zamba2-1.2b to layers 0-5,
   rwkv6-1.6b to 4; lanes = single forwards, the search's td_vmm lane
   launches counted, the layer-0 scalar search, the policy file), the
   MoE's P x E expert lanes (13 probes x 32 experts in one call) against
   13 calls of 32 lanes and the plain version, bit for bit and timed,
   each model's td_vmm lanes at its denses and flash_attn f32 at its
   attention sites against their plain versions, and lsq_quant at the
   QAT's f32 weights and activations;
   then fault tolerance and drift adaptation, at the smoke traffic of the
   reference's benches on full-width models: `phase_drift_traces`
   (`benchmarks/bench_drift_traces.py`: qwen3-8b cut to 4 layers
   (`FT_LAYERS`, as in `phase_chaos_serve`), td at
   sigma_max 2.0, 8 streams into capacity 2, the diurnal and bursty
   traces, each through the adaptive engine and its `scripted_swaps`
   replay, beside the plain engine on the same requests: zero lost, an
   adaptation and a supply-moving staged install per trace, the replay's
   tokens equal, one decode step built, no new td_vmm operand, no more
   host syncs a decode step than the plain engine; then td_vmm with
   ``params`` a row view of an (L, 2) operand tensor at the engines'
   shapes, bit for bit against its plain version and the memoized
   operand, before and after an in-place swap), `phase_chaos_serve`
   (`bench_chaos.run_parity` and `run_drift`: 24 streams in quant mode
   through a stall, a preemption and an explorer outage with the
   fault-free tokens; 6 streams in td mode through a drift excursion
   that adapts, re-prices and saves energy) and `phase_chaos_train`
   (`bench_chaos.run_train_half`: granite-8b at its widths cut to 1
   layer, 12 quant steps, a 7.4 GB checkpoint every 4 into
   build/chaos_ckpt/, a bitflip of the newest and a preemption; the
   resume at step 4 with the fault-free losses, digests of a restored
   tree equal the saved ones; save and restore seconds and the free
   disk printed);
   then the multi-device layer: `phase_mesh` (an NCCL group of one rank
   and a (1, 1) `DeviceMesh`: the LM sweep's per-layer search with
   ``mesh=`` bit for bit the unsharded one, noise included, its td_vmm
   lane launches counted; qwen3-8b at its widths cut to 4 layers, td,
   served plain and on the mesh through `serve.run` with its parameters
   placed by `param_specs(serving=True)`, tokens and logits bit for bit,
   launches, prefill and decode ms and host syncs a step; a checkpoint
   restored onto the mesh's placements bit for bit); then the stacked
   scan-over-layers layout (`phase_scan_layers`: qwen3-8b at its widths
   and 36 layers initialised stacked and unrolled, bit for bit, a keyed
   td forward whose logits differ between the layouts at the solved
   policy (the scan's seeds) and agree at sigma 0; served in both layouts
   in quant mode, td at sigma 0 with tdc_q 1 and td at the solved policy,
   tokens and logits bit for bit (the serve steps pass no key), launches,
   prefill and decode ms and 0 host syncs a step each; trained cut to 4
   layers, 8 x 128, 2 steps, quant and td at sigma 0, remat full and
   dots, losses and gradient norms bit for bit, step ms and peak GiB of
   each layout; granite-moe-1b-a400m at 24 layers and rwkv6-1.6b cut to
   4 served in quant mode in both layouts, bit for bit; decode_gqa,
   flash_attn and lsq_quant on layer views of stacked tensors, no copy),
   the four port-side examples in-process (`phase_examples`) and
   `phase_dryrun` (`python -m repro_torch.launch.dryrun` of dbrx-132b
   train_4k at 40 layers, of zamba2-1.2b and rwkv6-1.6b at long_500k
   and of rwkv6-1.6b at long_500k with ``--scan-layers`` on the (32, 8)
   production mesh, four processes at once on the host's CPU, the card
   hidden from them: each cell's modelled roofline, memory and wall; the
   scan cell's FLOPs and collectives equal to the unscanned cell's);
6. profiles a shorter serve run (plain, then with ``--td-attn td``, and
   counts each one's host syncs a step in an untraced rerun), a
   short scheduler run (4 requests, capacity 4) and a td train step under
   torch.profiler and prints where the device time goes, attention's
   device time per launch included; a profiler failure fails the run.

Prints one JSON line describing every kernel, then, last, the result line
`{"ok": true, "device": {...}}`.  Exits non-zero, printing no result, on
any failure, with no CUDA device, or without the repository's `src/`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

SERVE = dict(batch=4, prompt_len=128, gen=16)
# device kernel names of each port kernel, for the profile
KERNEL_NAMES = {"td_vmm": ("td_vmm_block", "td_vmm_split"),
                "lsq_quant": ("lsq_quant_kernel",),
                "flash_attn": ("flash_wg", "flash_attn_kernel"),
                "decode_gqa": ("decode_split",)}
TRAIN = dict(layers=4, seq=128, batch=8, td_steps=3, quant_steps=1)
# the continuous-batching engine, two traffics.  "scheduler": 16 ragged
# requests (prompts 64-128, 8-16 new tokens) into 8 slots of 144 tokens,
# rounded to 192 by the KV plan; prompts as long as the fixed-batch serve's.
# "scheduler_bench": the reference's serving gate
# (benchmarks/bench_serving.py:44, its request seed 7), 256 ragged streams
# (prompts 8-16, 16-32 new tokens) into 16 slots of 48 tokens, rounded to
# 64, on qwen3-8b cut to 4 of its 36 layers (the engine and its lockstep
# baseline alike: the gate compares their steps and tokens/s, and 36
# host-bound layers took the room of the zamba2 and rwkv6 phases).
SCHED = dict(capacity=8, s_cache=144, kv_block=64, requests=16,
             prompt_len=128, gen=16, seed=1)
BENCH_SCHED = dict(capacity=16, s_cache=48, kv_block=64, requests=256,
                   prompt_len=16, gen=32, seed=7, layers=4)
SCHED_PATHS = {"scheduler": SCHED, "scheduler_bench": BENCH_SCHED}
# the fault-tolerance phases' engines, full-width qwen3-8b.  "drift_traces":
# benchmarks/bench_drift_traces.py at its smoke traffic (8 streams, capacity
# 2, prompt 6, gen 24, request seed 7, drift threshold 0.15, traces of 64
# steps); "chaos_serve": benchmarks/bench_chaos.py's serve half at its
# smoke traffic (parity: 24 streams, capacity 4, prompt 8, gen 24, quant;
# drift: 6 streams, td, a drift factor 0.5 at step 2).  Slots of 30 and 32
# tokens round to 64.
DRIFT = dict(capacity=2, s_cache=30, kv_block=64, requests=8, prompt_len=6,
             gen=24, seed=7, threshold=0.15, trace_steps=64)
CHAOS = dict(capacity=4, s_cache=32, kv_block=64, requests=24, prompt_len=8,
             gen=24, seed=7, drift_requests=6)
# chaos_serve's recovery at a long context, quant: slots of 32768 tokens
# (4.83 GB of KV each), 11 of them (one below what plan_kv_cache admits
# next to the 16.4 GB of parameters on an 80 GB card: 53 GB of KV), prompt
# buckets of 1024, one request a slot (prompts of 500-1000 tokens, 16-32
# new tokens), a preemption at step 12
LONG = dict(capacity=11, s_cache=32768, prompt_pad=1024, kv_block=64,
            requests=11, prompt_len=1000, gen=32, seed=7, preempt_at=12)
# every engine whose admission (flash_attn B 1 over the bucket) and decode
# (decode_gqa B = capacity over the slot) shapes the kernel phases check
ENGINE_PATHS = {**SCHED_PATHS, "drift_traces": DRIFT, "chaos_serve": CHAOS,
                "chaos_serve long": LONG}
SMALL_SCHED = dict(capacities=(3, 9), s_cache=14, requests=12, prompt_len=8,
                   gen=6)
# the per-layer scenario run of the engine: SCHED's traffic, the layers'
# budgets cycling through exact, 1.0 and 2.0, at the vdd-opt scenario's ss
# corner
SCENARIO_RUN = dict(per_layer=("exact", "1.0", "2.0"), scenario="vdd-opt",
                    corner="ss")
# the reference's solve_td_policy (repro.tdsim.policy) at these keys:
# (bits_a, bits_w, n_chain, sigma_max) -> (R, sigma_chain, q), at the
# default supply, input statistics and library (vdd 0.8, m 8, hybrid TDC)
POLICY_ROWS = {
    (4, 4, 576, None): (76, 0.16601820290088654, 1),
    (4, 4, 576, 2.0): (1, 1.9179178476333618, 2),
    (4, 4, 64, None): (10, 0.1575535237789154, 1),
    (4, 4, 64, 2.0): (1, 0.6393059492111206, 6),
    (4, 4, 48, None): (7, 0.16557468473911285, 1),
    (4, 4, 48, 2.0): (1, 0.5536551475524902, 6),
    (4, 4, 16, None): (3, 0.1554127037525177, 1),
    (4, 4, 16, 2.0): (1, 0.3196529746055603, 6),
}
GOLDEN = ROOT / "tests" / "fixtures" / "design_space_golden.json"


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


def gpu_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return out[0]


def gpu_state() -> str:
    """SM clock, power draw and temperature now (beside timings)."""
    return gpu_line("clocks.sm,power.draw,temperature.gpu")


# ---------------------------------------------------------------------------
# Device time.  A kernel of a few microseconds runs faster than Python can
# enqueue it, so events around a loop of launches would time the host.  Here
# every launch is queued behind a spin of the device (torch.cuda._sleep)
# that lasts longer than the host takes to enqueue them all, and each launch
# sits between its own pair of events: the device reaches each start event
# with the launch already queued behind it.  The time is the median over the
# launches.  Timed cold, the launches are separated by a write of a buffer
# larger than the 50 MB L2, outside the events.
L2_FLUSH_BYTES = 256 * 2**20

_spin_ms_per_cycle = None
_flush_buf = None


def _spin_rate() -> float:
    """Device ms per cycle of torch.cuda._sleep, measured once."""
    global _spin_ms_per_cycle
    if _spin_ms_per_cycle is None:
        import torch
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(100_000)
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        torch.cuda.synchronize()
        _spin_ms_per_cycle = a.elapsed_time(b) / 20_000_000
    return _spin_ms_per_cycle


def _spin(ms: float) -> None:
    import torch
    torch.cuda._sleep(max(1, int(ms / _spin_rate())))


def flush_l2(release: bool = False) -> None:
    """Write a buffer larger than the L2 (allocated at first use); with
    ``release`` free it instead, before the paths run."""
    global _flush_buf
    import torch
    if release:
        _flush_buf = None
        torch.cuda.empty_cache()
        return
    if _flush_buf is None:
        _flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")
    _flush_buf.zero_()


def device_ms(fn, reps: int, cold: bool = False, must_cover: bool = True):
    """Per-launch device times (ms) of ``fn``, each launch queued behind a
    spin that outlasts the host's enqueue of all of them (see above).
    Returns (times, covered); ``covered`` is False if the host still
    outran the spin after three retries, and then fails the run unless
    ``must_cover`` is False (plain versions that sync inside)."""
    import torch
    Event = torch.cuda.Event
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if cold:
        flush_l2()
    fn()
    est_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = 3.0 * reps * est_ms + 1.0
    for _ in range(4):
        ev = [(Event(enable_timing=True), Event(enable_timing=True))
              for _ in range(reps)]
        s0, s1 = Event(enable_timing=True), Event(enable_timing=True)
        s0.record()
        _spin(spin_ms)
        s1.record()
        t0 = time.perf_counter()
        for a, b in ev:
            if cold:
                flush_l2()
            a.record()
            fn()
            b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in ev]
        if s0.elapsed_time(s1) >= host_ms:
            return times, True
        spin_ms = 4 * max(spin_ms, host_ms)
    if must_cover:
        fail(f"the host enqueue ({host_ms:.1f} ms) outran a {spin_ms:.1f} ms"
             f" spin: device times would include host gaps")
    return times, False


def host_us(fn, n: int = 20) -> float:
    """Host wall time of one call of ``fn`` (what the caller pays to
    enqueue it, the device held busy so the queue never blocks)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    est_ms = (time.perf_counter() - t0) * 1e3
    _spin(3.0 * n * est_ms + 1.0)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def kernel_us(fn, n: int = 20):
    """The device time of the kernels one call of ``fn`` launches, alone,
    from torch.profiler's CUPTI trace: (summed kernel durations per call in
    us, kernels per call), mean over ``n`` calls.  Unlike an event pair it
    leaves out the launch's own cost on the device.  None when three
    traces in a row come back without the device's activity (CUPTI in a
    sandbox): the number is then not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a trace now and then comes back without the device's activity: up to
    # three traces are taken
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ks:
            return (sum(e.time_range.end - e.time_range.start
                        for e in ks) / n, len(ks) / n)
    return None


def in_turns(tag: str, label: str, fns: dict, reps: dict,
             cold: bool = False, alone: bool = False) -> dict:
    """Times ``fns`` ("plain", "kernel" and, where given, "library" or
    another variant) in turns in one run: plain, kernel, the others,
    kernel, plain.  Returns the
    median device ms of each over both of its turns and the host us per
    call of kernel and library (and, with ``alone``, their kernels' own
    device time from `kernel_us`); prints every turn."""
    mid = [n for n in fns if n not in ("plain", "kernel")]
    order = [n for n in ("plain", "kernel", *mid, "kernel", "plain")
             if n in fns]
    times = {n: [] for n in fns}
    turns = []
    for n in order:
        t, covered = device_ms(fns[n], reps[n], cold,
                               must_cover=n != "plain")
        times[n] += t
        turns.append(f"{n} {statistics.median(t):.5f}"
                     + ("" if covered else " (host-bound)"))
    out = {f"{n}_ms": statistics.median(t) for n, t in times.items()}
    for n in ("kernel", "library"):
        if n in fns:
            out[f"{n}_host_us"] = host_us(fns[n])
    l2 = "cold" if cold else "warm"
    print(f"[{tag}] {label}: device ms in turns ({l2} L2, median of each "
          f"turn's launches): {', '.join(turns)}; host us per call: "
          + ", ".join(f"{n} {out[f'{n}_host_us']:.1f}"
                      for n in ("kernel", "library") if n in fns))
    if alone:
        said = []
        for n in ("kernel", "library"):
            if n in fns:
                got = kernel_us(fns[n])
                said.append(f"{n} not measured (three CUPTI traces held no "
                            "device time)" if got is None else
                            f"{n} {got[0]:.2f} us in {got[1]:g} kernel(s) "
                            "a call")
        print(f"[{tag}] {label}: kernels alone (CUPTI, warm L2): "
              + ", ".join(said))
    return out


def bound_ms(bytes_moved: float, ops: float, op_type: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_yardstick():
    """The floor of the device-time yardstick: an event pair around an
    empty kernel, warm and cold."""
    import torch
    for cold in (False, True):
        t, _ = device_ms(lambda: torch.cuda._sleep(0), 30, cold)
        print(f"[yardstick] event pair around an empty kernel "
              f"({'cold' if cold else 'warm'}): median "
              f"{statistics.median(t):.5f} ms, min {min(t):.5f} ms")


# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import build
    t0 = time.monotonic()
    reports = build.build()
    print(f"[build] {len(reports)} kernel libraries built in "
          f"{time.monotonic() - t0:.1f} s into {build.BUILD_DIR}")
    for name, text in reports.items():
        for line in text.splitlines():
            if "Function properties for" in line:
                print(f"[build] {name}: {line.split(' for ')[-1][:60]}")
            elif "registers" in line or "spill" in line:
                print(f"[build] {name}:   {line.strip()}")


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
    common.resolve_arch_policy = lambda a, device=None: pol
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
    small_engines(arch, pol, params)


def small_engines(arch, pol, params):
    """The continuous-batching engine on the smoke model of
    `phase_small_reference` (policy ``pol``), ragged requests, the card
    against the CPU: steps, completion order and every generated token
    must be equal.  At capacity 9 decode takes td_vmm's block route
    (M > 8), at 3 its split route."""
    from repro_torch.launch import serve
    from repro_torch.launch.scheduler import ContinuousBatchingEngine
    from repro_torch.models import common
    solve = common.resolve_arch_policy
    cfg = arch.model
    for capacity in SMALL_SCHED["capacities"]:
        runs = {}
        for dev in ("cpu", "cuda"):
            common.resolve_arch_policy = lambda a, device=None: pol
            try:
                eng = ContinuousBatchingEngine(
                    arch, capacity=capacity, s_cache=SMALL_SCHED["s_cache"],
                    kv_block=8, params=_to(params, dev), device=dev)
            finally:
                common.resolve_arch_policy = solve
            eng.run(serve.synthetic_requests(
                SMALL_SCHED["requests"], SMALL_SCHED["prompt_len"],
                SMALL_SCHED["gen"], cfg.vocab, seed=3))
            runs[dev] = (eng.steps_run, list(eng.done),
                         {r: q.generated for r, q in eng.done.items()})
        cpu, card = runs["cpu"], runs["cuda"]
        same = card == cpu
        print(f"[small] smoke engine td sigma=0 f32, capacity {capacity}, "
              f"{SMALL_SCHED['requests']} ragged requests, card vs CPU: "
              f"steps {card[0]} vs {cpu[0]}, completion order and every "
              f"generated token equal: {same}")
        if not same:
            fail(f"smoke engine at capacity {capacity} on the card disagrees "
                 "with the CPU run")


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
    # one solve (on the card) for both sides: a card solve and a CPU solve
    # may put sigma_chain an ulp apart
    pol = common.resolve_arch_policy(arch, device="cuda")
    params = get_api(cfg)["init"](0, cfg, pol, device="cpu")
    stream = SyntheticStream(DataCfg(vocab=cfg.vocab, seq_len=16,
                                     global_batch=4, seed=0))
    res = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        opt = adamw.init_opt_state(p)
        solve = common.resolve_arch_policy
        common.resolve_arch_policy = lambda a, device=None: pol
        try:
            step = steps.build_train_step(arch, shape)
        finally:
            common.resolve_arch_policy = solve
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
# td_vmm's shapes on the main paths (qwen3-8b), timed: (label, M, K, N,
# cold L2, bits_a, bits_w).  Decode reads each weight once per token, so it
# is timed cold.  The last row times the solved policies' narrower widths,
# whose epilogue computes only the noise chains its planes use.
TD_VMM_TIMED = [
    ("prefill mlp.wi", 512, 4096, 12288, False, 4, 4),
    ("prefill mlp.wo", 512, 12288, 4096, False, 4, 4),
    ("train mlp.wi", 128, 4096, 12288, False, 4, 4),  # one microbatch
    ("train lm_head", 128, 4096, 151936, False, 4, 4),
    ("decode attn.wk", 4, 4096, 1024, True, 4, 4),
    ("decode mlp.wi", 4, 4096, 12288, True, 4, 4),
    ("decode lm_head", 4, 4096, 151936, True, 4, 4),
    ("prefill mlp.wi, bits 2/3", 512, 4096, 12288, False, 2, 3),
    ("scheduler admission mlp.wi", 192, 4096, 12288, False, 4, 4),
    ("scheduler decode mlp.wi", 8, 4096, 12288, True, 4, 4),
    ("scheduler_bench decode mlp.wi", 16, 4096, 12288, True, 4, 4),
]


def slot_len(conf: dict) -> int:
    """The engine's slot length: ``s_cache`` rounded up to KV blocks, as
    `roofline.model.plan_kv_cache` rounds it."""
    return -(-conf["s_cache"] // conf["kv_block"]) * conf["kv_block"]


def bucket_len(conf: dict) -> int:
    """The engine's prompt bucket: ``prompt_pad``, else the slot."""
    return conf.get("prompt_pad") or slot_len(conf)


# td_vmm's other shapes on the engine's paths, checked (not timed): every
# dense's (K, N) besides mlp.wi (timed above) at the admission's M (the
# prompt bucket) and the decode step's M (the capacity), for both traffics
TD_VMM_SCHED = [(f"{path} {step} {name}", m, k, n)
                for path, conf in SCHED_PATHS.items()
                for step, m in (("admission", slot_len(conf)),
                                ("decode", conf["capacity"]))
                for name, k, n in (("attn.wq", 4096, 4096),
                                   ("attn.wk", 4096, 1024),
                                   ("mlp.wo", 12288, 4096),
                                   ("lm_head", 4096, 151936))]
# ragged shapes through both routes, (M, K, N, n_chain), at these widths
TD_VMM_RAGGED = [(5, 100, 70, 16), (9, 161, 130, 48), (130, 1200, 200, 576)]
TD_VMM_BITS = [(4, 4), (8, 8), (2, 3), (1, 4)]

# td_vmm's noise arithmetic alone, from csrc/td_vmm_noise.cuh: a loop trip
# is one noisy plane output as the epilogue computes it at q == 1 (z, sigma
# * z added, rint, the 2^b accumulation), from registers; NOISY false is
# the same loop without z.  The difference of their device times at a
# shape's count of noisy plane outputs is the floor of its noise epilogue.
_NOISE_PROBE = r"""
#include <cuda_runtime.h>
#include "td_vmm_noise.cuh"
template <bool NOISY>
__global__ void __launch_bounds__(256)
noise_probe(float* out, unsigned n, float sig, unsigned seed) {
  const unsigned t0 = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
#pragma unroll 4
  for (unsigned i = t0; i < n; i += gridDim.x * blockDim.x) {
    float part = (float)(i & 1023u);
    if (NOISY) part = __fadd_rn(part, __fmul_rn(sig, gauss(i, seed)));
    acc = __fadd_rn(acc, __fmul_rn(2.0f, rintf(part)));
  }
  out[t0] = acc;
}
extern "C" int noise_probe_launch(int noisy, float* out, unsigned n,
                                  int blocks, float sig, unsigned seed,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (noisy)
    noise_probe<true><<<blocks, 256, 0, s>>>(out, n, sig, seed);
  else
    noise_probe<false><<<blocks, 256, 0, s>>>(out, n, sig, seed);
  return (int)cudaGetLastError();
}
"""


def td_vmm_noise_probe():
    """Builds the probe above into build/td_vmm_probe/ and returns
    ``floor(n_outputs, sigma) -> (noise ms, noisy ms, base ms)``: the
    median device time of the probe with and without z over n_outputs,
    timed in turns (base, noisy, noisy, base)."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "td_vmm_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "noise_probe.cu", out_dir / "libnoise_probe.so"
    src.write_text(_NOISE_PROBE)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(src)], check=True,
                   capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).noise_probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint,
                   ctypes.c_int, ctypes.c_float, ctypes.c_uint,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(0).multi_processor_count * 4
    buf = torch.empty(blocks * 256, dtype=torch.float32, device="cuda")
    stream = build.stream_ptr(buf.device)

    def floor(n_outputs: int, sigma: float):
        runs = {0: [], 1: []}
        for noisy in (0, 1, 1, 0):
            def call():
                build.check(fn(noisy, buf.data_ptr(), n_outputs, blocks,
                               sigma, 33350994, stream), "noise probe")
            runs[noisy] += device_ms(call, 5)[0]
        noisy_ms = statistics.median(runs[1])
        base_ms = statistics.median(runs[0])
        return noisy_ms - base_ms, noisy_ms, base_ms
    return floor


def _codes(gen, shape, bits):
    import torch
    h = 2 ** (bits - 1)
    return torch.randint(-h, h, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def _td_vmm_check(tv, label, x, w, seed, kw, noisy) -> float:
    """The kernel against its plain version at sigma 0 (q 1 and 3: bit-exact)
    and at each (sigma, q) of ``noisy`` (at most 1e-4 of outputs may differ,
    each by a multiple of q: a z within ulps of a rounding boundary may flip
    one plane's TDC step q * 2^b).  Returns the largest |kernel - plain|."""
    import torch
    m, k = x.shape
    plan = tv.td_vmm_plan(m, k, w.shape[1], kw["n_chain"], kw["bits_a"])
    err_max = 0.0
    for sigma, q in [(0.0, 1.0), (0.0, 3.0), *noisy]:
        par = torch.tensor([sigma, q], dtype=torch.float32, device="cuda")
        got = tv.td_vmm(x, w, par, seed, **kw)
        want = tv.td_vmm_plain(x, w, par, seed, **kw)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max())
        err_max = max(err_max, err)
        frac = float((diff != 0).float().mean())
        print(f"[td_vmm] {label} M={m} K={k} N={w.shape[1]} bits "
              f"{kw['bits_a']}/{kw['bits_w']} n_chain {kw['n_chain']}, route "
              f"{plan.route}: sigma={sigma:.4f} q={q:g}: max |kernel - "
              f"plain| {err:g}, differing {frac:.2e}")
        if sigma == 0.0 and err != 0.0:
            fail(f"td_vmm not bit-exact at sigma=0 ({label}, q={q})")
        if sigma != 0.0 and (frac > 1e-4 or bool(
                torch.any(torch.remainder(got - want, q) != 0))):
            fail(f"td_vmm noisy outputs disagree ({label})")
        del got, want, diff
    return err_max


def phase_td_vmm(rows: list):
    """td_vmm against its plain version on the card through both routes:
    the ragged shapes at four bit widths, the continuous-batching engine's
    shapes (`TD_VMM_SCHED`), then the main paths' shapes;
    then device time in turns (plain, kernel at the solved sigma, kernel at
    sigma 0, kernel, plain) at the main paths' shapes, decode with a cold
    L2; at M >= 128 also torch._int_mm of the stacked planes and w' (int8),
    a yardstick of the tensor work alone (not the same function: printed,
    never the library call); and the floor of each shape's noise epilogue,
    timed on the card by `td_vmm_noise_probe`."""
    import torch
    from repro_torch.kernels.td_vmm import td_vmm as tv
    from repro_torch.tdsim.policy import solve_td_policy

    pol = solve_td_policy(4, 4, 576, None)
    solved = (pol.sigma_chain, float(pol.tdc_q))
    coarse = solve_td_policy(4, 4, 576, 2.0)       # q = 2 with noise
    gen = torch.Generator(device="cuda").manual_seed(0)
    seed = torch.tensor([33350994], dtype=torch.int64, device="cuda")
    max_err = 0.0                   # over every case, shape and policy
    for m, k, n, n_chain in TD_VMM_RAGGED:
        for bits_a, bits_w in TD_VMM_BITS:
            x, w = _codes(gen, (m, k), bits_a), _codes(gen, (k, n), bits_w)
            kw = dict(bits_a=bits_a, bits_w=bits_w, n_chain=n_chain)
            max_err = max(max_err, _td_vmm_check(
                tv, "ragged", x, w, seed, kw,
                [solved, (coarse.sigma_chain, float(coarse.tdc_q))]))
    for label, m, k, n in TD_VMM_SCHED:
        kw = dict(bits_a=4, bits_w=4, n_chain=576)
        x, w = _codes(gen, (m, k), 4), _codes(gen, (k, n), 4)
        max_err = max(max_err, _td_vmm_check(tv, label, x, w, seed, kw,
                                             [solved]))
        del x, w
    torch.cuda.empty_cache()
    noise_floor = td_vmm_noise_probe()
    print(f"[td_vmm] card before timing: {gpu_state()}")
    timed = {}
    for label, m, k, n, cold, bits_a, bits_w in TD_VMM_TIMED:
        kw = dict(bits_a=bits_a, bits_w=bits_w, n_chain=576)
        x, w = _codes(gen, (m, k), bits_a), _codes(gen, (k, n), bits_w)
        max_err = max(max_err, _td_vmm_check(tv, label, x, w, seed, kw,
                                             [solved]))
        par = torch.tensor(solved, dtype=torch.float32, device="cuda")
        par0 = torch.tensor([0.0, solved[1]], dtype=torch.float32,
                            device="cuda")
        big = m * n > 10**7
        t = in_turns("td_vmm", label, {
            "plain": lambda: tv.td_vmm_plain(x, w, par, seed, **kw),
            "kernel": lambda: tv.td_vmm(x, w, par, seed, **kw),
            "sigma0": lambda: tv.td_vmm(x, w, par0, seed, **kw)},
            {"plain": 1 if big else 2, "kernel": 5 if big else 20,
             "sigma0": 5 if big else 20}, cold=cold)
        plan = tv.td_vmm_plan(m, k, n, 576, bits_a)
        # the operations of the live contraction: the kernel walks k
        # positions, never the padding of the last segment
        b_ms, b_by = bound_ms(4 * (m * k + k * n + m * n),
                              2 * m * k * n * bits_a, "int8")
        outputs = bits_a * plan.n_seg * m * n       # noisy plane outputs
        floor, probe_ms, probe_base_ms = noise_floor(outputs, solved[0])
        row = dict(ms=t["kernel_ms"], plain_ms=t["plain_ms"],
                   sigma0_ms=t["sigma0_ms"], bound_ms=b_ms, bound_by=b_by,
                   noise_floor_ms=floor, route=plan.route,
                   shape=f"{label} M={m} K={k} N={n} bits "
                         f"{bits_a}/{bits_w}")
        if m >= 128:
            ox, ow = 2 ** (bits_a - 1), 2 ** (bits_w - 1)
            a8 = torch.cat([((x + ox) >> b) & 1 for b in range(bits_a)]).to(
                torch.int8)
            w8 = (w + ow).to(torch.int8)
            try:
                row["int_mm_ms"] = statistics.median(device_ms(
                    lambda: torch._int_mm(a8, w8), 5)[0])
            except RuntimeError as e:
                print(f"[td_vmm] torch._int_mm refused: "
                      f"{str(e).splitlines()[0][:100]}")
            del a8, w8
        print(f"[td_vmm] {label} ({plan.route} route): kernel "
              f"{t['kernel_ms']:.4f} ms (sigma 0: {t['sigma0_ms']:.4f}), "
              f"plain {t['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"kernel at {b_ms / t['kernel_ms']:.1%} of it; noise epilogue "
              f"floor {floor:.4f} ms (probe over {outputs} noisy plane "
              f"outputs: {probe_ms:.4f} ms with z, {probe_base_ms:.4f} "
              f"without)"
              + (f"; torch._int_mm of the stacked planes and w' (tensor "
                 f"work alone) {row['int_mm_ms']:.4f} ms"
                 if "int_mm_ms" in row else ""))
        timed[label] = row
        del x, w
        torch.cuda.empty_cache()
    print(f"[td_vmm] card after timing: {gpu_state()}")
    main = timed["prefill mlp.wi"]
    rows.append(dict(name="td_vmm", route="cuda",
                     source="src/repro_torch/csrc/td_vmm.cu",
                     replaces="src/repro/kernels/td_vmm/td_vmm.py:110",
                     max_abs_err=max_err, library_ms=None, ms=main["ms"],
                     plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                     bound_by=main["bound_by"], shape=main["shape"],
                     timed=timed))


def _sdpa(q, k, v, causal):
    """The library call beside the attention kernels (timed, never used by
    the port): SDPA on (B, H, S, D) tensors with grouped KV heads."""
    import torch
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)


# Besides the absolute 2e-2, bf16 attention outputs are held to one bf16
# ulp of the plain version's (at most 2^-7 |plain|), with a floor of 2^-8
# of the output's rms for elements near 0, where f32 sums in another order
# move the value by more than its own ulp; and to a share of differing
# outputs.  The absolute limit alone passes a kernel that drops a split
# chunk at a long shape, where outputs are about 0.01; the share catches
# a P rounded to one bf16 in the second product (27-40% of flash's outputs
# differ then, 0.14-0.35% with P_hi + P_lo: PERF.md, Findings).
ATOL_BF16 = 2e-2
MAX_DIFFERING = 0.01


def _cmp(got, want):
    """(max |got - want|, share of output elements that differ, ulp
    error): the ulp error is max |got - want| / (2^-7 |want| + 2^-8
    rms(want)), at most 1 when every output is within one bf16 ulp of the
    plain version's (see above)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    rms = float(w.square().mean().sqrt())
    if rms > 0:
        ulp = float((diff / (w.abs() * 2.0 ** -7 + rms * 2.0 ** -8)).max())
    else:                                   # the plain output is all 0
        ulp = 0.0 if err == 0 else math.inf
    return err, float((got != want).float().mean()), ulp


def _close(err: float, frac: float, ulp: float) -> bool:
    return err <= ATOL_BF16 and frac <= MAX_DIFFERING and ulp <= 1.0


def _randn(gen, shape):
    import torch
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def _i32(vals):
    import torch
    return torch.tensor(vals, dtype=torch.int32, device="cuda")


def flash_bound(b, sq, kv_lens, hq, hkv, d, causal, elem=2,
                op_type="bf16"):
    """Bound of one flash_attn call (q_offset 0): q and o once, the live
    key prefix of k and v once (``elem`` bytes an element: bf16 2, f32 4),
    4 D operations per live (query, key) pair at ``op_type``'s peak (f32:
    the CUDA cores' 67 TFLOP/s)."""
    pairs = 0
    for n in kv_lens:
        for i in range(sq):
            pairs += min(n, i + 1) if causal else n
    return bound_ms(elem * (2 * b * sq * hq * d + 2 * sum(kv_lens) * hkv * d),
                    4 * pairs * hq * d, op_type)


def phase_flash(rows: list):
    """flash_attn against its plain version on the card (bf16, tolerance
    2e-2): the serve prefill and train microbatch shapes, ragged kv_len with
    a fully masked row and q_offset, non-causal, Sq around the query tiles,
    g from 1 to 16, qwen2.5-3b's prefill (B 4, Sq 128, Hq 16, Hkv 2),
    train_4k's microbatch and the engine's admissions (B 1 over the prompt
    bucket, both traffics); at head dim 64 (g 1 and 2, a query row over
    2048 keys, ragged kv_len with a row of no live key, q_offset, causal
    and not) at the plan's key split and at 1, 2, 4 and 8 forced through
    the launcher, two launches of each bit-equal; then device time in
    turns with SDPA at the serve prefill, the train microbatch and
    train_4k; then the CUDA-core route (`_flash_cuda_cores`)."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attn as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    s_cache = SERVE["prompt_len"] + SERVE["gen"]
    checks = [  # (label, B, Sq, Skv, Hq, Hkv, kv_len, q_offset, causal)
        ("serve prefill", 4, 128, s_cache, 32, 8, [128] * 4, 0, True),
        ("ragged kv_len, row 1 fully masked, q_offset 5", 4, 128, s_cache,
         32, 8, [128, 0, 77, s_cache], 5, True),
        ("non-causal", 4, 128, s_cache, 32, 8, [128] * 4, 0, False),
        ("train microbatch", 1, 128, 128, 32, 8, [128], 0, True)]
    for sq in (7, 8, 9, 15, 16, 17, 31, 33):   # query tiles of 8, 16 rows
        checks.append((f"Sq {sq}, q_offset 5", 2, sq, sq + 5, 32, 8,
                       [sq + 5, sq], 5, True))
    for hq in (8, 16, 24, 64, 128):             # g = 1, 2, 3, 8, 16
        checks.append((f"g {hq // 8}", 2, 40, 48, hq, 8, [48, 33], 3, True))
    # phase_dense_configs' qwen2.5-3b prefill: 16 heads over 2 KV heads
    dc = DENSE_CONFIGS
    checks.append(("qwen2.5-3b prefill, g 8", dc["batch"], dc["prompt_len"],
                   dc["prompt_len"] + dc["gen"], 16, 2,
                   [dc["prompt_len"]] * dc["batch"], 0, True))
    checks.append(("train_4k microbatch", 1, 4096, 4096, 32, 8, [4096], 0,
                   True))
    for path, conf in ENGINE_PATHS.items():  # the engine's bucketed prefill
        n = bucket_len(conf)
        checks.append((f"{path} admission", 1, n, n, 32, 8, [n], 0, True))
    # chaos_train's forward (and its remat): granite-8b, batch 2 x 32
    checks.append(("chaos_train", CHAOS_TRAIN["batch"], CHAOS_TRAIN["seq"],
                   CHAOS_TRAIN["seq"], 32, 8, [CHAOS_TRAIN["seq"]] * 2, 0,
                   True))
    max_err = 0.0
    for label, b, sq, skv, hq, hkv, lens, off, causal in checks:
        d = 128
        q = _randn(gen, (b, sq, hq, d))
        k = _randn(gen, (b, skv, hkv, d))
        v = _randn(gen, (b, skv, hkv, d))
        args = (q, k, v, _i32(lens), _i32([off]))
        want = fa.flash_attn_plain(*args, causal=causal)
        dead = [i for i, n in enumerate(lens) if n == 0]
        got = fa.flash_attn(*args, causal=causal)
        torch.cuda.synchronize()
        err, frac, ulp = _cmp(got, want)
        zero = all(not bool(got[i].any()) for i in dead)
        print(f"[flash_attn] {label}: B={b} Sq={sq} Skv={skv} Hq={hq} "
              f"Hkv={hkv} kv_len={lens} causal={causal}: max |kernel - "
              f"plain| {err:g}, in bf16 ulps {ulp:.3f}, differing {frac:.4f}"
              + (f", rows with no live key exactly 0: {zero}"
                 if dead else ""))
        if not _close(err, frac, ulp) or not zero:
            fail(f"flash_attn disagrees with its plain version ({label})")
        max_err = max(max_err, err)
        del q, k, v, args, got, want
    torch.cuda.empty_cache()
    d64 = [  # (label, B, Sq, Skv, Hq, Hkv, kv_len, q_offset, causal)
        ("D 64, g 1, Sq 1 over 2048 keys, a row with no live key", 4, 1,
         2048, 16, 16, [2048, 0, 1000, 65], 0, False),
        ("D 64, g 2, Sq 1 over 2048 keys", 4, 1, 2048, 16, 8,
         [2048, 1999, 0, 64], 0, False),
        ("D 64, g 2, causal, ragged kv_len, q_offset 5", 4, 128, 144, 16, 8,
         [128, 0, 77, 144], 5, True),
        ("D 64, g 1, causal, q_offset 4036", 1, 64, 4100, 32, 32, [4100],
         4036, True),
        ("D 64, g 2, Sq 33, non-causal", 2, 33, 300, 16, 8, [300, 31], 7,
         False),
        ("D 64, g 1, Sq 31, causal", 2, 31, 97, 16, 16, [97, 0], 3, True)]
    for label, b, sq, skv, hq, hkv, lens, off, causal in d64:
        q = _randn(gen, (b, sq, hq, 64))
        k = _randn(gen, (b, skv, hkv, 64))
        v = _randn(gen, (b, skv, hkv, 64))
        args = (q, k, v, _i32(lens), _i32([off]))
        want = fa.flash_attn_plain(*args, causal=causal)
        dead = [i for i, n in enumerate(lens) if n == 0]
        plan = fa.flash_plan(b, sq, hq, hkv, skv)
        for split in (None, 1, 2, 4, 8):
            got = fa.flash_attn(*args, causal=causal, kv_split=split)
            again = fa.flash_attn(*args, causal=causal, kv_split=split)
            torch.cuda.synchronize()
            err, frac, ulp = _cmp(got, want)
            zero = all(not bool(got[i].any()) for i in dead)
            same = torch.equal(got, again)
            print(f"[flash_attn] {label}: B={b} Sq={sq} Skv={skv} Hq={hq} "
                  f"Hkv={hkv} kv_len={lens} q_offset={off} causal={causal}"
                  f", key split {split or f'{plan} (the plan)'}: max "
                  f"|kernel - plain| {err:g}, in bf16 ulps {ulp:.3f}, "
                  f"differing {frac:.4f}, two launches bit-equal {same}"
                  + (f", rows with no live key exactly 0: {zero}"
                     if dead else ""))
            if not _close(err, frac, ulp) or not zero or not same:
                fail(f"flash_attn disagrees with its plain version or with "
                     f"itself ({label}, key split {split})")
            max_err = max(max_err, err)
            del got, again
        del q, k, v, args, want
    torch.cuda.empty_cache()

    timed = {}
    print(f"[flash_attn] card before timing: {gpu_state()}")
    for label, b, sq, skv, reps in (("serve prefill", 4, 128, s_cache, 30),
                                    ("train microbatch", 1, 128, 128, 30),
                                    ("train_4k microbatch", 1, 4096, 4096,
                                     10)):
        hq, hkv, d = 32, 8, 128
        q = _randn(gen, (b, sq, hq, d))
        k = _randn(gen, (b, skv, hkv, d))
        v = _randn(gen, (b, skv, hkv, d))
        kv_len, off = _i32([sq] * b), _i32([0])
        qt = q.transpose(1, 2).contiguous()
        kt = k[:, :sq].transpose(1, 2).contiguous()
        vt = v[:, :sq].transpose(1, 2).contiguous()
        lib_err = float((_sdpa(qt, kt, vt, True).transpose(1, 2).float()
                         - fa.flash_attn(q, k, v, kv_len, off).float())
                        .abs().max())
        t = in_turns("flash_attn", label, {
            "plain": lambda: fa.flash_attn_plain(q, k, v, kv_len, off),
            "kernel": lambda: fa.flash_attn(q, k, v, kv_len, off),
            "library": lambda: _sdpa(qt, kt, vt, True)},
            {"plain": 2 if sq > 1024 else 5, "kernel": reps,
             "library": reps}, alone=True)
        b_ms, b_by = flash_bound(b, sq, [sq] * b, hq, hkv, d, True)
        print(f"[flash_attn] {label}: B={b} Sq={sq} cache={skv} Hq={hq} "
              f"Hkv={hkv} D={d} causal, kv_split "
              f"{fa.flash_plan(b, sq, hq, hkv)}: "
              f"kernel {t['kernel_ms']:.5f} ms, "
              f"plain {t['plain_ms']:.5f} ms, sdpa {t['library_ms']:.5f} ms "
              f"(|kernel - sdpa| {lib_err:.3e}), bound {b_ms:.5f} ms "
              f"({b_by}): kernel at {b_ms / t['kernel_ms']:.1%} of its "
              f"bound, {t['kernel_ms'] / t['library_ms']:.2f}x sdpa")
        timed[label] = dict(t, bound_ms=b_ms, bound_by=b_by,
                            shape=f"B={b} Sq={sq} S_cache={skv} Hq={hq} "
                            f"Hkv={hkv} D={d} causal")
        print(f"[flash_attn] card after timing {label}: {gpu_state()}")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    main = timed["serve prefill"]
    rows.append(dict(name="flash_attn", route="cuda",
                     source="src/repro_torch/csrc/flash_attn.cu",
                     replaces="src/repro/kernels/flash_attn/flash_attn.py:55",
                     max_abs_err=max_err, ms=main["kernel_ms"],
                     plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                     bound_by=main["bound_by"], library_ms=main["library_ms"],
                     shape="prefill " + main["shape"], timed=timed))

    _flash_cuda_cores(rows, gen)


# the LM sweep's attention, f32 on the CUDA-core route: a chunk of 13
# probes x batch 8, Sq 32, causal, at each model's heads (label, Hq, Hkv,
# D): granite-8b, granite-moe-1b-a400m, zamba2-1.2b's shared block
FLASH_F32_TIMED = [("granite-8b", 32, 8, 128), ("granite-moe", 16, 8, 64),
                   ("zamba2", 32, 32, 64)]


def _cc_check(fa, label, b, sq, skv, hq, hkv, d, lens, off, causal, kdt,
              gen) -> float:
    """flash_attn's CUDA-core route against its plain version on one
    shape with an f32 or bf16 (``kdt``) cache, for f32 q and, where the
    route takes it (not bf16 q with a bf16 cache at D 64 or 128), bf16 q:
    f32 q within ATOL_F32 of the plain version; bf16 q's output equal bit
    for bit to the f32 route's on the same (exactly widened) q, rounded to
    bf16 (the kernel widens q and rounds once at its store), and its
    distance from the plain version in bf16 ulps (`_cmp`) printed; two
    launches bit-equal; rows with no live key 0.  Returns the f32 error."""
    import torch
    bf = torch.bfloat16
    q32 = torch.randn((b, sq, hq, d), generator=gen, device="cuda")
    k, v = (torch.randn((b, skv, hkv, d), generator=gen, device="cuda")
            .to(kdt) for _ in range(2))
    lk, ok = _i32(lens), _i32([off])
    dead = [i for i, n in enumerate(lens) if n == 0]
    qdts = [torch.float32]
    if not (kdt == bf and d in fa.TC_HEAD_DIMS):
        qdts.append(bf)
    err = 0.0
    for qdt in qdts:
        q = q32.to(qdt)
        got = fa.flash_attn(q, k, v, lk, ok, causal=causal)
        again = fa.flash_attn(q, k, v, lk, ok, causal=causal)
        # the f32 route on q's (exactly widened) values
        ref = got if qdt != bf else fa.flash_attn(q.float(), k, v, lk, ok,
                                                  causal=causal)
        e = float((ref - fa.flash_attn_plain(q.float(), k, v, lk, ok,
                                             causal=causal)).abs().max())
        torch.cuda.synchronize()
        err = max(err, e)
        same = torch.equal(got, again)
        zero = all(not bool(got[i].any()) for i in dead)
        good = e <= ATOL_F32
        said = f"max |kernel - plain| {e:.3g}"
        if qdt == bf:
            rounded = torch.equal(got, ref.to(bf))
            _, frac, ulp = _cmp(got, fa.flash_attn_plain(
                q, k, v, lk, ok, causal=causal))
            said = (f"f32 route on its values within {e:.3g} of the plain "
                    f"version, the bf16 output that route's rounded bit for "
                    f"bit {rounded}; against the plain version in bf16 "
                    f"ulps {ulp:.3f}, differing {frac:.4f}")
            good = good and rounded
        print(f"[flash_attn] CUDA cores, {label}: B={b} Sq={sq} Skv={skv} "
              f"Hq={hq} Hkv={hkv} D={d} q {str(qdt)[6:]} cache "
              f"{str(kdt)[6:]} kv_len={lens if len(lens) <= 4 else lens[:4]}"
              f"{'..' if len(lens) > 4 else ''} q_offset={off} causal="
              f"{causal}: {said} (tolerance {ATOL_F32:g}); two launches "
              f"bit-equal {same}"
              + (f", rows with no live key exactly 0: {zero}" if dead
                 else ""))
        if not (good and same and zero):
            fail(f"flash_attn's CUDA-core route disagrees with its plain "
                 f"version or with itself ({label}, q {qdt})")
    return err


def _flash_cuda_cores(rows: list, gen) -> None:
    """The CUDA-core route (f32 q or cache, other head dims) against its
    plain version (`_cc_check`): the LM sweep's three layouts, the smoke
    models' D 16 and D 32 with ragged kv_len, a row of no live key and
    q_offset, mixed dtypes, Sq 1 over 2048 keys and Sq = Skv 2048, causal
    and not, g 3 and 64, D 20 and 7 (element-wise loads); then device time at
    FLASH_F32_TIMED's shapes in turns with the plain version and SDPA f32,
    beside the bound (bytes at f32, the CUDA cores' 67 TFLOP/s)."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attn as fa
    f32, bf = torch.float32, torch.bfloat16
    b, sq = LM_SWEEP["chunk"] * LM_SWEEP["global_batch"], LM_SWEEP["seq_len"]
    checks = [(f"LM sweep {m}", b, sq, sq, hq, hkv, d, [sq] * b, 0, True, k)
              for m, hq, hkv, d in FLASH_F32_TIMED for k in (f32, bf)]
    checks += [  # (label, B, Sq, Skv, Hq, Hkv, D, kv_len, q_off, causal, kv)
        ("D 16, ragged, a row of no live key, q_offset 5", 4, 32, 40, 4, 2,
         16, [40, 0, 17, 33], 5, True, f32),
        ("D 16, bf16 cache", 4, 32, 40, 4, 2, 16, [40, 0, 17, 33], 5, True,
         bf),
        ("D 32, g 4, Sq 7 at q_offset 40", 3, 7, 50, 8, 2, 32, [50, 1, 0],
         40, True, f32),
        ("Sq 1 over 2048 keys, ragged", 4, 1, 2048, 32, 8, 128,
         [2048, 0, 1000, 65], 0, False, f32),
        ("Sq 1 over 2048 keys at q_offset 2047, g 1", 2, 1, 2048, 16, 16, 64,
         [2048, 77], 2047, True, bf),
        ("Sq = Skv 2048", 1, 2048, 2048, 32, 8, 128, [2048], 0, True, f32),
        ("Sq = Skv 2048, non-causal, g 1", 1, 2048, 2048, 16, 16, 64, [2048],
         0, False, f32),
        ("g 3, ragged, q_offset 44", 2, 100, 144, 24, 8, 128, [144, 0], 44,
         True, f32),
        ("g 64", 2, 40, 48, 128, 2, 64, [48, 33], 3, True, f32),
        ("D 20, non-causal", 2, 33, 70, 6, 2, 20, [70, 31], 7, False, bf),
        ("D 7", 2, 5, 19, 3, 3, 7, [19, 4], 14, True, f32)]
    max_err = 0.0
    for label, *shape in checks:
        max_err = max(max_err, _cc_check(fa, label, *shape, gen))
        torch.cuda.empty_cache()

    timed = {}
    for model, hq, hkv, d in FLASH_F32_TIMED:
        q = torch.randn((b, sq, hq, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, sq, hkv, d), generator=gen, device="cuda")
                for _ in range(2))
        args = (q, k, v, _i32([sq] * b), _i32([0]))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_err = float((_sdpa(qt, kt, vt, True).transpose(1, 2)
                         - fa.flash_attn(*args)).abs().max())
        t = in_turns("flash_attn", f"LM sweep f32 {model}", {
            "plain": lambda: fa.flash_attn_plain(*args),
            "kernel": lambda: fa.flash_attn(*args),
            "library": lambda: _sdpa(qt, kt, vt, True)},
            {"plain": 5, "kernel": 20, "library": 20}, alone=True)
        b_ms, b_by = flash_bound(b, sq, [sq] * b, hq, hkv, d, True, elem=4,
                                 op_type="f32")
        print(f"[flash_attn] LM sweep f32 {model}: B={b} Sq={sq} Hq={hq} "
              f"Hkv={hkv} D={d} causal (CUDA cores): kernel "
              f"{t['kernel_ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, sdpa "
              f"f32 {t['library_ms']:.5f} ms (|kernel - sdpa| "
              f"{lib_err:.3e}), bound {b_ms:.5f} ms ({b_by}, f32 at 67 "
              f"TFLOP/s): kernel at {b_ms / t['kernel_ms']:.1%} of its "
              f"bound, {t['kernel_ms'] / t['library_ms']:.2f}x sdpa f32")
        timed[model] = dict(t, bound_ms=b_ms, bound_by=b_by,
                            shape=f"LM sweep f32 B={b} Sq={sq} Hq={hq} "
                            f"Hkv={hkv} D={d} causal, CUDA cores")
        del q, k, v, args, qt, kt, vt
    torch.cuda.empty_cache()
    main = timed["granite-8b"]
    rows.append(dict(
        name="flash_attn", route="cuda",
        source="src/repro_torch/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:55",
        max_abs_err=max_err, ms=main["kernel_ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], shape=main["shape"], timed=timed))


def _decode_check(dg, label, q, k, v, lens, chunk) -> float:
    """decode_gqa at lengths ``lens`` against its plain version and the
    plain split version (bf16, tolerance 2e-2, see `_cmp`), its split
    partials against the plain ones (relative 1e-4), length-0 rows exactly
    0.  Returns max |kernel - plain|."""
    import torch
    lt = _i32(lens)
    got = dg.decode_gqa(q, k, v, lt)
    want = dg.decode_gqa_plain(q, k, v, lt)
    sp = dg.decode_gqa_split_plain(q, k, v, lt, chunk)
    part = dg.decode_gqa_partials(q, k, v, lt)
    want_p = dg.split_partials_plain(q, k, v, lt, chunk)
    torch.cuda.synchronize()
    err, frac, ulp = _cmp(got, want)
    err_s, frac_s, ulp_s = _cmp(got, sp)
    err_p = max(_partials_err(x, y) for x, y in zip(part, want_p))
    zero = all(not bool(got[i].any()) for i, n in enumerate(lens) if n == 0)
    print(f"[decode_gqa] {label} lengths {lens}: max |kernel - plain| "
          f"{err:g}, in bf16 ulps {ulp:.3f}, differing {frac:.4f}, length-0 "
          f"rows exactly 0: {zero}; vs the plain split version {err_s:g}, "
          f"in bf16 ulps {ulp_s:.3f}, differing {frac_s:.4f}; partials (m, "
          f"l, acc) max rel err {err_p:.2e}")
    if not (_close(err, frac, ulp) and _close(err_s, frac_s, ulp_s)
            and zero and err_p <= 1e-4):
        fail(f"decode_gqa disagrees with its plain version ({label}, "
             f"lengths {lens})")
    return err


def phase_decode(rows: list):
    """decode_gqa against its plain version on the card (bf16, tolerance
    2e-2): the decode shape (B 4, S 144), lengths 0, 1, around the split
    chunk, S and past S, and decode_32k's length (B 4, S 32768); the
    continuous-batching engine's decode steps (B = capacity, S = its slot)
    at ragged per-row lengths, free slots at S (the attention clamps a free
    slot's length there) and lengths past S; the split partials and their
    combine against the plain split version; then device time in turns
    with SDPA, cold L2 (decode streams the whole model between two uses of
    a layer's cache)."""
    import torch
    from repro_torch.kernels.decode_gqa import decode_gqa as dg
    gen = torch.Generator(device="cuda").manual_seed(2)
    hq, hkv, d = 32, 8, 128
    max_err = 0.0
    for path, conf in ENGINE_PATHS.items():
        b, s = conf["capacity"], slot_len(conf)
        q = _randn(gen, (b, hq, d))
        k = _randn(gen, (b, s, hkv, d))
        v = _randn(gen, (b, s, hkv, d))
        _, chunk = dg.split_plan(s, b, hkv)
        edges = [0, 1, chunk - 1, chunk, chunk + 1, s - 1, s, s + 9]
        for lens in ([(37 * i) % s + 1 for i in range(b)],
                     [s] * b,
                     [edges[i % len(edges)] for i in range(b)]):
            max_err = max(max_err, _decode_check(
                dg, f"{path} decode B={b} S={s}", q, k, v, lens, chunk))
        del q, k, v
    b = 4
    s_main = SERVE["prompt_len"] + SERVE["gen"]
    length = SERVE["prompt_len"] + SERVE["gen"] // 2
    timed = {}
    for label, s in (("decode", s_main), ("decode_32k", 32768)):
        q = _randn(gen, (b, hq, d))
        k = _randn(gen, (b, s, hkv, d))
        v = _randn(gen, (b, s, hkv, d))
        full = length if s == s_main else s
        n_split, chunk = dg.split_plan(s, b, hkv)
        print(f"[decode_gqa] {label}: S={s} split into {n_split} chunks of "
              f"{chunk} keys: {n_split * b * hkv} blocks")
        for lens in ([full] * b, [0, 1, s // 2, s + 9],
                     [chunk - 1, chunk, chunk + 1, s],
                     [0, 2 * chunk - 1, 2 * chunk + 1, s - 1]):
            max_err = max(max_err, _decode_check(dg, label, q, k, v, lens,
                                                 chunk))
        lens = _i32([full] * b)
        qt = q[:, :, None].contiguous()
        kt = k[:, :full].transpose(1, 2).contiguous()
        vt = v[:, :full].transpose(1, 2).contiguous()
        t = in_turns("decode_gqa", label, {
            "plain": lambda: dg.decode_gqa_plain(q, k, v, lens),
            "kernel": lambda: dg.decode_gqa(q, k, v, lens),
            "library": lambda: _sdpa(qt, kt, vt, False)},
            {"plain": 5, "kernel": 30, "library": 30}, cold=True,
            alone=True)
        b_ms, b_by = bound_ms(2 * (2 * b * hq * d + 2 * b * full * hkv * d),
                              4 * b * hq * full * d, "bf16")
        print(f"[decode_gqa] {label}: B={b} S={s} length={full} Hq={hq} "
              f"Hkv={hkv} D={d}: kernel {t['kernel_ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f} ms, sdpa {t['library_ms']:.5f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}): kernel at "
              f"{b_ms / t['kernel_ms']:.1%} of its bound, "
              f"{t['kernel_ms'] / t['library_ms']:.2f}x sdpa")
        timed[label] = dict(t, bound_ms=b_ms, bound_by=b_by,
                            shape=f"B={b} S={s} length={full} Hq={hq} "
                            f"Hkv={hkv} D={d}")
        print(f"[decode_gqa] card after timing {label}: {gpu_state()}")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    main = timed["decode"]
    rows.append(dict(name="decode_gqa", route="cuda",
                     source="src/repro_torch/csrc/decode_gqa.cu",
                     replaces="src/repro/kernels/decode_gqa/decode_gqa.py:45",
                     max_abs_err=max_err, ms=main["kernel_ms"],
                     plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                     bound_by=main["bound_by"], library_ms=main["library_ms"],
                     shape="decode " + main["shape"], timed=timed))


def _partials_err(x, y) -> float:
    """Largest |x - y| / max(|y|, 1) over the live entries (m of an empty
    chunk is NEG_INF in both)."""
    import torch
    live = y > -1e29
    if not torch.equal(live, x > -1e29):
        return math.inf
    return float(((x - y).abs() / y.abs().clamp(min=1.0))[live].max()) \
        if bool(live.any()) else 0.0


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
    of the vector width (with NaN and infinities), in f32 and bf16; and the
    noise loop's f32 shapes (resnet20-cifar's im2col patches of the stem
    and a stage-0 conv at 512 images, its smallest and largest conv
    weights and the head's weight); step sizes with exact .5 ties, a
    random one and one below the 1e-8 floor; the LM sweep's f32
    shapes (granite-8b's weights, lm_head included, and a step's two
    activation widths); and in bf16 chaos_train's (granite-8b's weights
    and its batch 2 x 32 activations) and the quant engines' activations
    (chaos_serve's and its long-context run's, at admission, B 1 over the
    prompt bucket, and at decode, B = capacity), and phase_moe's quant
    training (granite-moe's 32-expert weight stacks and their activations
    at capacity 160, its attention weights, lm_head and a microbatch's
    activations).  Must be bit-exact (max_abs_err 0)."""
    import torch
    from repro_torch.kernels.lsq_quant import lsq_quant as lq
    from repro_torch.kernels.lsq_quant.ref import lsq_quant_ref

    d, f, v = 4096, 12288, 151936
    shapes = [("attn.wq/wo", (d, d)), ("attn.wk/wv", (d, 1024)),
              ("mlp.wi/wg", (d, f)), ("mlp.wo", (f, d)), ("lm_head", (d, v)),
              ("act d_model", (1, 128, d)), ("act d_ff", (1, 128, f)),
              ("odd length", (1_000_003,))]
    noise_loop = [("resnet stem patches", (512, 32, 32, 27)),
                  ("resnet s0 conv patches", (512, 32, 32, 144)),
                  ("resnet stem weight", (27, 16)),
                  ("resnet s2 conv weight", (576, 64)),
                  ("resnet head weight", (64, 10))]
    # the LM sweep's f32 QAT (granite-8b, batch 8 x 32): its weights and
    # the activations of a step
    g_d, g_f, g_v = 4096, 14336, 49152
    lm_sweep = [("granite attn.wq/wo", (g_d, g_d)),
                ("granite attn.wk/wv", (g_d, 1024)),
                ("granite mlp.wi/wg", (g_d, g_f)),
                ("granite mlp.wo", (g_f, g_d)),
                ("granite lm_head", (g_d, g_v)),
                ("granite act d_model", (8, 32, g_d)),
                ("granite act d_ff", (8, 32, g_f))]
    # bf16: chaos_train's QAT (granite-8b, batch 2 x 32) and the quant
    # engines' activations (qwen3-8b)
    ct = CHAOS_TRAIN
    chaos_bf16 = [(label.replace("granite", "chaos_train"), shape)
                  for label, shape in lm_sweep[:5]]
    chaos_bf16 += [("chaos_train act d_model", (ct["batch"], ct["seq"], g_d)),
                   ("chaos_train act d_ff", (ct["batch"], ct["seq"], g_f))]
    for path in ("chaos_serve", "chaos_serve long"):
        conf = ENGINE_PATHS[path]
        for step, lead in (("admission", (1, bucket_len(conf))),
                           ("decode", (conf["capacity"], 1))):
            chaos_bf16 += [(f"{path} {step} act d_model", (*lead, d)),
                           (f"{path} {step} act d_ff", (*lead, f))]
    # bf16: phase_moe's quant training (granite-moe-1b-a400m, microbatches
    # of 4 x 128): its expert stacks and their activations at capacity
    # 160, its attention weights, lm_head and the attention's activations
    m_d, m_f, m_e, m_v = 1024, 512, 32, 49408
    moe_bf16 = [("granite-moe expert wi/wg", (m_e, m_d, m_f)),
                ("granite-moe expert wo", (m_e, m_f, m_d)),
                ("granite-moe expert act d_model", (m_e, 160, m_d)),
                ("granite-moe expert act d_ff", (m_e, 160, m_f)),
                ("granite-moe attn.wq/wo", (m_d, m_d)),
                ("granite-moe attn.wk/wv", (m_d, 512)),
                ("granite-moe lm_head", (m_d, m_v)),
                ("granite-moe act d_model", (4, 128, m_d))]
    cases = [(0.25, -8, 7), (0.0371, 0, 255), (1e-9, -8, 7)]
    gen = torch.Generator(device="cuda").manual_seed(3)
    n_cases = 0
    max_err = 0.0
    for dtype, dtype_shapes in ((torch.float32,
                                 shapes + noise_loop + lm_sweep),
                                (torch.bfloat16,
                                 shapes + chaos_bf16 + moe_bf16)):
        for label, shape in dtype_shapes:
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
    print(f"[lsq_quant] {n_cases} cases ({len(shapes)} shapes x 2 dtypes, "
          f"{len(noise_loop)} noise-loop and {len(lm_sweep)} LM-sweep shapes "
          f"in f32, {len(chaos_bf16)} chaos and {len(moe_bf16)} "
          f"granite-moe shapes in bf16, x {len(cases)} step sizes): max "
          f"|kernel - plain| "
          f"{max_err:g} (tolerance 0, bit patterns compared)")
    if max_err != 0.0:
        fail("lsq_quant is not bit-exact with its plain version")

    # the library yardstick multiplies by 1/scale (not the same function);
    # timed in bf16 where the installed torch takes it, else in f32 over
    # the same element count
    timed = {}
    for label, shape in (("lm_head", (d, v)), ("mlp.wi", (d, f))):
        x = (torch.randn(shape, generator=gen, device="cuda") * 0.1).to(
            torch.bfloat16)
        s = torch.tensor(0.0371, device="cuda").to(torch.bfloat16)
        lib_in, lib_dtype, s_f = x, "bf16", float(s)
        try:
            torch.fake_quantize_per_tensor_affine(lib_in, s_f, 0, -8, 7)
        except RuntimeError as e:
            print(f"[lsq_quant] fake_quantize_per_tensor_affine refuses bf16 "
                  f"({str(e).splitlines()[0][:80]}); timed in f32")
            lib_in, lib_dtype = x.float(), "f32"
        t = in_turns("lsq_quant", f"{label} {tuple(shape)} bf16", {
            "plain": lambda: lsq_quant_ref(x, s, -8, 7),
            "kernel": lambda: lq.lsq_quant(x, s, -8, 7),
            "library": lambda: torch.fake_quantize_per_tensor_affine(
                lib_in, s_f, 0, -8, 7)},
            {"plain": 5, "kernel": 20, "library": 20})
        b_ms, b_by = bound_ms(2 * x.numel() * x.element_size(), 0, "bf16")
        timed[label] = dict(ms=t["kernel_ms"], plain_ms=t["plain_ms"],
                            library_ms=t["library_ms"], bound_ms=b_ms,
                            bound_by=b_by)
        print(f"[lsq_quant] {label} {tuple(shape)} bf16: kernel "
              f"{t['kernel_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"torch.fake_quantize_per_tensor_affine ({lib_dtype}) "
              f"{t['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del x, s, lib_in
    rows.append(dict(name="lsq_quant", route="cuda",
                     source="src/repro_torch/csrc/lsq_quant.cu",
                     replaces="src/repro/kernels/lsq_quant/lsq_quant.py:14",
                     max_abs_err=max_err,
                     shape=f"lm_head weight {d} x {v} bf16",
                     **timed["lm_head"]))


# ---------------------------------------------------------------------------
# the design-space engine and the policy solve on the card
# ---------------------------------------------------------------------------
def _golden_check(doc) -> int:
    """The golden fixture through `sweep_batched` and `design_space.evaluate`
    on the card; returns the number of points held."""
    import numpy as np
    from repro_torch.core import design_space as ds
    ns, bits = tuple(doc["ns"]), tuple(doc["bits"])
    points, winners = {}, {}
    for r in doc["records"]:
        k = (r["regime"], r["n"], r["bits"])
        if r["domain"] == "__winner__":
            winners[k] = r["winner"]
        else:
            points[(r["regime"], r["domain"], r["n"], r["bits"])] = r
    regimes = {"exact": ds.sigma_exact(), "relaxed": doc["sigma_relaxed"]}
    held = 0
    for regime, sigma in regimes.items():
        g = ds.sweep_batched(ns=ns, bit_widths=bits, sigma_maxes=(
            None if regime == "exact" else sigma), device="cuda")
        names = g.winner_names()
        for bi, b in enumerate(bits):
            for ni, n in enumerate(ns):
                pts = {d: ds.evaluate(d, n, b, sigma, device="cuda")
                       for d in ds.DOMAINS}
                for di, d in enumerate(g.domains):
                    ref = points[(regime, d, n, b)]
                    ix = (di, bi, ni, 0, 0, 0, 0, 0, 0)
                    got = [(int(g.redundancy[ix]), int(g.tdc_q[ix])),
                           (int(pts[d].redundancy),
                            int(pts[d].aux.get("tdc_lsb_q", 1)))]
                    vals = [(float(getattr(g, f)[ix]), float(getattr(
                        pts[d], f))) for f in ("e_mac", "throughput",
                                               "area_per_mac")]
                    want_f = [ref[f] for f in ("e_mac", "throughput",
                                               "area_per_mac")]
                    if any(rq != (ref["redundancy"], ref["tdc_q"])
                           for rq in got) or not all(
                            np.allclose(v, w, rtol=1e-4, atol=0)
                            for v, w in zip(vals, want_f)):
                        fail(f"golden {regime}/{d}/n={n}/B={b}: (R, q) "
                             f"{got}, e_mac/throughput/area {vals}, fixture "
                             f"{(ref['redundancy'], ref['tdc_q'])} {want_f}")
                    held += 2
                want = winners[(regime, n, b)]
                w_eval = min(pts, key=lambda d: pts[d].e_mac)
                if names[bi, ni, 0, 0, 0, 0, 0, 0] != want or w_eval != want:
                    fail(f"golden {regime} n={n} B={b}: winners "
                         f"{names[bi, ni, 0, 0, 0, 0, 0, 0]} / {w_eval}, "
                         f"fixture {want}")
    return held


def _grid_compare(corner: str, card, cpu) -> int:
    """Card grid against CPU grid: integer fields and winners equal, floats
    within rtol 1e-4.  A point whose integer decision differs fails unless
    its two candidates' e_mac are under 1e-6 apart (relative): a float32
    tie, printed and counted.  Returns the tie count."""
    import numpy as np
    ties, bad = [], []
    for f in ("redundancy", "tdc_q", "l_osc"):
        a, b = getattr(card, f), getattr(cpu, f)
        for ix in map(tuple, np.argwhere(a != b)):
            rel = abs(card.e_mac[ix] - cpu.e_mac[ix]) / abs(cpu.e_mac[ix])
            (ties if rel < 1e-6 else bad).append((f, ix, a[ix], b[ix], rel))
    wa, wb = card.winners(), cpu.winners()
    for ix in map(tuple, np.argwhere(wa != wb)):
        e = cpu.e_mac[(slice(None),) + ix]
        rel = abs(e[wa[ix]] - e[wb[ix]]) / abs(e[wb[ix]])
        (ties if rel < 1e-6 else bad).append(("winner", ix, card.domains[
            wa[ix]], cpu.domains[wb[ix]], rel))
    for t in ties:
        print(f"[design_space] dense/{corner} float32 tie: {t[0]} at "
              f"{t[1]}: card {t[2]}, CPU {t[3]}, candidates' e_mac "
              f"{t[4]:.2e} apart")
    if bad:
        fail(f"dense/{corner}: {len(bad)} integer decisions differ between "
             f"the card and the CPU, first {bad[:5]}")
    worst = {}
    for f in ("e_mac", "throughput", "area_per_mac", "sigma_chain",
              "latency"):
        a, b = getattr(card, f), getattr(cpu, f)
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
        worst[f] = float(rel.max())
        if not worst[f] <= 1e-4:
            fail(f"dense/{corner}: {f} differs by {worst[f]:.2e} relative")
    print(f"[design_space] dense/{corner}, card vs CPU: R, q, l_osc and "
          f"winners equal at {card.n_points} points but {len(ties)} float32 "
          f"ties; worst relative float difference "
          + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))
    return len(ties)


def phase_design_space():
    """The design-space engine on the card: the golden fixture, then the
    dense scenario at tt, ff and ss, each swept on the card and on this
    host's CPU through the same port and compared; the sweep's time
    (host clock to the device sync of its one copy to the host, median of
    3 after a warm-up), its kernel launches (profiled), and the explorer's
    memo hits."""
    import numpy as np
    import torch
    from repro_torch.core import explorer, scenario
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with open(GOLDEN) as f:
        doc = json.load(f)
    t0 = time.monotonic()
    held = _golden_check(doc)
    print(f"[design_space] golden fixture on the card: {held} points through "
          f"sweep_batched and design_space.evaluate, (R, q) and winners "
          f"exact, floats within rtol 1e-4 ({time.monotonic() - t0:.1f} s)")
    sc = scenario.get_scenario("dense")
    ties = 0
    for corner in sc.corners:
        scenario.sweep_scenario(sc, corner, device="cuda")      # warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            card = scenario.sweep_scenario(sc, corner, device="cuda")
            times.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        cpu = scenario.sweep_scenario(sc, corner, device="cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        ms = statistics.median(times)
        print(f"[design_space] dense/{corner}: {card.n_points} points, card "
              f"sweep median {ms:.1f} ms (all {[round(t, 1) for t in times]})"
              f", {card.n_points / ms * 1e3:.3e} points/s; this host's CPU "
              f"{cpu_ms:.1f} ms")
        ties += _grid_compare(corner, card, cpu)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scenario.sweep_scenario(sc, "tt", device="cuda")
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.end - e.time_range.start for e in kernels)
    print(f"[design_space] one dense sweep: {len(kernels)} device launches "
          f"(kernels and copies), {busy / 1e3:.1f} ms of device time; "
          f"float32 ties over the 3 corners: {ties}")
    svc = explorer.ExplorerService()
    g, miss = svc.sweep_info("dense", "tt")
    hits = [svc.sweep_info("dense", "tt")[1]["elapsed_ms"] for _ in range(5)]
    n = np.asarray([64.0, 576.0, 4096.0])
    s = np.asarray([2.0, 0.5, 1.0])
    t0 = time.perf_counter()
    svc.evaluate_td(n, s, bits=4)
    td_miss = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    svc.evaluate_td(n, s, bits=4)
    td_hit = (time.perf_counter() - t0) * 1e3
    print(f"[design_space] explorer: dense/tt miss {miss['elapsed_ms']:.1f} "
          f"ms, repeated query (memo hit) median "
          f"{statistics.median(hits):.4f} ms; evaluate_td of 3 points miss "
          f"{td_miss:.2f} ms, hit {td_hit:.4f} ms; stats "
          f"{svc.stats.snapshot()}")
    if svc.stats.memory_hits != 5 or svc.stats.td_hits != 1:
        fail(f"explorer memo: {svc.stats.snapshot()}")


def phase_policy():
    """`solve_td_policy` on the card at the keys of `POLICY_ROWS`: R and q
    exact, sigma_chain within 1e-6 relative of the reference's."""
    from repro_torch.core import explorer
    from repro_torch.tdsim.policy import solve_td_policy
    explorer.set_service(explorer.ExplorerService())
    for key, (r, sigma, q) in POLICY_ROWS.items():
        pol = solve_td_policy(*key)
        rel = abs(pol.sigma_chain - sigma) / sigma
        print(f"[policy] {key}: R {pol.redundancy}, q {pol.tdc_q}, "
              f"sigma_chain {pol.sigma_chain!r} (reference {sigma!r}, "
              f"{rel:.1e} relative), vdd {pol.vdd}")
        if (pol.redundancy, pol.tdc_q) != (r, q) or not rel <= 1e-6:
            fail(f"policy {key}: (R, q, sigma_chain) "
                 f"{(pol.redundancy, pol.tdc_q, pol.sigma_chain)}, reference "
                 f"{(r, q, sigma)}")
    explorer.set_service(None)


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


def _counts_reset(mods: dict) -> None:
    for m in mods.values():
        m.launches = 0


def serve_expected(cfg, steps: int, admissions: int = 1) -> dict:
    """Launches of a td serve (fixed batch: one admission; an engine: one
    a request): each forward runs the layers' td denses (`layer_denses`:
    7 a dense attention layer, wq, wk, wv, wo and wg, wi, wo, dense or
    over the experts' lanes) and lm_head's (none with tied embeddings), a
    prefill also a stub frontend's adapter; flash_attn once an attention
    layer an admission, decode_gqa once an attention layer a decode step
    (none in a mamba2 or rwkv6 layer).  An enc-dec model's prefill runs the adapter,
    7 a layer of its encoder, 11 a decoder layer (self-attention,
    cross-attention, SwiGLU) and lm_head, each decode step the decoder
    again (the cross-attention's K and V recomputed from the encoder's
    output); flash_attn runs the encoder's and both decoder attentions
    in a prefill and the cross-attention (Sq 1) in each decode step."""
    L = cfg.n_layers
    if cfg.family == "encdec":
        le = cfg.n_enc_layers or L
        return {"td_vmm": admissions * (2 + 7 * le + 11 * L)
                + steps * (11 * L + 1),
                "flash_attn": admissions * (le + 2 * L) + steps * L,
                "decode_gqa": L * steps, "lsq_quant": 0}
    head = 0 if cfg.tie_embeddings else 1
    adapter = admissions if cfg.frontend is not None else 0
    dense, attn = layer_denses(cfg)
    return {"td_vmm": (dense + head) * (admissions + steps) + adapter,
            "flash_attn": attn * admissions, "decode_gqa": attn * steps,
            "lsq_quant": 0}


def layer_denses(cfg) -> tuple[int, int]:
    """(td denses, attention calls) of one forward through a decoder's
    layers: 4 denses at an attention or shared-attention site, 2 in a
    mamba2 mixer, 5 in an rwkv6 time mix; 3 in a SwiGLU, an MoE (a lane
    launch each over its experts) or an RWKV channel mix, none in a
    mixer-only layer."""
    from repro_torch.models.transformer import _ffn_kind
    mix = {"attn": 4, "shared_attn": 4, "mamba2": 2, "rwkv6": 5}
    ffn = {"swiglu": 3, "moe": 3, "rwkv_cm": 3, "none": 0}
    layers = range(cfg.n_layers)
    return (sum(mix[cfg.mixer_at(i)] + ffn[_ffn_kind(cfg, i)]
                for i in layers),
            sum(cfg.mixer_at(i) in ("attn", "shared_attn") for i in layers))


def _serve_full(tag: str, arch, batch: int, prompt_len: int, gen: int,
                launches: dict, syncs: bool = False) -> None:
    """`serve.run` of ``arch`` at full width, its launches counted, its
    times and tokens printed and checked; with ``syncs`` also its host
    syncs a step (`step_syncs`; none allowed).  Returns `serve.run`'s
    stats."""
    import torch
    from repro_torch.launch import serve
    cfg = arch.model
    mods = kernel_modules()
    torch.cuda.reset_peak_memory_stats()
    _counts_reset(mods)
    stats: dict = {}
    t0 = time.monotonic()
    out: dict = {}

    def run():
        out["ids"] = serve.run(arch, batch, prompt_len, gen, seed=0,
                               stats=stats)
    if syncs:
        calib, calls = step_syncs(run)
    else:
        run()
    ids = out["ids"]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = {n: m.launches for n, m in mods.items()}
    print(f"[{tag}] {cfg.name} td, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.hd}, "
          f"batch {batch}, prompt {prompt_len}, gen {gen}: wall {wall:.1f} s "
          f"(init and solve included), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[{tag}] prefill {stats['prefill_ms']:.1f} ms; decode median "
          f"{statistics.median(stats['decode_ms']):.1f} ms/token (all: "
          f"{[round(t, 1) for t in stats['decode_ms']]})")
    if syncs:
        print(f"[{tag}] host syncs (torch's sync debug mode; a calibrating "
              f"blocking copy counts {calib}): prefill {calls['prefill']}, "
              f"each decode step {calls['decode']}")
        if any(calls["prefill"] + calls["decode"]):
            fail(f"{tag}: a serve step waits for the device")
    check_launches(tag, counts, serve_expected(cfg, gen - 1))
    ids = ids.cpu()
    if ids.shape != (batch, gen) or int(ids.min()) < 0 or \
            int(ids.max()) >= cfg.vocab:
        fail(f"{tag}: bad tokens {tuple(ids.shape)} in [{int(ids.min())}, "
             f"{int(ids.max())}]")
    print(f"[{tag}] tokens[0]: {ids[0].tolist()}")
    j = stats["j_per_token"]
    print(f"[{tag}] J/token (the paper's circuit model at the solved "
          f"policy, not a card measurement): td {j['td']:.4e}, analog "
          f"{j['analog']:.4e}, digital {j['digital']:.4e}")
    if not all(math.isfinite(v) and v > 0 for v in j.values()):
        fail(f"{tag}: J/token {j}")
    launches[tag] = counts
    return stats


def phase_serve(launches: dict):
    import repro_torch.configs as cfgs
    from repro_torch.launch import td_cli
    _serve_full("serve", td_cli.apply_td_args(cfgs.get("qwen3-8b"), "td"),
                SERVE["batch"], SERVE["prompt_len"], SERVE["gen"], launches)


def serve_requests(cfg, conf: dict):
    """The traffic ``conf``'s requests (`serve.synthetic_requests`)."""
    from repro_torch.launch import serve
    return serve.synthetic_requests(conf["requests"], conf["prompt_len"],
                                    conf["gen"], cfg.vocab, seed=conf["seed"])


def _sched_run(arch, conf: dict, params, continuous: bool, mods: dict):
    """One run of `ContinuousBatchingEngine` on the traffic ``conf``, after
    one warm-up request; every launch counter is set to 0 just before
    `run()` and read just after.  Returns (engine, summary, counts, peak
    GiB)."""
    import torch
    from repro_torch.launch.scheduler import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(arch, capacity=conf["capacity"],
                                   s_cache=conf["s_cache"],
                                   kv_block=conf["kv_block"], seed=0,
                                   params=params, continuous=continuous)
    eng.warmup()
    reqs = serve_requests(arch.model, conf)
    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.launches = 0
    out = eng.run(reqs)
    torch.cuda.synchronize()
    counts = {n: m.launches for n, m in mods.items()}
    return eng, out, counts, torch.cuda.max_memory_allocated() / 2**30


def _sched_report(path: str, mode: str, eng, out: dict, peak: float):
    """Prints a run's numbers: the summary's, and the medians of the
    engine's own admission and decode-step times (host clock, each ending
    at the step's device sync)."""
    print(f"[{path}] {mode}: capacity {eng.capacity}, slot {eng.s_cache} "
          f"tokens, prompt bucket {eng.prompt_pad}; {out['requests']} "
          f"requests, {out['new_tokens']} new tokens in "
          f"{out['wall_s'] * 1e3:.1f} ms: {out['tokens_per_s']:.2f} "
          f"tokens/s, {eng.steps_run} decode steps, {len(eng.admit_ms)} "
          f"admissions; per-request ms/token p50 "
          f"{out['ms_per_token_p50']:.1f}, p99 {out['ms_per_token_p99']:.1f};"
          f" peak memory {peak:.1f} GiB")
    print(f"[{path}] {mode}: admission (prefill + insert, to the device "
          f"sync) median {statistics.median(eng.admit_ms):.1f} ms, min "
          f"{min(eng.admit_ms):.1f}, max {max(eng.admit_ms):.1f}; decode "
          f"step median {statistics.median(eng.decode_ms):.1f} ms, min "
          f"{min(eng.decode_ms):.1f}, max {max(eng.decode_ms):.1f}")


def _energy_report(path: str, eng, out: dict) -> None:
    """The engine's meter: J/token in the three domains at the engine's
    policy (the paper's circuit model), the per-request rows summing to
    the run total and the total equal to the rate times the tokens, both to
    1e-9 relative."""
    from repro_torch.models import common, matmul_shapes
    from repro_torch.tdsim import energy_meter
    m = eng.meter
    total = out["energy_j_total"]
    rows = sum(r["energy_j"] for r in out["per_request"])
    by_rate = m.e_token * m.run_total_tokens()
    reps = energy_meter.compare_domains(
        matmul_shapes(eng.cfg), common.pol_at(eng.pol, 0),
        sigma_max=eng._meter_sigma(), device="cuda")
    j = {d: r.total_energy_per_token for d, r in reps.items()}
    print(f"[{path}] J/token (the paper's circuit model, not a card "
          f"measurement): td {j['td']:.4e} (meter {m.e_token:.4e}), analog "
          f"{j['analog']:.4e}, digital {j['digital']:.4e}; run total "
          f"{total:.4e} J over {m.run_total_tokens()} tokens, per-request "
          f"rows sum {rows:.4e} J, rate x tokens {by_rate:.4e} J")
    if not (abs(rows - total) <= 1e-9 * abs(total)
            and abs(by_rate - total) <= 1e-9 * abs(total) and total > 0
            and abs(j["td"] - m.e_token) <= 1e-9 * m.e_token):
        fail(f"{path}: energy rows {rows!r}, total {total!r}, rate x tokens "
             f"{by_rate!r}, td J/token {j['td']!r} against {m.e_token!r}")


def phase_scheduler(launches: dict):
    """The continuous-batching path: full-width qwen3-8b in td mode (bf16,
    seeded weights; 36 layers, the serving gate's 4) behind
    `ContinuousBatchingEngine`, on the two traffics of `SCHED_PATHS`, each also through the lockstep baseline
    (``continuous=False``) on the same requests and weights: on
    "scheduler" after the continuous run, on "scheduler_bench" before it.
    Both modes are timed alike, by the engine's own telemetry.  The
    continuous run of each traffic is the path whose launches count: with
    A admissions and D decode steps td_vmm runs (7 L + 1)(A + D) times,
    flash_attn L A, decode_gqa L D."""
    import repro_torch.configs as cfgs
    from repro_torch.launch import td_cli

    full = td_cli.apply_td_args(cfgs.get("qwen3-8b"), "td")
    cfg = full.model
    mods = kernel_modules()
    shared = None                 # the first engine's seeded init, shared
    for path, conf in SCHED_PATHS.items():
        order = (True, False) if path == "scheduler" else (False, True)
        arch, params = full, shared
        if conf.get("layers"):
            # a cut depth: its own seeded init, shared by its two runs
            arch, params = family_arch("qwen3-8b", "td", conf["layers"]), None
            print(f"[{path}] qwen3-8b at full width cut to {conf['layers']} "
                  f"of {cfg.n_layers} layers, continuous and lockstep alike")
        runs = {}
        for continuous in order:
            eng, out, counts, peak = _sched_run(arch, conf, params,
                                                continuous, mods)
            params = eng.params
            if not conf.get("layers"):
                shared = params
            mode = "continuous" if continuous else "lockstep"
            _sched_report(path, mode, eng, out, peak)
            runs[mode] = (eng, out, counts)
        eng, out, counts = runs["continuous"]
        a, d = len(eng.admit_ms), eng.steps_run
        check_launches(path, counts, serve_expected(eng.cfg, d, a))
        toks = [t for r in eng.done.values() for t in r.generated]
        want = {r.rid: r.max_new_tokens for r in serve_requests(cfg, conf)}
        if out["requests"] != conf["requests"] or a != conf["requests"] or \
                any(len(eng.done[r].generated) != n for r, n in want.items()):
            fail(f"{path}: finished {out['requests']} of {conf['requests']} "
                 f"requests in {a} admissions, or cut one short")
        if min(toks) < 0 or max(toks) >= cfg.vocab:
            fail(f"{path}: tokens out of range [{min(toks)}, {max(toks)}]")
        print(f"[{path}] completion order {list(eng.done)[:32]}; request "
              f"0: {eng.done[0].generated}")
        f_eng, f_out, _ = runs["lockstep"]
        print(f"[{path}] lockstep baseline (continuous=False), same requests "
              f"and weights: {f_out['steps']} decode steps against {d} "
              f"continuous, {f_out['tokens_per_s']:.2f} tokens/s against "
              f"{out['tokens_per_s']:.2f}")
        if f_out["new_tokens"] != out["new_tokens"] or f_out["steps"] < d:
            fail(f"{path}: lockstep baseline gave other tokens, or fewer "
                 "steps than continuous batching")
        if path == "scheduler_bench" and not d < f_out["steps"]:
            # the reference's serving gate: slot recycling saves steps
            fail(f"{path}: continuous batching ran {d} decode steps, "
                 f"lockstep {f_out['steps']}")
        _energy_report(path, eng, out)
        launches[path] = counts
        del runs, eng, f_eng


def phase_scheduler_scenario(launches: dict):
    """One more run of the continuous-batching engine at full width
    (qwen3-8b, 36 layers, SCHED's 16 requests): per-layer budgets
    (`--td-per-layer` cycling through SCENARIO_RUN["per_layer"]) at the
    vdd-opt scenario's ss corner, each layer at its own solved operating
    point.  Launches as in `phase_scheduler`."""
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.launch import td_cli

    base = cfgs.get("qwen3-8b")
    L = base.model.n_layers
    spec = ",".join((SCENARIO_RUN["per_layer"] * L)[:L])
    arch = td_cli.apply_td_args(base, "td", spec, SCENARIO_RUN["scenario"],
                                SCENARIO_RUN["corner"])
    t0 = time.monotonic()
    eng, out, counts, peak = _sched_run(arch, SCHED, None, True,
                                        kernel_modules())
    print(f"[scheduler_scenario] qwen3-8b td, --td-per-layer "
          f"{','.join(SCENARIO_RUN['per_layer'])} (cycled over {L} layers), "
          f"--scenario {SCENARIO_RUN['scenario']} --corner "
          f"{SCENARIO_RUN['corner']}: wall {time.monotonic() - t0:.1f} s "
          f"(init and solve included)")
    points = {}
    for i, p in enumerate(eng.pol.layers):
        key = (p.redundancy, p.tdc_q, p.sigma_chain, p.vdd, p.sigma_max)
        points.setdefault(key, []).append(i)
    for (r, q, sigma, vdd, budget), layers in points.items():
        print(f"[scheduler_scenario] layers {layers[:4]}.. ({len(layers)}): "
              f"budget {budget}, R {r}, q {q}, sigma_chain {sigma:.6g}, "
              f"vdd {vdd}")
    top = eng.pol.top
    print(f"[scheduler_scenario] lm_head: R {top.redundancy}, q {top.tdc_q}, "
          f"sigma_chain {top.sigma_chain:.6g}, vdd {top.vdd}, library "
          f"{top.techlib.name}")
    if len(points) != len(SCENARIO_RUN["per_layer"]):
        fail(f"scheduler_scenario: {len(points)} distinct layer operating "
             f"points, expected {len(SCENARIO_RUN['per_layer'])}")
    _sched_report("scheduler_scenario", "continuous", eng, out, peak)
    a, d = len(eng.admit_ms), eng.steps_run
    check_launches("scheduler_scenario", counts,
                   serve_expected(eng.cfg, d, a))
    toks = [t for r in eng.done.values() for t in r.generated]
    if out["requests"] != SCHED["requests"] or min(toks) < 0 or \
            max(toks) >= arch.model.vocab:
        fail(f"scheduler_scenario: {out['requests']} requests, tokens in "
             f"[{min(toks)}, {max(toks)}]")
    _energy_report("scheduler_scenario", eng, out)
    launches["scheduler_scenario"] = counts
    del eng
    torch.cuda.empty_cache()


def family_arch(name: str, mode: str | None, n_layers: int | None = None):
    """``name`` at its published widths and train settings in ``--td
    mode`` (None: the config's), cut to ``n_layers`` layers when given
    (train: qwen3-8b cut to TRAIN["layers"])."""
    import repro_torch.configs as cfgs
    from repro_torch.launch import td_cli
    arch = cfgs.get(name)
    if n_layers is not None:
        arch = arch.replace(model=cut_layers(arch.model, n_layers))
    return td_cli.apply_td_args(arch, mode)




def train_expected(cfg, n_micro: int, mode: str,
                   remat: str = "full") -> dict:
    """Launches of one train step: per microbatch the forward runs every
    dense (`layer_denses`, + lm_head; an MoE layer's wg, wi and wo are one
    lane launch each over its experts) and, under remat "full" or "dots",
    each layer's denses and its attention again in the backward (neither is
    a matmul "dots" keeps); a td dense's STE backward runs lsq_quant on x
    and w, a quant dense runs it in each forward.  A stub frontend's
    adapter and lm_head run outside the layers (never rerun); an enc-dec
    model has 7 denses and one attention an encoder layer, 11 and two a
    decoder layer, and the adapter."""
    if cfg.family == "encdec":
        le = cfg.n_enc_layers or cfg.n_layers
        in_layers = 7 * le + 11 * cfg.n_layers
        dense = in_layers + 2
        attn = le + 2 * cfg.n_layers
    else:
        in_layers, attn = layer_denses(cfg)
        dense = in_layers + (0 if cfg.tie_embeddings else 1) + (
            cfg.frontend is not None)
    rerun = in_layers if remat in ("full", "dots") else 0
    out = {"flash_attn": n_micro * (2 if rerun else 1) * attn,
           "decode_gqa": 0}
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
        arch = family_arch("qwen3-8b", mode, TRAIN["layers"])
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


# ---------------------------------------------------------------------------
# The paper's noise loop (Fig. 10 -> Fig. 11) on full-width ResNet20-CIFAR:
# quant-mode training as `benchmarks/bench_noise_tolerance._train_resnet`
# (512 synthetic images, 150 SGD steps at lr 0.05), the per-site batched
# sigma_max search over its 22 sites (chunk 13: one layer's 12 noisy
# probes and its clean one), the site-0 scalar check and the bench's
# timing gate, the network-level sweep and the per-site policy solve.
NOISE_LOOP = dict(train_images=512, eval_images=512, steps=150, lr=0.05,
                  sigmas=(0.25, 0.5, 1.0, 2.0, 4.0, 8.0), n_repeats=2,
                  chunk=13, seed=0, n_chain=576, mc_draws=10**6)
# the lane kernel's checks at 13 lanes, shared w, (label, M, K, N): the
# path's own launches over the 512 eval images, the stem, the stage-2
# conv2 and the head (all on the block route)
LANE_CHECKS = [("stem", 512 * 32 * 32, 27, 16),
               ("s2 conv2", 512 * 8 * 8, 576, 64), ("head", 512, 64, 10)]


def _lane_check(tv, label, x, w, params, seed, kw, want=None,
                tag="noise_loop") -> float:
    """A lane launch against its plain version (``want``, computed when
    None) and against one single-lane launch a lane: bit for bit, noise
    included.  Returns max |kernel - plain| (0)."""
    import torch
    got = tv.td_vmm(x, w, params, seed, **kw)
    if want is None:
        want = tv.td_vmm_plain(x, w, params, seed, **kw)
    singles = torch.stack([
        tv.td_vmm(x[p], w[p] if w.dim() == 3 else w, params[p],
                  seed[p:p + 1], **kw) for p in range(x.shape[0])])
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    plan = tv.td_vmm_plan(x.shape[1], x.shape[2], w.shape[-1], kw["n_chain"],
                          kw["bits_a"])
    w_kind = "per lane" if w.dim() == 3 else "shared"
    print(f"[{tag}] lanes {label}: P={x.shape[0]} M={x.shape[1]} "
          f"K={x.shape[2]} N={w.shape[-1]} w {w_kind} "
          f"bits {kw['bits_a']}/{kw['bits_w']}, route {plan.route}: max "
          f"|kernel - plain| {err:g}, lanes == single launches "
          f"{torch.equal(got, singles)}")
    if not (_bits_equal(got, want) and _bits_equal(got, singles)):
        fail(f"td_vmm lanes ({label}) differ from the plain version or the "
             f"single-lane launches")
    return err


def phase_noise_loop(launches: dict, rows: list):
    """The noise loop's main path (counted), then td_vmm's lane axis
    against its plain version and single-lane launches at the path's
    shapes, timed at the stage-0 conv2 at full lanes, and
    `simulate_chain_errors` on the card against `chain_stats`."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs import resnet20_cifar
    from repro_torch.core import chain
    from repro_torch.core import noise_tolerance as nt
    from repro_torch.models import resnet
    from repro_torch.optim.adamw import tree_leaves_with_path
    from repro_torch.tdsim import td_linear
    from repro_torch.tdsim.policy import TDPolicy, solve_network_policies
    from repro_torch.kernels.td_vmm import ref as td_ref

    cfg, conf, dev = resnet20_cifar.CONFIG, NOISE_LOOP, "cuda"
    sites = resnet.noise_sites(cfg)
    n_sites = len(sites)
    n_chain = 9 * max(cfg.stages)
    if (n_chain, n_sites) != (conf["n_chain"], 22):
        fail(f"resnet20-cifar: n_chain {n_chain}, {n_sites} sites")
    sigmas, reps, chunk = conf["sigmas"], conf["n_repeats"], conf["chunk"]
    per = len(sigmas) * reps + 1
    key = prng.key(conf["seed"])
    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    t_phase = time.monotonic()

    # 1. init and data
    pol_q = TDPolicy(mode="quant", bits_a=4, bits_w=4)
    gen = torch.Generator(device=dev).manual_seed(conf["seed"])
    params = resnet.init_params(gen, cfg, pol_q, device=dev)
    imgs, labels = resnet.make_synthetic_cifar(gen, conf["train_images"],
                                               cfg)
    eval_gen = torch.Generator(device=dev).manual_seed(
        prng.fold_in(key, 999)[1])
    eval_imgs, eval_labels = resnet.make_synthetic_cifar(
        eval_gen, conf["eval_images"], cfg)

    # 2. quant-mode training, plain SGD
    leaves = [t for _, t in tree_leaves_with_path(params)]
    for t in leaves:
        t.requires_grad_(True)
    onehot = torch.nn.functional.one_hot(labels, cfg.classes).float()
    losses, step_ms = [], []
    for _ in range(conf["steps"]):
        t0 = time.perf_counter()
        logits = resnet.forward(params, imgs, cfg, pol_q)
        loss = -(torch.log_softmax(logits, -1) * onehot).sum(-1).mean()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t -= conf["lr"] * g
        losses.append(float(loss.detach()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    for t in leaves:
        t.requires_grad_(False)
    with torch.no_grad():
        train_acc = float((resnet.forward(params, imgs, cfg, pol_q).argmax(-1)
                           == labels).float().mean())
    print(f"[noise_loop] resnet20-cifar stages {cfg.stages}, "
          f"{cfg.blocks_per_stage} blocks a stage, {cfg.img}x{cfg.img}, "
          f"{n_sites} sites, n_chain {n_chain}: quant 4/4 training, "
          f"{conf['steps']} SGD steps at lr {conf['lr']} on "
          f"{conf['train_images']} images: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, train accuracy {train_acc:.4f}, step ms "
          f"median {statistics.median(step_ms):.2f} (first "
          f"{step_ms[0]:.1f})")
    # trained: finite losses that fell, accuracy well above chance
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0] or train_acc < 2.0 / cfg.classes:
        fail(f"noise loop training: losses {losses[0]} -> {losses[-1]}, "
             f"train accuracy {train_acc}")

    # 3. the per-site batched search
    base = TDPolicy(mode="td", bits_a=4, bits_w=4, n_chain=n_chain,
                    sigma_chain=0.0, tdc_q=1)

    def site_eval(sv, keys):
        logits = resnet.forward_lanes(params, eval_imgs, cfg, base, sv, keys)
        return (logits.argmax(-1) == eval_labels).float().mean(-1)

    def scalar_site0(s, k):
        pols = [base.replace(sigma_chain=s if i == 0 else 0.0)
                for i in range(n_sites)]
        with torch.no_grad():
            logits = resnet.forward(params, eval_imgs, cfg, pols, k)
        return float((logits.argmax(-1) == eval_labels).float().mean())

    # warm-up: one chunk noisy at every site, one single pass
    warm = site_eval(torch.ones(chunk, n_sites, device=dev),
                     prng.split(key, chunk))
    scalar_site0(1.0, key)
    torch.cuda.synchronize()
    del warm
    tv = mods["td_vmm"]
    n0 = tv.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = nt.find_sigma_max_batched(site_eval, sigmas, key, n_layers=n_sites,
                                    n_repeats=reps, chunk_size=chunk,
                                    device=dev)
    torch.cuda.synchronize()
    t_batched = time.perf_counter() - t0
    search_launches = tv.launches - n0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_chunks = -(-n_sites * per // chunk)
    print(f"[noise_loop] per-site search: {res.n_evals} probes in "
          f"{n_chunks} chunks of {chunk}, {n_sites} sites x sigmas "
          f"{list(sigmas)} x {reps} repeats (+ clean), "
          f"{conf['eval_images']} eval images: wall {t_batched:.3f} s, "
          f"td_vmm launches {search_launches}, peak memory {peak:.2f} GiB")
    print(f"[noise_loop] acc_clean per site {res.acc_clean.tolist()}")
    for i, site in enumerate(sites):
        print(f"[noise_loop] sigma_max {site}: {res.sigma_max[i]:.4f} "
              f"(rel_drop {np.round(res.rel_drop[i], 4).tolist()})")
    if search_launches != n_sites * n_chunks or n_chunks != 22:
        fail(f"per-site search: {search_launches} td_vmm launches in "
             f"{n_chunks} chunks, expected {n_sites} x 22")
    if not np.isfinite(res.sigma_max).all() or \
            res.acc_clean.min() < 2.0 / cfg.classes:
        fail(f"per-site search: sigma_max {res.sigma_max}, acc_clean "
             f"{res.acc_clean}")

    # 4. the scalar search of site 0 and the bench's two gates
    t0 = time.perf_counter()
    res0 = nt.find_sigma_max(scalar_site0, sigmas, prng.fold_in(key, 0),
                             n_repeats=reps)
    t_scalar = time.perf_counter() - t0
    gaps = np.diff(np.asarray(sigmas, np.float64))
    cell = int(np.clip(np.searchsorted(sigmas, res0.sigma_max) - 1, 0,
                       len(gaps) - 1))
    d0 = abs(res0.sigma_max - float(res.sigma_max[0]))
    print(f"[noise_loop] site 0 scalar: sigma_max {res0.sigma_max:.4f} "
          f"against batched {res.sigma_max[0]:.4f} (|diff| {d0:.3g}, grid "
          f"step {gaps[cell]:g}); rel_drop equal "
          f"{np.array_equal(res0.rel_drop, res.rel_drop[0])}; wall "
          f"{t_scalar:.3f} s for {per} evals, x {n_sites} sites = "
          f"{t_scalar * n_sites:.3f} s against batched {t_batched:.3f} s "
          f"({t_scalar * n_sites / t_batched:.2f}x)")
    if d0 > float(gaps[cell]) + 1e-6:
        fail(f"site 0 scalar/batched sigma_max diverge: {d0} > "
             f"{gaps[cell]}")
    # stricter than the bench: a lane pass is the single pass bit for bit
    if not (np.array_equal(res0.rel_drop, res.rel_drop[0])
            and res0.acc_clean == res.acc_clean[0]):
        fail("site 0: the scalar search's accuracies differ from the "
             "batched search's")
    if not t_batched < t_scalar * n_sites:
        fail(f"batched {t_batched:.3f} s not faster than scalar "
             f"{t_scalar * n_sites:.3f} s ({n_sites} sites)")

    # 5. the network-level sweep (Fig. 10b): noise at every site
    def net_eval(sv, keys):
        return site_eval(sv.expand(-1, n_sites), keys)

    t0 = time.perf_counter()
    net = nt.find_sigma_max_batched(net_eval, sigmas, key, n_layers=1,
                                    n_repeats=reps, chunk_size=chunk,
                                    device=dev).layer(0)
    t_net = time.perf_counter() - t0
    print(f"[noise_loop] network sweep (Fig. 10b): acc_clean "
          f"{net.acc_clean:.4f}, rel_drop "
          + ", ".join(f"{s:g}: {d:.4f}" for s, d in zip(net.sigmas,
                                                        net.rel_drop))
          + f"; sigma_max {net.sigma_max:.4f}; wall {t_net:.3f} s")

    # 6. the per-site policies (Fig. 11), solved on the card, evaluated
    t0 = time.perf_counter()
    solved = solve_network_policies(res.sigma_max, bits_a=4, bits_w=4,
                                    n_chain=n_chain, device=dev)
    t_solve = time.perf_counter() - t0
    for site, sm, pol in zip(sites, res.sigma_max, solved.layers):
        print(f"[noise_loop] policy {site}: sigma_max {sm:.4f} -> R "
              f"{pol.redundancy}, q {pol.tdc_q}, sigma_chain "
              f"{pol.sigma_chain:.6f}")
    with torch.no_grad():
        logits = resnet.forward(params, eval_imgs, cfg, list(solved.layers),
                                prng.fold_in(key, 4242))
    acc_solved = float((logits.argmax(-1) == eval_labels).float().mean())
    torch.cuda.synchronize()
    wall = time.monotonic() - t_phase
    print(f"[noise_loop] solve {t_solve * 1e3:.1f} ms on the card; eval "
          f"accuracy at the solved policies {acc_solved:.4f} (clean "
          f"{net.acc_clean:.4f}); the path's wall {wall:.1f} s")
    counts = {n: m.launches for n, m in mods.items()}
    # warm-up 2 passes, search, scalar (per evals), network (1 chunk),
    # solved eval: 22 td_vmm launches a pass; training: 2 lsq_quant a site
    # a forward, 150 steps and the accuracy pass
    expected = {"td_vmm": n_sites * (2 + n_chunks + per + 1 + 1),
                "lsq_quant": 2 * n_sites * (conf["steps"] + 1),
                "flash_attn": 0, "decode_gqa": 0}
    check_launches("noise_loop", counts, expected)
    if not math.isfinite(acc_solved) or not math.isfinite(net.sigma_max):
        fail(f"noise loop: accuracy {acc_solved}, sigma_max {net.sigma_max}")
    launches["noise_loop"] = counts
    del params, imgs, eval_imgs, leaves, grads, logits
    torch.cuda.empty_cache()

    # 7. the lane kernel against its plain version and single launches
    cgen = torch.Generator(device=dev).manual_seed(7)
    pol_s = (1.9179178476333618, 2.0)                # solve_td_policy 2.0
    max_err = 0.0
    for bits_a, bits_w in ((4, 4), (8, 8)):
        kw = dict(bits_a=bits_a, bits_w=bits_w, n_chain=n_chain)
        for label, m, k, n in LANE_CHECKS:
            p_l = chunk
            x = _codes(cgen, (p_l, m, k), bits_a)
            w = _codes(cgen, (k, n), bits_w)
            par = torch.tensor([[pol_s[0] * (i % 3) / 2, 1.0 + i % 2]
                                for i in range(p_l)], device=dev)
            # a column of a wider table, as forward_lanes passes them
            seed = torch.randint(0, 2**32, (p_l, 3), generator=cgen,
                                 device=dev, dtype=torch.int64)[:, 1]
            max_err = max(max_err, _lane_check(tv, label, x, w, par, seed,
                                               kw))
        # the split route: 4 lanes of M 4, K 1000 (2 segments), w a lane
        x = _codes(cgen, (4, 4, 1000), bits_a)
        w = _codes(cgen, (4, 1000, 96), bits_w)
        par = torch.tensor([[0.7, 1.0], [pol_s[0], 2.0], [0.0, 1.0],
                            [2.5, 3.0]], device=dev)
        seed = torch.tensor([3, 0x9E3779B9, 77, 2**32 - 1],
                            dtype=torch.int64, device=dev)
        max_err = max(max_err, _lane_check(tv, "split", x, w, par, seed, kw))
    # the head through linear_lanes (bias) against one td_matmul a lane
    hx = torch.randn((chunk, conf["eval_images"], 64), generator=cgen,
                     device=dev)
    hp = {"w": 0.1 * torch.randn((64, 10), generator=cgen, device=dev),
          "b": torch.randn(10, generator=cgen, device=dev),
          "s_a": torch.tensor(0.3, device=dev),
          "s_w": torch.tensor(0.02, device=dev)}
    hsig = torch.linspace(0.0, 4.0, chunk, device=dev)
    hq = torch.ones(chunk, device=dev)
    keys = prng.split(key, chunk)
    hseed = torch.tensor([td_ref.derive_seed(kk) for kk in keys],
                         device=dev)
    got = td_linear.linear_lanes(hp, hx, base, hsig, hq, hseed)
    singles = torch.stack([td_linear.linear(
        hp, hx[i], base.replace(sigma_chain=float(hsig[i])), keys[i])
        for i in range(chunk)])
    if not _bits_equal(got, singles):
        fail("linear_lanes (head, bias) differs from single td_matmuls")
    print("[noise_loop] head linear_lanes (bias) == one td_matmul a lane")

    # the stage-0 conv2 at full lanes, timed in turns, then held bit for
    # bit against the first timed plain call's output
    m0 = conf["eval_images"] * cfg.img ** 2
    k0, n0_ = 9 * cfg.stages[0], cfg.stages[0]
    kw = dict(bits_a=4, bits_w=4, n_chain=n_chain)
    x = _codes(cgen, (chunk, m0, k0), 4)
    w = _codes(cgen, (k0, n0_), 4)
    par = torch.tensor([[pol_s[0], 2.0]] * chunk, device=dev)
    seed = torch.arange(chunk, dtype=torch.int64, device=dev) + 11
    print(f"[noise_loop] card before timing: {gpu_state()}")
    plain_out = []

    def plain_ms():
        """One call of the plain version between an event pair: it
        allocates gigabytes a lane, so the host, not a spin, paces it."""
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = tv.td_vmm_plain(x, w, par, seed, **kw)
        b.record()
        torch.cuda.synchronize()
        if not plain_out:
            plain_out.append(out)
        return a.elapsed_time(b)

    plain = [plain_ms()]
    t = in_turns("noise_loop", f"stage-0 conv2 lanes {chunk} x M {m0} K "
                 f"{k0} N {n0_}", {
                     "kernel": lambda: tv.td_vmm(x, w, par, seed, **kw),
                     "singles": lambda: [tv.td_vmm(x[i], w, par[i],
                                                   seed[i:i + 1], **kw)
                                         for i in range(chunk)]},
                 {"kernel": 5, "singles": 5})
    plain.append(plain_ms())
    t["plain_ms"] = statistics.median(plain)
    b_ms, b_by = bound_ms(4 * (chunk * m0 * k0 + k0 * n0_ + chunk * m0 * n0_)
                          + 8 * chunk + 8 * chunk,
                          2 * chunk * m0 * k0 * n0_ * 4, "int8")
    print(f"[noise_loop] stage-0 conv2 lanes: kernel {t['kernel_ms']:.4f} ms,"
          f" {chunk} single launches {t['singles_ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms (event pair, before and after: "
          f"{plain[0]:.4f}, {plain[1]:.4f}), bound {b_ms:.4f} ms ({b_by}), "
          f"kernel at {b_ms / t['kernel_ms']:.1%} of it")
    max_err = max(max_err, _lane_check(tv, "stage-0 conv2", x, w, par, seed,
                                       kw, want=plain_out[0]))
    rows.append(dict(name="td_vmm", route="cuda",
                     source="src/repro_torch/csrc/td_vmm.cu",
                     replaces="src/repro/kernels/td_vmm/td_vmm.py:110",
                     max_abs_err=max_err, library_ms=None, ms=t["kernel_ms"],
                     plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                     shape=f"noise_loop stage-0 conv2, lanes {chunk} x M "
                           f"{m0} K {k0} N {n0_} bits 4/4, shared w",
                     timed={"singles_ms": t["singles_ms"]}))
    del x, w, plain_out
    torch.cuda.empty_cache()

    # 8. the Monte-Carlo chain check on the card
    n_mc, n = conf["mc_draws"], n_chain
    mu_a, sig_a = (float(v) for v in chain.chain_stats(
        float(n), chain.cell_stats(4, 2.0)))
    mgen = torch.Generator(device=dev).manual_seed(1)
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    errs = chain.simulate_chain_errors(mgen, n, 4, 2.0, n_mc, device=dev)
    b.record()
    torch.cuda.synchronize()
    mu_e, sig_e = float(errs.mean()), float(errs.std())
    print(f"[noise_loop] simulate_chain_errors n {n}, bits 4, R 2, n_mc "
          f"{n_mc}: {a.elapsed_time(b):.2f} ms; mean {mu_e:.6f} (chain_stats "
          f"{mu_a:.6f}), std {sig_e:.6f} ({sig_a:.6f})")
    if abs(mu_e - mu_a) >= 5 * sig_a / math.sqrt(n_mc) or \
            abs(sig_e - sig_a) / sig_a >= 0.05:
        fail("simulate_chain_errors disagrees with chain_stats")


# ---------------------------------------------------------------------------
# TD attention (`tdsim/td_attention.py`) on full-width qwen3-8b: serve at
# SERVE's settings, 36 layers, with --td td --td-attn td and then quant;
# train at TRAIN's settings and cut with --td-attn td.  QK^T and PV are two
# td_vmm lane calls a layer a step over B * Hq lanes, one w a lane; neither
# flash_attn nor decode_gqa runs.  The lane calls at the path's own shapes
# (label, lanes, M, K, N): prefill over the whole 144-token cache, decode
# one query row, training's microbatch of 1 x 128 without a cache.
TD_ATTN_LANES = [("prefill QK^T", 128, 128, 128, 144),
                 ("prefill PV", 128, 128, 144, 128),
                 ("decode QK^T", 128, 1, 128, 144),
                 ("decode PV", 128, 1, 144, 128),
                 ("train QK^T", 32, 128, 128, 128),
                 ("train PV", 32, 128, 128, 128)]
TD_ATTN_TIMED = ("prefill QK^T", "prefill PV", "decode QK^T", "decode PV")
# `benchmarks/bench_attention._td_sigma_smoke` at qwen3-8b's head widths
TD_ATTN_BENCH = dict(batch=2, seq=128, sigmas=(0.0, 1.0, 4.0), max_err=0.05)


def _attn_lane_params(pols, lanes: int, hetero: bool):
    """(lanes, 2) float32 [sigma, q] of lane b * Hq + h: head h's solved
    policy, or with ``hetero`` a sigma and q that differ from head to
    head (0 on every fourth head)."""
    import torch
    hq = len(pols)
    rows = []
    for lane in range(lanes):
        h = lane % hq
        if hetero:
            rows.append([0.5 * (h % 4) * (1 + h // 8), 1.0 + h % 3])
        else:
            rows.append([pols[h].sigma_chain, float(pols[h].tdc_q)])
    return torch.tensor(rows, dtype=torch.float32, device="cuda")


def _attn_lane_seeds(lanes: int, salt: int = 0):
    """Contiguous lane seeds as td_attention derives them: hash32(seed ^
    lane ^ salt), seed = derive_seed((0, 0))."""
    import torch
    from repro_torch.kernels.td_vmm import ref as td_ref
    lane = torch.arange(lanes, dtype=torch.int64, device="cuda")
    return td_ref.hash32(lane ^ td_ref.derive_seed((0, 0)) ^ salt)


def phase_td_attention(launches: dict, rows: list):
    """TD attention's main paths (serve twice, train), each counted; then
    its lane calls against the plain version and single launches at the
    paths' shapes, timed; the reference bench's sigma check and a clean
    head beside a noisy one at full head widths; the STE gradient against
    the clean-attention gradient; the smoke model's td-attention serve on
    the card against the CPU."""
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.configs.base import ShapeCfg, TDExecCfg, TrainCfg
    from repro_torch.kernels.flash_attn.ops import _masked_attn, \
        flash_attention
    from repro_torch.launch import serve, steps, td_cli, train
    from repro_torch.models import common, get_api
    from repro_torch.tdsim.policy import NetworkPolicy, TDPolicy
    from repro_torch.tdsim.td_attention import td_attention

    mods = kernel_modules()
    tv = mods["td_vmm"]
    t_phase = time.monotonic()
    heads = None

    # 1. serve, 36 layers: --td-attn td, then quant
    for mode in ("td", "quant"):
        arch = td_cli.apply_td_args(cfgs.get("qwen3-8b"), "td",
                                    td_attn=mode)
        cfg = arch.model
        pols = common.resolve_arch_policy(arch, device="cuda").attn
        heads = heads or pols
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for m in mods.values():
            m.launches = 0
        stats: dict = {}
        t0 = time.monotonic()
        ids = serve.run(arch, SERVE["batch"], SERVE["prompt_len"],
                        SERVE["gen"], seed=0, stats=stats)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = {n: m.launches for n, m in mods.items()}
        path = f"serve_td_attn_{mode}"
        p0 = pols[0]
        print(f"[td_attention] serve qwen3-8b --td td --td-attn {mode}, "
              f"{cfg.n_layers} layers, batch {SERVE['batch']}, prompt "
              f"{SERVE['prompt_len']}, gen {SERVE['gen']}: wall {wall:.1f} "
              f"s (init included), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; head "
              f"policy ({len(pols)} heads, all equal "
              f"{all(p == p0 for p in pols)}): mode {p0.mode}, bits "
              f"{p0.bits_a}/{p0.bits_w}, n_chain {p0.n_chain}, R "
              f"{p0.redundancy}, q {p0.tdc_q}, sigma_chain "
              f"{p0.sigma_chain!r}")
        print(f"[td_attention] serve {mode}: prefill "
              f"{stats['prefill_ms']:.1f} ms; decode median "
              f"{statistics.median(stats['decode_ms']):.1f} ms/token (all: "
              f"{[round(t, 1) for t in stats['decode_ms']]})")
        ids_cpu = ids.cpu()
        print(f"[td_attention] serve {mode}: tokens[0] "
              f"{ids_cpu[0].tolist()}")
        # every step (prefill and gen - 1 decodes): 7 denses a layer,
        # lm_head, and QK^T and PV a layer
        check_launches(path, counts, {
            "td_vmm": (9 * cfg.n_layers + 1) * SERVE["gen"],
            "flash_attn": 0, "decode_gqa": 0, "lsq_quant": 0})
        if ids_cpu.shape != (SERVE["batch"], SERVE["gen"]) or \
                int(ids_cpu.min()) < 0 or int(ids_cpu.max()) >= cfg.vocab:
            fail(f"serve td-attn {mode}: bad tokens {ids_cpu.shape}")
        launches[path] = counts
        del ids

    # 2. train, 4 layers, --td-attn td
    shape = ShapeCfg("cli", TRAIN["seq"], TRAIN["batch"], "train")
    arch = td_cli.apply_td_args(
        family_arch("qwen3-8b", "td", TRAIN["layers"]), None, td_attn="td")
    cfg = arch.model
    n_micro = arch.microbatches_for(shape.name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.launches = 0
    stats = {}
    t0 = time.monotonic()
    _, losses = train.run(arch, shape, TRAIN["td_steps"], None, log_every=1,
                          seed=0, stats=stats)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = {n: m.launches for n, m in mods.items()}
    step_ms = [round(t * 1e3, 1) for t in stats["step_s"]]
    print(f"[td_attention] train qwen3-8b --td td --td-attn td, "
          f"{cfg.n_layers} layers, batch {shape.global_batch} x "
          f"{shape.seq_len} in {n_micro} microbatches, remat "
          f"{arch.train.remat}: wall {wall:.1f} s (init included), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; step "
          f"ms {step_ms}, median after the first "
          f"{statistics.median(step_ms[1:]):.1f} ms; losses {losses}; grad "
          f"norms {stats['grad_norm']}")
    per_step = train_expected(cfg, n_micro, "td")
    # attention: QK^T and PV in the forward and again in remat's rerun
    per_step.update(td_vmm=per_step["td_vmm"] + n_micro * 4 * cfg.n_layers,
                    flash_attn=0)
    check_launches("train_td_attn", counts,
                   {n: c * TRAIN["td_steps"] for n, c in per_step.items()})
    if len(losses) != TRAIN["td_steps"] or not all(
            math.isfinite(x) for x in losses + stats["grad_norm"]):
        fail(f"train td-attn: losses {losses}, grad norms "
             f"{stats['grad_norm']}")
    launches["train_td_attn"] = counts
    torch.cuda.empty_cache()

    # 3. the STE gradient is the clean-attention gradient, at one layer's
    # shapes in training (microbatch 1 x 128, bf16)
    gen = torch.Generator(device="cuda").manual_seed(3)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sq = TRAIN["seq"]
    qkv = [torch.randn((1, sq, h, hd), generator=gen, device="cuda").to(
        torch.bfloat16) for h in (hq, hkv, hkv)]
    g = torch.randn((1, sq, hq, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    kv_len = torch.full((1,), sq, dtype=torch.int32, device="cuda")
    q_off = torch.zeros((1,), dtype=torch.int32, device="cuda")
    grads = []
    for fn in (lambda a, b, c: td_attention(a, b, c, heads, (5, 6),
                                            causal=True),
               lambda a, b, c: _masked_attn(a, b, c, kv_len, q_off, True)):
        leaves = [t.clone().requires_grad_() for t in qkv]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    same = all(_bits_equal(a, b) for a, b in zip(*grads))
    print(f"[td_attention] STE gradient at B 1, S {sq}, {hq}/{hkv} heads "
          f"of {hd}, bf16: equal to the clean-attention gradient bit for "
          f"bit {same}")
    if not same:
        fail("td_attention's gradient differs from the clean attention's")

    # 4. the lane calls at the paths' shapes: kernel = plain = singles
    kw = dict(bits_a=heads[0].bits_a, bits_w=heads[0].bits_w,
              n_chain=heads[0].n_chain)
    max_err = 0.0
    for label, lanes, m, k, n in TD_ATTN_LANES:
        x = _codes(gen, (lanes, m, k), kw["bits_a"])
        w = _codes(gen, (lanes, k, n), kw["bits_w"])
        seed = _attn_lane_seeds(lanes)
        for hetero in (False, True):
            par = _attn_lane_params(heads, lanes, hetero)
            which = "heterogeneous heads" if hetero else "solved heads"
            max_err = max(max_err, _lane_check(
                tv, f"{label}, {which}", x, w, par, seed, kw,
                tag="td_attention"))

    # 5. the prefill and decode lane calls timed: kernel, 128 single
    # launches, plain (an event pair: its launches pace it)
    print(f"[td_attention] card before timing: {gpu_state()}")
    for label, lanes, m, k, n in TD_ATTN_LANES:
        if label not in TD_ATTN_TIMED:
            continue
        x = _codes(gen, (lanes, m, k), kw["bits_a"])
        w = _codes(gen, (lanes, k, n), kw["bits_w"])
        seed = _attn_lane_seeds(lanes)
        par = _attn_lane_params(heads, lanes, False)

        def plain_ms():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            tv.td_vmm_plain(x, w, par, seed, **kw)
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b)

        plain = [plain_ms()]
        t = in_turns("td_attention", f"{label} lanes {lanes} x M {m} K {k} "
                     f"N {n}", {
                         "kernel": lambda: tv.td_vmm(x, w, par, seed, **kw),
                         "singles": lambda: [
                             tv.td_vmm(x[i], w[i], par[i], seed[i:i + 1],
                                       **kw) for i in range(lanes)]},
                     {"kernel": 20, "singles": 5})
        plain.append(plain_ms())
        t["plain_ms"] = statistics.median(plain)
        b_ms, b_by = bound_ms(
            4 * lanes * (m * k + k * n + m * n) + 16 * lanes,
            2 * lanes * m * k * n * kw["bits_a"], "int8")
        plan = tv.td_vmm_plan(m, k, n, kw["n_chain"], kw["bits_a"])
        print(f"[td_attention] {label} lanes ({plan.route} route, "
              f"{plan.n_seg} segment(s)): kernel {t['kernel_ms']:.5f} ms, "
              f"{lanes} single launches {t['singles_ms']:.5f} ms, plain "
              f"{t['plain_ms']:.4f} ms (event pair, before and after: "
              f"{plain[0]:.4f}, {plain[1]:.4f}), bound {b_ms:.5f} ms "
              f"({b_by}), kernel at {b_ms / t['kernel_ms']:.1%} of it")
        rows.append(dict(
            name="td_vmm", route="cuda", source="src/repro_torch/csrc/td_vmm.cu",
            replaces="src/repro/kernels/td_vmm/td_vmm.py:110",
            max_abs_err=max_err, library_ms=None, ms=t["kernel_ms"],
            plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            shape=f"td_attention {label}, lanes {lanes} x M {m} K {k} N {n} "
                  f"bits {kw['bits_a']}/{kw['bits_w']}, w a lane, solved "
                  f"heads",
            timed={"singles_ms": t["singles_ms"]}))
        del x, w

    # 6. the reference bench's sigma check, and a clean head beside a
    # noisy one, at qwen3-8b's head widths (f32)
    conf = TD_ATTN_BENCH
    b, t_len = conf["batch"], conf["seq"]
    q, k, v = (torch.randn((b, t_len, h, hd), generator=gen, device="cuda")
               for h in (hq, hkv, hkv))
    clean = flash_attention(q, k, v, causal=True)
    base = TDPolicy(mode="td", bits_a=8, bits_w=8, n_chain=hd)
    errs = [float((td_attention(q, k, v, base.replace(sigma_chain=sg),
                                (0, 2), causal=True) - clean).abs().mean())
            for sg in conf["sigmas"]]
    print(f"[td_attention] bench sigma check, B {b}, T {t_len}, {hq}/{hkv} "
          f"heads of {hd}, 8 bits: mean |td - flash_attention| at sigma "
          f"{list(conf['sigmas'])}: {errs} (sigma 0 under "
          f"{conf['max_err']}, the last not below it)")
    if not (errs[0] < conf["max_err"] and errs[-1] >= errs[0]):
        fail(f"td_attention's sigma check: {errs}")
    o_clean = td_attention(q, k, v, base, (0, 2))
    o_het = td_attention(q, k, v, tuple(base.replace(
        sigma_chain=5.0 if h == 2 else 0.0) for h in range(hq)), (0, 2))
    clean_equal = all(torch.equal(o_het[:, :, h], o_clean[:, :, h])
                      for h in range(hq) if h != 2)
    delta = float((o_het[:, :, 2] - o_clean[:, :, 2]).abs().max())
    print(f"[td_attention] head 2 at sigma 5, the rest clean: clean heads "
          f"bit-identical to the all-clean run {clean_equal}, head 2 moved "
          f"by {delta:.4g}")
    if not clean_equal or not delta > 1e-3:
        fail("td_attention: per-head noise leaks or does not act")
    del q, k, v, clean, o_clean, o_het

    # 7. the smoke model's td-attention serve, f32, sigma 0 (the noise's
    # log and cos are not bit-equal across devices): card against CPU
    arch = cfgs.get_smoke("qwen3-8b").replace(
        td=TDExecCfg(mode="td", n_chain=48),
        td_attn=TDExecCfg(mode="td", n_chain=48),
        train=TrainCfg(compute_dtype="float32"))
    scfg = arch.model
    lay = TDPolicy(mode="td", n_chain=48)
    pol = NetworkPolicy(layers=(lay,) * scfg.n_layers, top=lay, attn=(
        TDPolicy(mode="td", n_chain=scfg.hd),) * scfg.n_heads)
    params = get_api(scfg)["init"](0, scfg, pol, device="cpu")
    toks = torch.from_numpy(serve.prompts(1, 2, 8, scfg.vocab))
    sshape = ShapeCfg("serve", 14, 2, "decode")
    solve = common.resolve_arch_policy
    common.resolve_arch_policy = lambda a, device=None: pol
    try:
        pre = steps.build_prefill_step(arch, sshape)
        srv = steps.build_serve_step(arch, sshape)
    finally:
        common.resolve_arch_policy = solve
    res = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        with torch.inference_mode():
            logits, state = pre(p, {"tokens": toks.to(dev)})
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            out = [tok]
            for _ in range(5):
                tok, state = srv(p, tok, state)
                out.append(tok)
        res[dev] = (logits.float().cpu(), torch.cat(out, 1).cpu())
    same = bool(torch.equal(res["cpu"][1], res["cuda"][1]))
    err = float((res["cpu"][0] - res["cuda"][0]).abs().max())
    print(f"[td_attention] smoke model --td-attn td at sigma 0, f32, card vs "
          f"CPU: tokens equal {same}, max |prefill logit diff| {err:.3e}")
    if not same:
        fail("the smoke model's td-attention serve on the card disagrees "
             "with the CPU run")
    print(f"[td_attention] the phase's wall {time.monotonic() - t_phase:.1f} "
          f"s")


# ---------------------------------------------------------------------------
# The LM per-layer noise sweep (`benchmarks/bench_noise_tolerance.
# _lm_eval_fns` and the LM part of its `run`) on full-width granite-8b cut
# to 4 layers (4 sites), f32: SyntheticStream(seq 32, batch 8), 60 quant 4/4
# plain-SGD steps at lr 0.15 under keys fold_in(key, i); eval on batch(999),
# next-token top-1; the base policy td 4/4, n_chain d_model, sigma 0, q 1;
# sigmas 0.25-8, 2 repeats, chunks of 13; the per-layer sweep, the network
# sweep and `solve_network_policies` of the per-layer sigma_max, written in
# the bench's JSON shape for ``--td-per-layer @file``.
LM_SWEEP = dict(layers=4, seq_len=32, global_batch=8, steps=60, lr=0.15,
                sigmas=(0.25, 0.5, 1.0, 2.0, 4.0, 8.0), n_repeats=2,
                chunk=13, seed=0, eval_step=999)


def _on(hb: dict, dev) -> dict:
    """A synthetic batch's tokens and labels on ``dev``."""
    import torch
    return {n: torch.from_numpy(hb[n]).to(dev) for n in ("tokens", "labels")}


@contextlib.contextmanager
def flash_shapes():
    """Counts flash_attn's launches inside the block by (q shape, cache
    shape, q dtype, cache dtype, causal), through the one call site of the
    kernel's wrapper (`kernels/flash_attn/ops`)."""
    import collections
    from repro_torch.kernels.flash_attn import ops
    seen = collections.Counter()
    real = ops.flash_attn

    def counted(q, k, v, kv_len, q_offset, *, causal=True, **kw):
        seen[(tuple(q.shape), tuple(k.shape), q.dtype, k.dtype,
              causal)] += 1
        return real(q, k, v, kv_len, q_offset, causal=causal, **kw)
    ops.flash_attn = counted
    try:
        yield seen
    finally:
        ops.flash_attn = real


def _flash_path_ms(tag: str, seen, wall: float, gen) -> None:
    """Device time of a path's flash_attn launches: each launch shape of
    ``seen`` (`flash_shapes`) timed on fresh inputs (every key live,
    q_offset 0), times its launches, next to the path's wall."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attn as fa
    total, parts = 0.0, []
    for (qs, ks, qdt, kdt, causal), n in sorted(seen.items()):
        q = torch.randn(qs, generator=gen, device="cuda").to(qdt)
        k, v = (torch.randn(ks, generator=gen, device="cuda").to(kdt)
                for _ in range(2))
        args = (q, k, v, _i32([ks[1]] * qs[0]), _i32([0]))
        t = statistics.median(device_ms(
            lambda: fa.flash_attn(*args, causal=causal), 10)[0])
        route = "tensor cores" if fa.tensor_core_route(q, k) else \
            "CUDA cores"
        total += n * t
        parts.append(f"{n} x {t:.5f} ms at q {list(qs)} {str(qdt)[6:]}, "
                     f"cache {str(kdt)[6:]} ({route})")
        del q, k, v, args
    print(f"[{tag}] flash_attn on the path: {' + '.join(parts)} = "
          f"{total:.3f} ms of device time, against the path's wall "
          f"{wall:.1f} s")


def _lm_qat(tag: str, what: str, cfg, conf: dict, key, dev):
    """The LM sweep's brief QAT (`benchmarks/bench_noise_tolerance.
    _lm_eval_fns`): the seeded quant-4/4 init, ``conf["steps"]`` plain SGD
    steps at ``conf["lr"]`` on the synthetic stream's batches.  Prints the
    losses, step ms and peak memory; fails on a non-finite loss.  Returns
    (params, stream)."""
    import torch
    from repro_torch import prng
    from repro_torch.data.synthetic import DataCfg, SyntheticStream
    from repro_torch.models import get_api
    from repro_torch.models.transformer import _ffn_kind
    from repro_torch.optim.adamw import tree_leaves_with_path
    from repro_torch.tdsim.policy import quant_policy

    api = get_api(cfg)
    pol_q = quant_policy(4, 4)
    params = api["init"](conf["seed"], cfg, pol_q, device=dev)
    stream = SyntheticStream(DataCfg(vocab=cfg.vocab, seq_len=conf["seq_len"],
                                     global_batch=conf["global_batch"]))
    # the leaves the loss never reads: ln2 of a layer with no FFN (zamba2's
    # mixer-only layers); every other leaf must get a gradient
    unread = tuple(f"layers/{i}/ln2/" for i in range(cfg.n_layers)
                   if _ffn_kind(cfg, i) == "none")
    named = [(n, t) for n, t in tree_leaves_with_path(params)
             if not n.startswith(unread)]
    leaves = [t for _, t in named]
    for t in leaves:
        t.requires_grad_(True)
    losses, step_ms = [], []
    for i in range(conf["steps"]):
        t0 = time.perf_counter()
        loss, _ = api["train_loss"](params, _on(stream.batch(i), dev), cfg,
                                    pol_q, prng.fold_in(key, i))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        cut = [n for (n, _), g in zip(named, grads) if g is None]
        if cut:
            fail(f"{tag} QAT: no gradient reaches {cut}")
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t -= conf["lr"] * g
        losses.append(float(loss.detach()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    for t in leaves:
        t.requires_grad_(False)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] {what}, d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"f32: quant 4/4 QAT, {conf['steps']} SGD steps at lr "
          f"{conf['lr']} on batch {conf['global_batch']} x "
          f"{conf['seq_len']}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(min {min(losses):.4f}), step ms median "
          f"{statistics.median(step_ms):.2f} (first {step_ms[0]:.1f}); peak "
          f"memory {peak:.2f} GiB")
    print(f"[{tag}] losses {[round(x, 4) for x in losses]}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{tag} QAT: losses {losses}")
    return params, stream


def phase_lm_noise_sweep(launches: dict):
    """The LM sweep's path on granite-8b at its published widths, cut to
    LM_SWEEP["layers"] of 36 layers (`_lm_sweep_family`: QAT, lanes =
    single forwards bit for bit, the per-layer batched search with 7 td_vmm
    lane launches a layer a chunk, the site-0 scalar search, the network
    sweep, the policy solve and its file), then its kernels at its shapes
    (`_lm_sweep_kernel_checks`)."""
    import torch
    import repro_torch.configs as cfgs
    cfg = cfgs.get("granite-8b").model
    if (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) != \
            (4096, 32, 8, 14336, 49152):
        fail(f"granite-8b widths {cfg}")
    t0 = time.monotonic()
    with flash_shapes() as seen:
        cfg, solved0 = _lm_sweep_family("lm_noise_sweep", "granite-8b",
                                        LM_SWEEP["layers"], launches)
    wall = time.monotonic() - t0
    gc.collect()
    torch.cuda.empty_cache()
    d, f, kv_d = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.hd
    _lm_sweep_kernel_checks("lm_noise_sweep", cfg, kernel_modules()["td_vmm"],
                            solved0, [("attn.wq/wo", d, d),
                                      ("attn.wk/wv", d, kv_d),
                                      ("mlp.wi/wg", d, f), ("mlp.wo", f, d)],
                            attn=True)
    _flash_path_ms("lm_noise_sweep", seen,
                   wall, torch.Generator(device="cuda").manual_seed(6))


# flash_attn's f32 path (CUDA cores) against its plain version: the softmax
# of at most 32 keys summed in another order, about 100 f32 ulps at |o| ~ 1
ATOL_F32 = 1e-5


def _lm_sweep_kernel_checks(tag: str, cfg, tv, solved, denses: list,
                            attn: bool) -> None:
    """The LM sweep's kernels against their plain versions at its shapes
    (these launches come after the path's counts were read): td_vmm's
    lanes at a chunk's 13 lanes of M 256 over a shared w, n_chain d_model,
    at each of ``denses`` ((label, K, N)), at sigma 0, at the sweep's
    per-lane sigmas and at layer 0's ``solved`` policy, bit for bit
    against the plain version and single launches; with ``attn``
    flash_attn in f32 at the single forward's batch 8, the 3-lane check's
    24 and a chunk's 104, Sq 32, the model's heads, causal, within
    ATOL_F32."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attn as fa
    conf, chunk = LM_SWEEP, LM_SWEEP["chunk"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    m = conf["global_batch"] * conf["seq_len"]
    kw = dict(bits_a=4, bits_w=4, n_chain=cfg.d_model)
    sweep = [0.0] + [s for s in conf["sigmas"]
                     for _ in range(conf["n_repeats"])]
    variants = {
        "sigma 0": [[0.0, 1.0]] * chunk,
        "the sweep's sigmas": [[s, 1.0] for s in sweep[:chunk]],
        f"solved (sigma {solved.sigma_chain:.4f}, q {solved.tdc_q})":
            [[solved.sigma_chain, float(solved.tdc_q)]] * chunk}
    seed = torch.randint(0, 2 ** 32, (chunk,), generator=gen,
                         dtype=torch.int64, device="cuda")
    for label, k, n in denses:
        x = _codes(gen, (chunk, m, k), kw["bits_a"])
        w = _codes(gen, (k, n), kw["bits_w"])
        for which, rows in variants.items():
            par = torch.tensor(rows, dtype=torch.float32, device="cuda")
            _lane_check(tv, f"{label}, {which}", x, w, par, seed, kw,
                        tag=tag)
        del x, w
    torch.cuda.empty_cache()
    for b in (conf["global_batch"], 3 * conf["global_batch"],
              chunk * conf["global_batch"]) if attn else ():
        sq = conf["seq_len"]
        q = torch.randn((b, sq, cfg.n_heads, cfg.hd), generator=gen,
                        device="cuda")
        k, v = (torch.randn((b, sq, cfg.n_kv_heads, cfg.hd), generator=gen,
                            device="cuda") for _ in range(2))
        args = (q, k, v, _i32([sq] * b), _i32([0]))
        err = float((fa.flash_attn(*args, causal=True)
                     - fa.flash_attn_plain(*args, causal=True)).abs().max())
        print(f"[{tag}] flash_attn f32 B={b} Sq={sq} Hq={cfg.n_heads} "
              f"Hkv={cfg.n_kv_heads} D={cfg.hd} causal: max |kernel - "
              f"plain| {err:.3g} (tolerance {ATOL_F32:g})")
        if not err <= ATOL_F32:
            fail(f"flash_attn f32 disagrees with its plain version ({tag}, "
                 f"B {b})")
        del q, k, v, args


# The LM sweep on every decoder family: the recipe of LM_SWEEP on each
# model at its published widths, cut in depth (zamba2 keeps layers 0-5, so
# that its first shared-attention site, 5, is inside the cut).
SWEEP_FAMILIES = {"granite-moe": ("granite-moe-1b-a400m", 4),
                  "zamba2": ("zamba2-1.2b", 6),
                  "rwkv6": ("rwkv6-1.6b", 4)}


def cut_layers(cfg, n: int):
    """``cfg``'s first ``n`` layers, its layer and FFN patterns cut with
    them."""
    return dataclasses.replace(
        cfg, n_layers=n,
        layer_pattern=(None if cfg.layer_pattern is None
                       else cfg.layer_pattern[:n]),
        ffn_pattern=None if cfg.ffn_pattern is None else cfg.ffn_pattern[:n])


def sweep_expected(cfg, steps: int, lane_passes: list, singles: int
                   ) -> dict:
    """Launches of an LM sweep's path on ``cfg``: quant-4/4 QAT (``steps``
    steps), then passes at td 4/4 under a quant-4/4 top: lane passes
    (``lane_passes``: (lanes, first noisy layer) each) and ``singles``
    single forwards.  td_vmm runs once a td dense a pass: 4 at an
    attention site, 2 in a mamba2 mixer, 5 in an rwkv6 time mix, 3 in a
    SwiGLU, an RWKV channel mix or an MoE (a lane launch each over its
    experts, P x E lanes in a lane pass); the shared block and lm_head, at
    the quant top, none.  flash_attn runs once an attention or shared site
    a QAT step and a pass.  lsq_quant runs twice a quant matmul (x and w):
    every dense and lm_head of a QAT step; in a pass lm_head once a lane,
    and the shared block's 4 denses a site once a lane from the first
    noisy layer on (lane by lane), once before it (the clean prefix)."""
    from repro_torch.models.transformer import _ffn_kind
    mix = {"attn": 4, "shared_attn": 0, "mamba2": 2, "rwkv6": 5}
    ffn = {"swiglu": 3, "moe": 3, "rwkv_cm": 3, "none": 0}
    layers = range(cfg.n_layers)
    td = sum(mix[cfg.mixer_at(i)] + ffn[_ffn_kind(cfg, i)] for i in layers)
    n_attn = sum(cfg.mixer_at(i) in ("attn", "shared_attn") for i in layers)
    shared = [i for i in layers if cfg.mixer_at(i) == "shared_attn"]
    passes = len(lane_passes) + singles
    quant_pass = sum(p + 4 * sum(p if i >= first else 1 for i in shared)
                     for p, first in lane_passes)
    return {"td_vmm": td * passes,
            "flash_attn": n_attn * (steps + passes),
            "decode_gqa": 0,
            "lsq_quant": 2 * (td + 4 * len(shared) + 1) * steps
            + 2 * (quant_pass + singles * (1 + 4 * len(shared)))}


def _lm_sweep_family(tag: str, name: str, n_keep: int, launches: dict
                     ) -> tuple:
    """LM_SWEEP's recipe on ``name`` at its published widths cut to
    ``n_keep`` layers, f32: QAT; 3 lanes against 3 single forwards bit
    for bit, noise on; the per-layer batched search (a chunk's 13 probes
    as lanes), its td_vmm launches counted; the scalar search of layer 0
    against it; the network sweep; the policies solved, their file
    written under build/ and read back.  The path's launches are checked
    (`sweep_expected`).  Returns the model's config and solved layer-0
    policy."""
    import numpy as np
    import torch
    import repro_torch.configs as cfgs
    from repro_torch import prng
    from repro_torch.configs.base import TDExecCfg
    from repro_torch.core import noise_tolerance as nt
    from repro_torch.launch import td_cli
    from repro_torch.models import transformer as tr
    from repro_torch.tdsim.policy import (NetworkPolicy, TDPolicy,
                                          quant_policy,
                                          solve_network_policies)

    conf, dev = LM_SWEEP, "cuda"
    full = cfgs.get(name).model
    cfg = cut_layers(full, n_keep)
    n_l = cfg.n_layers
    pol_q = quant_policy(4, 4)
    key = prng.key(conf["seed"])
    sigmas, reps, chunk = conf["sigmas"], conf["n_repeats"], conf["chunk"]
    per = len(sigmas) * reps + 1
    mods = kernel_modules()
    tv = mods["td_vmm"]
    _counts_reset(mods)
    t_phase = time.monotonic()
    pattern = "" if cfg.layer_pattern is None else \
        f" ({list(cfg.layer_pattern)})"
    params, stream = _lm_qat(tag, f"{name}, {n_l} of {full.n_layers} "
                             f"layers{pattern}", cfg, conf, key, dev)
    batch = _on(stream.batch(conf["eval_step"]), dev)
    base = TDPolicy(mode="td", bits_a=4, bits_w=4, n_chain=cfg.d_model,
                    sigma_chain=0.0, tdc_q=1)

    def layer_eval(sv, keys):
        logits = tr.forward_lanes(params, batch, cfg, base, sv, keys, pol_q)
        return (logits.argmax(-1) == batch["labels"]).float().mean((1, 2))

    def single_logits(sv_row, k):
        pol = NetworkPolicy(layers=tuple(base.replace(sigma_chain=float(s))
                                         for s in sv_row), top=pol_q)
        with torch.no_grad():
            return tr.forward(params, batch, cfg, pol, key=k)[0]

    def scalar_layer0(s, k):
        logits = single_logits([s] + [0.0] * (n_l - 1), k)
        return float((logits.argmax(-1) == batch["labels"]).float().mean())

    # 3 lanes against 3 single forwards (layer 0 clean in every lane)
    rows3 = [[0.0, 0.5, 2.0], [0.0, 0.0, 0.0], [0.0, 4.0, 0.25]]
    sv3 = torch.tensor([[r[i % 3] if i else 0.0 for i in range(n_l)]
                        for r in rows3], device=dev)
    keys3 = prng.split(prng.fold_in(key, 77), 3)
    lanes3 = tr.forward_lanes(params, batch, cfg, base, sv3, keys3, pol_q)
    same3 = [_bits_equal(lanes3[p], single_logits(sv3[p].tolist(),
                                                  keys3[p]))
             for p in range(3)]
    moved = float((lanes3[0] - lanes3[1]).abs().max())
    print(f"[{tag}] forward_lanes, 3 lanes at sigma {sv3.tolist()}: each "
          f"lane equal to its single forward bit for bit {same3}; lane 0 "
          f"(noisy) against lane 1 (clean): max |logit diff| {moved:.6g}")
    if not all(same3) or not moved > 0:
        fail(f"{tag}: forward_lanes differs from the single forwards, or "
             "its noise does not act")
    del lanes3

    # the per-layer batched search, its td_vmm launches counted
    layer_eval(torch.ones(chunk, n_l, device=dev), prng.split(key, chunk))
    torch.cuda.synchronize()
    n0 = tv.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = nt.find_sigma_max_batched(layer_eval, sigmas, key, n_layers=n_l,
                                    n_repeats=reps, chunk_size=chunk,
                                    device=dev)
    torch.cuda.synchronize()
    t_batched = time.perf_counter() - t0
    search_launches = tv.launches - n0
    n_chunks = -(-n_l * per // chunk)
    if per != chunk:
        fail(f"{tag}: a chunk of {chunk} probes holds {per} a layer")
    search = [(chunk, i) for i in range(n_l)]       # chunk i: layer i
    want_search = sweep_expected(cfg, 0, search, 0)["td_vmm"]
    print(f"[{tag}] per-layer search: {res.n_evals} probes in {n_chunks} "
          f"chunks of {chunk}: wall {t_batched:.3f} s, td_vmm lane "
          f"launches {search_launches} (expected {want_search}), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"acc_clean per layer {res.acc_clean.tolist()}, sigma_max "
          f"{np.round(res.sigma_max, 4).tolist()}")
    if search_launches != want_search or \
            not np.isfinite(res.sigma_max).all():
        fail(f"{tag}: per-layer search with {search_launches} td_vmm "
             f"launches, sigma_max {res.sigma_max}")

    # the scalar search of layer 0 against the batched one
    t0 = time.perf_counter()
    res0 = nt.find_sigma_max(scalar_layer0, sigmas, prng.fold_in(key, 0),
                             n_repeats=reps)
    t_scalar = time.perf_counter() - t0
    equal0 = bool(np.array_equal(res0.rel_drop, res.rel_drop[0])
                  and res0.acc_clean == res.acc_clean[0]
                  and res0.sigma_max == res.sigma_max[0])
    print(f"[{tag}] layer 0 scalar: sigma_max {res0.sigma_max:.4f} against "
          f"batched {res.sigma_max[0]:.4f}, accuracies equal {equal0}; wall "
          f"{t_scalar:.3f} s for {per} evals, x {n_l} layers = "
          f"{t_scalar * n_l:.3f} s against batched {t_batched:.3f} s")
    if not equal0:
        fail(f"{tag} layer 0: the scalar search differs from the batched")

    # the network sweep, the policies, their file read back
    net = nt.find_sigma_max_batched(
        lambda sv, keys: layer_eval(sv.expand(-1, n_l), keys), sigmas, key,
        n_layers=1, n_repeats=reps, chunk_size=chunk, device=dev).layer(0)
    solved = solve_network_policies(res.sigma_max, bits_a=4, bits_w=4,
                                    n_chain=base.n_chain, device=dev)
    path = ROOT / "build" / "noise_tolerance" / \
        f"per_layer_policies_{name}.json"
    nt.write_policies(path, name, [f"layer{i}" for i in range(n_l)],
                      res.sigma_max, solved)
    back = td_cli.parse_td_per_layer(
        f"@{path}", TDExecCfg(mode="td", n_chain=cfg.d_model), n_l)
    read_ok = [(c.sigma_max, c.n_chain, c.bits_a, c.bits_w) for c in back] \
        == [(float(s), p.n_chain, p.bits_a, p.bits_w)
            for s, p in zip(res.sigma_max, solved.layers)]
    with torch.no_grad():
        logits = tr.forward(params, batch, cfg, NetworkPolicy(
            layers=solved.layers, top=pol_q), key=prng.fold_in(key, 4242))[0]
    acc_solved = float((logits.argmax(-1) == batch["labels"]).float().mean())
    torch.cuda.synchronize()
    print(f"[{tag}] network sweep: sigma_max {net.sigma_max:.4f} (acc_clean "
          f"{net.acc_clean:.4f}); policies R "
          f"{[p.redundancy for p in solved.layers]}, q "
          f"{[p.tdc_q for p in solved.layers]}; {path.relative_to(ROOT)} "
          f"read back {read_ok}; accuracy at the solved policies "
          f"{acc_solved:.4f}; the path's wall "
          f"{time.monotonic() - t_phase:.1f} s")
    if not read_ok:
        fail(f"{tag}: the per-layer policy file does not read back")
    # the passes: the 3-lane check (layer 0 clean), the search's warm-up,
    # its chunks and the network sweep (noisy from layer 0); the singles:
    # the 3-lane check's, the scalar search's and the solved policies'
    lane_passes = [(3, 1), (chunk, 0)] + search + [(chunk, 0)]
    singles = 3 + per + 1
    counts = {n: m.launches for n, m in mods.items()}
    check_launches(tag, counts, sweep_expected(cfg, conf["steps"],
                                               lane_passes, singles))
    launches[tag] = counts
    return cfg, solved.layers[0]


def _moe_lanes_check(rows: list, cfg, solved, sigmas) -> None:
    """One P x E td_vmm lane call of the MoE under the sweep (a chunk's 13
    probes x granite-moe's 32 experts; M the capacity of one probe's 8 x
    32 tokens, wi K 1024 N 512 and wo K 512 N 1024; lane (p, e) reads
    expert e of the one (E, K, N) stack of codes, at probe p's sigma, a
    seed a lane) against its plain version and against 13 calls of 32
    expert lanes, bit for bit.  At wi and the solved policy: the call
    timed in turns with the 13 calls, a row with its bound (x and the E
    distinct weights read once); and the whole entry point
    (`td_linear.td_matmul_expert_lanes`: quantize x and w, one launch,
    dequantize) timed in turns with the same steps around 13 per-probe
    launches, bit for bit, each with its peak memory above its inputs."""
    import torch
    from repro_torch.kernels.td_vmm import ops as td_ops
    from repro_torch.kernels.td_vmm import td_vmm as tv
    from repro_torch.models.ffn import _capacity
    from repro_torch.quant import lsq
    from repro_torch.tdsim import td_linear
    from repro_torch.tdsim.policy import TDPolicy
    conf = LM_SWEEP
    p_l, e = conf["chunk"], cfg.moe.num_experts
    m = _capacity(conf["global_batch"] * conf["seq_len"], cfg.moe)
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    kw = dict(bits_a=4, bits_w=4, n_chain=d)
    gen = torch.Generator(device="cuda").manual_seed(23)
    sweep = [0.0] + [s for s in sigmas for _ in range(conf["n_repeats"])]
    variants = {"the sweep's sigmas": sweep[:p_l],
                f"solved (sigma {solved.sigma_chain:.4f}, q "
                f"{solved.tdc_q})": [solved.sigma_chain] * p_l}
    seeds = torch.randint(0, 2 ** 32, (p_l * e,), generator=gen,
                          dtype=torch.int64, device="cuda")
    for nm, k, n in (("wi", d, f), ("wo", f, d)):
        x = _codes(gen, (p_l * e, m, k), 4)
        w = _codes(gen, (e, k, n), 4)
        for which, sig in variants.items():
            q = float(solved.tdc_q) if which.startswith("solved") else 1.0
            par = torch.tensor([[s, q] for s in sig for _ in range(e)],
                               dtype=torch.float32, device="cuda")
            got = tv.td_vmm(x, w, par, seeds, **kw)

            def by_probe():
                return torch.cat([tv.td_vmm(
                    x[i * e:(i + 1) * e], w, par[i * e:(i + 1) * e],
                    seeds[i * e:(i + 1) * e], **kw) for i in range(p_l)])
            probes = by_probe()
            want = tv.td_vmm_plain(x, w, par, seeds, **kw)
            torch.cuda.synchronize()
            ok = _bits_equal(got, want) and _bits_equal(got, probes)
            print(f"[lm_sweep_moe] td_vmm {nm}, {which}: {p_l} x {e} = "
                  f"{p_l * e} lanes, M {m} K {k} N {n}, lane (p, e) reading "
                  f"expert e of one stack: one call == plain "
                  f"{_bits_equal(got, want)}, == {p_l} calls of {e} lanes "
                  f"{_bits_equal(got, probes)}")
            if not ok:
                fail(f"td_vmm's {p_l * e} MoE sweep lanes ({nm}, {which}) "
                     "differ from the plain version or the per-probe calls")
            if nm == "wi" and which.startswith("solved"):
                plain = [_event_ms(lambda: tv.td_vmm_plain(
                    x, w, par, seeds, **kw))]
                t = in_turns("lm_sweep_moe", f"td_vmm {nm} {p_l} x {e} "
                             "lanes", {
                                 "kernel": lambda: tv.td_vmm(
                                     x, w, par, seeds, **kw),
                                 "per_probe": by_probe},
                             {"kernel": 10, "per_probe": 5})
                plain.append(_event_ms(lambda: tv.td_vmm_plain(
                    x, w, par, seeds, **kw)))
                t["plain_ms"] = statistics.median(plain)
                b_ms, b_by = bound_ms(
                    4 * (p_l * e * m * k + e * k * n + p_l * e * m * n)
                    + 16 * p_l * e, 2 * p_l * e * m * k * n * 4, "int8")
                print(f"[lm_sweep_moe] td_vmm {nm} {p_l} x {e} lanes: "
                      f"kernel {t['kernel_ms']:.5f} ms, {p_l} calls of {e} "
                      f"lanes {t['per_probe_ms']:.5f} ms, plain "
                      f"{t['plain_ms']:.4f} ms (event pair, before and "
                      f"after: {plain[0]:.4f}, {plain[1]:.4f}), bound "
                      f"{b_ms:.5f} ms ({b_by}): kernel at "
                      f"{b_ms / t['kernel_ms']:.1%} of it")
                entry = _moe_entry_check(td_linear, td_ops, lsq, TDPolicy,
                                         gen, (p_l, e, m, k, n), par, seeds)
                rows.append(dict(
                    name="td_vmm", route="cuda",
                    source="src/repro_torch/csrc/td_vmm.cu",
                    replaces="src/repro/kernels/td_vmm/td_vmm.py:110",
                    max_abs_err=0.0, library_ms=None, ms=t["kernel_ms"],
                    plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                    shape=f"lm_sweep_moe {nm}, {p_l} x {e} lanes x M {m} K "
                          f"{k} N {n} bits 4/4, lane (p, e) reading expert "
                          "e of one stack, solved sigma",
                    timed={"per_probe_ms": t["per_probe_ms"], **entry}))
            del got, probes, want
        del x, w
        torch.cuda.empty_cache()


def _moe_entry_check(td_linear, td_ops, lsq, TDPolicy, gen, dims: tuple,
                     par, seeds) -> dict:
    """`td_linear.td_matmul_expert_lanes` on f32 x (P, E, M, K) and w (E,
    K, N) against the same quantize and dequantize around P per-probe
    launches of E lanes over the one stack of w's codes: bit for bit,
    device ms in turns, and the peak memory each takes above its inputs.
    Returns the timed entries of the kernel's row."""
    import torch
    p_l, e, m, k, n = dims
    xf = torch.randn((p_l, e, m, k), generator=gen, device="cuda")
    wf = torch.randn((e, k, n), generator=gen, device="cuda") * k ** -0.5
    s_a = torch.tensor(0.5, device="cuda")
    s_w = (2 * wf.abs().mean() / 7 ** 0.5)
    pol = TDPolicy(mode="td", bits_a=4, bits_w=4, n_chain=k)
    pp = par.reshape(p_l, e, 2)
    sig, q = pp[:, 0, 0].contiguous(), pp[:, 0, 1].contiguous()
    sd = seeds.reshape(p_l, e)

    def one_call():
        return td_linear.td_matmul_expert_lanes(xf, wf, s_a, s_w, pol, sig,
                                                q, sd)

    def per_probe():
        x_int = lsq.lsq_quantize_int(xf, s_a, 4, signed=True)
        w_int = lsq.lsq_quantize_int(wf, s_w, 4, signed=True)
        y = torch.stack([td_ops.td_vmm_lanes(
            x_int[i], w_int, pol, sig[i].expand(e), q[i].expand(e), sd[i])
            for i in range(p_l)])
        return y * (torch.clamp(s_a, min=1e-8) * torch.clamp(s_w, min=1e-8))

    def peak_gib(fn) -> float:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    same = _bits_equal(one_call(), per_probe())
    t = in_turns("lm_sweep_moe", f"td_matmul_expert_lanes {p_l} x {e} "
                 "lanes (quantize, launch, dequantize)",
                 {"kernel": one_call, "per_probe": per_probe},
                 {"kernel": 5, "per_probe": 5})
    mem = {"entry_peak_gib": peak_gib(one_call),
           "entry_per_probe_peak_gib": peak_gib(per_probe)}
    print(f"[lm_sweep_moe] td_matmul_expert_lanes M {m} K {k} N {n}: one "
          f"call {t['kernel_ms']:.5f} ms against the same steps around "
          f"{p_l} launches {t['per_probe_ms']:.5f} ms, equal bit for bit "
          f"{same}; peak memory above the inputs "
          f"{mem['entry_peak_gib']:.4f} GiB against "
          f"{mem['entry_per_probe_peak_gib']:.4f} GiB")
    if not same:
        fail("td_matmul_expert_lanes differs from its per-probe launches")
    del xf, wf
    return {"entry_ms": t["kernel_ms"],
            "entry_per_probe_ms": t["per_probe_ms"], **mem}


def _sweep_denses(cfg) -> list:
    """(label, K, N) of the td denses of a sweep model's layers, one entry
    a shape (the MoE's experts are `_moe_lanes_check`'s; the shared
    block, at the quant top, runs no td_vmm)."""
    from repro_torch.models import mamba2
    d = cfg.d_model
    if cfg.moe is not None:
        kv_d = cfg.n_kv_heads * cfg.hd
        return [("attn.wq/wo", d, d), ("attn.wk/wv", d, kv_d)]
    if cfg.rwkv is not None:
        return [("timemix wr/wk/wv/wg/wo, chanmix wr", d, d),
                ("chanmix wk", d, cfg.d_ff), ("chanmix wv", cfg.d_ff, d)]
    di, nh, _, ns, _ = mamba2.dims(cfg)
    return [("mamba.in_proj", d, 2 * di + 2 * ns + nh),
            ("mamba.out_proj", di, d), ("mlp.wi/wg", d, cfg.d_ff),
            ("mlp.wo", cfg.d_ff, d)]


def phase_lm_sweep_families(launches: dict, rows: list):
    """LM_SWEEP's recipe on the MoE, the hybrid and rwkv6
    (`SWEEP_FAMILIES`, `_lm_sweep_family`), each path's launches checked;
    then each model's kernels at its shapes (`_lm_sweep_kernel_checks`:
    td_vmm's 13 shared-w lanes at its denses, flash_attn in f32 at its
    attention or shared site), the MoE's P x E expert lanes
    (`_moe_lanes_check`), and lsq_quant bit for bit at the QAT's f32
    weights and activations (the MoE's expert stack and its slotted
    tokens, zamba2's in_proj, rwkv6's chanmix wk), the expert stack timed
    against its plain version and `fake_quantize_per_tensor_affine`."""
    import torch
    from repro_torch.models.ffn import _capacity
    walls = {}
    lsq_shapes = []
    f32 = torch.float32
    tv = kernel_modules()["td_vmm"]
    for tag, (name, n_keep) in SWEEP_FAMILIES.items():
        t0 = time.monotonic()
        with flash_shapes() as seen:
            cfg, solved0 = _lm_sweep_family(f"lm_sweep_{tag}", name, n_keep,
                                            launches)
        path_wall = time.monotonic() - t0
        gc.collect()
        torch.cuda.empty_cache()
        _lm_sweep_kernel_checks(f"lm_sweep_{tag}", cfg, tv,
                                solved0, _sweep_denses(cfg),
                                attn=cfg.rwkv is None)
        if seen:
            _flash_path_ms(f"lm_sweep_{tag}", seen, path_wall,
                           torch.Generator(device="cuda").manual_seed(6))
        d = cfg.d_model
        if cfg.moe is not None:
            _moe_lanes_check(rows, cfg, solved0, LM_SWEEP["sigmas"])
            e, fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
            cap = _capacity(LM_SWEEP["global_batch"] * LM_SWEEP["seq_len"],
                            cfg.moe)
            lsq_shapes += [("moe expert stack wi", (e * d, fe), f32),
                           ("moe slotted x", (e * cap, d), f32)]
        elif cfg.rwkv is not None:
            lsq_shapes.append(("rwkv6 chanmix wk", (d, cfg.d_ff), f32))
        else:
            lsq_shapes.append(("zamba2 mamba.in_proj",
                               (d, _sweep_denses(cfg)[0][2]), f32))
        walls[tag] = time.monotonic() - t0
        gc.collect()
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(8)
    _lsq_rows("lm_sweep", rows, gen, lsq_shapes, "moe expert stack wi")
    print(f"[lm_sweep_families] walls, s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))


# ---------------------------------------------------------------------------
# dbrx-132b at its published widths, cut to DBRX["layers"] of 40 layers (one
# layer is about 3.3B parameters; 40 do not fit one card), bf16, td.
DBRX = dict(arch="dbrx-132b", layers=2)


def _dbrx_kernel_checks(rows: list) -> None:
    """The kernels at dbrx's shapes against their plain versions: td_vmm's
    16 expert lanes (w a lane, the solved sigma, a seed a lane) at the
    prefill's capacity (4 x 128 tokens: M 160, block route) and decode's
    (M 4, split route), wi K 6144 N 10752 and wo K 10752 N 6144, bit for
    bit against the plain version and 16 single launches, wi timed;
    flash_attn at the serve prefill (B 4, Sq 128, cache 144, Hq 48, Hkv
    8, D 128, bf16: the wgmma path) and decode_gqa at decode (g 6, S
    144), each timed against SDPA."""
    import torch
    from repro_torch.kernels.td_vmm import td_vmm as tv
    from repro_torch.models.ffn import _capacity
    from repro_torch.tdsim.policy import solve_td_policy
    import repro_torch.configs as cfgs
    cfg = cfgs.get(DBRX["arch"]).model
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    pol = solve_td_policy(4, 4, 576, None)
    gen = torch.Generator(device="cuda").manual_seed(40)
    par = torch.tensor([[pol.sigma_chain, float(pol.tdc_q)]] * e,
                       dtype=torch.float32, device="cuda")
    seeds = torch.randint(0, 2 ** 32, (e,), generator=gen,
                          dtype=torch.int64, device="cuda")
    kw = dict(bits_a=4, bits_w=4, n_chain=576)
    b, s_p, gen_n = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    err = 0.0
    for label, m in (("prefill", _capacity(b * s_p, cfg.moe)),
                     ("decode", _capacity(b, cfg.moe))):
        for nm, k, n in (("wi", d, f), ("wo", f, d)):
            x, w = _codes(gen, (e, m, k), 4), _codes(gen, (e, k, n), 4)
            want = tv.td_vmm_plain(x, w, par, seeds, **kw)
            err = max(err, _lane_check(tv, f"dbrx {label} {nm}", x, w, par,
                                       seeds, kw, want=want, tag="dbrx"))
            del want
            if nm == "wi":
                cold = m <= 8
                plain = [_event_ms(lambda: tv.td_vmm_plain(
                    x, w, par, seeds, **kw))]
                t = in_turns("dbrx", f"td_vmm {label} {nm} lanes", {
                    "kernel": lambda: tv.td_vmm(x, w, par, seeds, **kw)},
                    {"kernel": 10}, cold=cold)
                plain.append(_event_ms(lambda: tv.td_vmm_plain(
                    x, w, par, seeds, **kw)))
                t["plain_ms"] = statistics.median(plain)
                b_ms, b_by = bound_ms(4 * (e * m * k + e * k * n + e * m * n)
                                      + 16 * e, 2 * e * m * k * n * 4,
                                      "int8")
                plan = tv.td_vmm_plan(m, k, n, 576, 4)
                print(f"[dbrx] td_vmm {label} {nm}: {e} lanes ({plan.route} "
                      f"route, {'cold' if cold else 'warm'} L2): kernel "
                      f"{t['kernel_ms']:.5f} ms, plain {t['plain_ms']:.4f} "
                      f"ms (event pair, before and after: {plain[0]:.4f}, "
                      f"{plain[1]:.4f}), bound {b_ms:.5f} ms ({b_by}): "
                      f"kernel at {b_ms / t['kernel_ms']:.1%} of it")
                rows.append(dict(
                    name="td_vmm", route="cuda",
                    source="src/repro_torch/csrc/td_vmm.cu",
                    replaces="src/repro/kernels/td_vmm/td_vmm.py:110",
                    max_abs_err=err, library_ms=None, ms=t["kernel_ms"],
                    plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                    shape=f"dbrx {label} {nm}, lanes {e} x M {m} K {k} N "
                          f"{n} bits 4/4, w a lane, {plan.route} route, "
                          "solved sigma"))
            del x, w
            torch.cuda.empty_cache()
    s_cache = s_p + gen_n
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bf = torch.bfloat16
    _flash_rows("dbrx", rows, gen, [
        ("prefill", b, s_p, s_cache, hq, hkv, hd, [s_p] * b, True, bf, bf)],
        timed=("prefill",))
    _decode_rows(rows, "dbrx", gen, hq, hkv, hd, [
        ("decode", b, s_cache, s_p + gen_n // 2)])


def phase_dbrx(launches: dict, rows: list):
    """dbrx-132b at its published widths (6144, 48/8 heads of 128, 16
    experts top-4 of 10752, vocab 100352) cut to DBRX["layers"] of 40
    layers, bf16, td (4/4, the port's solve): SERVE's batch through
    `serve.run` (launches checked, host syncs a step counted: none
    allowed), the smoke model on the card against the CPU, then the
    kernels at its shapes.  No training on the card: one full-width
    layer's f32 training state is about 70 GB."""
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.tdsim.policy import TDPolicy
    t_phase = time.monotonic()
    arch = family_arch(DBRX["arch"], "td", DBRX["layers"])
    cfg = arch.model
    if (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab,
            cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert) != \
            (6144, 48, 8, 100352, 16, 4, 10752):
        fail(f"dbrx-132b widths {cfg}")
    print(f"[dbrx] {cfg.name}: {cfg.n_layers} of 40 layers (cut: 40 layers "
          f"are about 132B parameters), compute "
          f"{arch.train.compute_dtype}")
    _serve_full("dbrx_serve", arch, SERVE["batch"], SERVE["prompt_len"],
                SERVE["gen"], launches, syncs=True)
    gc.collect()
    torch.cuda.empty_cache()
    t_serve = time.monotonic() - t_phase
    smoke = cfgs.get_smoke(DBRX["arch"])
    # a dropless capacity, so that a token's experts do not depend on the
    # rest of the batch
    _family_small("dbrx_small", smoke.replace(model=dataclasses.replace(
        smoke.model, moe=dataclasses.replace(smoke.model.moe,
                                             capacity_factor=8.0))),
                  TDPolicy(mode="td", n_chain=64))
    _dbrx_kernel_checks(rows)
    print(f"[dbrx] phase wall {time.monotonic() - t_phase:.1f} s (serve "
          f"{t_serve:.1f})")


# ---------------------------------------------------------------------------
# The explorer's disk store, corner fan-out and refinement on the card, at
# benchmarks/bench_explorer.py's cases (:41-50) and full-run sizes.
EXPLORER = dict(parity_target=512, res_target=1_000_000,
                res_max_axis_values=16_000, res_max_levels=24,
                fanout="edge", store=ROOT / "build" / "explorer_store")


def phase_explorer():
    """`ExplorerService.refine` on bench_explorer's parity case (target 512,
    coarse 9, tau 0.25) bit-identical to the port's dense oracle on the
    card and equal to the CPU's refine (evaluated values, levels and
    integer fields equal, floats within rtol 1e-4); its resolution case
    (target 1e6) at >= 1e7 effective points from <= 2e5 evaluated; a round
    trip through the disk store across two services; the corner fan-out
    against the serial loop, bit-identical, both walls."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core import design_grid, explorer
    from repro_torch.core import scenario as sc
    conf = EXPLORER
    parity_sc = sc.Scenario("explorer-parity", ns=(64, 256, 1024),
                            bit_widths=(2, 4), sigma_maxes=(0.5, 2.0),
                            vdds=(0.40, 0.80))
    res_sc = sc.Scenario("explorer-res", ns=(576,), bit_widths=(2, 4),
                         sigma_maxes=(0.5, 2.0), vdds=(0.40, 0.80))
    t_phase = time.monotonic()
    svc = explorer.ExplorerService()
    g_p = conf["parity_target"]
    kw = dict(target=g_p, coarse=9, tau=0.25, max_axis_values=g_p)
    t0 = time.perf_counter()
    res = svc.refine(parity_sc, **kw)
    t_ref = time.perf_counter() - t0
    axes = svc._corner_axes(parity_sc, sc.get_corner(None))
    oracle = design_grid.minimize_over_vdd(svc.sweep_axes(
        **{**axes, "vdds": tuple(float(v) for v in res.dense_values)}))
    fields = ("redundancy", "tdc_q", "vdd_opt", "e_mac")
    parity = {f: bool(np.array_equal(getattr(res.grid, f),
                                     getattr(oracle, f))) for f in fields}
    parity["winner"] = bool(np.array_equal(res.grid.winners(),
                                           oracle.winners()))
    cpu = explorer.ExplorerService(device="cpu").refine(parity_sc, **kw)
    same = bool(np.array_equal(cpu.evaluated_values, res.evaluated_values)
                and cpu.levels == res.levels
                and all(np.array_equal(getattr(cpu.grid, f),
                                       getattr(res.grid, f))
                        for f in ("redundancy", "tdc_q", "vdd_opt"))
                and all(np.allclose(getattr(cpu.grid, f),
                                    getattr(res.grid, f), rtol=1e-4, atol=0)
                        for f in ("e_mac", "throughput", "area_per_mac")))
    print(f"[explorer] refine parity (target {g_p}): {res.levels} levels, "
          f"{len(res.evaluated_values)} axis values, "
          f"{res.points_evaluated} points evaluated, wall {t_ref:.3f} s; "
          f"identical to the dense oracle on the card {parity}; equal to "
          f"the CPU's refine {same}")
    if not all(parity.values()) or not same:
        fail("explorer refine differs from the dense oracle or the CPU")
    t0 = time.perf_counter()
    rr = svc.refine(res_sc, target=conf["res_target"], coarse=9, tau=0.25,
                    max_axis_values=conf["res_max_axis_values"],
                    max_levels=conf["res_max_levels"])
    t_res = time.perf_counter() - t0
    print(f"[explorer] refine resolution (target {conf['res_target']}): "
          f"{rr.levels} levels, {rr.points_evaluated} points evaluated, "
          f"{rr.effective_points} effective, wall {t_res:.3f} s")
    if rr.points_evaluated > 200_000 or rr.effective_points < 10_000_000:
        fail(f"explorer refine resolution: {rr.points_evaluated} evaluated,"
             f" {rr.effective_points} effective")
    shutil.rmtree(conf["store"], ignore_errors=True)
    a = explorer.ExplorerService(cache_dir=str(conf["store"]))
    g1, i1 = a.sweep_info("edge", "ss")
    b = explorer.ExplorerService(cache_dir=str(conf["store"]))
    g2, i2 = b.sweep_info("edge", "ss")
    stored = i2["source"] == "disk" and all(
        np.array_equal(getattr(g1, f), getattr(g2, f))
        for f in design_grid._FIELDS)
    print(f"[explorer] disk store: {i1['source']} in {i1['elapsed_ms']:.1f} "
          f"ms, then a second service's {i2['source']} hit in "
          f"{i2['elapsed_ms']:.1f} ms, {g2.n_points} points, equal "
          f"{stored}")
    shutil.rmtree(conf["store"], ignore_errors=True)
    if not stored:
        fail("explorer disk store: the second service did not read it back")
    spec = sc.get_scenario(conf["fanout"])
    svc.sweep_scenarios(spec, parallel=False, use_cache=False)    # warm-up
    svc.sweep_scenarios(spec, parallel=True, use_cache=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = svc.sweep_scenarios(spec, parallel=False, use_cache=False)
    t_serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    fan = svc.sweep_scenarios(spec, parallel=True, use_cache=False)
    t_fan = time.perf_counter() - t0
    identical = list(fan) == list(serial) and all(
        np.array_equal(getattr(serial[c], f), getattr(fan[c], f))
        for c in serial for f in design_grid._FIELDS)
    print(f"[explorer] fan-out {spec.name}, corners {list(serial)} on "
          f"{torch.cuda.device_count()} device(s): serial {t_serial * 1e3:.1f}"
          f" ms, threads {t_fan * 1e3:.1f} ms, identical {identical}; stats "
          f"{svc.stats.snapshot()}; phase wall "
          f"{time.monotonic() - t_phase:.1f} s")
    if not identical or svc.stats.fanout_sweeps != 2 * len(serial):
        fail("explorer fan-out differs from the serial loop")


# ---------------------------------------------------------------------------
# Fault tolerance and drift adaptation (benchmarks/bench_drift_traces.py and
# benchmarks/bench_chaos.py at their smoke traffic, on full-width models).
def build_traces(steps: int) -> dict:
    """bench_drift_traces.build_traces: a hand-shaped diurnal swing and a
    seeded bursty trace with the bench's ranges."""
    from repro_torch import ft
    third = max(4, steps // 3)
    diurnal = ft.TrafficTrace([
        ft.TraceSegment(steps=third, activity=1.1, load=1.0),
        ft.TraceSegment(steps=third, activity=0.25, sparsity=0.85,
                        load=0.5),
        ft.TraceSegment(steps=steps - 2 * third, activity=0.9, load=0.9),
    ], seed=0)
    bursty = ft.TrafficTrace.generate(
        seed=11, steps=steps, n_segments=6, activity_range=(0.2, 1.8),
        sparsity_range=(0.5, 0.9), load_range=(0.4, 1.0))
    return {"diurnal": diurnal, "bursty": bursty}


@contextlib.contextmanager
def sync_log():
    """Records the host syncs torch reports under
    ``torch.cuda.set_sync_debug_mode("warn")`` on this thread only (a
    staged rebuild's solve syncs its own stream on a worker thread)."""
    import torch
    main, log = threading.get_ident(), []

    def show(message, *a, **k):
        if threading.get_ident() == main and "synchronizing" in str(message):
            log.append(1)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield log
        finally:
            torch.cuda.set_sync_debug_mode(0)


def _counted(eng, name: str, log: list, per_call: list) -> None:
    """Wraps the engine's method ``name`` to append the host syncs of each
    call to ``per_call``."""
    fn = getattr(eng, name)

    def wrapped(*a, **k):
        n0 = len(log)
        out = fn(*a, **k)
        per_call.append(len(log) - n0)
        return out
    setattr(eng, name, wrapped)


def _engine_run(arch, conf: dict, params, mods: dict, n_requests=None,
                **kw):
    """One engine on ``conf``'s traffic after a warm-up request: launch
    counters and the td_vmm operand memo read just before and after
    `run()`, host syncs counted per decode step and per operand install.
    ``kw`` goes to the engine (``adapt``, ``scripted_swaps``, ...) and to
    `run` (``trace``, ``schedule``).  Returns (engine, summary, facts)."""
    import torch
    from repro_torch import ft
    from repro_torch.kernels.td_vmm import ops as td_ops
    from repro_torch.launch import serve, steps
    from repro_torch.launch.scheduler import ContinuousBatchingEngine
    from repro_torch.models import common

    run_kw = {k: kw.pop(k) for k in ("trace", "schedule") if k in kw}
    builds = []
    build = steps.build_adaptive_serve_step
    steps.build_adaptive_serve_step = \
        lambda *a, **k: builds.append(1) or build(*a, **k)
    try:
        eng = ContinuousBatchingEngine(
            arch, capacity=conf["capacity"], s_cache=conf["s_cache"],
            prompt_pad=conf.get("prompt_pad"), kv_block=conf["kv_block"],
            seed=0, params=params, **kw)
    finally:
        steps.build_adaptive_serve_step = build
    eng.warmup()
    reqs = serve.synthetic_requests(n_requests or conf["requests"],
                                    conf["prompt_len"], conf["gen"],
                                    arch.model.vocab, seed=conf["seed"])
    t0 = time.monotonic()
    for r in reqs:
        r.arrival_s = t0
    decode_syncs, install_syncs, step_syncs_ = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    memo0 = len(td_ops._params)
    with sync_log() as log:
        _counted(eng, "_run_decode", log, decode_syncs)
        _counted(eng, "_decode", log, step_syncs_)
        _counted(eng, "_install_ops", log, install_syncs)
        for m in mods.values():
            m.launches = 0
        out = eng.run(reqs, retry_policy=ft.RetryPolicy(backoff_s=0.0),
                      **run_kw)
        torch.cuda.synchronize()
        counts = {n: m.launches for n, m in mods.items()}
    facts = dict(counts=counts, builds=len(builds),
                 memo_growth=len(td_ops._params) - memo0,
                 decode_syncs=decode_syncs, install_syncs=install_syncs,
                 step_syncs=step_syncs_,
                 peak=torch.cuda.max_memory_allocated() / 2**30,
                 outputs={rid: list(r.generated)
                          for rid, r in eng.done.items()})
    a, d = len(eng.admit_ms), len(eng.decode_ms)
    L = arch.model.n_layers
    mode = common.pol_at(eng.pol, 0).mode
    per_dense = {"td": ("td_vmm", 1), "quant": ("lsq_quant", 2)}[mode]
    want = {"td_vmm": 0, "lsq_quant": 0, "flash_attn": L * a,
            "decode_gqa": L * d}
    want[per_dense[0]] = per_dense[1] * (7 * L + 1) * (a + d)
    facts["expected"] = want
    return eng, out, facts


def _engine_line(path: str, label: str, eng, out: dict, facts: dict):
    print(f"[{path}] {label}: {out['requests']} requests, "
          f"{out['new_tokens']} new tokens in {out['wall_s']:.2f} s: "
          f"{out['tokens_per_s']:.2f} tokens/s, {eng.steps_run} decode "
          f"steps ({eng.replay_steps} of them replayed a continuation's "
          f"row), {len(eng.admit_ms)} admissions; decode step median "
          f"{statistics.median(eng.decode_ms):.1f} ms (min "
          f"{min(eng.decode_ms):.1f}, max {max(eng.decode_ms):.1f}); "
          f"admission median {statistics.median(eng.admit_ms):.1f} ms; "
          f"peak memory {facts['peak']:.1f} GiB; host syncs a decode step "
          f"{sorted(set(facts['decode_syncs']))}, an operand install "
          f"{sorted(set(facts['install_syncs']))}; decode step built "
          f"{facts['builds']} time(s); td_vmm operand memo grew by "
          f"{facts['memo_growth']}")


# every td dense's (K, N) of qwen3-8b: q and o, k and v, gate and up, down,
# lm_head
QWEN_DENSES = [("attn.wq/wo", 4096, 4096), ("attn.wk/wv", 4096, 1024),
               ("mlp.wi", 4096, 12288), ("mlp.wo", 12288, 4096),
               ("lm_head", 4096, 151936)]


def _ops_row_checks(pol, swap: tuple, shapes: list) -> float:
    """td_vmm with ``params`` a row view of an (L, 2) operand tensor, the
    adaptive step's operand: bit for bit against its plain version and
    against the same launch with the memoized operand, at sigma 0 (row 0)
    and at the solved (sigma, q) (row 1), for every qwen3-8b dense at each
    (label, M) of ``shapes``; then row 1 is overwritten in place with
    ``swap`` (a non-blocking copy from pinned memory, as the engine's
    install), which must move the output, to the plain version at the new
    values.  Returns the largest |kernel - plain| measured."""
    import torch
    from repro_torch.kernels.td_vmm import ops as td_ops
    from repro_torch.kernels.td_vmm import td_vmm as tv
    from repro_torch.models import common
    from repro_torch.tdsim.policy import NetworkPolicy

    gen = torch.Generator(device="cuda").manual_seed(19)
    seed = torch.full((1,), 33350994, dtype=torch.int64, device="cuda")
    kw = dict(bits_a=pol.bits_a, bits_w=pol.bits_w, n_chain=pol.n_chain)
    rows = [(0.0, 1.0), (pol.sigma_chain, float(pol.tdc_q))]
    err = 0.0
    for label, m in shapes:
        for name, k, n in QWEN_DENSES:
            ops = torch.tensor(rows, dtype=torch.float32, device="cuda")
            rt = common.runtime_td_policy(NetworkPolicy(layers=(pol, pol)),
                                          ops)
            x, w = _codes(gen, (m, k), kw["bits_a"]), \
                _codes(gen, (k, n), kw["bits_w"])
            got = []
            for i, (sigma, q) in enumerate(rows):
                par = td_ops.policy_params(rt.layers[i], x.device)
                if par.data_ptr() != ops[i].data_ptr():
                    fail("td_vmm's operand is not the row of ops")
                out = tv.td_vmm(x, w, par, seed, **kw)
                memo = tv.td_vmm(x, w, td_ops.runtime_operands(
                    sigma, q, x.device), seed, **kw)
                plain = tv.td_vmm_plain(x, w, par, seed, **kw)
                err = max(err, float((out - plain).abs().max()))
                if not (torch.equal(out, memo) and torch.equal(out, plain)):
                    fail(f"td_vmm with an ops row: {label} {name} M={m} "
                         f"sigma {sigma}: kernel, memoized and plain "
                         "differ")
                got.append(out)
            host = torch.tensor(swap, dtype=torch.float32).pin_memory()
            ops[1].copy_(host, non_blocking=True)
            par = td_ops.policy_params(rt.layers[1], x.device)
            after = tv.td_vmm(x, w, par, seed, **kw)
            plain = tv.td_vmm_plain(x, w, par, seed, **kw)
            err = max(err, float((after - plain).abs().max()))
            moved = not torch.equal(after, got[1])
            if not (torch.equal(after, plain) and moved):
                fail(f"td_vmm after an in-place swap: {label} {name} M={m}:"
                     f" equal to plain {torch.equal(after, plain)}, moved "
                     f"{moved}")
            print(f"[td_vmm] ops row {label} {name} M={m} K={k} N={n} "
                  f"(route {tv.td_vmm_plan(m, k, n, kw['n_chain'], 4).route}"
                  f"): sigma 0 and ({rows[1][0]:.6g}, q {rows[1][1]:g}) "
                  f"bit-exact against plain and memoized; after the swap to "
                  f"({swap[0]:.6g}, q {swap[1]:g}) moved, bit-exact")
            del x, w, got, after, plain
    torch.cuda.empty_cache()
    return err


# drift_traces and chaos_serve run qwen3-8b at its published widths cut to
# this depth: their gates (adaptation, parity, recovery) are per request
# and step, and the 36 layers' host-bound decode steps made room for the
# enc-dec and frontend phases (PERF.md §4)
FT_LAYERS = 4


def phase_drift_traces(launches: dict, rows: list):
    """bench_drift_traces at its smoke traffic on qwen3-8b at its widths
    cut to FT_LAYERS layers (bf16, td, sigma_max 2.0, drift threshold
    0.15): the plain engine on the same requests (decode ms and host
    syncs beside the adaptive ones), then for each trace the adaptive
    engine live and its ``scripted_swaps`` replay.  Gates per trace: zero
    lost, an adaptation, a staged install that moved the supply, two Vdds
    in the swap log, the adapted energy below the static worst case, the
    replay's tokens equal, one decode step built per engine, no new td_vmm
    operand, and no more host syncs a decode step than the plain
    engine's.  Then td_vmm with an ops row at the path's shapes."""
    import torch
    from repro_torch.configs.base import TDExecCfg
    from repro_torch.models import common

    conf = DRIFT
    arch = family_arch("qwen3-8b", None, FT_LAYERS).replace(
        td=TDExecCfg(mode="td", sigma_max=2.0))
    mods = kernel_modules()
    t_phase = time.monotonic()
    plain, pout, pf = _engine_run(arch, conf, None, mods)
    params = plain.params
    _engine_line("drift_traces", "plain engine", plain, pout, pf)
    check_launches("drift_traces plain", pf["counts"], pf["expected"])
    plain_syncs = max(pf["decode_syncs"])
    plain_ms = statistics.median(plain.decode_ms)
    pol = common.pol_at(plain.pol, 0)
    total = {n: 0 for n in mods}
    swap = None
    for name, trace in build_traces(conf["trace_steps"]).items():
        eng, out, f = _engine_run(arch, conf, params, mods, adapt=True,
                                  drift_threshold=conf["threshold"],
                                  trace=trace)
        _engine_line("drift_traces", f"{name} live", eng, out, f)
        check_launches(f"drift_traces {name}", f["counts"], f["expected"])
        for n, c in f["counts"].items():
            total[n] += c
        m = eng.meter
        log = [(e["step"], e["kind"], e["vdds"][0],
                tuple(float(v) for v in e["ops"].reshape(-1)[:2]))
               for e in eng.swap_log]
        print(f"[drift_traces] {name}: {trace!r}; adaptations "
              f"{out['adaptations']}, staged installs "
              f"{out['staged_installs']}, supply spans {out['supply_spans']};"
              f" swap log (step, kind, vdd, (sigma, q)) {log}; p_x_one "
              f"measured {out['p_x_one_measured']:.4f}; J/token (the "
              f"circuit model) first {m.rate_history[0]:.4e}, last "
              f"{m.rate_history[-1]:.4e}; run {out['energy_j_total']:.4e} J "
              f"against the static worst case "
              f"{out['static_worst_energy_j']:.4e} J; decode median "
              f"{statistics.median(eng.decode_ms):.1f} ms against the plain "
              f"engine's {plain_ms:.1f}")
        vdds = {v for e in eng.swap_log for v in e["vdds"]}
        if not (out["requests"] == conf["requests"]
                and out["adaptations"] >= 1 and out["supply_spans"] >= 1
                and len(vdds) >= 2
                and out["static_worst_energy_j"] > out["energy_j_total"]):
            fail(f"drift_traces {name}: requests {out['requests']}, "
                 f"adaptations {out['adaptations']}, supply spans "
                 f"{out['supply_spans']}, vdds {sorted(vdds)}, energy "
                 f"{out['energy_j_total']} vs {out['static_worst_energy_j']}")
        if f["builds"] != 1 or f["memo_growth"] != 0 or \
                max(f["decode_syncs"]) > plain_syncs or \
                any(f["install_syncs"]):
            fail(f"drift_traces {name}: decode step built {f['builds']} "
                 f"times, memo grew by {f['memo_growth']}, host syncs a "
                 f"decode step {max(f['decode_syncs'])} against the plain "
                 f"engine's {plain_syncs}, installs {f['install_syncs']}")
        moved = [(float(e["ops"].reshape(-1)[0]),
                  float(e["ops"].reshape(-1)[1])) for e in eng.swap_log]
        moved = [o for o in moved if o != (pol.sigma_chain,
                                           float(pol.tdc_q))]
        if not moved:
            fail(f"drift_traces {name}: no swap moved (sigma, q)")
        swap = swap or moved[0]
        rep, rout, rf = _engine_run(arch, conf, params, mods, adapt=True,
                                    drift_threshold=conf["threshold"],
                                    scripted_swaps=eng.swap_log,
                                    trace=trace)
        _engine_line("drift_traces", f"{name} scripted replay", rep, rout, rf)
        if rf["outputs"] != f["outputs"] or rout["adaptations"] != 0 or \
                rf["builds"] != 1 or rf["memo_growth"] != 0:
            fail(f"drift_traces {name}: the scripted replay gave other "
                 f"tokens ({rf['outputs'] != f['outputs']}), adapted "
                 f"{rout['adaptations']} times, built its step "
                 f"{rf['builds']} times or grew the memo by "
                 f"{rf['memo_growth']}")
        print(f"[drift_traces] {name}: the scripted replay's tokens equal "
              f"the live run's ({sum(len(v) for v in f['outputs'].values())}"
              f" tokens)")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    launches["drift_traces"] = total
    # the decode step alone, plain and adaptive in turns (plain, adaptive,
    # adaptive, plain; 10 steps each on the engines' last state, host clock
    # to the step's token read): the engine runs above share the host
    # with a rebuild's solve and vary with their admissions
    turns = {"plain": [], "adaptive": []}
    for label in ("plain", "adaptive", "adaptive", "plain"):
        e = plain if label == "plain" else rep
        with torch.inference_mode():
            for _ in range(10):
                t0 = time.perf_counter()
                e._run_decode()
                turns[label].append((time.perf_counter() - t0) * 1e3)
    print(f"[drift_traces] decode step alone, in turns: plain median "
          f"{statistics.median(turns['plain']):.1f} ms "
          f"({[round(t, 1) for t in turns['plain']]}), adaptive median "
          f"{statistics.median(turns['adaptive']):.1f} ms "
          f"({[round(t, 1) for t in turns['adaptive']]})")
    del plain, rep
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[drift_traces] phase wall {time.monotonic() - t_phase:.1f} s")
    err = _ops_row_checks(pol, swap, [
        ("drift_traces admission", slot_len(conf)),
        ("drift_traces decode", conf["capacity"]),
        ("chaos_serve decode", CHAOS["capacity"])])
    tv_row = next(r for r in rows if r["name"] == "td_vmm")
    tv_row["max_abs_err"] = max(tv_row["max_abs_err"], err)


def phase_chaos_serve(launches: dict):
    """bench_chaos.run_parity and run_drift at their smoke traffic on
    qwen3-8b at its widths cut to FT_LAYERS layers (bf16).  Parity, quant
    mode: the fault-free run, then a stall at step 1, a preemption at half its
    steps and an explorer outage two steps later: zero lost, the
    fault-free tokens, a re-admission, the explorer marked down.  Then the
    same preemption at a long context (`_long_recovery`).  Drift,
    td mode: a drift factor of 0.5 at step 2 must adapt and re-price the
    meter, save energy against the static worst case, with one decode step
    built and no new td_vmm operand."""
    import torch
    from repro_torch import ft
    from repro_torch.configs.base import TDExecCfg

    conf = CHAOS
    mods = kernel_modules()
    t_phase = time.monotonic()
    arch = family_arch("qwen3-8b", None, FT_LAYERS).replace(
        td=TDExecCfg(mode="quant"))
    eng0, base, f0 = _engine_run(arch, conf, None, mods)
    _engine_line("chaos_serve", "parity, fault-free", eng0, base, f0)
    check_launches("chaos_serve fault-free", f0["counts"], f0["expected"])
    params = eng0.params
    fire_at = max(2, base["steps"] // 2)
    sched = ft.FaultSchedule([
        ft.FaultEvent(1, "stall", {"duration_s": 0.01}),
        ft.FaultEvent(fire_at, "preempt"),
        ft.FaultEvent(fire_at + 2, "explorer_outage", {"up": False})])
    print(f"[chaos_serve] schedule {sched.to_json()!r}")
    eng, pre, f = _engine_run(arch, conf, params, mods, schedule=sched)
    _engine_line("chaos_serve", "parity, under the schedule", eng, pre, f)
    check_launches("chaos_serve", f["counts"], f["expected"])
    readmissions = sum(r["readmissions"] for r in pre["per_request"])
    kinds = {x["kind"] for x in pre["faults"]}
    print(f"[chaos_serve] faults {pre['faults']}; readmissions "
          f"{readmissions}; stragglers {pre['stragglers']}; explorer up "
          f"{eng.explorer_up}; outputs equal the fault-free run's: "
          f"{f['outputs'] == f0['outputs']}")
    if not ({"preempt", "stall", "explorer_outage"} <= kinds
            and pre["requests"] == conf["requests"]
            and f["outputs"] == f0["outputs"] and readmissions >= 1
            and not eng.explorer_up):
        fail(f"chaos_serve parity: faults {kinds}, requests "
             f"{pre['requests']}, readmissions {readmissions}, explorer up "
             f"{eng.explorer_up}, outputs equal "
             f"{f['outputs'] == f0['outputs']}")
    launches["chaos_serve"] = f["counts"]
    del eng0, eng
    gc.collect()
    torch.cuda.empty_cache()
    _long_recovery(arch, params, mods, launches)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    arch = family_arch("qwen3-8b", None, FT_LAYERS).replace(
        td=TDExecCfg(mode="td"))
    sched = ft.FaultSchedule([ft.FaultEvent(2, "drift", {"factor": 0.5})])
    eng, out, f = _engine_run(arch, conf, None, mods,
                              n_requests=conf["drift_requests"], adapt=True,
                              schedule=sched)
    _engine_line("chaos_serve", "drift", eng, out, f)
    check_launches("chaos_serve_drift", f["counts"], f["expected"])
    m = eng.meter
    worst = max(m.rate_history)
    static_j = worst * m.run_total_tokens()
    saved = static_j - m.run_total_energy()
    print(f"[chaos_serve] drift: adaptations {out['adaptations']}, "
          f"excursions {out['drift_excursions']}, p_x_one anchor "
          f"{eng.drift.anchor:.4f}, measured {out['p_x_one_measured']:.4f}; "
          f"meter policy swaps {out['meter_policy_swaps']}, J/token (the "
          f"circuit model) {[f'{r:.4e}' for r in m.rate_history]}; saved "
          f"{saved:.4e} J of {static_j:.4e} ({100 * saved / static_j:.1f}%)")
    if not (out["requests"] == conf["drift_requests"]
            and out["adaptations"] >= 1 and out["meter_policy_swaps"] >= 1
            and saved > 0 and f["builds"] == 1 and f["memo_growth"] == 0):
        fail(f"chaos_serve drift: requests {out['requests']}, adaptations "
             f"{out['adaptations']}, meter swaps {out['meter_policy_swaps']},"
             f" saved {saved}, builds {f['builds']}, memo growth "
             f"{f['memo_growth']}")
    launches["chaos_serve_drift"] = f["counts"]
    print(f"[chaos_serve] phase wall {time.monotonic() - t_phase:.1f} s")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def _long_recovery(arch, params, mods: dict, launches: dict) -> None:
    """A preemption at a long context (`LONG`, quant): the fault-free run,
    then the same requests with a preemption at step 12.  Gates: the
    engine kept its 11 slots of 32768 tokens, zero lost, the fault-free
    tokens, every request re-admitted, and the recovery's peak memory
    within one slot of the fault-free run's (the continuations replay in
    the engine's own cache).  Prints the recovery's time: the
    re-admissions' prefills and the decode steps that replayed rows, and
    the wall against the fault-free run's."""
    import torch
    from repro_torch import ft

    conf = LONG
    eng0, base, f0 = _engine_run(arch, conf, params, mods)
    _engine_line("chaos_serve long", "fault-free", eng0, base, f0)
    check_launches("chaos_serve long fault-free", f0["counts"],
                   f0["expected"])
    plan, cap = eng0.kv_plan, eng0.capacity
    slot_gib = plan.bytes_per_slot / 2**30
    print(f"[chaos_serve long] qwen3-8b quant: {cap} slots of "
          f"{eng0.s_cache} tokens ({plan.bytes_per_slot} bytes of KV each, "
          f"{cap * plan.bytes_per_slot} in all; plan_kv_cache admits "
          f"{plan.max_slots} in its budget of {plan.budget_bytes} bytes, the "
          f"card's {torch.cuda.get_device_properties(0).total_memory} less "
          f"the parameters), prompt bucket {eng0.prompt_pad}")
    if cap != conf["capacity"]:
        fail(f"chaos_serve long: the engine took {cap} slots, not "
             f"{conf['capacity']}")
    del eng0
    gc.collect()
    torch.cuda.empty_cache()
    at = conf["preempt_at"]
    sched = ft.FaultSchedule([ft.FaultEvent(at, "preempt")])
    eng, pre, f = _engine_run(arch, conf, params, mods, schedule=sched)
    _engine_line("chaos_serve long", "preempted", eng, pre, f)
    check_launches("chaos_serve long", f["counts"], f["expected"])
    launches["chaos_serve_long"] = f["counts"]
    readmit_ms = eng.admit_ms[conf["requests"]:]
    replay_ms = eng.decode_ms[at:at + eng.replay_steps]
    readmissions = sum(r["readmissions"] for r in pre["per_request"])
    print(f"[chaos_serve long] recovery from the preemption at step {at}: "
          f"{len(readmit_ms)} re-admissions {sum(readmit_ms):.1f} ms "
          f"(median {statistics.median(readmit_ms):.1f}), then "
          f"{eng.replay_steps} decode steps that replayed rows "
          f"{sum(replay_ms):.1f} ms: {sum(readmit_ms) + sum(replay_ms):.1f}"
          f" ms; wall {pre['wall_s']:.3f} s against the fault-free "
          f"{base['wall_s']:.3f} s; peak memory {f['peak']:.3f} GiB against "
          f"the fault-free {f0['peak']:.3f} GiB (a slot is {slot_gib:.3f} "
          f"GiB; a second cache for the replay would be "
          f"{cap * slot_gib:.3f} GiB more); outputs equal the fault-free "
          f"run's: {f['outputs'] == f0['outputs']}")
    if not (pre["requests"] == conf["requests"]
            and readmissions == conf["requests"]
            and f["outputs"] == f0["outputs"]
            and f["peak"] < f0["peak"] + slot_gib):
        fail(f"chaos_serve long: requests {pre['requests']}, readmissions "
             f"{readmissions}, outputs equal {f['outputs'] == f0['outputs']},"
             f" peak {f['peak']:.3f} GiB against {f0['peak']:.3f}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


CHAOS_TRAIN = dict(layers=1, seq=32, batch=2, steps=12, ckpt_every=4,
                   corrupt_at=9, preempt_at=10, stall_at=2, keep=4)


def phase_chaos_train(launches: dict):
    """bench_chaos.run_train_half at its smoke length on granite-8b at its
    published widths, cut to 1 of 36 layers (a checkpoint of the f32
    parameters and AdamW's two moments is then 7.4 GB), quant mode, seq 32,
    batch 2 in one microbatch: the fault-free run twice (its determinism),
    then 12 steps with a save every 4 into build/chaos_ckpt/, a stall at 2,
    a bitflip of the newest checkpoint at 9 and a preemption at 10 under
    `ft.run_with_retries`.  Gates: sessions start at 0 and 4, all three
    faults fired, the losses after the resume equal the fault-free run's,
    the restored tree's digests equal the saved ones, and the last
    checkpoint restores the run's final parameters bit for bit."""
    import shutil
    import torch
    import repro_torch.configs as cfgs
    from repro_torch import ft
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ShapeCfg, TDExecCfg
    from repro_torch.launch import train
    from repro_torch.optim.adamw import init_opt_state, tree_leaves_with_path

    conf = CHAOS_TRAIN
    base = cfgs.get("granite-8b")
    arch = base.replace(
        model=dataclasses.replace(base.model, n_layers=conf["layers"]),
        train=dataclasses.replace(base.train, n_microbatches=1),
        td=TDExecCfg(mode="quant"))
    cfg = arch.model
    if (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) != \
            (4096, 32, 8, 14336, 49152):
        fail(f"granite-8b widths {cfg}")
    shape = ShapeCfg("chaos", conf["seq"], conf["batch"], "train")
    mods = kernel_modules()
    d = ROOT / "build" / "chaos_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    saves, restores = [], []
    save, restore = ckpt.save, ckpt.restore

    def timed_save(*a, **k):
        h = save(*a, **k)
        saves.append(h)
        return h

    def timed_restore(*a, **k):
        t0 = time.perf_counter()
        out = restore(*a, **k)
        restores.append((out[0], time.perf_counter() - t0))
        return out

    def session_losses(ckpt_dir, schedule, record):
        def session():
            return train.run(arch, shape, conf["steps"], ckpt_dir,
                             ckpt_every=conf["ckpt_every"], log_every=4,
                             schedule=schedule, record=record)
        return ft.run_with_retries(
            session, policy=ft.RetryPolicy(backoff_s=0.0),
            on_restart=lambda n, e: print(f"[chaos_train] restart {n}: "
                                          f"{e!r}"))

    t_phase = time.monotonic()
    oracle = [session_losses(None, None, {})[1] for _ in range(2)]
    same = oracle[0] == oracle[1]
    spread = max(abs(a - b) for a, b in zip(*oracle))
    print(f"[chaos_train] granite-8b quant, {cfg.n_layers} layer, d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, batch "
          f"{shape.global_batch} x {shape.seq_len}: fault-free losses "
          f"{oracle[0]}; a second fault-free run equal bit for bit: {same} "
          f"(largest difference {spread!r})")
    torch.cuda.empty_cache()
    params = train.build_session(arch, shape, None)[0]
    n_params = sum(p.numel() for _, p in tree_leaves_with_path(params))
    del params
    ckpt_bytes = 12 * n_params + 4
    free = shutil.disk_usage(d).free
    print(f"[chaos_train] {n_params} parameters: a checkpoint (f32 "
          f"parameters and two moments) is {ckpt_bytes} bytes; free disk "
          f"{free} bytes")
    if free < conf["keep"] * ckpt_bytes:
        fail(f"chaos_train: {free} bytes free cannot hold {conf['keep']} "
             f"checkpoints of {ckpt_bytes} bytes")
    sched = ft.FaultSchedule([
        ft.FaultEvent(conf["stall_at"], "stall", {"duration_s": 0.01}),
        ft.FaultEvent(conf["corrupt_at"], "ckpt_corrupt",
                      {"mode": "bitflip", "seed": 3}),
        ft.FaultEvent(conf["preempt_at"], "preempt")])
    rec: dict = {}
    ckpt.save, ckpt.restore = timed_save, timed_restore
    try:
        for m in mods.values():
            m.launches = 0
        final, losses = session_losses(str(d), sched, rec)
        torch.cuda.synchronize()
        counts = {n: m.launches for n, m in mods.items()}
    finally:
        ckpt.save, ckpt.restore = save, restore
    resume = rec["starts"][-1]
    print(f"[chaos_train] sessions start at {rec['starts']}; faults "
          f"{rec['faults']}; losses after the resume {losses}")
    for h in saves:
        print(f"[chaos_train] save of step {h.step}: {h.copy_s:.2f} s to "
              f"the host, {h.write_s:.2f} s for the digests and the disk")
    for step, sec in restores:
        print(f"[chaos_train] restore (step {step} after verifying the "
              f"newer ones): {sec:.2f} s")
    n_steps = conf["preempt_at"] + conf["steps"] - resume
    per_step = train_expected(cfg, 1, "quant")
    check_launches("chaos_train", counts,
                   {n: c * n_steps for n, c in per_step.items()})
    launches["chaos_train"] = counts
    kinds = {k for _, k in rec["faults"]}
    match = (losses == oracle[0][resume:] if same else
             max(abs(a - b) for a, b in zip(losses, oracle[0][resume:]))
             <= spread)
    if not (rec["starts"] == [0, conf["ckpt_every"]]
            and {"stall", "ckpt_corrupt", "preempt"} <= kinds and match):
        fail(f"chaos_train: starts {rec['starts']}, faults {kinds}, losses "
             f"after the resume {losses} against {oracle[0][resume:]} "
             f"(gate: {'bit-equality' if same else f'spread {spread}'})")
    last = ckpt.latest_steps(str(d))[-1]
    step, tree, _ = ckpt.restore(str(d), (final, init_opt_state(final)),
                                 step=last, device="cuda")
    with open(d / f"step_{last:08d}" / ckpt.MANIFEST) as fh:
        manifest = json.load(fh)
    names, leaves = ckpt._flatten(tree)
    digests = ckpt._digests([ckpt._to_host(v)[0] for v in leaves])
    same_params = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_path(tree[0]), tree_leaves_with_path(final)))
    print(f"[chaos_train] step {step} restored: digests equal the saved "
          f"ones {digests == manifest['digests']}, names "
          f"{names == manifest['names']}, parameters equal the run's final "
          f"ones bit for bit {same_params}")
    if digests != manifest["digests"] or not same_params:
        fail("chaos_train: a restored tree differs from the saved one")
    del tree, final
    shutil.rmtree(d, ignore_errors=True)
    print(f"[chaos_train] phase wall {time.monotonic() - t_phase:.1f} s; "
          f"losses bit-equal to the fault-free run after the resume: "
          f"{losses == oracle[0][resume:]}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The MoE decoder and the config-only dense decoders at their published
# widths and depths.  "moe": granite-moe-1b-a400m (24 layers, d 1024, 16
# heads over 8 KV heads of 64, 32 experts top-8 of d_ff 512, vocab 49408)
# in td mode, not cut: the fixed-batch serve of SERVE's shape, the
# continuous-batching engine on SCHED's traffic, and training at the
# config's 2 microbatches and remat "dots" on TRAIN's batch (8 x 128),
# then one-off steps at remat none and full and with the bf16 gradient
# sum.  "dense_configs": qwen2.5-3b and qwen3-4b (36 layers each) served in
# a fixed batch of 4 x 128 prompts, 8 new tokens.
MOE = dict(arch="granite-moe-1b-a400m", td_steps=3, quant_steps=1,
           remat_steps=2)
DENSE_CONFIGS = dict(archs=("qwen2.5-3b", "qwen3-4b"), batch=4,
                     prompt_len=128, gen=8)


def moe_arch(mode: str, remat: str | None = None, grad_dtype=None):
    """granite-moe-1b-a400m at its published widths, depth and train
    settings, in ``--td mode`` (``remat`` / ``grad_dtype`` override the
    config's)."""
    import repro_torch.configs as cfgs
    from repro_torch.launch import td_cli
    arch = td_cli.apply_td_args(cfgs.get(MOE["arch"]), mode)
    train = arch.train
    if remat is not None:
        train = dataclasses.replace(train, remat=remat)
    if grad_dtype is not None:
        train = dataclasses.replace(train, grad_allreduce_dtype=grad_dtype)
    return arch.replace(train=train)


def _train_run(tag: str, arch, steps: int, launches: dict,
               batch: int = TRAIN["batch"], depth: str = "not cut") -> dict:
    """`train.run` of ``arch`` on ``batch`` x TRAIN's sequence, launches
    checked against `train_expected`, host syncs counted inside each step
    (none allowed); returns its losses, grad norms, step ms and peak
    GiB."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import train
    shape = ShapeCfg("cli", TRAIN["seq"], batch, "train")
    cfg, mode, remat = arch.model, arch.td.mode, arch.train.remat
    n_micro = arch.microbatches_for(shape.name)
    mods = kernel_modules()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _counts_reset(mods)
    stats: dict = {}
    t0 = time.monotonic()
    out: dict = {}
    calib, calls = step_syncs(lambda: out.update(losses=train.run(
        arch, shape, steps, None, log_every=1, seed=0, stats=stats)[1]),
        ("train",))
    losses = out["losses"]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = {n: m.launches for n, m in mods.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [t * 1e3 for t in stats["step_s"]]
    print(f"[{tag}] {cfg.name} {mode}, {cfg.n_layers} layers ({depth}), "
          f"batch {shape.global_batch} x {shape.seq_len} in {n_micro} "
          f"microbatches, remat {remat}, grad sum "
          f"{arch.train.grad_allreduce_dtype}, "
          f"{arch.train.compute_dtype} compute: wall {wall:.1f} s (init "
          f"included), peak memory {peak:.2f} GiB")
    print(f"[{tag}] step ms {[round(t, 1) for t in step_ms]}; losses "
          f"{losses}; grad norms {stats['grad_norm']}; host syncs inside "
          f"each step {calls['train']} (torch's sync debug mode; a "
          f"calibrating blocking copy counts {calib})")
    if any(calls["train"]):
        fail(f"{tag}: a train step waits for the device (host syncs "
             f"{calls['train']})")
    check_launches(tag, counts, {n: c * steps for n, c in train_expected(
        cfg, n_micro, mode, remat).items()})
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"{tag}: losses {losses}")
    launches[tag] = counts
    return dict(losses=losses, grad_norms=stats["grad_norm"],
                step_ms=step_ms, peak=peak)


def _moe_grad_sums() -> None:
    """One train step's gradients of full-width granite-moe (td, 2
    microbatches, remat "dots") summed in float32 and in bfloat16, from
    the same parameters, batch and key: each bf16 leaf within one bf16
    ulp (at the leaf's largest magnitude) of the float32 sum cast to
    bf16; then one bf16 step at 4 microbatches, held bit for bit to the
    bf16 running sum of the microbatch gradients (caught by hooks on the
    leaves).  `adamw.apply_updates` is replaced for the three steps by one
    that keeps the gradients and leaves the parameters as they are."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.synthetic import DataCfg, SyntheticStream
    from repro_torch.launch import steps
    from repro_torch.models import common, get_api
    from repro_torch.optim import adamw

    shape = ShapeCfg("cli", TRAIN["seq"], TRAIN["batch"], "train")
    archs = {g: moe_arch("td", grad_dtype=g)
             for g in ("float32", "bfloat16")}
    cfg = archs["float32"].model
    pol = common.resolve_arch_policy(archs["float32"], device="cuda")
    params = get_api(cfg)["init"](0, cfg, pol, device="cuda")
    opt = adamw.init_opt_state(params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticStream(
        DataCfg(vocab=cfg.vocab, seq_len=shape.seq_len,
                global_batch=shape.global_batch, seed=0)).batch(0).items()}
    kept: dict = {}
    update = adamw.apply_updates

    def keep(p, grads, state, train_cfg):
        kept["grads"] = [g for _, g in adamw.tree_leaves_with_path(grads)]
        return p, state, {"grad_norm": adamw.global_norm(grads),
                          "lr": torch.zeros(())}
    solve = common.resolve_arch_policy
    out = {}
    try:
        adamw.apply_updates = keep
        common.resolve_arch_policy = lambda a, device=None: pol
        for g, arch in archs.items():
            ms = time.monotonic()
            _, _, m = steps.build_train_step(arch, shape)(params, opt, batch,
                                                          0)
            torch.cuda.synchronize()
            out[g] = (kept.pop("grads"), float(m["loss"]),
                      float(m["grad_norm"]), (time.monotonic() - ms) * 1e3)
    finally:
        adamw.apply_updates = update
        common.resolve_arch_policy = solve
    (g32, l32, n32, ms32), (g16, l16, n16, ms16) = out["float32"], \
        out["bfloat16"]
    worst, n_leaves = 0.0, 0
    for a, b in zip(g32, g16):
        if b.dtype != torch.bfloat16 or a.dtype != torch.float32:
            fail(f"moe grad sums: leaf dtypes {a.dtype}, {b.dtype}")
        a16 = a.to(torch.bfloat16)
        top = float(a16.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
        diff = float((b.float() - a16.float()).abs().max())
        ratio = diff / ulp if ulp else (0.0 if diff == 0 else math.inf)
        worst = max(worst, ratio)
        n_leaves += 1
    print(f"[moe_grad_sum] {cfg.name} td, 2 microbatches, remat dots: loss "
          f"{l32} (f32 sum) vs {l16} (bf16 sum), grad norm {n32} vs {n16}; "
          f"step ms {ms32:.1f} vs {ms16:.1f}; {n_leaves} leaves, largest "
          f"|bf16 sum - bf16(f32 sum)| {worst:.3f} bf16 ulps of the leaf's "
          f"largest magnitude")
    if l32 != l16 or worst > 1.0:
        fail("moe grad sums: the bf16 sum is not within one bf16 ulp of the "
             "f32 sum")
    del g32, g16

    # compute is bf16, so each microbatch's gradient is a bf16 value: over
    # 2 microbatches the bf16 running sum equals the f32 sum cast to bf16
    # and the check above cannot tell them apart.  Over 4 it can: the step's
    # sum is held bit for bit to the bf16 running sum of the gradients that
    # reach the leaves, microbatch by microbatch, and its leaves that differ
    # from the f32 sum cast to bf16 are counted.
    n_mb = 4
    arch = archs["bfloat16"]
    arch = arch.replace(train=dataclasses.replace(arch.train,
                                                  n_microbatches=n_mb))
    leaves = [p for _, p in adamw.tree_leaves_with_path(params)]
    run16: list = [None] * len(leaves)
    run32: list = [None] * len(leaves)

    def caught(j):
        def hook(p):
            if run16[j] is None:
                run16[j] = torch.zeros_like(p.grad, dtype=torch.bfloat16)
                run32[j] = torch.zeros_like(p.grad)
            run16[j].add_(p.grad.to(torch.bfloat16))
            run32[j].add_(p.grad)
        return hook
    hooks = [p.requires_grad_(True).register_post_accumulate_grad_hook(
        caught(j)) for j, p in enumerate(leaves)]
    try:
        adamw.apply_updates = keep
        common.resolve_arch_policy = lambda a, device=None: pol
        steps.build_train_step(arch, shape)(params, opt, batch, 0)
        torch.cuda.synchronize()
        g16 = kept.pop("grads")
    finally:
        adamw.apply_updates = update
        common.resolve_arch_policy = solve
        for h in hooks:
            h.remove()
    n_bad = n_apart = 0
    for got, r16, r32 in zip(g16, run16, run32):
        want = r16.div_(torch.full((), n_mb, dtype=torch.bfloat16,
                                   device="cuda"))
        n_bad += not _bits_equal(got, want)
        n_apart += not _bits_equal(want, (r32 / n_mb).to(torch.bfloat16))
    print(f"[moe_grad_sum] {n_mb} microbatches: {len(g16)} leaves, "
          f"{n_bad} differ from the bf16 running sum of their microbatch "
          f"gradients (tolerance 0, bit patterns compared); {n_apart} "
          f"leaves where that sum differs from the f32 sum cast to bf16")
    if n_bad:
        fail(f"moe grad sums: {n_bad} leaves of the {n_mb}-microbatch bf16 "
             "sum are not the bf16 running sum")
    del g16, run16, run32, leaves, params, opt


def _moe_determinism() -> None:
    """Two identical prefills of full-width granite-moe (td, bf16, batch
    SERVE x prompt 128) on the card: logits and every layer's cache bit
    for bit equal (the combine sums each token's slots in slot order,
    without atomics)."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import serve, steps
    from repro_torch.models import common, get_api
    arch = moe_arch("td")
    cfg = arch.model
    pol = common.resolve_arch_policy(arch, device="cuda")
    params = get_api(cfg)["init"](0, cfg, pol, dtype=torch.bfloat16,
                                  device="cuda")
    shape = ShapeCfg("serve", SERVE["prompt_len"] + SERVE["gen"],
                     SERVE["batch"], "decode")
    pre = steps.build_prefill_step(arch, shape, device="cuda")
    toks = torch.from_numpy(serve.prompts(0, SERVE["batch"],
                                          SERVE["prompt_len"],
                                          cfg.vocab)).cuda()
    outs = []
    with torch.inference_mode():
        for _ in range(2):
            logits, state = pre(params, {"tokens": toks})
            outs.append((logits, state["layers"]))
    torch.cuda.synchronize()
    same = _bits_equal(outs[0][0], outs[1][0]) and all(
        torch.equal(a[n], b[n]) for a, b in zip(outs[0][1], outs[1][1])
        for n in ("k", "v"))
    print(f"[moe_determinism] two full-width prefills (B {SERVE['batch']} x "
          f"{SERVE['prompt_len']}): logits and caches bit-equal {same}")
    if not same:
        fail("moe: two identical prefills differ")
    del outs, params


# the MoE's expert matmuls as td_vmm lanes (32 experts, w a lane) at the
# path's per-lane M: prefill and a train microbatch (512 tokens, cap 160),
# the engine's admission (a prompt bucket of 192 tokens, cap 60) and every
# decode step (batch 4 or the engine's 8 slots, cap = top_k = 8)
MOE_LANES = [("prefill/train", 160), ("engine admission", 60),
             ("decode", 8)]
MOE_LANES_TIMED = ("prefill/train", "decode")


def _event_ms(fn) -> float:
    """One call of ``fn`` between an event pair (for a host-paced plain
    version, which no spin covers)."""
    import torch
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def _moe_kernel_checks(rows: list) -> None:
    """The kernels at the MoE path's shapes, against their plain versions
    on the card: td_vmm's 32-lane expert calls (wi/wg: K 1024, N 512; wo:
    K 512, N 1024; w a lane, the solved sigma, a seed a lane) bit for bit
    against the plain version and 32 single launches, timed at M 160 and
    M 8 against the single launches; flash_attn at D 64 in bf16 (the
    tensor cores: B 4, Sq 128, Hq 16, Hkv 8, the serve prefill, the
    train microbatch and the engine's admission) and decode_gqa at D 64, g
    2 (B 4, S 144; the engine's B 8, S 192), within the existing
    tolerances, each timed against SDPA."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels.decode_gqa import decode_gqa as dg
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.td_vmm import td_vmm as tv
    from repro_torch.kernels.td_vmm.ref import derive_seed
    from repro_torch.tdsim.policy import solve_td_policy

    pol = solve_td_policy(4, 4, 576, None)
    e, d, f = 32, 1024, 512
    gen = torch.Generator(device="cuda").manual_seed(20)
    par = torch.tensor([[pol.sigma_chain, float(pol.tdc_q)]] * e,
                       dtype=torch.float32, device="cuda")
    seeds = torch.tensor([derive_seed(k) for k in prng.split((0, 20), e)],
                         dtype=torch.int64, device="cuda")
    kw = dict(bits_a=4, bits_w=4, n_chain=576)
    err = 0.0
    for label, m in MOE_LANES:
        for nm, k, n in (("wi", d, f), ("wo", f, d)):
            x, w = _codes(gen, (e, m, k), 4), _codes(gen, (e, k, n), 4)
            want = tv.td_vmm_plain(x, w, par, seeds, **kw)
            err = max(err, _lane_check(tv, f"moe {label} {nm}", x, w, par,
                                       seeds, kw, want=want, tag="moe"))
            if label in MOE_LANES_TIMED and nm == "wi":
                # the plain version loops the lanes on the host: one call
                # between an event pair before and one after the turns
                plain = [_event_ms(lambda: tv.td_vmm_plain(
                    x, w, par, seeds, **kw))]
                t = in_turns("moe", f"td_vmm {label} {nm} lanes", {
                    "kernel": lambda: tv.td_vmm(x, w, par, seeds, **kw),
                    "singles": lambda: [tv.td_vmm(x[i], w[i], par[i],
                                                  seeds[i:i + 1], **kw)
                                        for i in range(e)]},
                    {"kernel": 20, "singles": 5}, cold=m <= 8)
                plain.append(_event_ms(lambda: tv.td_vmm_plain(
                    x, w, par, seeds, **kw)))
                t["plain_ms"] = statistics.median(plain)
                b_ms, b_by = bound_ms(4 * (e * m * k + e * k * n + e * m * n)
                                      + 16 * e, 2 * e * m * k * n * 4,
                                      "int8")
                plan = tv.td_vmm_plan(m, k, n, 576, 4)
                print(f"[moe] td_vmm {label} {nm}: {e} lanes ({plan.route} "
                      f"route): kernel {t['kernel_ms']:.5f} ms, {e} single "
                      f"launches {t['singles_ms']:.5f} ms, plain "
                      f"{t['plain_ms']:.4f} ms (event pair, before and "
                      f"after: {plain[0]:.4f}, {plain[1]:.4f}), bound "
                      f"{b_ms:.5f} ms "
                      f"({b_by}): kernel at {b_ms / t['kernel_ms']:.1%} of "
                      f"it")
                rows.append(dict(
                    name="td_vmm", route="cuda",
                    source="src/repro_torch/csrc/td_vmm.cu",
                    replaces="src/repro/kernels/td_vmm/td_vmm.py:110",
                    max_abs_err=err, library_ms=None, ms=t["kernel_ms"],
                    plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                    shape=f"moe {label} {nm}, lanes {e} x M {m} K {k} N {n} "
                          f"bits 4/4, w a lane, solved sigma",
                    timed={"singles_ms": t["singles_ms"]}))
            del x, w, want
    torch.cuda.empty_cache()

    hq, hkv, hd = 16, 8, 64
    s_cache = SERVE["prompt_len"] + SERVE["gen"]
    f_err = 0.0
    for label, b, sq, skv in (("prefill", 4, 128, s_cache),
                              ("train microbatch", 4, 128, 128),
                              ("engine admission", 1, slot_len(SCHED),
                               slot_len(SCHED))):
        q = _randn(gen, (b, sq, hq, hd))
        k = _randn(gen, (b, skv, hkv, hd))
        v = _randn(gen, (b, skv, hkv, hd))
        args = (q, k, v, _i32([sq] * b), _i32([0]))
        got = fa.flash_attn(*args)
        want = fa.flash_attn_plain(*args)
        torch.cuda.synchronize()
        ferr, frac, ulp = _cmp(got, want)
        route = (f"tensor cores, key split {fa.flash_plan(b, sq, hq, hkv, skv)}"
                 if fa.tensor_core_route(q, k) else "CUDA cores")
        print(f"[moe] flash_attn {label}: B={b} Sq={sq} Skv={skv} Hq={hq} "
              f"Hkv={hkv} D={hd} bf16 ({route}): max |kernel - "
              f"plain| {ferr:g}, in bf16 ulps {ulp:.3f}, differing "
              f"{frac:.4f}")
        if not _close(ferr, frac, ulp):
            fail(f"flash_attn disagrees with its plain version (moe "
                 f"{label}, D 64)")
        f_err = max(f_err, ferr)
        if label == "prefill":
            qt = q.transpose(1, 2).contiguous()
            kt = k[:, :sq].transpose(1, 2).contiguous()
            vt = v[:, :sq].transpose(1, 2).contiguous()
            t = in_turns("moe", "flash_attn prefill D 64", {
                "plain": lambda: fa.flash_attn_plain(*args),
                "kernel": lambda: fa.flash_attn(*args),
                "library": lambda: _sdpa(qt, kt, vt, True)},
                {"plain": 5, "kernel": 30, "library": 30}, alone=True)
            b_ms, b_by = flash_bound(b, sq, [sq] * b, hq, hkv, hd, True)
            print(f"[moe] flash_attn prefill D 64: kernel "
                  f"{t['kernel_ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
                  f"sdpa {t['library_ms']:.5f} ms, bound {b_ms:.5f} ms "
                  f"({b_by}): kernel at {b_ms / t['kernel_ms']:.1%} of its "
                  f"bound, {t['kernel_ms'] / t['library_ms']:.2f}x sdpa")
            rows.append(dict(
                name="flash_attn", route="cuda",
                source="src/repro_torch/csrc/flash_attn.cu",
                replaces="src/repro/kernels/flash_attn/flash_attn.py:55",
                max_abs_err=f_err, ms=t["kernel_ms"], plain_ms=t["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=t["library_ms"],
                shape=f"moe prefill B={b} Sq={sq} S_cache={skv} Hq={hq} "
                      f"Hkv={hkv} D={hd} causal, {route}",
                timed={k2: t[k2] for k2 in t if k2.endswith("_us")}))
            del qt, kt, vt
        del q, k, v, args, got, want
    torch.cuda.empty_cache()
    _decode_rows(rows, "moe", gen, hq, hkv, hd, [
        ("decode", SERVE["batch"], s_cache,
         SERVE["prompt_len"] + SERVE["gen"] // 2),
        ("engine decode", SCHED["capacity"], slot_len(SCHED), None)])


def _decode_rows(rows, tag, gen, hq, hkv, hd, cases) -> None:
    """decode_gqa at (label, B, S, timed length or None) against its plain
    version (`_decode_check`, several length patterns), and, where a
    length is given, timed against SDPA with a cold L2: one row each."""
    import torch
    from repro_torch.kernels.decode_gqa import decode_gqa as dg
    for label, b, s, length in cases:
        q = _randn(gen, (b, hq, hd))
        k = _randn(gen, (b, s, hkv, hd))
        v = _randn(gen, (b, s, hkv, hd))
        _, chunk = dg.split_plan(s, b, hkv)
        err = 0.0
        for lens in ([(37 * i) % s + 1 for i in range(b)], [s] * b,
                     [[0, 1, chunk, s + 9][i % 4] for i in range(b)]):
            err = max(err, _decode_check(
                dg, f"{tag} {label} B={b} S={s} Hq={hq} Hkv={hkv} D={hd}",
                q, k, v, lens, chunk))
        if length is not None:
            lt = _i32([length] * b)
            qt = q[:, :, None].contiguous()
            kt = k[:, :length].transpose(1, 2).contiguous()
            vt = v[:, :length].transpose(1, 2).contiguous()
            t = in_turns(tag, f"decode_gqa {label} g {hq // hkv} D {hd}", {
                "plain": lambda: dg.decode_gqa_plain(q, k, v, lt),
                "kernel": lambda: dg.decode_gqa(q, k, v, lt),
                "library": lambda: _sdpa(qt, kt, vt, False)},
                {"plain": 5, "kernel": 30, "library": 30}, cold=True,
                alone=True)
            b_ms, b_by = bound_ms(
                2 * (2 * b * hq * hd + 2 * b * length * hkv * hd),
                4 * b * hq * length * hd, "bf16")
            print(f"[{tag}] decode_gqa {label}: B={b} S={s} length={length} "
                  f"Hq={hq} Hkv={hkv} D={hd}: kernel {t['kernel_ms']:.5f} "
                  f"ms, plain {t['plain_ms']:.5f} ms, sdpa "
                  f"{t['library_ms']:.5f} ms, bound {b_ms:.5f} ms ({b_by}): "
                  f"kernel at {b_ms / t['kernel_ms']:.1%} of its bound, "
                  f"{t['kernel_ms'] / t['library_ms']:.2f}x sdpa")
            rows.append(dict(
                name="decode_gqa", route="cuda",
                source="src/repro_torch/csrc/decode_gqa.cu",
                replaces="src/repro/kernels/decode_gqa/decode_gqa.py:45",
                max_abs_err=err, ms=t["kernel_ms"], plain_ms=t["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=t["library_ms"],
                shape=f"{tag} {label} B={b} S={s} length={length} Hq={hq} "
                      f"Hkv={hkv} D={hd}",
                timed={k2: t[k2] for k2 in t if k2.endswith("_us")}))
            del qt, kt, vt
        del q, k, v
    torch.cuda.empty_cache()


def phase_moe(launches: dict, rows: list):
    """The MoE decoder at full width and depth: granite-moe-1b-a400m, 24
    layers, td mode (4/4, the port's solve), seeded bf16 weights.  Serves
    SERVE's batch through `serve.run` (launches checked: the 32 experts of
    each projection are one td_vmm launch) and counts its host syncs a
    step, checks that two identical prefills are bit-equal, serves SCHED's
    traffic through the continuous-batching engine (J/token, the meter's
    rows equal to its total), trains TRAIN's batch at the config's remat
    "dots" (3 td steps, 1 quant step), then 2 td steps each at remat none
    and full (the same losses and grad norms as "dots", peak memory and
    step ms beside it), compares the bf16 gradient sum with the f32 one,
    runs the smoke MoE on the card against the CPU, and holds the kernels
    to their plain versions at this path's shapes."""
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.tdsim.policy import TDPolicy
    t_phase = time.monotonic()
    walls: dict = {}

    def lap(part: str) -> None:
        walls[part] = time.monotonic() - t_phase - sum(walls.values())
    arch = moe_arch("td")
    cfg = arch.model
    _serve_full("moe_serve", arch, SERVE["batch"], SERVE["prompt_len"],
                SERVE["gen"], launches, syncs=True)
    torch.cuda.empty_cache()
    _moe_determinism()
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve")

    mods = kernel_modules()
    eng, out, counts, peak = _sched_run(arch, SCHED, None, True, mods)
    _sched_report("moe_engine", "continuous", eng, out, peak)
    a, d = len(eng.admit_ms), eng.steps_run
    check_launches("moe_engine", counts, serve_expected(eng.cfg, d, a))
    toks = [t for r in eng.done.values() for t in r.generated]
    if out["requests"] != SCHED["requests"] or min(toks) < 0 or \
            max(toks) >= cfg.vocab:
        fail(f"moe_engine: {out['requests']} requests, tokens in "
             f"[{min(toks)}, {max(toks)}]")
    _energy_report("moe_engine", eng, out)
    launches["moe_engine"] = counts
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    lap("engine")

    runs = {}
    for mode in ("td", "quant"):
        runs[("dots", mode)] = _train_run(
            f"moe_train_{mode}", moe_arch(mode), MOE[f"{mode}_steps"],
            launches)
    for remat in ("none", "full"):
        runs[(remat, "td")] = _train_run(
            f"moe_train_td_{remat}", moe_arch("td", remat=remat),
            MOE["remat_steps"], launches)
    ref = runs[("dots", "td")]
    n = MOE["remat_steps"]
    for remat in ("none", "dots", "full"):
        r = runs[(remat, "td")]
        print(f"[moe_train] remat {remat}: peak {r['peak']:.2f} GiB, step "
              f"{n} ms {r['step_ms'][n - 1]:.1f}, losses {r['losses'][:n]}, "
              f"grad norms {r['grad_norms'][:n]}")
        if r["losses"][:n] != ref["losses"][:n] or any(
                abs(x - y) > 1e-5 * abs(y) for x, y in
                zip(r["grad_norms"][:n], ref["grad_norms"][:n])):
            fail(f"moe_train: remat {remat} gives other losses or grad "
                 "norms than dots")
    _moe_grad_sums()
    gc.collect()
    torch.cuda.empty_cache()
    lap("train")
    # a dropless capacity, so that a token's experts do not depend on the
    # rest of the batch
    smoke = cfgs.get_smoke(MOE["arch"])
    _family_small("moe_small", smoke.replace(model=dataclasses.replace(
        smoke.model, moe=dataclasses.replace(smoke.model.moe,
                                             capacity_factor=8.0))),
                  TDPolicy(mode="td", n_chain=64), remat="dots")
    lap("card vs CPU")
    _moe_kernel_checks(rows)
    lap("kernel checks")
    print(f"[moe] phase wall {time.monotonic() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + ")")


def phase_dense_configs(launches: dict, rows: list):
    """The config-only dense decoders at full width and depth: qwen2.5-3b
    (QKV bias, 16 heads over 2 KV heads: decode_gqa at g 8) and qwen3-4b
    (qk-norm, 32 over 8), 36 layers each, td mode, served in a fixed
    batch (launches checked); then decode_gqa at g 8, D 128 and td_vmm at
    these models' ragged contractions (K 2560 and 9728 of qwen3-4b, 11008
    of qwen2.5-3b against chains of 576) against their plain versions."""
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.kernels.td_vmm import td_vmm as tv
    from repro_torch.launch import td_cli
    from repro_torch.tdsim.policy import solve_td_policy
    t_phase = time.monotonic()
    conf = DENSE_CONFIGS
    for name in conf["archs"]:
        _serve_full(f"dense_configs {name}",
                    td_cli.apply_td_args(cfgs.get(name), "td"),
                    conf["batch"], conf["prompt_len"], conf["gen"], launches)
        gc.collect()
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(21)
    s = conf["prompt_len"] + conf["gen"]
    _decode_rows(rows, "dense_configs", gen, 16, 2, 128, [
        ("qwen2.5-3b decode", conf["batch"], s,
         conf["prompt_len"] + conf["gen"] // 2)])
    pol = solve_td_policy(4, 4, 576, None)
    solved = (pol.sigma_chain, float(pol.tdc_q))
    seed = torch.tensor([33350994], dtype=torch.int64, device="cuda")
    kw = dict(bits_a=4, bits_w=4, n_chain=576)
    err = 0.0
    m_pre = conf["batch"] * conf["prompt_len"]
    for label, m, k, n in (
            ("qwen3-4b prefill attn.wq", m_pre, 2560, 4096),
            ("qwen3-4b prefill mlp.wi", m_pre, 2560, 9728),
            ("qwen3-4b decode mlp.wo", conf["batch"], 9728, 2560),
            ("qwen2.5-3b prefill mlp.wo", m_pre, 11008, 2048),
            ("qwen2.5-3b decode attn.wk", conf["batch"], 2048, 256)):
        x, w = _codes(gen, (m, k), 4), _codes(gen, (k, n), 4)
        err = max(err, _td_vmm_check(tv, f"dense_configs {label}", x, w,
                                     seed, kw, [solved]))
        del x, w
    tv_row = next(r for r in rows if r["name"] == "td_vmm")
    tv_row["max_abs_err"] = max(tv_row["max_abs_err"], err)
    print(f"[dense_configs] phase wall {time.monotonic() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# The enc-dec family (seamless-m4t-large-v2, its audio frontend a stub) and
# a decoder's stub frontend (internvl2-26b's vision adapter) at full width.
ENCDEC = dict(arch="seamless-m4t-large-v2", td_steps=3, quant_steps=1,
              long_steps=8)
# internvl2-26b: serve 4 x 128 prompts (64 patches) and 8 new tokens; its
# config's 16 microbatches take a global batch of 16 (one row each)
FRONTEND = dict(arch="internvl2-26b", gen=8, train_layers=2,
                train_batch=16, td_steps=1, quant_steps=1)


def _steps_serve(tag: str, arch, batch: int, prompt_len: int, steps: int,
                 n_front: int, launches: dict) -> None:
    """Prefill of ``batch`` prompts of ``prompt_len`` tokens with
    ``n_front`` frontend positions, then ``steps`` greedy decode steps,
    through `steps.build_prefill_step` / `build_serve_step` on seeded
    bf16 weights: each step timed on the host clock to a device sync,
    its host syncs counted (none allowed), launches checked, logits
    finite, tokens in range.  Returns the steps' ms, the prefill's
    first."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import serve, steps as steps_lib
    from repro_torch.models import common, get_api
    cfg = arch.model
    pol = common.resolve_arch_policy(arch, device="cuda")
    params = get_api(cfg)["init"](0, cfg, pol, dtype=torch.bfloat16,
                                  device="cuda")
    s_cache = prompt_len + steps + (n_front if cfg.family == "decoder"
                                    else 0)
    shape = ShapeCfg("serve", s_cache, batch, "decode")
    pre = steps_lib.build_prefill_step(arch, shape, device="cuda")
    srv = steps_lib.build_serve_step(arch, shape, device="cuda")
    toks = torch.from_numpy(serve.prompts(1, batch, prompt_len,
                                          cfg.vocab)).cuda()
    batch_in = {"tokens": toks}
    if n_front:
        batch_in["embeds"] = torch.from_numpy(serve.frontend_embeds(
            1, batch, n_front, cfg.d_frontend or cfg.d_model)).to(
                "cuda", torch.bfloat16)
    mods = kernel_modules()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counts_reset(mods)
    ms, syncs = [], []
    with torch.inference_mode(), sync_log() as log:
        t0 = time.monotonic()
        logits, state = pre(params, batch_in)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        syncs.append(len(log))
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        finite = bool(torch.isfinite(logits).all())
        out = [tok]
        for _ in range(steps):
            n0 = len(log)
            t0 = time.monotonic()
            tok, state = srv(params, tok, state)
            syncs.append(len(log) - n0)
            torch.cuda.synchronize()
            ms.append((time.monotonic() - t0) * 1e3)
            out.append(tok)
    counts = {n: m.launches for n, m in mods.items()}
    ids = torch.cat(out, 1).cpu()
    print(f"[{tag}] {cfg.name}, {cfg.n_layers} layers, batch {batch} x "
          f"({n_front} frontend positions + {prompt_len} tokens), "
          f"{steps} decode steps: prefill {ms[0]:.1f} ms, decode median "
          f"{statistics.median(ms[1:]):.1f} ms a token (all "
          f"{[round(t, 1) for t in ms[1:]]}); host syncs prefill "
          f"{syncs[0]}, each decode step {syncs[1:]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"tokens[0] {ids[0].tolist()}")
    check_launches(tag, counts, serve_expected(cfg, steps))
    if any(syncs):
        fail(f"{tag}: a step waits for the device")
    if not finite or int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab:
        fail(f"{tag}: logits finite {finite}, tokens in "
             f"[{int(ids.min())}, {int(ids.max())}]")
    launches[tag] = counts
    del params, state, logits
    return ms


def _family_small(tag: str, smoke, pol_td0, remat: str = "full") -> None:
    """A smoke ArchConfig (f32 compute, 2 microbatches, ``remat``) on the
    card against the CPU: prefill (with its frontend's embeddings) + 5
    greedy decode steps in td at sigma 0 (tokens equal, logits within
    1e-3), two train steps in td at the solved policy on batches with the
    driver's frontend inputs (losses rtol 1e-4, grad norms rtol 1e-3, as
    `phase_train_small`)."""
    import torch
    from repro_torch.configs.base import ShapeCfg, TrainCfg
    from repro_torch.data.synthetic import DataCfg, SyntheticStream
    from repro_torch.launch import serve, steps, td_cli, train
    from repro_torch.models import common, get_api
    from repro_torch.optim import adamw

    cfg = smoke.model
    arch = td_cli.apply_td_args(smoke, "td").replace(
        train=TrainCfg(n_microbatches=2, remat=remat,
                       compute_dtype="float32"))
    solved = common.resolve_arch_policy(arch, device="cuda")
    solve = common.resolve_arch_policy
    prompt, gen = 8, 6
    n_front = 8 if cfg.frontend is not None else 0
    batch_in = {"tokens": torch.from_numpy(serve.prompts(1, 2, prompt,
                                                         cfg.vocab))}
    if n_front:
        batch_in["embeds"] = torch.from_numpy(serve.frontend_embeds(
            1, 2, n_front, cfg.d_frontend or cfg.d_model))
    s_cache = prompt + gen + (n_front if cfg.family == "decoder" else 0)
    stream = SyntheticStream(DataCfg(vocab=cfg.vocab, seq_len=16,
                                     global_batch=4, seed=0))
    res = {}
    for dev in ("cpu", "cuda"):
        try:
            common.resolve_arch_policy = lambda a, device=None: pol_td0
            sshape = ShapeCfg("serve", s_cache, 2, "decode")
            pre = steps.build_prefill_step(arch, sshape)
            srv = steps.build_serve_step(arch, sshape)
            common.resolve_arch_policy = lambda a, device=None: solved
            trn = steps.build_train_step(arch, ShapeCfg("t", 16, 4, "train"))
        finally:
            common.resolve_arch_policy = solve
        p = _to(get_api(cfg)["init"](0, cfg, pol_td0, device="cpu"), dev)
        with torch.inference_mode():
            logits, state = pre(p, {k: v.to(dev)
                                    for k, v in batch_in.items()})
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            out = [tok]
            for _ in range(5):
                tok, state = srv(p, tok, state)
                out.append(tok)
        opt = adamw.init_opt_state(p)
        losses, gns = [], []
        for i in range(2):
            b = train.frontend_inputs(
                {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch(i).items()}, stream, i, cfg,
                torch.device(dev))
            p, opt, m = trn(p, opt, b, i)
            losses.append(float(m["loss"]))
            gns.append(float(m["grad_norm"]))
        res[dev] = (logits.float().cpu(), torch.cat(out, 1).cpu(), losses,
                    gns)
    (lc, tc, lsc, gc_), (lg, tg, lsg, gg) = res["cpu"], res["cuda"]
    err = float((lc - lg).abs().max())
    same = bool(torch.equal(tc, tg))
    print(f"[{tag}] {cfg.name}{' (tied embeddings)' * cfg.tie_embeddings}"
          f" f32, card vs CPU: serve td sigma=0 tokens equal {same}, max "
          f"|logit diff| {err:.3e} (tolerance 1e-3); train td solved, 2 "
          f"steps, remat {remat}: losses {lsg} vs {lsc}, grad norms {gg} vs "
          f"{gc_}")
    ok = same and err <= 1e-3 and all(
        abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lsg, lsc)) and all(
        abs(a - b) <= 1e-3 * abs(b) for a, b in zip(gg, gc_))
    if not ok:
        fail(f"{tag}: the smoke model on the card disagrees with the CPU run")


def _td_vmm_rows(tag: str, rows: list, gen, checks: list) -> None:
    """td_vmm at ``checks`` ((label, M, K, N) of the path, bits 4/4,
    n_chain 576) against its plain version (bit for bit at sigma 0, noise
    at the solved sigma as `_td_vmm_check` holds it), each also timed: the
    kernel at the solved sigma in two turns, decode shapes (M <= 8) with a
    cold L2, between two calls of the plain version each in an event pair
    (it is host-paced at long contractions, where a spin cannot cover
    it), each a row with its bound."""
    import torch
    from repro_torch.kernels.td_vmm import td_vmm as tv
    from repro_torch.tdsim.policy import solve_td_policy
    pol = solve_td_policy(4, 4, 576, None)
    solved = (pol.sigma_chain, float(pol.tdc_q))
    seed = torch.tensor([33350994], dtype=torch.int64, device="cuda")
    kw = dict(bits_a=4, bits_w=4, n_chain=576)
    par = torch.tensor(solved, dtype=torch.float32, device="cuda")
    err = 0.0
    for label, m, k, n in checks:
        x, w = _codes(gen, (m, k), 4), _codes(gen, (k, n), 4)
        e = _td_vmm_check(tv, f"{tag} {label}", x, w, seed, kw, [solved])
        err = max(err, e)
        cold = m <= 8

        def plain_ms() -> float:
            if cold:
                flush_l2()
            return _event_ms(lambda: tv.td_vmm_plain(x, w, par, seed, **kw))
        plain = [plain_ms()]
        t = in_turns(tag, f"td_vmm {label}", {
            "kernel": lambda: tv.td_vmm(x, w, par, seed, **kw)},
            {"kernel": 10 if m * n > 2**26 else 20}, cold=cold)
        plain.append(plain_ms())
        t["plain_ms"] = statistics.median(plain)
        b_ms, b_by = bound_ms(4 * (m * k + k * n + m * n) + 16,
                              2 * m * k * n * 4, "int8")
        plan = tv.td_vmm_plan(m, k, n, 576, 4)
        print(f"[{tag}] td_vmm {label}: M {m} K {k} N {n} ({plan.route} "
              f"route, {'cold' if cold else 'warm'} L2): kernel "
              f"{t['kernel_ms']:.5f} ms, plain {t['plain_ms']:.4f} ms "
              f"(event pair, before and after: {plain[0]:.4f}, "
              f"{plain[1]:.4f}), bound {b_ms:.5f} ms ({b_by}): kernel at "
              f"{b_ms / t['kernel_ms']:.1%} of it")
        rows.append(dict(
            name="td_vmm", route="cuda",
            source="src/repro_torch/csrc/td_vmm.cu",
            replaces="src/repro/kernels/td_vmm/td_vmm.py:110",
            max_abs_err=e, library_ms=None, ms=t["kernel_ms"],
            plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            shape=f"{tag} {label}, M {m} K {k} N {n} bits 4/4, "
                  f"{plan.route} route, solved sigma"))
        del x, w
        torch.cuda.empty_cache()
    tv_row = next(r for r in rows if r["name"] == "td_vmm")
    tv_row["max_abs_err"] = max(tv_row["max_abs_err"], err)


def _flash_rows(tag: str, rows: list, gen, checks: list,
                timed: tuple) -> None:
    """flash_attn at ``checks`` ((label, B, Sq, Skv, Hq, Hkv, D, kv_len,
    causal, q dtype, kv dtype)) against its plain version: bf16 outputs
    by `_close`'s gates, f32 outputs (f32 q) within ATOL_F32 (a share of
    differing outputs is a bf16 gate: f32 sums over the CUDA cores' 32-key
    tiles differ from the plain version's in their last bits); the
    ``timed`` ones (the path's bf16 shapes; not the edge cases, nor
    training's f32 operands) also in turns with SDPA over the live keys,
    each a row with its bound."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attn as fa
    f_err = 0.0
    for label, b, sq, skv, hq, hkv, d, lens, causal, qdt, kdt in checks:
        q = _randn(gen, (b, sq, hq, d)).to(qdt)
        k = _randn(gen, (b, skv, hkv, d)).to(kdt)
        v = _randn(gen, (b, skv, hkv, d)).to(kdt)
        off = skv - sq if causal and lens[0] != sq else 0
        args = (q, k, v, _i32(lens), _i32([off]))
        got = fa.flash_attn(*args, causal=causal)
        want = fa.flash_attn_plain(*args, causal=causal)
        torch.cuda.synchronize()
        err, frac, ulp = _cmp(got, want)
        path = (f"tensor cores, key split {fa.flash_plan(b, sq, hq, hkv, skv)}"
                if fa.tensor_core_route(q, k) else "CUDA cores")
        print(f"[{tag}] flash_attn {label}: B={b} Sq={sq} Skv={skv} Hq={hq} "
              f"Hkv={hkv} D={d} kv_len={lens} causal={causal} q "
              f"{str(qdt)[6:]} kv {str(kdt)[6:]} ({path}): max |kernel - "
              f"plain| {err:g}, in bf16 ulps {ulp:.3f}, differing "
              f"{frac:.4f}")
        if not (err <= ATOL_F32 if qdt == torch.float32
                else _close(err, frac, ulp)):
            fail(f"flash_attn disagrees with its plain version ({tag} "
                 f"{label})")
        f_err = max(f_err, err)
        if label in timed:
            n = lens[0]
            qt = q.transpose(1, 2).contiguous()
            kt = k[:, :n].transpose(1, 2).contiguous()
            vt = v[:, :n].transpose(1, 2).contiguous()
            # SDPA's causal mask is top-left aligned: it matches only at
            # Sq = the live keys
            t = in_turns(tag, f"flash_attn {label}", {
                "plain": lambda: fa.flash_attn_plain(*args, causal=causal),
                "kernel": lambda: fa.flash_attn(*args, causal=causal),
                "library": lambda: _sdpa(qt, kt, vt, causal)},
                {"plain": 2 if sq * skv > 2**20 else 5, "kernel": 20,
                 "library": 20}, alone=True)
            b_ms, b_by = flash_bound(b, sq, lens, hq, hkv, d, causal)
            print(f"[{tag}] flash_attn {label}: kernel {t['kernel_ms']:.5f} "
                  f"ms, plain {t['plain_ms']:.5f} ms, sdpa "
                  f"{t['library_ms']:.5f} ms, bound {b_ms:.5f} ms ({b_by}): "
                  f"kernel at {b_ms / t['kernel_ms']:.1%} of its bound, "
                  f"{t['kernel_ms'] / t['library_ms']:.2f}x sdpa")
            rows.append(dict(
                name="flash_attn", route="cuda",
                source="src/repro_torch/csrc/flash_attn.cu",
                replaces="src/repro/kernels/flash_attn/flash_attn.py:55",
                max_abs_err=err, ms=t["kernel_ms"], plain_ms=t["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=t["library_ms"],
                shape=f"{tag} {label} B={b} Sq={sq} Skv={skv} Hq={hq} "
                      f"Hkv={hkv} D={d} {'causal' if causal else 'non-causal'}"
                      f", {path}",
                timed={k2: t[k2] for k2 in t if k2.endswith("_us")}))
            del qt, kt, vt
        del q, k, v, args, got, want
    torch.cuda.empty_cache()
    fa_row = next(r for r in rows if r["name"] == "flash_attn")
    fa_row["max_abs_err"] = max(fa_row["max_abs_err"], f_err)


def _lsq_rows(tag: str, rows: list, gen, shapes: list, timed: str) -> None:
    """lsq_quant at ``shapes`` ((label, shape, dtype): the path's weights in
    the compute dtype and its activations), three step sizes each, bit for
    bit against its plain version; ``timed`` also in turns with the plain
    version and `fake_quantize_per_tensor_affine`, a row with its
    bound."""
    import torch
    from repro_torch.kernels.lsq_quant import lsq_quant as lq
    from repro_torch.kernels.lsq_quant.ref import lsq_quant_ref
    n_cases = 0
    for label, shape, dtype in shapes:
        for s_val, qn, qp in [(0.25, -8, 7), (0.0371, -8, 7), (1e-9, -8, 7)]:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            s = torch.tensor(s_val, device="cuda").to(dtype)
            got = lq.lsq_quant(x, s, qn, qp)
            want = lsq_quant_ref(x, s, qn, qp)
            torch.cuda.synchronize()
            n_cases += 1
            if not _bits_equal(got, want):
                fail(f"lsq_quant is not bit-exact at {tag} {label} "
                     f"{tuple(shape)} {dtype} s={s_val}")
            del x, got, want
    print(f"[{tag}] lsq_quant: {n_cases} cases bit-exact ({len(shapes)} "
          f"shapes x 3 step sizes)")
    label, shape, dtype = next(c for c in shapes if c[0] == timed)
    x = (torch.randn(shape, generator=gen, device="cuda") * 0.1).to(dtype)
    s = torch.tensor(0.0371, device="cuda").to(dtype)
    s_f = float(s)
    try:
        torch.fake_quantize_per_tensor_affine(x, s_f, 0, -8, 7)
        lib_in = x
    except RuntimeError:
        lib_in = x.float()
    t = in_turns(tag, f"lsq_quant {label} {tuple(shape)}", {
        "plain": lambda: lsq_quant_ref(x, s, -8, 7),
        "kernel": lambda: lq.lsq_quant(x, s, -8, 7),
        "library": lambda: torch.fake_quantize_per_tensor_affine(
            lib_in, s_f, 0, -8, 7)},
        {"plain": 5, "kernel": 20, "library": 20})
    b_ms, b_by = bound_ms(2 * x.numel() * x.element_size(), 0, "bf16")
    print(f"[{tag}] lsq_quant {label} {tuple(shape)}: kernel "
          f"{t['kernel_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"fake_quantize_per_tensor_affine ({str(lib_in.dtype)[6:]}) "
          f"{t['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}): kernel "
          f"at {b_ms / t['kernel_ms']:.1%} of it")
    rows.append(dict(name="lsq_quant", route="cuda",
                     source="src/repro_torch/csrc/lsq_quant.cu",
                     replaces="src/repro/kernels/lsq_quant/lsq_quant.py:14",
                     max_abs_err=0.0, ms=t["kernel_ms"],
                     plain_ms=t["plain_ms"], library_ms=t["library_ms"],
                     bound_ms=b_ms, bound_by=b_by,
                     shape=f"{tag} {label} {shape[0]} x {shape[1]} "
                           f"{str(dtype)[6:]}"))
    del x, lib_in


def _encdec_kernel_checks(rows: list) -> None:
    """The kernels at the enc-dec path's shapes, against their plain
    versions on the card: td_vmm at lm_head (K 1024, N 256256: decode M 4
    and a train microbatch M 256), the encoder and the cross-attention's K
    and V over B x frames rows (serve 256, the long memory 8192) and the
    decoder's denses; flash_attn at D 64, g 1 (the tensor cores, bf16): the
    encoder (non-causal, Sq = Skv), the decoder's prefill (causal), the
    cross-attention at Sq 128 and Sq 1 over 64 and 2048 frames, and the
    training's float32 encoder and bf16-against-f32 cross-attention;
    decode_gqa at D 64, g 1; lsq_quant at the quant step's weights (the
    1024 x 256256 lm_head) and activations."""
    import torch
    from repro_torch.configs import seamless_m4t_large_v2 as conf
    gen = torch.Generator(device="cuda").manual_seed(22)
    cfg = conf.CONFIG.model
    d, f, v, h, hd = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_heads, cfg.hd
    b, p, g = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    fr, fl = max(8, p // 2), conf.DEC_PREFILL
    mb = TRAIN["batch"] // conf.CONFIG.train.n_microbatches
    _td_vmm_rows("encdec", rows, gen, [
        ("decode lm_head", b, d, v),
        ("train lm_head", mb * TRAIN["seq"], d, v),
        ("encoder attn.wq", b * fr, d, d),
        ("encoder mlp.wi", b * fr, d, f),
        ("encoder mlp.wo", b * fr, f, d),
        ("long encoder mlp.wi", b * fl, d, f),
        ("long cross wk", b * fl, d, d),
        ("decode cross wq", b, d, d),
        ("decode mlp.wo", b, f, d)])
    bf, f32 = torch.bfloat16, torch.float32
    n_vis = max(4, min(16, TRAIN["seq"] // 4))
    _flash_rows("encdec", rows, gen, [
        ("encoder", b, fr, fr, h, h, hd, [fr] * b, False, bf, bf),
        ("long encoder", b, fl, fl, h, h, hd, [fl] * b, False, bf, bf),
        ("decoder prefill", b, p, p + g, h, h, hd, [p] * b, True, bf, bf),
        ("cross prefill", b, p, fr, h, h, hd, [fr] * b, False, bf, bf),
        ("cross decode", b, 1, fr, h, h, hd, [fr] * b, False, bf, bf),
        ("long cross decode", b, 1, fl, h, h, hd, [fl] * b, False, bf, bf),
        ("train encoder, f32", mb, n_vis, n_vis, h, h, hd, [n_vis] * mb,
         False, f32, f32),
        ("train cross, bf16 q, f32 kv", mb, TRAIN["seq"], n_vis, h, h, hd,
         [n_vis] * mb, False, bf, f32)],
        ("encoder", "long encoder", "decoder prefill", "cross prefill",
         "cross decode", "long cross decode"))
    _decode_rows(rows, "encdec", gen, h, h, hd, [
        ("decode", b, p + g, p + g // 2),
        ("long decode", b, p + ENCDEC["long_steps"],
         p + ENCDEC["long_steps"] // 2)])
    _lsq_rows("encdec", rows, gen, [
        ("lm_head", (d, v), bf), ("attn", (d, d), bf),
        ("mlp.wi", (d, f), bf), ("mlp.wo", (f, d), bf),
        ("adapter", (cfg.d_frontend, d), bf),
        ("act d_model", (mb, TRAIN["seq"], d), bf),
        ("act d_ff", (mb, TRAIN["seq"], f), bf),
        ("encoder act d_model, f32", (mb, n_vis, d), f32),
        ("encoder act d_ff, f32", (mb, n_vis, f), f32)], "lm_head")


def _frontend_kernel_checks(rows: list) -> None:
    """The kernels at internvl2-26b's shapes against their plain versions
    on the card: td_vmm at the adapter (K 3200, N 6144: the serve's 256
    patch rows and the 4096 of the 1024-patch prefill), lm_head (N 92672)
    at decode and the layers' denses; flash_attn at D 128, g 6 (the
    tensor-core path; 48 heads over 8): the serve prefill, the 1024-patch
    prefill, a training microbatch and ragged lengths with an offset;
    decode_gqa at D 128, g 6; lsq_quant at the quant step's weights and
    activations."""
    import torch
    from repro_torch.configs import internvl2_26b as conf
    gen = torch.Generator(device="cuda").manual_seed(23)
    cfg = conf.CONFIG.model
    d, f, v, hq, hkv, hd = (cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_heads,
                            cfg.n_kv_heads, cfg.hd)
    b, p, g = SERVE["batch"], SERVE["prompt_len"], FRONTEND["gen"]
    fr, npat = max(8, p // 2), conf.N_PATCHES
    _td_vmm_rows("frontend", rows, gen, [
        ("adapter", b * fr, cfg.d_frontend, d),
        ("patch prefill adapter", b * npat, cfg.d_frontend, d),
        ("decode lm_head", b, d, v),
        ("prefill attn.wk", b * (fr + p), d, hkv * hd),
        ("decode mlp.wo", b, f, d)])
    bf, f32 = torch.bfloat16, torch.float32
    sv = fr + p
    n_vis = max(4, min(16, TRAIN["seq"] // 4))
    _flash_rows("frontend", rows, gen, [
        ("serve prefill", b, sv, sv + g, hq, hkv, hd, [sv] * b, True, bf, bf),
        ("patch prefill", b, npat + p, npat + p, hq, hkv, hd,
         [npat + p] * b, True, bf, bf),
        ("train microbatch", 1, TRAIN["seq"], TRAIN["seq"], hq, hkv, hd,
         [TRAIN["seq"]], True, bf, bf),
        ("ragged, q_offset", 2, 40, 48, hq, hkv, hd, [48, 33], True, bf,
         bf),
        ("f32", 2, 40, 40, hq, hkv, hd, [40, 17], True, f32, f32)],
        ("serve prefill", "patch prefill", "train microbatch"))
    _decode_rows(rows, "frontend", gen, hq, hkv, hd, [
        ("decode", b, sv + g, sv + g // 2)])
    _lsq_rows("frontend", rows, gen, [
        ("adapter", (cfg.d_frontend, d), bf),
        ("lm_head", (d, v), bf), ("attn.wq", (d, d), bf),
        ("attn.wk", (d, hkv * hd), bf), ("mlp.wi", (d, f), bf),
        ("mlp.wo", (f, d), bf), ("embeds, f32", (1, n_vis, cfg.d_frontend),
                                 f32),
        ("act d_model", (1, TRAIN["seq"], d), bf),
        ("act d_ff", (1, TRAIN["seq"], f), bf)], "lm_head")


def phase_encdec(launches: dict, rows: list):
    """The enc-dec family at full width and depth: seamless-m4t-large-v2,
    24 encoder + 24 decoder layers (not cut), td (4/4, the port's solve),
    seeded bf16 weights.  Serves SERVE's batch through `serve.run` (64
    frames of embeddings; launches and host syncs a step checked), then a
    long memory through the prefill and serve steps (4 x 2048 frames, the
    config's DEC_PREFILL, prompt 128, 8 decode steps: cross-attention at
    Skv 2048, Sq 1), trains TRAIN's batch (16 frames a row) at the
    config's 4 microbatches and remat full (3 td steps, 1 quant step),
    runs the smoke model on the card against the CPU, and holds the
    kernels to their plain versions at this path's shapes."""
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.configs import seamless_m4t_large_v2 as conf
    from repro_torch.tdsim.policy import TDPolicy
    t_phase = time.monotonic()
    walls: dict = {}

    def lap(part: str) -> None:
        walls[part] = time.monotonic() - t_phase - sum(walls.values())
    name = ENCDEC["arch"]
    arch = family_arch(name, "td")
    cfg = arch.model
    n_param = _n_params(cfg)
    print(f"[encdec] {name}: {cfg.n_enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n_param / 1e9:.3f}"
          f"B parameters")
    _serve_full("encdec_serve", arch, SERVE["batch"], SERVE["prompt_len"],
                SERVE["gen"], launches, syncs=True)
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve")
    if conf.DEC_PREFILL > conf.CROSS_MEMORY_CAP:
        fail("encdec: the long memory exceeds CROSS_MEMORY_CAP")
    _steps_serve("encdec_long", arch, SERVE["batch"], SERVE["prompt_len"],
                 ENCDEC["long_steps"], conf.DEC_PREFILL, launches)
    gc.collect()
    torch.cuda.empty_cache()
    lap("long serve")
    for mode in ("td", "quant"):
        r = _train_run(f"encdec_train_{mode}", family_arch(name, mode),
                       ENCDEC[f"{mode}_steps"], launches)
        print(f"[encdec_train_{mode}] peak {r['peak']:.2f} GiB, step ms "
              f"{[round(t, 1) for t in r['step_ms']]}, losses "
              f"{r['losses']}")
        gc.collect()
        torch.cuda.empty_cache()
    lap("train")
    _family_small("encdec_small", cfgs.get_smoke(name),
                  TDPolicy(mode="td", n_chain=64))
    lap("card vs CPU")
    _encdec_kernel_checks(rows)
    lap("kernel checks")
    print(f"[encdec] phase wall {time.monotonic() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + ")")


def _n_params(cfg) -> int:
    """The parameter count of a dense attention model ``cfg`` (weights
    and norms; the LSQ step sizes left out), from its widths."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    layer = attn + 3 * d * f + 2 * d
    n = cfg.vocab * d + d + (cfg.d_frontend or d) * d * (
        cfg.frontend is not None)
    if cfg.family == "encdec":
        le = cfg.n_enc_layers or cfg.n_layers
        return n + cfg.vocab * d + d + le * layer + cfg.n_layers * (
            layer + attn + d)
    return n + cfg.n_layers * layer + cfg.vocab * d * (
        not cfg.tie_embeddings)


def phase_frontend(launches: dict, rows: list):
    """A decoder's stub frontend at full width and depth: internvl2-26b's
    backbone, 48 layers (not cut), td, seeded bf16 weights (39.8 GB).
    Serves SERVE's batch of prompts with 64 patches through `serve.run`
    (8 new tokens; launches and host syncs a step checked), then one
    prefill of 4 x (1024 patches, the config's N_PATCHES, + 128 tokens)
    and 2 decode steps through the steps; trains at full width **cut to 2
    of 48 layers** (one td step and one quant step, the config's 16
    microbatches over a batch of 16 x 128: 16 patches and 112 tokens a
    row); runs the smoke model and the tied-embeddings smoke model
    (qwen3-8b's smoke config with ``tie_embeddings``) on the card against
    the CPU; holds the kernels to their plain versions at this path's
    shapes."""
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.configs import internvl2_26b as conf
    from repro_torch.tdsim.policy import TDPolicy
    t_phase = time.monotonic()
    walls: dict = {}

    def lap(part: str) -> None:
        walls[part] = time.monotonic() - t_phase - sum(walls.values())
    name = FRONTEND["arch"]
    arch = family_arch(name, "td")
    cfg = arch.model
    n_param = _n_params(cfg)
    print(f"[frontend] {name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}"
          f", d_ff {cfg.d_ff}, vocab {cfg.vocab}, adapter from "
          f"{cfg.d_frontend}: {n_param / 1e9:.3f}B parameters")
    _serve_full("frontend_serve", arch, SERVE["batch"], SERVE["prompt_len"],
                FRONTEND["gen"], launches, syncs=True)
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve")
    _steps_serve("frontend_patches", arch, SERVE["batch"],
                 SERVE["prompt_len"], 2, conf.N_PATCHES, launches)
    gc.collect()
    torch.cuda.empty_cache()
    lap("patch prefill")
    for mode in ("td", "quant"):
        r = _train_run(f"frontend_train_{mode}",
                       family_arch(name, mode, FRONTEND["train_layers"]),
                       FRONTEND[f"{mode}_steps"], launches,
                       batch=FRONTEND["train_batch"],
                       depth=f"cut from {cfg.n_layers}")
        print(f"[frontend_train_{mode}] peak {r['peak']:.2f} GiB, step ms "
              f"{[round(t, 1) for t in r['step_ms']]}, losses "
              f"{r['losses']}")
        gc.collect()
        torch.cuda.empty_cache()
    lap("train")
    pol0 = TDPolicy(mode="td", n_chain=64)
    _family_small("frontend_small", cfgs.get_smoke(name), pol0)
    qwen = cfgs.get_smoke("qwen3-8b")
    _family_small("tied_small", qwen.replace(model=dataclasses.replace(
        qwen.model, tie_embeddings=True)), pol0)
    lap("card vs CPU")
    _frontend_kernel_checks(rows)
    lap("kernel checks")
    print(f"[frontend] phase wall {time.monotonic() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + ")")


# ---------------------------------------------------------------------------
# The sub-quadratic families at their published widths and depths:
# zamba2-1.2b (38 layers: 32 mixer-only mamba2 layers, the shared
# attention block at 6 sites with their SwiGLUs) and rwkv6-1.6b (24
# layers of time and channel mix).  Serve SERVE's batch, a long context
# (B 1 x 4096 prompt tokens against B 1 x 128, 4 decode steps each), the
# scans alone, training at the config's 4 microbatches and remat full.
SSM = dict(long_prompt=4096, short_prompt=128, steps=4, td_steps=2,
           quant_steps=1)
# training depth (None: not cut); rwkv6's is cut to 8 of 24 layers (its
# per-token scan made its 3 steps at full depth 50-76 s of the run)
SSM_TRAIN_LAYERS = {"zamba2": None, "rwkv6": 8}
SSM_ARCHS = {"zamba2": "zamba2-1.2b", "rwkv6": "rwkv6-1.6b"}


def _kernel_count(fn) -> tuple[int, float]:
    """(device kernels, their summed device ms) of one call of ``fn``
    under torch.profiler; (0, 0.0) when the trace holds no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(ks), sum(e.time_range.end - e.time_range.start
                        for e in ks) / 1e3


_VIEWS = ("view", "_unsafe_view", "permute", "slice", "select", "unsqueeze",
          "squeeze", "expand", "alias", "as_strided", "t", "transpose",
          "reshape")


def _ops_count(fn) -> int:
    """The torch ops one call of ``fn`` dispatches, views left out: about
    one kernel launch each (no kernel of this repo is among them)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in _VIEWS:
                Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.n


def _scan_inputs(cfg, gen, b: int, s: int):
    """(name, a call of the model's scan) at batch b, length s: float32
    inputs of the shapes the mixer hands it."""
    import torch
    if cfg.ssm is not None:
        from repro_torch.models import mamba2
        di, nh, hp, ns, _ = mamba2.dims(cfg)
        x = _randn(gen, (b, s, nh, hp)).float()
        dt = mamba2.softplus(_randn(gen, (b, s, nh)).float() - 4.0)
        a = -torch.linspace(1.0, 16.0, nh, device="cuda")
        bm = _randn(gen, (b, s, ns)).float()
        cm = _randn(gen, (b, s, ns)).float()
        return "ssd_chunked", lambda: mamba2.ssd_chunked(x, dt, a, bm, cm,
                                                         cfg.ssm.chunk)
    from repro_torch.models import rwkv6
    nh, hd = rwkv6.dims(cfg)
    r, k, v = (_randn(gen, (b, s, nh, hd)).float() for _ in range(3))
    w = torch.exp(-torch.exp(_randn(gen, (b, s, nh, hd)).float() * 0.5
                             - 1.0))
    u = _randn(gen, (nh, hd)).float() * 0.1
    return "wkv6_scan", lambda: rwkv6.wkv6_scan(r, k, v, w, u)


def _scan_report(tag: str, arch) -> None:
    """The model's scan alone (`ssd_chunked` / `wkv6_scan`) at the serve
    prefill's shape (B 4 x 128) and the long prefill's (B 1 x 4096): the
    ops it dispatches a call, the kernels and their summed device time
    the profiler records (a trace of a call of a millisecond may miss
    some), one call in an event pair (host gaps included) and the host's
    time to enqueue it (a scan of thousands of kernels is host- or
    latency-bound: no spin can cover it); then the launches of one
    prefill step of the full model and the kernels of one decode step,
    with their summed device time against its traced wall (serve shapes,
    after a warm-up)."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import serve, steps as steps_lib
    from repro_torch.models import common, get_api
    from repro_torch.optim import adamw
    cfg = arch.model
    gen = torch.Generator(device="cuda").manual_seed(25)
    for b, s in ((SERVE["batch"], SERVE["prompt_len"]),
                 (1, SSM["long_prompt"])):
        name, fn = _scan_inputs(cfg, gen, b, s)
        n_ops = _ops_count(fn)
        n_k, busy = _kernel_count(fn)
        ev, host = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            e.record()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            ev.append(a.elapsed_time(e))
        ev, host = statistics.median(ev), statistics.median(host)
        print(f"[{tag}] {name} alone, B {b} x S {s}: {n_ops} ops "
              f"dispatched a call (views left out); the profiler records "
              f"{n_k} kernels, {busy:.3f} ms of device time; one call in an "
              f"event pair {ev:.3f} ms, its host enqueue {host:.3f} ms "
              f"(medians of 3): the device busy {busy / ev:.1%} of the "
              f"call")
        del fn
    torch.cuda.empty_cache()
    pol = common.resolve_arch_policy(arch, device="cuda")
    params = get_api(cfg)["init"](0, cfg, pol, dtype=torch.bfloat16,
                                  device="cuda")
    n_param = sum(t.numel() for _, t in adamw.tree_leaves_with_path(params))
    print(f"[{tag}] {cfg.name}: {n_param / 1e9:.3f}B parameters (every "
          f"leaf, the LSQ steps included)")
    b, p = SERVE["batch"], SERVE["prompt_len"]
    shape = ShapeCfg("serve", p + 2, b, "decode")
    pre = steps_lib.build_prefill_step(arch, shape, device="cuda")
    srv = steps_lib.build_serve_step(arch, shape, device="cuda")
    toks = torch.from_numpy(serve.prompts(1, b, p, cfg.vocab)).cuda()
    mods = kernel_modules()
    with torch.inference_mode():
        # a warm-up pass; then the prefill's launches counted (the ops it
        # dispatches and the port's kernels: a trace of its thousands of
        # kernels takes seconds) and one decode step traced
        logits, state = pre(params, {"tokens": toks})
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        srv(params, tok, state)
        _counts_reset(mods)
        n_pre = _ops_count(lambda: pre(params, {"tokens": toks})) + sum(
            m.launches for m in mods.values())
        t0 = time.monotonic()
        n_dec, d_dec = _kernel_count(lambda: srv(params, tok, state))
        w_dec = (time.monotonic() - t0) * 1e3
    print(f"[{tag}] one prefill step (B {b} x {p}): about {n_pre} launches "
          f"(ops dispatched, views left out, and the port's kernels); one "
          f"decode step: {n_dec} kernels, {d_dec:.1f} ms of device time in "
          f"a traced wall of {w_dec:.1f} ms" + (
              "" if n_dec else " (the trace held no device time: not "
              "measured)"))
    del params, state, logits
    torch.cuda.empty_cache()


def _ssm_phase(tag: str, launches: dict, rows: list, checks) -> None:
    """One sub-quadratic model at its published widths and depth (not
    cut, but for rwkv6's training: `SSM_TRAIN_LAYERS`), td (4/4, the
    port's solve), seeded bf16 weights: `serve.run` of
    SERVE's batch (launches and host syncs a step checked), the prefill
    and serve steps at B 1 x 128 and B 1 x 4096 prompt tokens with 4
    decode steps each (host syncs checked; decode ms against context),
    the scan alone and the kernels of a step (`_scan_report`), training
    through `train.run` at the config's 4 microbatches and remat full (2
    td steps, 1 quant step), the smoke model on the card against the CPU,
    and ``checks(rows)``: the kernels at this path's shapes."""
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.tdsim.policy import TDPolicy
    t_phase = time.monotonic()
    walls: dict = {}

    def lap(part: str) -> None:
        walls[part] = time.monotonic() - t_phase - sum(walls.values())
    name = SSM_ARCHS[tag]
    arch = family_arch(name, "td")
    cfg = arch.model
    mixers = sorted({cfg.mixer_at(i) for i in range(cfg.n_layers)})
    print(f"[{tag}] {name}: {cfg.n_layers} layers ({', '.join(mixers)}), "
          f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}")
    stats = _serve_full(f"{tag}_serve", arch, SERVE["batch"],
                        SERVE["prompt_len"], SERVE["gen"], launches,
                        syncs=True)
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve")
    ms = {}
    for which in ("short", "long"):
        ms[which] = _steps_serve(f"{tag}_{which}", arch, 1,
                                 SSM[f"{which}_prompt"], SSM["steps"], 0,
                                 launches)
        gc.collect()
        torch.cuda.empty_cache()
    (sp, *sd), (lp, *ld) = ms["short"], ms["long"]
    print(f"[{tag}] context {SSM['short_prompt']} against "
          f"{SSM['long_prompt']} (B 1): prefill {sp:.1f} against {lp:.1f} ms "
          f"({lp / sp:.2f}x for {SSM['long_prompt'] // SSM['short_prompt']}x"
          f" the tokens); decode median {statistics.median(sd):.1f} against "
          f"{statistics.median(ld):.1f} ms a token "
          f"({statistics.median(ld) / statistics.median(sd):.3f}x); serve "
          f"B {SERVE['batch']} x {SERVE['prompt_len']}: prefill "
          f"{stats['prefill_ms']:.1f} ms, decode median "
          f"{statistics.median(stats['decode_ms']):.1f} ms")
    lap("long context")
    _scan_report(tag, arch)
    lap("scans")
    for mode in ("td", "quant"):
        keep = SSM_TRAIN_LAYERS[tag]
        r = _train_run(f"{tag}_train_{mode}", family_arch(name, mode, keep),
                       SSM[f"{mode}_steps"], launches,
                       depth=("not cut" if keep is None
                              else f"cut from {cfg.n_layers}"))
        print(f"[{tag}_train_{mode}] peak {r['peak']:.2f} GiB, step ms "
              f"{[round(t, 1) for t in r['step_ms']]}, losses "
              f"{r['losses']}")
        gc.collect()
        torch.cuda.empty_cache()
    lap("train")
    _family_small(f"{tag}_small", cfgs.get_smoke(name),
                  TDPolicy(mode="td", n_chain=64))
    lap("card vs CPU")
    checks(rows)
    lap("kernel checks")
    print(f"[{tag}] phase wall {time.monotonic() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + ")")


def _ssm_train_mb() -> int:
    """Rows of a train microbatch: TRAIN's batch over the configs' 4
    microbatches, times its sequence."""
    from repro_torch.configs import zamba2_1_2b
    return TRAIN["batch"] // zamba2_1_2b.CONFIG.train.n_microbatches


def _zamba2_kernel_checks(rows: list) -> None:
    """The kernels at zamba2-1.2b's shapes against their plain versions on
    the card: td_vmm at mamba2's in_proj (K 2048, N 8384: not a multiple
    of 128) and out_proj (K 4096), the shared block's wq, the SwiGLU, and
    lm_head (N 32000) at decode and a train microbatch; flash_attn at D
    64, g 1 (the tensor cores; 32 heads of 64): the serve prefill, a
    train microbatch and the 4096-token prefill, timed against SDPA;
    decode_gqa at D 64, g 1 over the serve's cache and the long one;
    lsq_quant on the new weights and activations."""
    import torch
    from repro_torch.configs import zamba2_1_2b as conf
    from repro_torch.models import mamba2
    gen = torch.Generator(device="cuda").manual_seed(26)
    cfg = conf.CONFIG.model
    d, f, v, h, hd = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_heads, cfg.hd
    di, nh, _, ns, _ = mamba2.dims(cfg)
    n_in = 2 * di + 2 * ns + nh
    b, p, g = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    mb, seq, lp = _ssm_train_mb(), TRAIN["seq"], SSM["long_prompt"]
    _td_vmm_rows("zamba2", rows, gen, [
        ("prefill mamba.in_proj", b * p, d, n_in),
        ("decode mamba.in_proj", b, d, n_in),
        ("prefill mamba.out_proj", b * p, di, d),
        ("decode mamba.out_proj", b, di, d),
        ("prefill shared wq", b * p, d, h * hd),
        ("prefill mlp.wi", b * p, d, f),
        ("decode mlp.wo", b, f, d),
        ("decode lm_head", b, d, v),
        ("train lm_head", mb * seq, d, v)])
    bf = torch.bfloat16
    _flash_rows("zamba2", rows, gen, [
        ("prefill", b, p, p + g, h, h, hd, [p] * b, True, bf, bf),
        ("train microbatch", mb, seq, seq, h, h, hd, [seq] * mb, True, bf,
         bf),
        ("long prefill", 1, lp, lp + SSM["steps"], h, h, hd, [lp], True,
         bf, bf)],
        ("prefill", "train microbatch", "long prefill"))
    _decode_rows(rows, "zamba2", gen, h, h, hd, [
        ("decode", b, p + g, p + g // 2),
        ("long decode", 1, lp + SSM["steps"], lp + SSM["steps"] // 2)])
    _lsq_rows("zamba2", rows, gen, [
        ("mamba.in_proj", (d, n_in), bf), ("mamba.out_proj", (di, d), bf),
        ("lm_head", (d, v), bf), ("mlp.wi", (d, f), bf),
        ("act d_model", (mb, seq, d), bf), ("act d_inner", (mb, seq, di),
                                            bf)], "mamba.in_proj")


def _rwkv6_kernel_checks(rows: list) -> None:
    """The kernels at rwkv6-1.6b's shapes against their plain versions on
    the card: td_vmm at the time mix's 2048 x 2048 denses, the channel
    mix's wk (N 7168) and wv (K 7168), and lm_head (N 65536) at decode and
    a train microbatch; lsq_quant on the new weights and activations.
    Neither attention kernel is on this path."""
    import torch
    from repro_torch.configs import rwkv6_1_6b as conf
    gen = torch.Generator(device="cuda").manual_seed(27)
    cfg = conf.CONFIG.model
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    b, p = SERVE["batch"], SERVE["prompt_len"]
    mb, seq = _ssm_train_mb(), TRAIN["seq"]
    _td_vmm_rows("rwkv6", rows, gen, [
        ("prefill timemix wr", b * p, d, d),
        ("decode timemix wo", b, d, d),
        ("prefill chanmix wk", b * p, d, f),
        ("decode chanmix wv", b, f, d),
        ("decode lm_head", b, d, v),
        ("train lm_head", mb * seq, d, v)])
    bf = torch.bfloat16
    _lsq_rows("rwkv6", rows, gen, [
        ("lm_head", (d, v), bf), ("chanmix wk", (d, f), bf),
        ("chanmix wv", (f, d), bf), ("timemix wr", (d, d), bf),
        ("act d_model", (mb, seq, d), bf), ("act d_ff", (mb, seq, f), bf)],
        "chanmix wk")


def phase_zamba2(launches: dict, rows: list):
    """zamba2-1.2b, 38 layers (`_ssm_phase`)."""
    _ssm_phase("zamba2", launches, rows, _zamba2_kernel_checks)


def phase_rwkv6(launches: dict, rows: list):
    """rwkv6-1.6b, 24 layers (`_ssm_phase`); flash_attn and decode_gqa
    must not launch on its paths."""
    _ssm_phase("rwkv6", launches, rows, _rwkv6_kernel_checks)
    for path, counts in launches.items():
        if path.startswith("rwkv6") and (counts["flash_attn"]
                                         or counts["decode_gqa"]):
            fail(f"{path}: an attention kernel ran on an attention-free "
                 f"model ({counts})")


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
               and not e.name.startswith(("serve.", "train.", "sched."))]
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
    kind_n = collections.Counter()
    for name, us in by_name.items():
        kind = next((k for k, tags in KERNEL_NAMES.items()
                     if any(t in name for t in tags)), None)
        if kind is None:
            kind = ("matmul (cuBLAS)" if any(
                t in name for t in ("gemm", "cutlass", "xmma", "nvjet"))
                else "other (elementwise, copies, reductions)")
        kinds[kind] += us
        kind_n[kind] += count[name]
    print(f"[profile] {span} by kind: " + ", ".join(
        f"{k} {us / 1e3:.2f} ms ({us / busy:.1%})"
        for k, us in kinds.most_common()))
    for k in ("flash_attn", "decode_gqa"):
        if kind_n[k]:
            print(f"[profile] {span} {k}: {kinds[k] / 1e3:.3f} ms in "
                  f"{kind_n[k]} launches, {kinds[k] / kind_n[k]:.2f} us of "
                  f"device time a launch")
    for name, us in by_name.most_common(10):
        print(f"[profile]   {us / 1e3:9.2f} ms {us / busy:6.1%} "
              f"x{count[name]:<5d} {name[:110]}")


STEP_BUILDERS = {"prefill": "build_prefill_step",
                 "decode": "build_serve_step", "train": "build_train_step"}


def step_syncs(run, names=("prefill", "decode")) -> tuple[int, dict]:
    """``run()`` (a `serve.run` or `train.run`) with the host syncs that
    torch reports under ``torch.cuda.set_sync_debug_mode("warn")`` (a
    blocking copy either way, ``.item()``; an explicit
    ``torch.cuda.synchronize`` is not one; `sync_log`) counted per call of
    the steps ``names`` (keys of `STEP_BUILDERS`).  Returns (the syncs of
    one calibrating blocking copy: 1 when the counting works, {name:
    [syncs of each call]})."""
    import torch
    from repro_torch.launch import steps
    calls: dict = {n: [] for n in names}
    builders = {n: getattr(steps, STEP_BUILDERS[n]) for n in names}

    def counting(name, build, log):
        def built(*a, **kw):
            step = build(*a, **kw)

            def counted(*args):
                n0 = len(log)
                out = step(*args)
                calls[name].append(len(log) - n0)
                return out
            return counted
        return built

    with sync_log() as log:
        try:
            torch.tensor([0.0], device="cuda")
            calib = len(log)
            for n in names:
                setattr(steps, STEP_BUILDERS[n],
                        counting(n, builders[n], log))
            run()
        finally:
            for n in names:
                setattr(steps, STEP_BUILDERS[n], builders[n])
    return calib, calls


# ---------------------------------------------------------------------------
# The multi-device layer: a (1, 1) mesh on the card, and the dry run
# ---------------------------------------------------------------------------
MESH = dict(arch="qwen3-8b", layers=4, batch=4, prompt_len=128, gen=16)
DRYRUN_CELLS = [("dbrx-132b", "train_4k", False),
                ("zamba2-1.2b", "long_500k", False),
                ("rwkv6-1.6b", "long_500k", False),
                ("rwkv6-1.6b", "long_500k", True)]


def _mesh_search(tag: str, mesh, launches: dict) -> None:
    """LM_SWEEP's per-layer batched search on granite-8b cut to its layers
    (`_lm_sweep_family`'s QAT and eval), unsharded and with ``mesh=``: the
    two results bit for bit equal, noise included, and the same td_vmm
    lane launches each."""
    import numpy as np
    import torch
    import repro_torch.configs as cfgs
    from repro_torch import prng
    from repro_torch.core import noise_tolerance as nt
    from repro_torch.models import transformer as tr
    from repro_torch.tdsim.policy import TDPolicy, quant_policy

    conf, dev = LM_SWEEP, "cuda"
    cfg = cut_layers(cfgs.get("granite-8b").model, conf["layers"])
    n_l = cfg.n_layers
    key = prng.key(conf["seed"])
    sigmas, reps, chunk = conf["sigmas"], conf["n_repeats"], conf["chunk"]
    mods = kernel_modules()
    tv = mods["td_vmm"]
    _counts_reset(mods)
    params, stream = _lm_qat(tag, f"granite-8b, {n_l} layers", cfg, conf,
                             key, dev)
    batch = _on(stream.batch(conf["eval_step"]), dev)
    base = TDPolicy(mode="td", bits_a=4, bits_w=4, n_chain=cfg.d_model,
                    sigma_chain=0.0, tdc_q=1)
    pol_q = quant_policy(4, 4)

    def layer_eval(sv, keys):
        logits = tr.forward_lanes(params, batch, cfg, base, sv, keys, pol_q)
        return (logits.argmax(-1) == batch["labels"]).float().mean((1, 2))

    layer_eval(torch.ones(chunk, n_l, device=dev), prng.split(key, chunk))
    res, walls, lane = {}, {}, {}
    for name, m in (("unsharded", None), ("mesh", mesh)):
        torch.cuda.synchronize()
        n0 = tv.launches
        t0 = time.perf_counter()
        res[name] = nt.find_sigma_max_batched(
            layer_eval, sigmas, key, n_layers=n_l, n_repeats=reps,
            chunk_size=chunk, mesh=m, device=dev)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        lane[name] = tv.launches - n0
    search = [(chunk, i) for i in range(n_l)]
    want = sweep_expected(cfg, 0, search, 0)["td_vmm"]
    same = all(np.array_equal(getattr(res["unsharded"], f),
                              getattr(res["mesh"], f))
               for f in ("rel_drop", "acc_clean", "sigma_max"))
    print(f"[{tag}] per-layer search, {res['mesh'].n_evals} probes in "
          f"chunks of {chunk}: unsharded {walls['unsharded']:.3f} s, "
          f"mesh=(1, 1) {walls['mesh']:.3f} s; td_vmm lane launches "
          f"{lane['unsharded']} / {lane['mesh']} (expected {want} each); "
          f"equal bit for bit (rel_drop, acc_clean, sigma_max, noise on) "
          f"{same}; sigma_max {np.round(res['mesh'].sigma_max, 4).tolist()}")
    if not same or lane["mesh"] != want or lane["unsharded"] != want:
        fail(f"{tag}: the mesh search differs from the unsharded one")
    counts = {n: m.launches for n, m in mods.items()}
    check_launches(tag, counts, sweep_expected(
        cfg, conf["steps"], [(chunk, 0)] + search + search, 0))
    launches[tag] = counts


def _mesh_serve(tag: str, mesh, launches: dict) -> None:
    """MESH's qwen3-8b in td mode served plain and on ``mesh`` through
    `serve.run`: tokens and every step's logits bit for bit equal, each
    run's launches counted (td_vmm, flash_attn and decode_gqa on local
    shards on the mesh), prefill and decode ms and host syncs a step."""
    import torch
    from repro_torch.launch import serve
    arch = family_arch(MESH["arch"], "td", MESH["layers"])
    cfg = arch.model
    if (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab) != \
            (4096, 32, 8, 151936):
        fail(f"{tag}: qwen3-8b widths {cfg}")
    mods = kernel_modules()
    out, stats = {}, {}
    b, p, g = MESH["batch"], MESH["prompt_len"], MESH["gen"]
    for name, m in (("plain", None), ("mesh", mesh)):
        _counts_reset(mods)
        stats[name] = {"logits": []}

        def run(m=m, name=name):
            out[name] = serve.run(arch, b, p, g, seed=0,
                                  stats=stats[name], mesh=m)
        torch.cuda.synchronize()
        calib, calls = step_syncs(run)
        counts = {n: mm.launches for n, mm in mods.items()}
        path = f"{tag}" if m is not None else f"{tag}_plain"
        check_launches(path, counts, serve_expected(cfg, g - 1))
        launches[path] = counts
        st = stats[name]
        print(f"[{tag}] {name}: prefill {st['prefill_ms']:.2f} ms, decode "
              f"median {statistics.median(st['decode_ms']):.2f} ms/token "
              f"(all {[round(t, 2) for t in st['decode_ms']]}); host syncs "
              f"(calibration {calib}): prefill {calls['prefill']}, each "
              f"decode step {calls['decode']}")
        if calib < 1 or any(calls["prefill"] + calls["decode"]):
            fail(f"{tag} {name}: a serve step waits for the device (or the "
                 "sync counting does not work)")
    same_ids = bool(torch.equal(out["plain"], out["mesh"]))
    lg_p, lg_m = stats["plain"]["logits"], stats["mesh"]["logits"]
    same_lg = len(lg_p) == len(lg_m) == g and all(
        _bits_equal(x, y) for x, y in zip(lg_p, lg_m))
    print(f"[{tag}] {cfg.name} td, {cfg.n_layers} of 36 layers, batch {b}, "
          f"prompt {p}, gen {g} on mesh (data 1, model 1), parameters "
          f"placed by param_specs(serving=True): tokens equal {same_ids}, "
          f"logits of the prefill "
          f"and {g - 1} decode steps equal bit for bit {same_lg}; "
          f"tokens[0] {out['mesh'][0].tolist()}")
    if not (same_ids and same_lg):
        fail(f"{tag}: the mesh serve differs from the plain serve")


def _mesh_restore(tag: str, mesh) -> None:
    """A checkpoint of the smoke qwen3-8b's parameters (float32 and a
    bfloat16 copy) restored onto the mesh's placements, bit for bit."""
    import shutil
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import sharding
    from repro_torch.models import get_api
    from repro_torch.optim.adamw import tree_leaves_with_path
    from repro_torch.tdsim.policy import PRECISE
    cfg = cfgs.get_smoke("qwen3-8b").model
    params = get_api(cfg)["init"](0, cfg, PRECISE, device="cuda")
    tree = {"f32": params,
            "bf16": {"embed": {"table": params["embed"]["table"].to(
                torch.bfloat16)}}}
    path = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    try:
        ckpt.save(str(path), 5, tree, async_write=False)
        specs = sharding.param_specs(tree, mesh)
        step, back, _ = ckpt.restore(str(path), tree, device="cuda",
                                     shardings=specs, mesh=mesh)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    pairs = list(zip(tree_leaves_with_path(tree), tree_leaves_with_path(back)))
    equal = all(_bits_equal(b.full_tensor(), a) and b.device_mesh is mesh
                for (_, a), (_, b) in pairs)
    print(f"[{tag}] checkpoint of {len(pairs)} leaves restored onto the "
          f"mesh's placements (step {step}): bit for bit {equal}")
    if step != 5 or not equal:
        fail(f"{tag}: the restore onto placements differs")


def phase_mesh(launches: dict):
    """The multi-device layer on one card: an NCCL group of one rank
    (`HashStore`, device_id cuda:0) and a (1, 1) `DeviceMesh`; the LM
    sweep's search with ``mesh=`` (`_mesh_search`), qwen3-8b served on
    the mesh (`_mesh_serve`) and a checkpoint restored onto placements
    (`_mesh_restore`); the group destroyed at the end."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
        print(f"[mesh] {mesh} over nccl, world size "
              f"{dist.get_world_size()}")
        t0 = time.monotonic()
        _mesh_search("mesh_search", mesh, launches)
        t1 = time.monotonic()
        gc.collect()
        torch.cuda.empty_cache()
        _mesh_serve("mesh_serve", mesh, launches)
        t2 = time.monotonic()
        _mesh_restore("mesh_restore", mesh)
        print(f"[mesh] walls: search {t1 - t0:.1f} s, serve (plain and "
              f"mesh) {t2 - t1:.1f} s, restore {time.monotonic() - t2:.1f} s")
    finally:
        dist.destroy_process_group()


def phase_dryrun():
    """`python -m repro_torch.launch.dryrun` on the (data 32, model 8)
    production mesh for DRYRUN_CELLS (the last with ``--scan-layers``),
    one process a cell, all at once, on this host's CPU (the fake process
    group; no kernel runs, the card is hidden from them).  Prints each
    cell's roofline (a model from the H100's data-sheet rates, not a
    measurement) and its wall; a scan cell must count its unscanned
    cell's FLOPs and collectives."""
    out = ROOT / "build" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    procs = {}
    t0 = time.monotonic()
    try:
        for arch, shape, scan in DRYRUN_CELLS:
            procs[(arch, shape, scan)] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--out", str(out)]
                + (["--scan-layers"] if scan else []), env=env,
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        logs = {c: p.communicate(timeout=600)[0] for c, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    results = {}
    for (arch, shape, scan), p in procs.items():
        if p.returncode != 0:
            fail(f"dryrun {arch} {shape} exit {p.returncode}:\n"
                 f"{logs[(arch, shape, scan)][-4000:]}")
        res = json.loads((out / f"{arch}__{shape}__32x8"
                          f"{'__scan' if scan else ''}.json").read_text())
        results[(arch, shape, scan)] = res
        rl, mem = res["roofline"], res["memory"]
        print(f"[dryrun] {arch} {shape}{' --scan-layers' if scan else ''} "
              f"on 32x8 (256 cards), "
              f"{res['n_params']:.6g} params: modelled from H100 SXM "
              f"data-sheet rates, not measured: dominant {rl['dominant']}, "
              f"step_s {rl['step_s']:.6g} (compute {rl['compute_s']:.6g}, "
              f"memory {rl['memory_s']:.6g}, collective "
              f"{rl['collective_s']:.6g}), mfu {rl['mfu']:.6g}; per-device "
              f"peak memory {mem['peak_bytes'] / 1e9:.3f} GB (params "
              f"{mem['params_bytes'] / 1e9:.3f}, optimizer "
              f"{mem['opt_bytes'] / 1e9:.3f}, the step's live tensors "
              f"{mem['peak_step_bytes'] / 1e9:.3f}), fits 80 GB "
              f"{mem['fits']}; wall {res['wall_s']:.2f} s in its process")
    for (arch, shape, scan), res in results.items():
        if not scan:
            continue
        base = results[(arch, shape, False)]
        same = (res["flops_per_chip"] == base["flops_per_chip"]
                and res["collectives"] == base["collectives"])
        print(f"[dryrun] {arch} {shape} --scan-layers against unscanned: "
              f"FLOPs a device {res['flops_per_chip']:.6g} / "
              f"{base['flops_per_chip']:.6g}, collectives "
              f"{res['collectives']['counts']} / "
              f"{base['collectives']['counts']}, equal {same}; bytes a "
              f"device {res['bytes_per_chip']:.6g} / "
              f"{base['bytes_per_chip']:.6g}, the step's peak live "
              f"{res['memory']['peak_step_bytes']:.6g} / "
              f"{base['memory']['peak_step_bytes']:.6g} B (modelled)")
        if not same:
            fail(f"dryrun {arch} {shape}: the scan cell counts other FLOPs "
                 "or collectives than the unscanned cell")
    print(f"[dryrun] {len(procs)} cells at once: wall "
          f"{time.monotonic() - t0:.1f} s")


# ---------------------------------------------------------------------------
# The stacked scan-over-layers layout (scan_layers) and the examples
# ---------------------------------------------------------------------------
SCAN = dict(arch="qwen3-8b", serve_layers=None, train_layers=4,
            engine_layers=4, train_steps=2,
            families=(("granite-moe-1b-a400m", None), ("rwkv6-1.6b", 4)))
EXAMPLES = dict(train_steps=20)


def scan_arch(arch):
    """``arch`` with its model in the stacked layout."""
    return arch.replace(model=dataclasses.replace(arch.model,
                                                  scan_layers=True))


@contextlib.contextmanager
def fixed_policy(pol):
    """Every policy resolution (`serve.run`, the step builders) returns
    ``pol`` inside the block."""
    from repro_torch.models import common
    solve = common.resolve_arch_policy
    common.resolve_arch_policy = lambda a, device=None: pol
    try:
        yield
    finally:
        common.resolve_arch_policy = solve


def _scan_init(tag: str, arch) -> None:
    """`init_params(seed, cfg_scan)` at full width in bf16 equals the
    unrolled init stacked, bit for bit, leaf by leaf; then one keyed
    forward of SERVE's prompts in each layout: at the solved policy the
    logits differ (the scan seeds its denses under the reference's scan
    paths, (i, 0, j) and (i, 1, j), the unrolled forward under (2i, j)
    and (2i + 1, j)), at sigma 0 with tdc_q 1 they are equal."""
    import torch
    from repro_torch import prng
    from repro_torch.launch import serve
    from repro_torch.models import common
    from repro_torch.models import transformer as tr
    from repro_torch.optim.adamw import tree_leaves_with_path
    pol = common.resolve_arch_policy(arch, device="cuda")
    cfg = arch.model
    loop = tr.init_params(0, cfg, pol, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    scan = tr.init_params(0, scan_arch(arch).model, pol, torch.bfloat16,
                          "cuda")
    torch.cuda.synchronize()
    t_scan = time.monotonic() - t0
    if not isinstance(scan["layers"], dict):
        fail(f"{tag}: the scan config's init is not stacked")
    per_layer = [dict(tree_leaves_with_path(lp)) for lp in loop["layers"]]
    stacked = tree_leaves_with_path(scan["layers"])
    equal = all(_bits_equal(t[i], per_layer[i][p]) for p, t in stacked
                for i in range(cfg.n_layers))
    outer = [(p, t) for p, t in tree_leaves_with_path(scan)
             if not p.startswith("layers/")]
    flat_loop = dict(tree_leaves_with_path(loop))
    equal = equal and all(_bits_equal(t, flat_loop[p]) for p, t in outer)
    print(f"[{tag}] {cfg.name} init, {cfg.n_layers} layers, bf16: "
          f"{len(stacked)} stacked leaves of shape (L, ...) equal the "
          f"unrolled init stacked bit for bit: {equal} (stacked init "
          f"{t_scan:.2f} s)")
    if not equal:
        fail(f"{tag}: the stacked init differs from the unrolled one")
    toks = torch.from_numpy(serve.prompts(0, SERVE["batch"],
                                          SERVE["prompt_len"],
                                          cfg.vocab)).to("cuda")
    same = {}
    for label, p in (("solved", pol),
                     ("sigma 0", pol.replace(sigma_chain=0.0, tdc_q=1))):
        with torch.inference_mode():
            lg = [tr.forward(params, {"tokens": toks}, c, p,
                             key=prng.key(0))[0]
                  for params, c in ((loop, cfg), (scan,
                                                  scan_arch(arch).model))]
        same[label] = _bits_equal(*lg)
        del lg
    print(f"[{tag}] a keyed td forward ({SERVE['batch']} x "
          f"{SERVE['prompt_len']}, key 0): stacked logits equal to the "
          f"unrolled ones bit for bit at the solved policy {same['solved']} "
          f"(the seeds differ), at sigma 0 {same['sigma 0']}")
    if same["solved"] or not same["sigma 0"]:
        fail(f"{tag}: the keyed forwards {same}")


def _layout_serves(tag: str, arch, launches: dict, pol=None) -> dict:
    """`serve.run` of ``arch`` unrolled and stacked (SERVE's batch,
    prompt and gen, bf16), at ``pol`` when given: each layout's tokens,
    logits, prefill and decode ms, host syncs a step (none allowed) and
    launches (recorded as the paths ``{tag}_unrolled`` and
    ``{tag}_stacked``)."""
    import torch
    from repro_torch.launch import serve
    mods = kernel_modules()
    res = {}
    b, p, g = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    for layout, a in (("unrolled", arch), ("stacked", scan_arch(arch))):
        gc.collect()
        torch.cuda.empty_cache()
        _counts_reset(mods)
        stats: dict = {"logits": []}
        out: dict = {}

        def run(a=a, stats=stats, out=out):
            out["ids"] = serve.run(a, b, p, g, seed=0, stats=stats)
        with (fixed_policy(pol) if pol is not None
              else contextlib.nullcontext()):
            calib, calls = step_syncs(run)
        counts = {n: m.launches for n, m in mods.items()}
        launches[f"{tag}_{layout}"] = counts
        res[layout] = dict(ids=out["ids"], logits=stats["logits"],
                           prefill=stats["prefill_ms"],
                           decode=statistics.median(stats["decode_ms"]),
                           counts=counts)
        print(f"[{tag}] {layout}: prefill {stats['prefill_ms']:.2f} ms, "
              f"decode median {res[layout]['decode']:.2f} ms/token; host "
              f"syncs (calibration {calib}): prefill {calls['prefill']}, "
              f"each decode step {calls['decode']}; launches {counts}")
        if calib < 1 or any(calls["prefill"] + calls["decode"]):
            fail(f"{tag} {layout}: a serve step waits for the device (or "
                 "the sync counting does not work)")
    return res


def _same_serve(res: dict) -> tuple[bool, bool]:
    """(tokens equal, every step's logits equal bit for bit) of the two
    layouts' serves."""
    import torch
    u, s = res["unrolled"], res["stacked"]
    ids = bool(torch.equal(u["ids"], s["ids"]))
    lg = len(u["logits"]) == len(s["logits"]) == SERVE["gen"] and all(
        _bits_equal(x, y) for x, y in zip(u["logits"], s["logits"]))
    return ids, lg


def _scan_serve(launches: dict) -> None:
    """Full-width qwen3-8b served in both layouts, tokens and logits bit
    for bit across layouts: quant, td at sigma 0 with tdc_q 1 and td at
    the solved policy.  The serve steps pass no key, in the reference as
    in the port, so every td dense draws the seed of key (0, 0) in both
    layouts (the keyed forward of `_scan_init` shows the scan's own
    seeds)."""
    from repro_torch.models import common
    cfg = family_arch(SCAN["arch"], "td", SCAN["serve_layers"]).model
    if (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab) != (4096, 32, 8, 128, 12288, 151936):
        fail(f"scan_serve: qwen3-8b widths {cfg}")
    td = family_arch(SCAN["arch"], "td", SCAN["serve_layers"])
    solved = common.resolve_arch_policy(td, device="cuda")
    td0 = solved.replace(sigma_chain=0.0, tdc_q=1)
    for mode, arch, pol in (
            ("quant", family_arch(SCAN["arch"], "quant",
                                  SCAN["serve_layers"]), None),
            ("td0", td, td0), ("td", td, solved)):
        tag = f"scan_serve_{mode}"
        res = _layout_serves(tag, arch, launches, pol)
        if mode == "quant":
            want = res["unrolled"]["counts"]
        else:
            want = serve_expected(cfg, SERVE["gen"] - 1)
            check_launches(f"{tag}_unrolled", res["unrolled"]["counts"], want)
        check_launches(f"{tag}_stacked", res["stacked"]["counts"], want)
        ids, lg = _same_serve(res)
        u, s = res["unrolled"], res["stacked"]
        print(f"[{tag}] {cfg.name} {mode}, {cfg.n_layers} layers, batch "
              f"{SERVE['batch']} x {SERVE['prompt_len']}, {SERVE['gen']} "
              f"new, bf16: stacked against unrolled: tokens equal {ids}, "
              f"logits of the prefill and {SERVE['gen'] - 1} decode steps "
              f"equal bit for bit {lg}; prefill {u['prefill']:.2f} / "
              f"{s['prefill']:.2f} ms, decode {u['decode']:.2f} / "
              f"{s['decode']:.2f} ms a token (unrolled / stacked)")
        if not (ids and lg):
            fail(f"{tag}: the stacked serve differs from the unrolled one")


def _scan_train(launches: dict) -> None:
    """qwen3-8b at full width cut to SCAN's train layers, 8 x 128, in
    quant mode and td at sigma 0, remat full and dots, in both layouts:
    losses and gradient norms of every step bit for bit equal; step ms
    and peak memory of each."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import train
    from repro_torch.models import common
    shape = ShapeCfg("cli", TRAIN["seq"], TRAIN["batch"], "train")
    steps = SCAN["train_steps"]
    mods = kernel_modules()
    td = family_arch(SCAN["arch"], "td", SCAN["train_layers"])
    td0 = common.resolve_arch_policy(td, device="cuda").replace(
        sigma_chain=0.0, tdc_q=1)
    for mode in ("quant", "td0"):
        for remat in ("full", "dots"):
            base = family_arch(SCAN["arch"], "quant" if mode == "quant"
                               else "td", SCAN["train_layers"])
            base = base.replace(train=dataclasses.replace(base.train,
                                                          remat=remat))
            cfg = base.model
            n_micro = base.microbatches_for(shape.name)
            per_step = train_expected(cfg, n_micro, "quant" if mode ==
                                      "quant" else "td", remat)
            got = {}
            for layout, a in (("unrolled", base),
                              ("stacked", scan_arch(base))):
                tag = f"scan_train_{mode}_{remat}_{layout}"
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.memory_allocated() / 2**30
                _counts_reset(mods)
                stats: dict = {}
                with (fixed_policy(td0) if mode == "td0"
                      else contextlib.nullcontext()):
                    params, losses = train.run(a, shape, steps, None,
                                               log_every=steps, seed=0,
                                               stats=stats)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 2**30 - start
                del params          # not alive through the next run
                counts = {n: m.launches for n, m in mods.items()}
                check_launches(tag, counts, {n: c * steps
                                             for n, c in per_step.items()})
                launches[tag] = counts
                got[layout] = (losses, stats["grad_norm"])
                print(f"[scan_train] {cfg.name} {mode}, {cfg.n_layers} "
                      f"layers, batch {shape.global_batch} x "
                      f"{shape.seq_len}, remat {remat}, {layout}: step ms "
                      f"{[round(t * 1e3, 1) for t in stats['step_s']]}, "
                      f"peak {peak:.2f} GiB above the {start:.2f} GiB "
                      f"allocated before the run; losses {losses}; grad "
                      f"norms {stats['grad_norm']}")
            same = got["unrolled"] == got["stacked"]
            print(f"[scan_train] {mode} remat {remat}: losses and grad "
                  f"norms of {steps} steps bit for bit equal across "
                  f"layouts: {same}")
            if not same or not all(math.isfinite(x)
                                   for x in got["stacked"][0]):
                fail(f"scan_train {mode} {remat}: stacked {got['stacked']}"
                     f" against unrolled {got['unrolled']}")


def _scan_families(launches: dict) -> None:
    """The other homogeneous stacks in quant mode, stacked against
    unrolled, bit for bit: granite-moe-1b-a400m at its 24 layers and
    rwkv6-1.6b cut to 4."""
    for name, layers in SCAN["families"]:
        arch = family_arch(name, "quant", layers)
        tag = f"scan_{name.split('-')[0]}"
        res = _layout_serves(tag, arch, launches)
        if res["stacked"]["counts"] != res["unrolled"]["counts"]:
            fail(f"{tag}: the stacked serve launches "
                 f"{res['stacked']['counts']}, the unrolled "
                 f"{res['unrolled']['counts']}")
        ids, lg = _same_serve(res)
        print(f"[{tag}] {name} quant, {arch.model.n_layers} layers: "
              f"stacked against unrolled: tokens equal {ids}, logits equal "
              f"bit for bit {lg}")
        if not (ids and lg):
            fail(f"{tag}: the stacked serve differs from the unrolled one")


def _scan_engine(launches: dict) -> None:
    """The continuous-batching engine on full-width qwen3-8b cut to
    SCAN's engine layers (4 of 36: the whole script's time), unrolled and
    stacked, on SCHED's traffic (16 ragged
    requests into 8 slots of 144), in quant mode and td at sigma 0 with
    tdc_q 1: the stacked engine's tokens equal the unrolled engine's bit
    for bit, with 0 host syncs inside a decode step (the engine's copy of
    a step's tokens is its one sync a step) and the launches of the
    traffic (`_engine_run`'s expectation) in both layouts."""
    import torch
    from repro_torch.models import common
    mods = kernel_modules()
    td = family_arch(SCAN["arch"], "td", SCAN["engine_layers"])
    td0 = common.resolve_arch_policy(td, device="cuda").replace(
        sigma_chain=0.0, tdc_q=1)
    for mode, arch, pol in (
            ("quant", family_arch(SCAN["arch"], "quant",
                                  SCAN["engine_layers"]), None),
            ("td0", td, td0)):
        got = {}
        for layout, a in (("unrolled", arch), ("stacked", scan_arch(arch))):
            gc.collect()
            torch.cuda.empty_cache()
            tag = f"scan_engine_{mode}_{layout}"
            with (fixed_policy(pol) if pol is not None
                  else contextlib.nullcontext()):
                eng, out, facts = _engine_run(a, SCHED, None, mods)
            _engine_line(tag, f"{a.model.name}, {a.model.n_layers} layers",
                         eng, out, facts)
            check_launches(tag, facts["counts"], facts["expected"])
            launches[tag] = facts["counts"]
            # the decode step itself never waits for the device; the
            # engine's one sync a step is its copy of the step's tokens
            if set(facts["step_syncs"]) != {0} or \
                    set(facts["decode_syncs"]) != {1}:
                fail(f"{tag}: host syncs inside the decode steps "
                     f"{facts['step_syncs']}, around them "
                     f"{facts['decode_syncs']}")
            if out["requests"] != SCHED["requests"]:
                fail(f"{tag}: finished {out['requests']} of "
                     f"{SCHED['requests']} requests")
            if isinstance(eng.params["layers"], dict) != (
                    layout == "stacked"):
                fail(f"{tag}: the engine's parameters are not {layout}")
            got[layout] = facts["outputs"]
            del eng
        same = got["unrolled"] == got["stacked"]
        print(f"[scan_engine] {mode}: the stacked engine's tokens of "
              f"{len(got['stacked'])} requests equal the unrolled engine's "
              f"bit for bit: {same}; host syncs inside each decode step 0 "
              f"in both layouts (the engine's token copy the one a step); "
              f"request 0: {got['stacked'][0]}")
        if not same:
            fail(f"scan_engine {mode}: the stacked engine's tokens differ "
                 "from the unrolled engine's")


def _scan_views() -> None:
    """The kernels on the layer views of stacked tensors (`torch.unbind`
    of a stacked KV cache and weight) take them without a copy
    (``contiguous()`` is the view itself, 16-byte aligned) and give the
    results of their copies bit for bit.  td_vmm takes fresh codes, never
    a view."""
    import torch
    from repro_torch.kernels.decode_gqa import ops as dec_ops
    from repro_torch.kernels.flash_attn import ops as fl_ops
    from repro_torch.kernels.lsq_quant import lsq_quant as lq
    gen = torch.Generator(device="cuda").manual_seed(5)
    L, b, s, hkv, hq, d = 4, SERVE["batch"], 160, 8, 32, 128
    k = torch.randn((L, b, s, hkv, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    v = torch.randn((L, b, s, hkv, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randn((L, 4096, 1024), generator=gen, device="cuda")
    q1 = torch.randn((b, hq, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    qs = torch.randn((b, 16, hq, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    lens = torch.full((b,), 150, dtype=torch.int32, device="cuda")
    off = torch.full((1,), 134, dtype=torch.int32, device="cuda")
    ok = True
    for i, (kv, vv, wv) in enumerate(zip(torch.unbind(k), torch.unbind(v),
                                         torch.unbind(w))):
        for t in (kv, vv, wv):
            ok &= t.contiguous() is t and t.data_ptr() % 16 == 0
            ok &= (t.storage_offset() > 0) == (i > 0)
        kc, vc, wc = kv.clone(), vv.clone(), wv.clone()
        ok &= _bits_equal(dec_ops.decode_attention(q1, kv, vv, lens),
                          dec_ops.decode_attention(q1, kc, vc, lens))
        ok &= _bits_equal(fl_ops.flash_attention(qs, kv, vv, lens, off),
                          fl_ops.flash_attention(qs, kc, vc, lens, off))
        sc = torch.tensor(0.01, device="cuda")
        ok &= _bits_equal(lq.lsq_quant(wv, sc, -8, 7),
                          lq.lsq_quant(wc, sc, -8, 7))
    torch.cuda.synchronize()
    print(f"[scan_views] decode_gqa, flash_attn and lsq_quant on the {L} "
          f"layer views of stacked (L, B, S, Hkv, D) caches and an (L, "
          f"4096, 1024) weight: no copy (contiguous views at their "
          f"offsets), results equal to their copies' bit for bit: {ok}")
    if not ok:
        fail("scan_views: a kernel copies or differs on a layer view")


def phase_scan_layers(launches: dict):
    """The stacked layout (`scan_layers`) at full width: the stacked init
    against the unrolled one, qwen3-8b served in both layouts (quant, td
    at sigma 0, td at the solved policy), trained cut to 4 layers (quant
    and td at sigma 0, remat full and dots), granite-moe and rwkv6 served
    in quant mode, qwen3-8b cut to 4 layers behind the continuous-batching
    engine in both layouts (quant and td at sigma 0), and the kernels on
    layer views."""
    walls = {}
    t0 = time.monotonic()
    _scan_init("scan_init", family_arch(SCAN["arch"], "td",
                                        SCAN["serve_layers"]))
    for name, fn in (("serve", _scan_serve), ("train", _scan_train),
                     ("families", _scan_families), ("engine", _scan_engine)):
        t1 = time.monotonic()
        fn(launches)
        walls[name] = time.monotonic() - t1
    _scan_views()
    print(f"[scan_layers] walls, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items())
        + f"; phase {time.monotonic() - t0:.1f}")


def _load_example(name: str):
    import importlib.util
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(launches: dict):
    """The four port-side examples in-process on the card, as a user runs
    them: quickstart_torch, serve_decode_torch (its launches counted),
    train_qat_lm_torch --small --steps 20 (its loss falling) and
    hw_design_explorer_torch --scenario edge --corner ss --minimize-vdd
    (its table written to build/examples/)."""
    import io
    import shutil
    import torch
    from repro_torch.core import explorer
    walls = {}
    out_dir = ROOT / "build" / "examples"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    mods = kernel_modules()

    t0 = time.monotonic()
    q = _load_example("quickstart_torch").main([])
    walls["quickstart"] = time.monotonic() - t0
    if q["winner"] != "td" or not 0 < q["rel"] < 0.1:
        fail(f"examples: quickstart winner {q['winner']}, rel {q['rel']}")

    t0 = time.monotonic()
    _counts_reset(mods)
    ids = _load_example("serve_decode_torch").main([])
    torch.cuda.synchronize()
    counts = {n: m.launches for n, m in mods.items()}
    launches["examples_serve"] = counts
    walls["serve_decode"] = time.monotonic() - t0
    print(f"[examples] serve_decode_torch: tokens {tuple(ids.shape)}, "
          f"launches {counts}")
    if ids.shape != (4, 24) or not (counts["td_vmm"] and
                                    counts["flash_attn"] and
                                    counts["decode_gqa"]):
        fail(f"examples: serve_decode {tuple(ids.shape)}, {counts}")

    t0 = time.monotonic()
    ckpt_dir = out_dir / "qat_ckpt"
    _, losses = _load_example("train_qat_lm_torch").main(
        ["--small", "--steps", str(EXAMPLES["train_steps"]), "--ckpt-dir",
         str(ckpt_dir)])
    walls["train_qat_lm"] = time.monotonic() - t0
    k = max(1, len(losses) // 10)
    if len(losses) != EXAMPLES["train_steps"] or \
            not sum(losses[-k:]) < sum(losses[:k]):
        fail(f"examples: train_qat_lm losses {losses}")

    t0 = time.monotonic()
    prev = explorer.set_service(None)
    buf, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            g = _load_example("hw_design_explorer_torch").main(
                ["--scenario", "edge", "--corner", "ss", "--minimize-vdd"])
    finally:
        explorer.set_service(prev)
    walls["hw_design_explorer"] = time.monotonic() - t0
    (out_dir / "explorer_edge_ss.txt").write_text(buf.getvalue()
                                                  + err.getvalue())
    table = buf.getvalue().splitlines()
    print(f"[examples] hw_design_explorer_torch --scenario edge --corner ss "
          f"--minimize-vdd on {g.e_mac.size} grid values: {len(table)} "
          f"table lines (build/examples/explorer_edge_ss.txt); "
          f"{err.getvalue().splitlines()[1:2]}")
    if not any("winner map" in line for line in table):
        fail("examples: the explorer printed no winner map")
    print(f"[examples] walls, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items()))
    shutil.rmtree(ckpt_dir, ignore_errors=True)


def phase_profile():
    """Where the time goes: a shorter serve run (gen 4, plain and with
    --td-attn td; then again untraced, its host syncs counted a step), a
    scheduler run (4
    requests, capacity 4, after a warm-up request) and a 2-step td train
    run under torch.profiler, each kernel assigned by its device timestamp
    to the "serve.prefill" / "serve.decode" / "sched.prefill" /
    "sched.decode" / "train.step" span that ran it, and the engine's
    inserts and the AdamW update to "sched.insert" and "train.optimizer",
    read from their device-side ranges (the train reports read the
    second, steady step).  A profiler failure, or a trace without device
    time, fails the run."""
    import torch
    import repro_torch.configs as cfgs
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import serve, td_cli, train
    from repro_torch.launch.scheduler import ContinuousBatchingEngine
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    arch = td_cli.apply_td_args(cfgs.get("qwen3-8b"), "td")
    for label, a in (("plain", arch), ("with --td-attn td", td_cli.
                                         apply_td_args(arch, None,
                                                       td_attn="td"))):
        print(f"[profile] serve {label}:")
        with profile(activities=acts) as prof:
            serve.run(a, SERVE["batch"], SERVE["prompt_len"], 4, seed=0)
        for span in ("serve.prefill", "serve.decode"):
            _span_report(prof, span, slice(None))
        del prof
        torch.cuda.empty_cache()
        calib, calls = step_syncs(lambda: serve.run(
            a, SERVE["batch"], SERVE["prompt_len"], 4, seed=0))
        print(f"[profile] serve {label}: host syncs (torch's sync debug "
              f"mode; a calibrating blocking copy counts {calib}): "
              f"prefill {calls['prefill']}, each decode step "
              f"{calls['decode']}")
        torch.cuda.empty_cache()
    eng = ContinuousBatchingEngine(arch, capacity=4,
                                   s_cache=SCHED["s_cache"],
                                   kv_block=SCHED["kv_block"], seed=0)
    eng.warmup()
    reqs = serve.synthetic_requests(4, SCHED["prompt_len"], 4,
                                    arch.model.vocab, seed=SCHED["seed"])
    with profile(activities=acts) as prof:
        eng.run(reqs)
    print(f"[profile] scheduler: 4 requests, capacity 4, "
          f"{eng.steps_run} decode steps")
    _span_report(prof, "sched.prefill", slice(None))
    _span_report(prof, "sched.insert", slice(None), side="device")
    _span_report(prof, "sched.decode", slice(None))
    del prof, eng
    torch.cuda.empty_cache()
    shape = ShapeCfg("cli", TRAIN["seq"], TRAIN["batch"], "train")
    with profile(activities=acts) as prof:
        train.run(family_arch("qwen3-8b", "td", TRAIN["layers"]), shape, 2,
                  None, seed=0)
    _span_report(prof, "train.step", slice(-1, None))
    _span_report(prof, "train.optimizer", slice(-1, None), side="device")


def main() -> None:
    t_start = time.monotonic()
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
    phase_yardstick()
    phase_design_space()
    t0 = time.monotonic()
    phase_explorer()
    t_explorer = time.monotonic() - t0
    phase_policy()
    phase_small_reference()
    phase_train_small()
    rows: list = []
    walls: dict = {"build to train_small": time.monotonic() - t_start,
                   "explorer": t_explorer}

    def timed(name: str, fn, *args) -> None:
        t0 = time.monotonic()
        fn(*args)
        walls[name] = time.monotonic() - t0
    for fn in (phase_td_vmm, phase_flash, phase_decode, phase_lsq_quant):
        timed(fn.__name__[6:], fn, rows)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launches_by_path", "timed")
    flush_l2(release=True)
    launches: dict = {}
    with_rows = (phase_moe, phase_dense_configs, phase_encdec,
                 phase_frontend, phase_zamba2, phase_rwkv6, phase_dbrx,
                 phase_noise_loop, phase_td_attention,
                 phase_lm_sweep_families, phase_drift_traces)
    for phase in (phase_serve, phase_scheduler, phase_scheduler_scenario,
                  phase_train, phase_moe, phase_dense_configs, phase_encdec,
                  phase_frontend, phase_zamba2, phase_rwkv6, phase_dbrx,
                  phase_noise_loop, phase_td_attention,
                  phase_lm_noise_sweep, phase_lm_sweep_families,
                  phase_drift_traces, phase_chaos_serve, phase_chaos_train,
                  phase_mesh, phase_scan_layers, phase_examples):
        gc.collect()           # engines wrapped by `_counted` form cycles
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timed(phase.__name__[6:], phase,
              *((launches, rows) if phase in with_rows else (launches,)))
    gc.collect()
    torch.cuda.empty_cache()
    timed("dryrun", phase_dryrun)
    timed("profile", phase_profile)
    print(f"[time] phase walls, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items())
        + f"; whole run {time.monotonic() - t_start:.1f}")
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in launches.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["launches"] == 0:
            fail(f"{r['name']} never launched on a main path")
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err",
                    "library_ms"):
            if r[key] is not None and not math.isfinite(r[key]):
                fail(f"{r['name']}: {key} is {r[key]}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
