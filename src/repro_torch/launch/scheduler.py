"""Continuous-batching TD serving engine (port of
`repro/launch/scheduler.py:133-660`).

  * **Admission queue decoupled from step execution**: requests arrive on
    a FIFO queue (`submit`); the engine admits them into free slots
    between steps.
  * **Continuous batching with slot recycling**: a fixed-capacity batch of
    KV-cache slots; a finished request's slot goes to the next queued
    request at once (bucketed prefill + insert), while the other slots
    keep decoding.  The decode kernel's runtime ``length`` operand masks
    every slot to its own valid prefix, so any mix of fill levels runs the
    same step.  Decode runs every slot, free ones included: td_vmm hashes
    its noise over the (M, N) of the call, so the batch is never compacted.
  * **Block KV slots sized against the device memory**:
    `roofline.model.plan_kv_cache` rounds slots to blocks and caps the
    capacity at what the card (or, on the CPU, an H100 80GB) holds once
    the parameters are on it.
  * **Latency telemetry**: per-token wall-clock timestamps give
    per-request p50/p99 ms/token; `admit_ms` and `decode_ms` hold each
    admission's and each decode step's host time (ms), both ending at the
    step's one device sync (an admission also enqueues its insert).
  * **Fault tolerance**: the loop runs under `ft.run_with_retries` with
    `ft.StepWatchdog` timing every decode step; a `Preemption` drains the
    in-flight requests back onto the queue as continuations (prompt +
    tokens so far), so no admitted request is lost.  A continuation
    prefills its prompt and then replays its tokens as the inputs of the
    engine's own decode steps, beside the live slots and the other
    continuations (`Slot.replay`): recovery needs no second cache and no
    steps of its own.  In precise and quant modes a decode row depends on
    nothing but its own inputs at the engine's batch size, so greedy
    outputs equal an uninterrupted run's bit for bit, on the card too.  In
    td mode they need not: td_vmm's noise is hashed over the call's rows,
    a continuation may land in another slot, and the replay runs at the
    current operating point.  `run(schedule=...)` also consumes a
    deterministic `ft.FaultSchedule` (preemptions, stalls, drift
    excursions, explorer outages).
  * **Per-request energy**: `energy_meter.RequestMeter` attributes J/token
    to each request (prompt tokens at admission, each generated token as
    it is recorded) at the policy's operating point, in the
    ``meter_domain`` (td, analog or digital); `request_rows` and `summary`
    carry the energy fields.  No meter for a precise policy.

  * **Drift adaptation** (``adapt=True``): the decode step
    (`steps.build_adaptive_serve_step`, built once) also returns the
    activation bit density of the occupied slots, smoothed by a
    `ft.DriftEstimator`.  On a threshold crossing the engine adapts in two
    phases.  Phase 1, in the same step: re-resolve the td layers'
    (R, q) at the measured statistics through ``resolver`` and write the
    new (sigma, q) into the operand tensor ``ops`` (made once, on the
    device) and re-price the meter.  Phase 2 (``supply_span``): a
    `ft.StagedRebuild` worker solves the policy set across the supply
    grid (`solve_td_policies_over_vdd`) and pre-prices the meter on its
    own CUDA stream, handing numpy ops, policies and the report back; the
    engine installs them at a later step boundary.  A swap is a
    ``non_blocking`` copy from pinned host memory into ``ops`` on the
    decode's stream: no host sync, no rebuilt step, no new operand.
    Every install lands in ``swap_log``; replaying it through a second
    engine (``scripted_swaps``, detection off) gives the same tokens.
  * **Traffic traces** (``run(trace=...)``): a `ft.TrafficTrace` scales
    the measured bit density by each segment's ``activity``, overrides
    the weight sparsity the re-resolve assumes by its ``sparsity``, and
    throttles admissions to its ``load`` share of the capacity.

Device: the engine's tensors live on ``device`` (CUDA unless the caller
asks for the CPU).  The host waits for the device once per admission (the
prefill's token) and once per decode step (the batch's tokens, with the
adaptive step's bit density in the same copy), as the reference does.
The steps run in the `torch.profiler` spans "sched.prefill" (ends at the
admission's token read), "sched.insert" (no sync of its own: its kernels
finish before the next step's prompt copy or token read) and
"sched.decode" (ends at the token read).

Scope: decoder-family, pure-attention, token-only models (the bucketed
prefill relies on causal masking to keep pad junk out of the prefix).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import device as device_mod
from repro_torch import ft
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import steps as steps_lib
from repro_torch.models import common, get_api, matmul_shapes, transformer
from repro_torch.optim.adamw import tree_leaves_with_path
from repro_torch.roofline import model as roofline_model
from repro_torch.tdsim import policy as td_policy
from repro_torch.tdsim.energy_meter import RequestMeter

__all__ = ["Request", "Slot", "ContinuousBatchingEngine"]


@dataclasses.dataclass
class Request:
    """One serving request.  `prompt` is the original prompt; on a
    preemption re-admission the engine prefills prompt + generated-so-far
    as a continuation, so `generated` survives restarts."""
    rid: int
    prompt: np.ndarray                 # int32 token ids, shape (L,)
    max_new_tokens: int
    arrival_s: float = 0.0
    # --- engine bookkeeping ---
    generated: list = dataclasses.field(default_factory=list)
    t_admitted: float | None = None
    t_first_token: float | None = None
    token_s: list = dataclasses.field(default_factory=list)  # per decoded tok
    readmissions: int = 0

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)

    @property
    def context(self) -> np.ndarray:
        """Prompt extended with everything generated (continuation text)."""
        if not self.generated:
            return np.asarray(self.prompt, np.int32)
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.generated, np.int32)])


@dataclasses.dataclass
class Slot:
    """One row of the fixed-capacity decode batch.  ``replay`` holds the
    generated tokens a re-admitted continuation still has to feed to the
    decode step before it decodes new ones."""
    index: int
    request: Request | None = None
    replay: deque = dataclasses.field(default_factory=deque)

    @property
    def free(self) -> bool:
        return self.request is None


class ContinuousBatchingEngine:
    """Admission queue + slot-recycled continuous batching over one
    prefill / insert / decode step triple.

    ``params``: parameters on ``device`` (the port's seeded init, stored in
    the compute dtype, when None)."""

    def __init__(self, arch, capacity: int = 8, s_cache: int = 128,
                 prompt_pad: int | None = None, seed: int = 0,
                 eos_id: int | None = None, params=None,
                 meter_domain: str = "td", kv_block: int = 64,
                 continuous: bool = True, clock=time.monotonic,
                 adapt: bool = False, drift_threshold: float = 0.2,
                 resolver=None, supply_span: bool = True,
                 supply_resolver=None, vdd_grid=None,
                 scripted_swaps=None, device=None):
        cfg = arch.model
        if cfg.family != "decoder":
            raise ValueError("scheduler requires a decoder-family model")
        if cfg.frontend is not None:
            raise ValueError("scheduler serves token-only models (modality "
                             "frontends need pad-aware prefill)")
        bad = {cfg.mixer_at(i) for i in range(cfg.n_layers)} - {"attn"}
        if bad:
            raise ValueError("scheduler requires pure-attention mixers "
                             f"(bucketed prefill); got {sorted(bad)}")
        self.device = device_mod.resolve(device)
        self.arch, self.cfg = arch, cfg
        self.clock = clock
        self.eos_id = eos_id
        # continuous=False is the fixed-batch baseline: admission only when
        # every slot is free (lockstep batches, the slowest request holds
        # the whole batch); the same steps, only the scheduling differs
        self.continuous = continuous

        self.pol = common.resolve_arch_policy(arch, device=self.device)
        if params is None:
            params = get_api(cfg)["init"](
                seed, cfg, self.pol, device=self.device,
                dtype=steps_lib.DTYPES[arch.train.compute_dtype])
        self.params = params

        # block KV slots sized against the device memory net of the
        # parameters: round the slot to blocks, cap capacity at what the
        # budget admits
        self.kv_plan = roofline_model.plan_kv_cache(
            cfg, capacity, s_cache, block=kv_block,
            weight_bytes=sum(t.numel() * t.element_size()
                             for _, t in tree_leaves_with_path(params)
                             if isinstance(t, torch.Tensor)),
            hbm_bytes=roofline_model.device_hbm_bytes(self.device))
        self.capacity = min(capacity, max(1, self.kv_plan.max_slots))
        self.s_cache = self.kv_plan.s_cache
        self.prompt_pad = min(prompt_pad or self.s_cache, self.s_cache)

        self._prefill = steps_lib.build_ragged_prefill_step(
            arch, self.prompt_pad, device=self.device)
        self._insert = steps_lib.build_insert_step()
        shape = ShapeCfg("serve", self.s_cache, self.capacity, "decode")
        self.adapt = adapt
        build = (steps_lib.build_adaptive_serve_step if adapt
                 else steps_lib.build_serve_step)
        self._decode = build(arch, shape, device=self.device)

        pol0 = common.pol_at(self.pol, 0)
        self.meter = (RequestMeter(matmul_shapes(cfg), pol0,
                                   domain=meter_domain,
                                   sigma_max=self._meter_sigma(),
                                   device=self.device)
                      if pol0.mode != "precise" else None)
        self.watchdog = ft.StepWatchdog()
        self.admit_ms: list[float] = []
        self.decode_ms: list[float] = []
        self.replay_steps = 0        # decode steps that replayed a row

        # drift adaptation and chaos-schedule state.  ``_ops`` is the one
        # operand tensor the adaptive step reads; swaps write into it
        self._ops = common.td_policy_ops(self.pol, device=self.device)
        self._ops_staging = None     # the pinned source of the last swap
        self._rebuild_stream = (torch.cuda.Stream(self.device)
                                if adapt and self.device.type == "cuda"
                                else None)
        # the default resolvers solve on the engine's device (partials, not
        # lambdas over self: an engine must not keep itself alive)
        self.resolver = (resolver if resolver is not None else
                         functools.partial(td_policy.solve_td_policies,
                                           device=self.device))
        self.supply_span = bool(supply_span)
        self.vdd_grid = vdd_grid     # None = the paper's supply grid
        self.supply_resolver = (
            supply_resolver if supply_resolver is not None
            else functools.partial(td_policy.solve_td_policies_over_vdd,
                                   vdds=vdd_grid, device=self.device))
        self.drift = (ft.DriftEstimator(anchor=pol0.p_x_one,
                                        threshold=drift_threshold)
                      if adapt else None)
        self._wsp = (ft.weight_bit_sparsity(self.params["embed"]["table"],
                                            pol0.bits_w) if adapt else None)
        self._drift_gain = 1.0       # chaos drift excursion multiplier
        self.adaptations = 0
        self.explorer_up = True
        self.on_outage = None        # callable(up: bool)
        self.fault_log: list = []

        # staged supply swap and trace replay state
        self._staged: ft.StagedRebuild | None = None
        self._adapt_gen = 0          # bumps per excursion; staleness check
        self._staged_gen = -1        # generation the in-flight rebuild saw
        self._last_measured: tuple[float, float] | None = None
        self.swap_log: list[dict] = []   # installs: step / kind / ops / vdds
        self.supply_spans = 0            # staged installs that moved a Vdd
        self.staged_installs = 0
        self.trace = None
        # scripted_swaps: a recorded swap_log (or [(step, ops)] pairs)
        # replayed at step boundaries with drift detection off, the same
        # decode step: greedy outputs must equal the live run's
        self._scripted = None
        if scripted_swaps is not None:
            ss = [(int(e["step"]), e["ops"]) if isinstance(e, dict)
                  else (int(e[0]), e[1]) for e in scripted_swaps]
            self._scripted = deque(sorted(ss, key=lambda e: e[0]))

        self.queue: deque[Request] = deque()
        self.slots = [Slot(i) for i in range(self.capacity)]
        self.done: dict[int, Request] = {}
        self.steps_run = 0
        self._reset_device_state()

    # ------------------------------------------------------------------
    # device state
    # ------------------------------------------------------------------
    def _reset_device_state(self) -> None:
        self._state = None           # the old caches go before the new come
        caches = transformer.init_caches(self.capacity, self.s_cache,
                                         self.cfg, torch.bfloat16,
                                         device=self.device,
                                         per_row_idx=True)
        self._state = {"layers": caches, "enc_out": None}
        self._tok = torch.zeros((self.capacity, 1), dtype=torch.int32,
                                device=self.device)
        # the adaptive step's occupancy mask, kept on the device and set
        # slot by slot (a fill takes its value as an argument: no copy)
        self._occupancy = torch.zeros((self.capacity,), dtype=torch.float32,
                                      device=self.device)

    def _install_ops(self, ops) -> None:
        """Write an operating point into ``_ops`` at a step boundary, on
        the decode's stream.  On the card the source is a fresh pinned
        buffer, copied without a host sync; it is kept until the next
        install (and torch's pinned allocator does not reuse it before the
        copy has run)."""
        host = torch.as_tensor(np.asarray(ops, np.float32)).reshape(
            self._ops.shape)
        if self._ops.device.type == "cuda":
            host = host.pin_memory()
            self._ops.copy_(host, non_blocking=True)
            self._ops_staging = host
        else:
            self._ops.copy_(host)

    # ------------------------------------------------------------------
    # intake (host only)
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.context) + max(0, req.remaining) > self.s_cache:
            raise ValueError(
                f"request {req.rid}: context {len(req.context)} + "
                f"{req.remaining} new tokens exceeds the {self.s_cache}"
                "-token slot")
        self.queue.append(req)

    def submit_all(self, reqs) -> None:
        for r in reqs:
            self.submit(r)

    # ------------------------------------------------------------------
    # admission: bucketed prefill into a free slot
    # ------------------------------------------------------------------
    def _admit(self, slot: Slot) -> None:
        t0 = time.perf_counter()
        req = self.queue.popleft()
        # a continuation (re-admitted after a preemption) prefills its
        # original prompt and replays its tokens in the next decode steps
        prompt = np.asarray(req.prompt, np.int32) if req.generated \
            else req.context
        padded = np.zeros((1, self.prompt_pad), np.int32)
        padded[0, :len(prompt)] = prompt
        # the copy waits for the device, which the last step left idle
        toks = torch.from_numpy(padded).to(self.device)
        with record_function("sched.prefill"):
            tok, pstate = self._prefill(self.params, toks, len(prompt))
            first = int(tok[0, 0])     # the admission's one host sync
        with record_function("sched.insert"):
            self._state = self._insert(self._state, pstate, slot.index,
                                       len(prompt))
            if req.generated:
                self._tok[slot.index].fill_(req.generated[0])
                slot.replay.extend(req.generated[1:])
            else:
                self._tok[slot.index] = tok[0]
        self.admit_ms.append((time.perf_counter() - t0) * 1e3)
        slot.request = req
        if self.adapt:
            self._occupancy[slot.index].fill_(1.0)
        now = self.clock()
        if req.t_admitted is None:
            req.t_admitted = now
        if self.meter is not None:
            self.meter.on_prefill(req.rid, len(req.context))
        if not req.generated:
            # the prefill's argmax is this request's next token
            self._record_token(req, first, now)

    def _record_token(self, req: Request, token: int, now: float) -> None:
        req.generated.append(token)
        req.token_s.append(now)
        if req.t_first_token is None:
            req.t_first_token = now
        if self.meter is not None:
            self.meter.on_decode(req.rid)

    def _meter_sigma(self):
        """The meter's budget: a solved policy prices at its own, a quant
        policy at the representative relaxed budget 2.0."""
        pol0 = common.pol_at(self.pol, 0)
        return None if pol0.sigma_max is not None else 2.0

    def _finished(self, req: Request, last: int) -> bool:
        return req.remaining <= 0 or (self.eos_id is not None
                                      and last == self.eos_id)

    def _retire_or_keep(self, slot: Slot) -> None:
        req = slot.request
        if req is not None and self._finished(req, req.generated[-1]):
            self.done[req.rid] = req
            slot.request = None        # recycled on the next admit round
            if self.adapt:
                self._occupancy[slot.index].fill_(0.0)

    # ------------------------------------------------------------------
    # the worker loop: admit -> one batched decode step -> harvest
    # ------------------------------------------------------------------
    @property
    def active(self) -> list[Slot]:
        return [s for s in self.slots if not s.free]

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler tick.  Returns False when no work remains."""
        # staged and scripted swaps install here, at the step boundary: the
        # decode below is the first to run at the new operating point
        self._poll_staged()
        if self._scripted is not None:
            while self._scripted and self._scripted[0][0] <= self.steps_run:
                self._install_ops(self._scripted.popleft()[1])
        seg = self.trace.at(self.steps_run) if self.trace is not None \
            else None
        if self.continuous or not self.active:
            budget = self.capacity if seg is None else \
                max(1, int(np.ceil(seg.load * self.capacity)))
            for slot in self.slots:
                if budget <= 0:
                    break
                if slot.free and self.queue:
                    self._admit(slot)
                    self._retire_or_keep(slot)   # max_new_tokens == 1
                    budget -= 1
        active = self.active
        if not active:
            return bool(self.queue)
        self.watchdog.start(self.steps_run)
        with record_function("sched.decode"):
            toks, px = self._run_decode()
        self.decode_ms.append(self.watchdog.stop().duration * 1e3)
        self.steps_run += 1
        now = self.clock()
        replayed = False
        for slot in active:
            if slot.replay:
                # a continuation's row rebuilt as its first run built it:
                # its next input is its own next token, not this output
                self._tok[slot.index].fill_(slot.replay.popleft())
                replayed = True
                continue
            self._record_token(slot.request, int(toks[slot.index, 0]), now)
            self._retire_or_keep(slot)
        self.replay_steps += replayed
        if px is not None and self._scripted is None:
            gain = self._drift_gain * (seg.activity if seg is not None
                                       else 1.0)
            if self.drift.update(px * gain):
                self._readapt()
        return bool(self.queue or self.active)

    def _run_decode(self) -> tuple[np.ndarray, float | None]:
        """One batched decode step: (tokens (capacity, 1) on the host, the
        adaptive step's p_x_one or None).  The step's one host sync: the
        adaptive step's bit density rides in the tokens' copy."""
        if not self.adapt:
            self._tok, self._state = self._decode(self.params, self._tok,
                                                  self._state)
            return self._tok.cpu().numpy(), None
        self._tok, self._state, px = self._decode(
            self.params, self._tok, self._state, self._ops, self._occupancy)
        packed = torch.cat([self._tok.reshape(-1).view(torch.float32),
                            px.reshape(1)]).cpu().numpy()
        return packed[:-1].view(np.int32).reshape(-1, 1), float(packed[-1])

    # ------------------------------------------------------------------
    # drift adaptation: re-resolve at the measured operating point
    # ------------------------------------------------------------------
    def _measured_wsp(self) -> float:
        """Weight-sparsity statistic of a re-resolve: the trace segment's
        traffic mix when it declares one, else the one-shot measurement
        of the deployed params."""
        if self.trace is not None:
            seg = self.trace.at(self.steps_run)
            if seg.sparsity is not None:
                return float(seg.sparsity)
        return self._wsp

    def _td_specs(self, measured: float, wsp: float) -> list:
        """Per-td-layer re-resolve questions at the measured statistics
        (each layer keeps its own budget, shape, TDC, library and vdd)."""
        return [td_policy.TDLayerSpec(
                    bits_a=p.bits_a, bits_w=p.bits_w, n_chain=p.n_chain,
                    sigma_max=p.sigma_max, vdd=p.vdd, p_x_one=measured,
                    w_bit_sparsity=wsp, m=p.m, tdc_arch=p.tdc_arch,
                    techlib=p.techlib)
                for p in (common.pol_at(self.pol, i)
                          for i in common.td_layer_indices(self.pol))]

    @staticmethod
    def _td_vdds(pol) -> tuple:
        return tuple(common.pol_at(pol, i).vdd
                     for i in common.td_layer_indices(pol))

    def _readapt(self) -> None:
        """The smoothed activity left the band the current policy was
        priced for.  Phase 1, here: re-resolve every td layer at the
        measured statistics (supply unchanged), write the new (sigma, q)
        into ``_ops`` and re-price the meter.  Phase 2: start the
        supply-spanning rebuild on a worker thread (`_launch_staged`)."""
        measured = float(self.drift.value)
        wsp = self._measured_wsp()
        specs = self._td_specs(measured, wsp)
        if specs:
            self.pol = common.replace_td_layers(self.pol,
                                                self.resolver(specs))
            ops = common.td_policy_ops(self.pol).numpy()
            self._install_ops(ops)
            self.swap_log.append({"step": self.steps_run, "kind": "hot",
                                  "ops": ops,
                                  "vdds": self._td_vdds(self.pol)})
        pol0 = common.pol_at(self.pol, 0)
        if self.meter is not None:
            # quant-mode meters re-price at the measured statistics too
            # (their policy carries no solved operating point of its own)
            self.meter.set_policy(
                pol0 if specs else pol0.replace(p_x_one=measured,
                                                w_bit_sparsity=wsp),
                sigma_max=self._meter_sigma())
        self.drift.rearm(measured)
        self.adaptations += 1
        self._adapt_gen += 1
        self._last_measured = (measured, wsp)
        if specs and self.supply_span:
            self._launch_staged(measured, wsp)

    # ------------------------------------------------------------------
    # staged supply swap (phase 2)
    # ------------------------------------------------------------------
    def _launch_staged(self, measured: float, wsp: float) -> None:
        """Start the supply-spanning rebuild off-thread: per-layer Vdd
        argmin over the grid at the measured statistics, the policy solve
        and the meter's re-price, on the worker's own CUDA stream (the
        decode's stream never waits for it), handing host values back.  At
        most one rebuild is in flight."""
        if self._staged is not None:
            return
        self._staged_gen = self._adapt_gen
        base_pol = self.pol
        resolver = self.supply_resolver
        specs = self._td_specs(measured, wsp)
        meter = self.meter
        sigma = self._meter_sigma()
        stream = self._rebuild_stream

        def rebuild():
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                solved = common.replace_td_layers(base_pol, resolver(specs))
                ops = common.td_policy_ops(solved).numpy()
                report = (meter.price(common.pol_at(solved, 0),
                                      sigma_max=sigma)
                          if meter is not None else None)
            return solved, ops, report

        self._staged = ft.StagedRebuild(
            rebuild, name=f"supply-rebuild@{self.steps_run}")

    def _poll_staged(self) -> None:
        """Install a finished staged rebuild (step boundary).  A worker
        exception re-raises here, once, so a resolver that died inside the
        thread fails the run instead of silently keeping the old supply."""
        if self._staged is None or not self._staged.done:
            return
        staged, self._staged = self._staged, None
        res = staged.poll()        # raises once on worker failure
        if res is None:
            return
        if self._staged_gen != self._adapt_gen:
            # a newer excursion re-priced phase 1 while this rebuild ran:
            # rebuild at the latest measured operating point instead
            measured, wsp = self._last_measured
            self._launch_staged(measured, wsp)
            return
        solved, ops, report = res
        moved = self._td_vdds(solved) != self._td_vdds(self.pol)
        self.pol = solved
        self._install_ops(ops)
        if self.meter is not None and report is not None:
            self.meter.install(report)
        self.swap_log.append({"step": self.steps_run, "kind": "staged",
                              "ops": ops, "vdds": self._td_vdds(solved)})
        self.staged_installs += 1
        if moved:
            self.supply_spans += 1

    # ------------------------------------------------------------------
    # chaos-schedule consumption
    # ------------------------------------------------------------------
    def _apply_faults(self, events) -> None:
        for ev in events:
            self.fault_log.append((self.steps_run, ev.kind))
            if ev.kind == "preempt":
                raise ft.Preemption(f"chaos preempt at step {self.steps_run}")
            if ev.kind == "stall":
                time.sleep(float(ev.params.get("duration_s", 0.05)))
            elif ev.kind == "drift":
                self._drift_gain = float(ev.params.get("factor", 1.0))
            elif ev.kind == "explorer_outage":
                self.explorer_up = bool(ev.params.get("up", False))
                if self.on_outage is not None:
                    self.on_outage(self.explorer_up)
            # "ckpt_corrupt" targets training: logged, no-op here

    def warmup(self) -> None:
        """Run one dummy request end to end (the kernels build and load at
        their first launch), then reset the telemetry and device state, so
        a timed run measures scheduling, not set-up."""
        self.submit(Request(rid="__warmup__",
                            prompt=np.full((1,), 3, np.int32),
                            max_new_tokens=2))
        while self.step():
            pass
        self.done.clear()
        self.steps_run = 0
        self.watchdog = ft.StepWatchdog()
        self.admit_ms, self.decode_ms = [], []
        self.replay_steps = 0
        if self.meter is not None:
            self.meter._usage.clear()
        if self.drift is not None:
            self.drift.rearm(self.drift.anchor)
        if self._staged is not None:      # don't let a warm-up rebuild
            self._staged.wait()           # land mid-measurement
            self._staged = None
        self.swap_log.clear()
        self.adaptations = 0
        self.supply_spans = 0
        self.staged_installs = 0
        self._reset_device_state()

    # ------------------------------------------------------------------
    # fault tolerance: drain + re-admit instead of dying
    # ------------------------------------------------------------------
    def drain(self) -> int:
        """Preemption recovery: move every in-flight request back onto the
        front of the queue as a continuation and reset device state.
        Generated tokens are kept: re-admitted, a continuation replays
        them through the decode step (`Slot.replay`) and goes on from its
        last one."""
        inflight = [s.request for s in self.slots if not s.free]
        for slot in self.slots:
            slot.request = None
            slot.replay.clear()
        for req in reversed(inflight):
            req.readmissions += 1
            self.queue.appendleft(req)
        self._reset_device_state()
        return len(inflight)

    def run(self, requests=None, retry_policy: ft.RetryPolicy | None = None,
            inject=None, schedule: "ft.FaultSchedule | None" = None,
            trace: "ft.TrafficTrace | None" = None) -> dict:
        """Drive the loop to completion under retry protection.

        `inject(step_index)` (tests) may raise `ft.Preemption` to simulate
        node loss; the engine drains and re-admits.  ``schedule`` is a
        `ft.FaultSchedule` consumed fire-once per step: preemptions drain
        and retry, stalls sleep (the watchdog flags them), drift events
        scale the measured activity, explorer outages set `explorer_up`
        and call `on_outage`.  ``trace`` is a `ft.TrafficTrace` replayed
        against the step counter (see the module docstring).  A rebuild
        still in flight when the queue drains is landed (or its error
        raised) before the summary."""
        if requests is not None:
            self.submit_all(requests)
        if trace is not None:
            self.trace = trace
        t0 = self.clock()

        def body():
            while True:
                if schedule is not None:
                    self._apply_faults(schedule.pop(self.steps_run))
                if inject is not None:
                    inject(self.steps_run)
                if not self.step():
                    return True

        ft.run_with_retries(body, policy=retry_policy,
                            on_restart=lambda n, e: self.drain())
        while self._staged is not None:
            # a stale result relaunches once at the latest statistics
            self._staged.wait()
            self._poll_staged()
        return self.summary(self.clock() - t0)

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def request_rows(self) -> list[dict]:
        """Per-request telemetry rows (CSV-ready), completion order, with
        the meter's energy fields when there is a meter."""
        rows = []
        for req in self.done.values():
            dts = np.diff(np.asarray(req.token_s)) * 1e3
            row = {"request": req.rid, "prompt_len": len(req.prompt),
                   "new_tokens": len(req.generated),
                   "readmissions": req.readmissions,
                   "ttft_ms": (req.t_first_token - req.arrival_s) * 1e3,
                   "ms_per_token_p50": (float(np.percentile(dts, 50))
                                        if dts.size else 0.0),
                   "ms_per_token_p99": (float(np.percentile(dts, 99))
                                        if dts.size else 0.0)}
            if self.meter is not None:
                rep = self.meter.request_report(req.rid)
                row.update({"energy_j": rep["energy_j"],
                            "j_per_token": rep["j_per_token"],
                            "j_per_decoded_token":
                                rep["j_per_decoded_token"]})
            rows.append(row)
        return rows

    def summary(self, wall_s: float) -> dict:
        rows = self.request_rows()
        new_toks = sum(r["new_tokens"] for r in rows)
        p50 = [r["ms_per_token_p50"] for r in rows if r["new_tokens"] > 1]
        p99 = [r["ms_per_token_p99"] for r in rows if r["new_tokens"] > 1]
        out = {"requests": len(rows), "new_tokens": new_toks,
               "wall_s": wall_s,
               "tokens_per_s": new_toks / wall_s if wall_s else 0.0,
               "steps": self.steps_run,
               "stragglers": self.watchdog.straggler_count,
               "ms_per_token_p50": float(np.median(p50)) if p50 else 0.0,
               "ms_per_token_p99": (float(np.percentile(p99, 99))
                                    if p99 else 0.0),
               "adaptations": self.adaptations,
               "faults": [{"step": s, "kind": k} for s, k in self.fault_log],
               "per_request": rows}
        if self.drift is not None:
            out["p_x_one_measured"] = self.drift.value
            out["drift_excursions"] = self.drift.excursions
            out["supply_spans"] = self.supply_spans
            out["staged_installs"] = self.staged_installs
            out["swap_log"] = [{"step": e["step"], "kind": e["kind"],
                                "vdds": list(e["vdds"])}
                               for e in self.swap_log]
        if self.trace is not None:
            out["trace"] = {"seed": self.trace.seed,
                            "segments": len(self.trace.segments),
                            "total_steps": self.trace.total_steps}
        if self.meter is not None:
            out["energy_j_total"] = self.meter.run_total_energy()
            out["j_per_token"] = (out["energy_j_total"] /
                                  max(1, self.meter.run_total_tokens()))
            out["meter_policy_swaps"] = self.meter.policy_swaps
            out["rate_epochs"] = self.meter.rate_epochs()
            out["static_worst_energy_j"] = self.meter.static_worst_energy()
        return out
