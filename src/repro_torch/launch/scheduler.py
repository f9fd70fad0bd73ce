"""Continuous-batching TD serving engine (port of
`repro/launch/scheduler.py`, without drift adaptation and chaos).

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
    capacity at what the card (or, on the CPU, an H100 80GB) holds.
  * **Latency telemetry**: per-token wall-clock timestamps give
    per-request p50/p99 ms/token; `admit_ms` and `decode_ms` hold each
    admission's and each decode step's host time (ms), both ending at the
    step's one device sync (an admission also enqueues its insert).
  * **Fault tolerance**: the loop runs under `ft.run_with_retries` with
    `ft.StepWatchdog` timing every decode step; a `Preemption` drains the
    in-flight requests back onto the queue as continuations (prompt +
    tokens so far), so no admitted request is lost and greedy outputs
    match an uninterrupted run.

  * **Per-request energy**: `energy_meter.RequestMeter` attributes J/token
    to each request (prompt tokens at admission, each generated token as
    it is recorded) at the policy's operating point, in the
    ``meter_domain`` (td, analog or digital); `request_rows` and `summary`
    carry the energy fields.  No meter for a precise policy.

Not ported yet (ROADMAP.md §1): drift adaptation (``adapt``,
``resolver``, ``supply_resolver``, ``scripted_swaps``) and
`run(schedule=..., trace=...)`; they raise `NotImplementedError`.

Device: the engine's tensors live on ``device`` (CUDA unless the caller
asks for the CPU).  The host waits for the device once per admission (the
prefill's token) and once per decode step (the batch's tokens), as the
reference does.  The steps run in the `torch.profiler` spans
"sched.prefill" (ends at the admission's token read), "sched.insert" (no
sync of its own: its kernels finish before the next step's prompt copy or
token read) and "sched.decode" (ends at the token read).

Scope: decoder-family, pure-attention, token-only models (the bucketed
prefill relies on causal masking to keep pad junk out of the prefix).
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.roofline import model as roofline_model
from repro_torch.tdsim.energy_meter import RequestMeter

__all__ = ["Request", "Slot", "ContinuousBatchingEngine"]


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not yet ported to repro_torch "
                               "(ROADMAP.md §1, 'Still to port')")


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
    """One row of the fixed-capacity decode batch."""
    index: int
    request: Request | None = None

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
                 continuous: bool = True,
                 clock=time.monotonic, adapt: bool = False, resolver=None,
                 supply_resolver=None, scripted_swaps=None, device=None):
        if adapt:
            raise _not_ported("drift adaptation (adapt=True)")
        for name, given in (("resolver", resolver),
                            ("supply_resolver", supply_resolver),
                            ("scripted_swaps", scripted_swaps)):
            if given is not None:
                raise _not_ported(f"drift adaptation ({name})")
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

        # block KV slots sized against the device memory: round the slot
        # to blocks, cap capacity at what the budget admits
        self.kv_plan = roofline_model.plan_kv_cache(
            cfg, capacity, s_cache, block=kv_block,
            hbm_bytes=roofline_model.device_hbm_bytes(self.device))
        self.capacity = min(capacity, max(1, self.kv_plan.max_slots))
        self.s_cache = self.kv_plan.s_cache
        self.prompt_pad = min(prompt_pad or self.s_cache, self.s_cache)

        self.pol = common.resolve_arch_policy(arch, device=self.device)
        if params is None:
            params = get_api(cfg)["init"](
                seed, cfg, self.pol, device=self.device,
                dtype=steps_lib.DTYPES[arch.train.compute_dtype])
        self.params = params

        self._prefill = steps_lib.build_ragged_prefill_step(
            arch, self.prompt_pad, device=self.device)
        self._insert = steps_lib.build_insert_step()
        shape = ShapeCfg("serve", self.s_cache, self.capacity, "decode")
        self._decode = steps_lib.build_serve_step(arch, shape,
                                                  device=self.device)

        pol0 = common.pol_at(self.pol, 0)
        self.meter = (RequestMeter(matmul_shapes(cfg), pol0,
                                   domain=meter_domain,
                                   sigma_max=self._meter_sigma(),
                                   device=self.device)
                      if pol0.mode != "precise" else None)
        self.watchdog = ft.StepWatchdog()
        self.admit_ms: list[float] = []
        self.decode_ms: list[float] = []

        self.queue: deque[Request] = deque()
        self.slots = [Slot(i) for i in range(self.capacity)]
        self.done: dict[int, Request] = {}
        self.steps_run = 0
        self._reset_device_state()

    # ------------------------------------------------------------------
    # device state
    # ------------------------------------------------------------------
    def _reset_device_state(self) -> None:
        caches = transformer.init_caches(self.capacity, self.s_cache,
                                         self.cfg, torch.bfloat16,
                                         device=self.device,
                                         per_row_idx=True)
        self._state = {"layers": caches, "enc_out": None}
        self._tok = torch.zeros((self.capacity, 1), dtype=torch.int32,
                                device=self.device)

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
        ctx = req.context
        padded = np.zeros((1, self.prompt_pad), np.int32)
        padded[0, :len(ctx)] = ctx
        # the copy waits for the device, which the last step left idle
        toks = torch.from_numpy(padded).to(self.device)
        with record_function("sched.prefill"):
            tok, pstate = self._prefill(self.params, toks, len(ctx))
            first = int(tok[0, 0])     # the admission's one host sync
        with record_function("sched.insert"):
            self._state = self._insert(self._state, pstate, slot.index,
                                       len(ctx))
            self._tok[slot.index] = tok[0]
        self.admit_ms.append((time.perf_counter() - t0) * 1e3)
        slot.request = req
        now = self.clock()
        if req.t_admitted is None:
            req.t_admitted = now
        if self.meter is not None:
            self.meter.on_prefill(req.rid, len(ctx))
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

    # ------------------------------------------------------------------
    # the worker loop: admit -> one batched decode step -> harvest
    # ------------------------------------------------------------------
    @property
    def active(self) -> list[Slot]:
        return [s for s in self.slots if not s.free]

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler tick.  Returns False when no work remains."""
        if self.continuous or not self.active:
            budget = self.capacity
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
            self._tok, self._state = self._decode(self.params, self._tok,
                                                  self._state)
            toks = self._tok.cpu().numpy()   # the step's one host sync
        self.decode_ms.append(self.watchdog.stop().duration * 1e3)
        self.steps_run += 1
        now = self.clock()
        for slot in active:
            self._record_token(slot.request, int(toks[slot.index, 0]), now)
            self._retire_or_keep(slot)
        return bool(self.queue or self.active)

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
        if self.meter is not None:
            self.meter._usage.clear()
        self._reset_device_state()

    # ------------------------------------------------------------------
    # fault tolerance: drain + re-admit instead of dying
    # ------------------------------------------------------------------
    def drain(self) -> int:
        """Preemption recovery: move every in-flight request back onto the
        front of the queue as a continuation and reset device state.
        Generated tokens are kept: greedy decode re-prefilled from
        prompt+generated continues with the same tokens."""
        inflight = [s.request for s in self.slots if not s.free]
        for slot in self.slots:
            slot.request = None
        for req in reversed(inflight):
            req.readmissions += 1
            self.queue.appendleft(req)
        self._reset_device_state()
        return len(inflight)

    def run(self, requests=None, retry_policy: ft.RetryPolicy | None = None,
            inject=None, schedule=None, trace=None) -> dict:
        """Drive the loop to completion under retry protection.

        `inject(step_index)` (tests, benches) may raise `ft.Preemption` to
        simulate node loss; the engine drains and re-admits.  ``schedule``
        (a chaos `FaultSchedule`) and ``trace`` (a `TrafficTrace`) are not
        ported yet and raise."""
        if schedule is not None:
            raise _not_ported("run(schedule=...) (ft/chaos.py)")
        if trace is not None:
            raise _not_ported("run(trace=...) (ft/chaos.py, ft/drift.py)")
        if requests is not None:
            self.submit_all(requests)
        t0 = self.clock()

        def body():
            while True:
                if inject is not None:
                    inject(self.steps_run)
                if not self.step():
                    return True

        ft.run_with_retries(body, policy=retry_policy,
                            on_restart=lambda n, e: self.drain())
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
               "per_request": rows}
        if self.meter is not None:
            out["energy_j_total"] = self.meter.run_total_energy()
            out["j_per_token"] = (out["energy_j_total"] /
                                  max(1, self.meter.run_total_tokens()))
            out["meter_policy_swaps"] = self.meter.policy_swaps
            out["rate_epochs"] = self.meter.rate_epochs()
            out["static_worst_energy_j"] = self.meter.static_worst_energy()
        return out
