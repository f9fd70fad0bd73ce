"""Deterministic chaos engine: seeded fault schedules that replay
bit-identically (the port's copy of `repro/ft/chaos.py`, numpy only).

A `FaultSchedule` is a registry of `FaultEvent`s keyed by the step at
which they fire.  The launchers consume it through ``pop(step)``: each
event fires exactly once (a preemption restarts the loop, and the
restarted session must not trip the same fault again), and because the
schedule is plain data (seeded generation, JSON round trip) the same
schedule drives tests, the chaos checks and a real soak run alike.

Event kinds (``CHAOS_KINDS``):

``preempt``
    Node loss: the consumer raises `ft.Preemption` (train restarts from
    the last checkpoint under `run_with_retries`; the serving engine
    drains in-flight requests back onto the queue).
``stall``
    Straggler: the consumer sleeps ``duration_s`` before the step, which
    the `StepWatchdog` must flag.
``ckpt_corrupt``
    Storage fault against the newest published checkpoint:
    ``mode="bitflip"`` (seeded byte flip inside ``arrays.npz``),
    ``"truncate"`` (arrays.npz cut to half), ``"rm_manifest"`` or
    ``"tmp_litter"`` (a leftover ``step_*.tmp`` dir from a killed
    writer).  `checkpoint.ckpt.restore` must fall back to the newest
    intact step.
``explorer_outage``
    The explorer server goes dark (``up=False``) or recovers
    (``up=True``): remote policy resolution must degrade to the
    in-process grid, never fail a request.
``drift``
    Operating-point excursion: the measured activation activity is
    scaled by ``factor`` (a workload shift, e.g. a sparser traffic mix),
    which the serving drift adapter must detect and re-resolve policies
    for.

`corrupt_checkpoint` is the storage-fault injector itself, aimed at the
port's checkpoint layout (``manifest.json`` beside ``arrays.npz``; the
reference writes ``manifest.msgpack``).  Generated schedules and traces,
and their JSON text, equal the reference's for the same seed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random

import numpy as np

CHAOS_KINDS = ("preempt", "stall", "ckpt_corrupt", "explorer_outage",
               "drift")

CORRUPT_MODES = ("bitflip", "truncate", "rm_manifest", "tmp_litter")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault at one step.  ``params`` is kind-specific plain data
    (JSON-able)."""
    step: int
    kind: str
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in CHAOS_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(kinds: {CHAOS_KINDS})")


class FaultSchedule:
    """Ordered fault registry with fire-once ``pop`` semantics.

    Build explicitly from events, from JSON, or generate one with
    `FaultSchedule.generate(seed=...)` -- the same seed always yields the
    same schedule, and `to_json` -> `from_json` round-trips exactly, so a
    schedule can be archived as an artifact and replayed bit-identically.
    """

    def __init__(self, events=(), seed: int = 0):
        self.seed = int(seed)
        self._events: dict[int, list[FaultEvent]] = {}
        self.fired: list[FaultEvent] = []
        for ev in events:
            self.add(ev)

    def add(self, ev: FaultEvent) -> "FaultSchedule":
        self._events.setdefault(int(ev.step), []).append(ev)
        return self

    @property
    def pending(self) -> list[FaultEvent]:
        return [ev for s in sorted(self._events)
                for ev in self._events[s]]

    def events_of(self, kind: str) -> list[FaultEvent]:
        return [ev for ev in self.pending + self.fired if ev.kind == kind]

    def pop(self, step: int) -> list[FaultEvent]:
        """Every not-yet-fired event declared at or before ``step`` (a
        restarted loop may skip past a declared step; the fault must
        still fire exactly once)."""
        due = []
        for s in sorted(self._events):
            if s > step:
                break
            due.extend(self._events[s])
        for s in [s for s in self._events if s <= step]:
            del self._events[s]
        self.fired.extend(due)
        return due

    # -- replay / persistence ---------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed,
             "events": [{"step": ev.step, "kind": ev.kind,
                         "params": ev.params}
                        for ev in self.pending + self.fired]},
            indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        d = json.loads(text)
        return cls([FaultEvent(int(e["step"]), e["kind"],
                               dict(e.get("params", {})))
                    for e in d.get("events", [])],
                   seed=int(d.get("seed", 0)))

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "FaultSchedule":
        with open(path) as f:
            return cls.from_json(f.read())

    @classmethod
    def generate(cls, seed: int, steps: int,
                 kinds=CHAOS_KINDS, n_faults: int = 4,
                 drift_factors=(0.5, 1.5)) -> "FaultSchedule":
        """A seeded random schedule: ``n_faults`` events at distinct steps
        in [1, steps), cycling through ``kinds``.  Same seed -> identical
        schedule, bit for bit."""
        rng = random.Random(int(seed))
        lo, hi = 1, max(2, int(steps))
        at = sorted(rng.sample(range(lo, hi), min(n_faults, hi - lo)))
        sched = cls(seed=seed)
        for i, step in enumerate(at):
            kind = kinds[i % len(kinds)]
            params: dict = {}
            if kind == "stall":
                params = {"duration_s": round(rng.uniform(0.05, 0.2), 3)}
            elif kind == "ckpt_corrupt":
                params = {"mode": rng.choice(CORRUPT_MODES),
                          "seed": rng.randrange(2 ** 16)}
            elif kind == "explorer_outage":
                params = {"up": False}
            elif kind == "drift":
                params = {"factor": rng.choice(list(drift_factors))}
            sched.add(FaultEvent(step, kind, params))
        return sched


# ---------------------------------------------------------------------------
# Storage-fault injector
# ---------------------------------------------------------------------------
def corrupt_checkpoint(ckpt_dir: str, mode: str, step: int | None = None,
                       seed: int = 0) -> int | None:
    """Corrupt the checkpoint at ``step`` (default: newest) in one of the
    declared ways.  Deterministic for a given (mode, seed, checkpoint).
    Returns the corrupted step, or None when there was nothing to hit
    (``tmp_litter`` needs no published step)."""
    from repro_torch.checkpoint import ckpt as ckpt_mod

    if mode not in CORRUPT_MODES:
        raise ValueError(f"unknown corruption mode {mode!r} "
                         f"(modes: {CORRUPT_MODES})")
    steps = ckpt_mod.latest_steps(ckpt_dir)
    if mode == "tmp_litter":
        # a writer killed mid-publish: a stale .tmp dir with a partial
        # manifest; restore/latest_steps must skip it entirely
        nxt = (steps[-1] if steps else 0) + 1
        tmp = os.path.join(ckpt_dir, f"step_{nxt:08d}.tmp")
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, ckpt_mod.MANIFEST), "wb") as f:
            f.write(b"\x00partial")
        return None
    if not steps:
        return None
    step = steps[-1] if step is None else int(step)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    arrays = os.path.join(d, "arrays.npz")
    if mode == "rm_manifest":
        os.remove(os.path.join(d, ckpt_mod.MANIFEST))
    elif mode == "truncate":
        size = os.path.getsize(arrays)
        with open(arrays, "r+b") as f:
            f.truncate(max(1, size // 2))
    elif mode == "bitflip":
        # flip one byte INSIDE a member's array payload (located via the
        # zip local header) so the archive still opens but that array's
        # sha256 digest no longer matches — flipping zip metadata instead
        # could go unnoticed by a lenient reader
        import struct
        import zipfile

        rng = random.Random(int(seed))
        with zipfile.ZipFile(arrays) as z:
            info = rng.choice(z.infolist())
        with open(arrays, "r+b") as f:
            f.seek(info.header_offset + 26)
            nlen, elen = struct.unpack("<HH", f.read(4))
            data_off = info.header_offset + 30 + nlen + elen
            off = data_off + rng.randrange(max(1, info.compress_size))
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
    return step


def excursion_trace(seed: int, steps: int, base: float = 0.25,
                    shift: float = 0.1) -> np.ndarray:
    """A deterministic drifting operating-point trace (activity per step):
    a random walk that the drift-adaptive serve bench uses as its
    workload model.  Same seed -> identical trace."""
    rng = np.random.default_rng(int(seed))
    walk = np.cumsum(rng.uniform(-shift, shift, size=int(steps)))
    return np.clip(base + walk, 0.05, 0.95)


# ---------------------------------------------------------------------------
# Traffic traces (multi-hour workload models for the drift-adaptive engine)
# ---------------------------------------------------------------------------
ACTIVITY_BOUNDS = (0.05, 4.0)    # multiplier on the measured p_x_one
SPARSITY_BOUNDS = (0.0, 1.0)     # w_bit_sparsity of the traffic mix
LOAD_BOUNDS = (0.05, 1.0)        # admission pressure (fraction of capacity)


@dataclasses.dataclass(frozen=True)
class TraceSegment:
    """One piecewise-constant stretch of traffic.

    ``steps`` scheduler decode steps during which the workload runs at
    ``activity`` (a MULTIPLIER on the measured activation bit density --
    the same knob as the chaos ``drift`` event's ``factor``),
    ``sparsity`` (the traffic mix's weight-bit-sparsity statistic fed to
    the re-resolve) and ``load`` (admission pressure: the fraction of
    free slots the scheduler may fill per step)."""
    steps: int
    activity: float = 1.0
    sparsity: float | None = None    # None = keep the deployed statistic
    load: float = 1.0

    def __post_init__(self):
        if int(self.steps) <= 0:
            raise ValueError(f"segment needs steps >= 1, got {self.steps}")
        lo, hi = ACTIVITY_BOUNDS
        if not (lo <= float(self.activity) <= hi):
            raise ValueError(f"activity {self.activity} outside {lo}..{hi}")
        if self.sparsity is not None and not (
                SPARSITY_BOUNDS[0] <= float(self.sparsity)
                <= SPARSITY_BOUNDS[1]):
            raise ValueError(f"sparsity {self.sparsity} outside 0..1")
        if not (0.0 < float(self.load) <= LOAD_BOUNDS[1]):
            raise ValueError(f"load {self.load} outside (0, 1]")


class TrafficTrace:
    """A deterministic multi-hour traffic model: ordered piecewise
    activity/sparsity/load segments that replay bit-identically.

    The first-class successor of `excursion_trace`: where the random walk
    produced an anonymous per-step array, a trace is plain data -- seeded
    generation (`generate`), exact JSON round-trip (`to_json` ->
    `from_json`), and step-indexed lookup (`at(step)`; steps past the end
    hold the final segment, so a serve run longer than the trace keeps its
    last operating point).  `ContinuousBatchingEngine.run(trace=...)`
    replays one through the drift-adaptation loop.
    """

    def __init__(self, segments, seed: int = 0):
        self.seed = int(seed)
        self.segments: tuple[TraceSegment, ...] = tuple(segments)
        if not self.segments:
            raise ValueError("a trace needs >= 1 segment")
        starts = np.cumsum([0] + [int(s.steps) for s in self.segments])
        self._starts = starts[:-1]
        self.total_steps = int(starts[-1])

    # -- step-indexed replay ----------------------------------------------
    def segment_index(self, step: int) -> int:
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        return min(int(np.searchsorted(self._starts, step, side="right")) - 1,
                   len(self.segments) - 1)

    def at(self, step: int) -> TraceSegment:
        """The segment in force at ``step`` (the tail segment persists
        past ``total_steps``)."""
        return self.segments[self.segment_index(step)]

    def boundaries(self) -> list[tuple[int, int]]:
        """Per-segment [start, end) step intervals -- contiguous, gapless,
        monotonically covering [0, total_steps)."""
        return [(int(s), int(s) + seg.steps)
                for s, seg in zip(self._starts, self.segments)]

    def activity_curve(self, steps: int | None = None) -> np.ndarray:
        """Per-step activity multipliers (replayed, length ``steps``)."""
        n = self.total_steps if steps is None else int(steps)
        return np.asarray([self.at(t).activity for t in range(n)], np.float64)

    # -- replay / persistence ---------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed,
             "segments": [{"steps": s.steps, "activity": s.activity,
                           "sparsity": s.sparsity, "load": s.load}
                          for s in self.segments]},
            indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TrafficTrace":
        d = json.loads(text)
        return cls([TraceSegment(int(s["steps"]),
                                 float(s.get("activity", 1.0)),
                                 (None if s.get("sparsity") is None
                                  else float(s["sparsity"])),
                                 float(s.get("load", 1.0)))
                    for s in d.get("segments", [])],
                   seed=int(d.get("seed", 0)))

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "TrafficTrace":
        with open(path) as f:
            return cls.from_json(f.read())

    def __eq__(self, other) -> bool:
        return (isinstance(other, TrafficTrace)
                and self.seed == other.seed
                and self.segments == other.segments)

    def __repr__(self) -> str:
        return (f"TrafficTrace(seed={self.seed}, "
                f"segments={len(self.segments)}, "
                f"total_steps={self.total_steps})")

    # -- seeded generation --------------------------------------------------
    @classmethod
    def generate(cls, seed: int, steps: int, n_segments: int = 6,
                 activity_range=(0.4, 1.6), sparsity_range=(0.4, 0.9),
                 load_range=(0.5, 1.0)) -> "TrafficTrace":
        """A seeded random trace: ``n_segments`` piecewise segments whose
        step counts partition [0, steps).  Same seed -> identical trace,
        bit for bit (`random.Random`, like `FaultSchedule.generate`)."""
        rng = random.Random(int(seed))
        steps = max(1, int(steps))
        n_segments = max(1, min(int(n_segments), steps))
        # n_segments - 1 distinct interior cut points -> positive durations
        cuts = sorted(rng.sample(range(1, steps), n_segments - 1)) \
            if n_segments > 1 else []
        edges = [0] + cuts + [steps]
        segs = []
        for a, b in zip(edges[:-1], edges[1:]):
            segs.append(TraceSegment(
                steps=b - a,
                activity=round(rng.uniform(*activity_range), 4),
                sparsity=round(rng.uniform(*sparsity_range), 4),
                load=round(rng.uniform(*load_range), 4)))
        return cls(segs, seed=seed)

    @classmethod
    def from_excursion(cls, seed: int, steps: int, segment: int = 16,
                       base: float = 0.25, shift: float = 0.1
                       ) -> "TrafficTrace":
        """Bucket an `excursion_trace` random walk into piecewise segments:
        each ``segment``-step bucket's mean activity, normalized by
        ``base`` so it becomes the multiplier a trace carries."""
        walk = excursion_trace(seed, steps, base=base, shift=shift)
        lo, hi = ACTIVITY_BOUNDS
        segs = []
        for a in range(0, int(steps), int(segment)):
            chunk = walk[a:a + int(segment)]
            segs.append(TraceSegment(
                steps=len(chunk),
                activity=float(np.clip(chunk.mean() / base, lo, hi))))
        return cls(segs, seed=seed)
