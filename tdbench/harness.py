"""The benchmark of the PyTorch/CUDA port (`repro_torch`): one cell run
once, from set-up to the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``tdbench/configs/<config>.json``: the model as run, its
TD macro and the operating point the port must solve to), a traffic mix
(``tdbench/traffic/<traffic>.json``: the parameters of the generator it
names, ``tdbench/traffic/<generator>.py``) and has a file of its own,
``tdbench/workloads/<cell>.json``, with the output check's scope and
limits.  Per-layer metrics are readers in ``tdbench/metrics/<metric>.py``.
Everything is found by name.

A run:
  1. makes the weights on the device from the seed (`make_params`);
  2. builds the engine (`launch.scheduler.ContinuousBatchingEngine`),
     which solves the TD policy; the solved operating point is checked
     against the configuration's;
  3. warms the engine up (its own ``warmup``: one request through the
     cell's prefill bucket and decode batch, every kernel built and
     loaded);
  4. sends the generator's first requests and runs one engine step, which
     admits them;
  5. opens the window: engine steps, the generator sending after each
     what it has due, until ``--seconds`` have passed; with ``--trace 1``
     a steady sub-window is profiled;
  6. reads the device's peak memory, frees the engine and checks the
     served tokens against the plain reference (`reference/`).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from tdbench import work as work_mod
from tdbench.reference import judge as judge_mod
from tdbench.reference import model as ref_model
from tdbench.reference import td as ref_td

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_START = 0.3          # share of the window before the sub-window
PROFILE_LEN_S = 4.0          # the sub-window's length


# ---------------------------------------------------------------------------
# the cell, found by name
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    spec: dict                   # tdbench/workloads/<cell>.json
    end_to_end: list
    per_layer: list
    root: str
    chips: int = 1


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files, and
    the metrics it reports."""
    bench = _read(os.path.join(root, "BENCHMARK.json"))
    ent = next((w for w in bench["workloads"] if w["name"] == name), None)
    if ent is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    base = os.path.join(root, "tdbench")
    cfg = next(c for c in bench["configs"] if c["name"] == ent["config"])

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return Cell(name=name,
                config=_read(os.path.join(root, cfg["file"])),
                traffic=_read(os.path.join(base, "traffic",
                                           ent["traffic"] + ".json")),
                spec=_read(os.path.join(base, "workloads", name + ".json")),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)],
                root=root, chips=int(ent.get("chips", 1)))


def model_dims(config: dict) -> dict:
    """The sizes the work arithmetic and the reference read."""
    mc = dict(config["model_cfg"])
    mc["bits_a"] = config["td"]["bits_a"]
    mc["bits_w"] = config["td"]["bits_w"]
    return mc


def arch_of(config: dict):
    from repro_torch.configs.base import (ArchConfig, ModelCfg, MoECfg,
                                          TDExecCfg)
    mc = dict(config["model_cfg"])
    if "moe" in mc:
        mc["moe"] = MoECfg(**mc["moe"])
    return ArchConfig(model=ModelCfg(**mc), td=TDExecCfg(**config["td"]))


# ---------------------------------------------------------------------------
# weights, made by the benchmark from the seed
# ---------------------------------------------------------------------------
def _param_specs(mc: dict, init: dict) -> list:
    """(path, shape, std) of every random leaf, in a fixed order: every
    weight normal with the source's ``std`` (its initializer_range), the
    products that write into the residual stream (attention's wo, the
    MLP's and the experts' wo) at std / sqrt(2 L), L the published
    depth, as GPT-2 and MPT (LLM Foundry, which trained DBRX) scale
    them."""
    d, hd = mc["d_model"], mc["head_dim"]
    hq, hkv = mc["n_heads"], mc["n_kv_heads"]
    std = init["std"]
    res = std / (2.0 * init["published_layers"]) ** 0.5
    out = [(("embed", "table"), (mc["vocab"], d), std)]
    for i in range(mc["n_layers"]):
        L = ("layers", i)
        out += [(L + ("attn", "wq", "w"), (d, hq * hd), std),
                (L + ("attn", "wk", "w"), (d, hkv * hd), std),
                (L + ("attn", "wv", "w"), (d, hkv * hd), std),
                (L + ("attn", "wo", "w"), (hq * hd, d), res)]
        moe = mc.get("moe")
        if moe is None:
            f = mc["d_ff"]
            out += [(L + ("mlp", "wi", "w"), (d, f), std),
                    (L + ("mlp", "wg", "w"), (d, f), std),
                    (L + ("mlp", "wo", "w"), (f, d), res)]
        else:
            e, f = moe["num_experts"], moe["d_ff_expert"]
            out += [(L + ("moe", "router", "w"), (d, e), std),
                    (L + ("moe", "wi"), (e, d, f), std),
                    (L + ("moe", "wg"), (e, d, f), std),
                    (L + ("moe", "wo"), (e, f, d), res)]
    out.append((("lm_head", "w"), (d, mc["vocab"]), std))
    return out


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if key == "layers" else {})
    node[path[-1]] = value


def make_params(mc: dict, init: dict, seed: int, device,
                dtype=torch.bfloat16) -> dict:
    """The served weights in the port's layout, in ``dtype`` on
    ``device``: one normal draw from a generator on the device fills one
    flat buffer, whose views are scaled to each leaf's std.  LSQ steps
    are 2 mean|w| / sqrt(Qp) a weight (an expert stack one step) and
    2 / sqrt(Qp) for activations; norm scales are 1."""
    qp = 2 ** (mc["bits_w"] - 1) - 1
    qpa = 2 ** (mc["bits_a"] - 1) - 1
    specs = _param_specs(mc, init)
    total = sum(int(np.prod(s)) for _, s, _ in specs)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    tree: dict = {"layers": []}
    at = 0
    sqrt_qp = float(np.sqrt(np.float32(qp)))
    for path, shape, std in specs:
        n = int(np.prod(shape))
        t = flat[at:at + n].view(shape)
        t.mul_(std)
        at += n
        _put(tree, path, t)
        if path[-1] == "w" and path[-2] != "router":
            s = 2.0 * torch.mean(t.abs(), dtype=torch.float32) / sqrt_qp
            _put(tree, path[:-1] + ("s_w",), s.to(dtype))
            _put(tree, path[:-1] + ("s_a",), torch.tensor(
                2.0 / qpa ** 0.5, dtype=torch.float32,
                device=device).to(dtype))
        elif path[-2] == "moe" and path[-1] in ("wi", "wg", "wo"):
            s = 2.0 * torch.mean(t.abs(), dtype=torch.float32) / sqrt_qp
            _put(tree, path[:-1] + ("s_" + path[-1],), s.to(dtype))
    d, hd = mc["d_model"], mc["head_dim"]
    ones_d = torch.ones(d, dtype=dtype, device=device)
    ones_h = torch.ones(hd, dtype=dtype, device=device)
    for lp in tree["layers"]:
        lp["ln1"] = {"scale": ones_d}
        lp["ln2"] = {"scale": ones_d}
        if mc.get("qk_norm"):
            lp["attn"]["q_norm"] = {"scale": ones_h}
            lp["attn"]["k_norm"] = {"scale": ones_h}
        if "moe" in lp:
            lp["moe"]["s_a"] = torch.tensor(
                2.0 / qpa ** 0.5, dtype=torch.float32,
                device=device).to(dtype)
    tree["final_norm"] = {"scale": ones_d}
    return tree


# ---------------------------------------------------------------------------
# the traffic: a generator found by name, the mix its parameters
# ---------------------------------------------------------------------------
def _load(root: str, sub: str, name: str):
    """The module ``tdbench/<sub>/<name>.py`` of the checkout ``root``."""
    import importlib.util
    path = os.path.join(root, "tdbench", sub, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"tdbench_{sub}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_traffic(root: str, mix: dict, vocab: int, seed: int):
    """The generator the mix names, made from the mix and the seed."""
    return _load(root, "traffic", mix["generator"]).Traffic(mix, vocab, seed)


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------
def _pct(vals, q: float) -> float:
    return float(np.percentile(np.asarray(vals, np.float64), q))


def _isolation() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Log:
    """What the benchmark saw of the engine: each request's slot and
    first decode step, each admission's and decode step's order."""
    slot: dict = dataclasses.field(default_factory=dict)
    decode0: dict = dataclasses.field(default_factory=dict)
    admit_order: list = dataclasses.field(default_factory=list)
    profiled_admits: list = dataclasses.field(default_factory=list)
    profiled_steps: list = dataclasses.field(default_factory=list)
    snapshots: list = dataclasses.field(default_factory=list)


class Run:
    """One run of a cell on ``device``."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t0: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t0 = trace, device, t0
        self.mc = model_dims(cell.config)
        self.log = Log()
        self.key_of: list = []          # a request id's generator key

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.launch.scheduler import ContinuousBatchingEngine
        tr = self.cell.traffic
        self.traffic = load_traffic(self.cell.root, tr, self.mc["vocab"],
                                    self.seed)
        self.params = make_params(self.mc, self.cell.config["init"],
                                  self.seed, self.device)
        self.engine = ContinuousBatchingEngine(
            arch_of(self.cell.config), capacity=tr["capacity"],
            s_cache=self.traffic.max_context,
            prompt_pad=tr["prompt_pad"], params=self.params,
            device=self.device)
        if self.engine.capacity != tr["capacity"]:
            raise RuntimeError(f"the engine holds {self.engine.capacity} "
                               f"slots, the traffic asks for "
                               f"{tr['capacity']}")
        self.engine.warmup()
        if self.trace:
            # the profiler's first start initialises its tracer (seconds
            # on the card): here, not inside the sub-window
            from tdbench import trace as trace_mod
            trace_mod.warm_up()
        self._seen_done = 0
        self._send(self.traffic.start(), time.monotonic())
        self._step()
        self._traffic_turn(time.monotonic())

    def operating_point(self) -> dict:
        """The solved policy's operating point against the
        configuration's: {name: (solved, stated)}."""
        pol = self.engine.pol
        want = self.cell.config["operating_point"]
        td = self.cell.config["td"]
        return {"redundancy": (pol.redundancy, want["redundancy"]),
                "sigma_chain": (float(pol.sigma_chain),
                                want["sigma_chain"]),
                "tdc_q": (float(pol.tdc_q), want["tdc_q"]),
                "n_chain": (pol.n_chain, td["n_chain"]),
                "bits_a": (pol.bits_a, td["bits_a"]),
                "bits_w": (pol.bits_w, td["bits_w"])}

    # -- the loop -----------------------------------------------------------
    def _step(self) -> None:
        """One engine step, its admissions' slots read off the engine's
        admission rule (free slots in order take the queue in order)."""
        eng = self.engine
        tick = eng.steps_run
        free = [s.index for s in eng.slots if s.free]
        queued = [r.rid for r in eng.queue]
        eng.step()
        for slot, rid in zip(free, queued):
            self.log.slot[rid] = slot
            self.log.decode0[rid] = tick
            self.log.admit_order.append(rid)

    def _snapshot(self) -> None:
        """With the ``snapshots`` check: after every ``every``-th step of
        the window, up to ``snapshots`` of them, a device copy of the
        engine's KV caches (the program's state the check follows) and
        the step's slots."""
        chk = self.cell.spec["check"]
        if "snapshots" not in chk:
            return
        tick = self.engine.steps_run - 1
        k = tick - self.first_tick - 1
        if k < 0 or k % chk["every"] or \
                len(self.log.snapshots) >= chk["snapshots"]:
            return
        layers = self.engine._state["layers"]
        self.log.snapshots.append({
            "tick": tick,
            "k": [c["k"].clone() for c in layers],
            "v": [c["v"].clone() for c in layers]})

    def _send(self, asks: list, now: float) -> None:
        """Submit the generator's ``(key, prompt, max_new_tokens)`` asks,
        each arriving ``now``."""
        from repro_torch.launch.scheduler import Request
        for key, prompt, out in asks:
            rid = len(self.key_of)
            self.key_of.append(key)
            self.engine.submit(Request(rid=rid, prompt=prompt,
                                       max_new_tokens=out, arrival_s=now))

    def _traffic_turn(self, now: float) -> None:
        with torch.profiler.record_function("bench.traffic"):
            done = list(self.engine.done.values())
            keys = [self.key_of[r.rid] for r in done[self._seen_done:]]
            self._seen_done = len(done)
            self._send(self.traffic.after_step(now, keys), now)

    def window(self) -> None:
        """Engine steps until ``seconds`` have passed; with ``trace`` the
        profiler over [PROFILE_START, + PROFILE_LEN_S] of it, from one
        step boundary to another."""
        from tdbench import trace as trace_mod
        prof = (trace_mod.Profile(os.path.join(
            self.cell.root, "build", "tdbench", "trace.json"))
            if self.trace else None)
        p0 = PROFILE_START * self.seconds
        mark = None
        self.first_tick = self.engine.steps_run
        self.t_open = time.monotonic()
        while True:
            if prof is not None and mark is None and \
                    time.monotonic() - self.t_open >= p0:
                prof.start()
                mark = (len(self.log.admit_order), self.engine.steps_run,
                        time.monotonic())
            self._step()
            self._snapshot()
            now = time.monotonic()
            self._traffic_turn(now)
            if mark is not None and self.prof_result is None and (
                    now - mark[2] >= PROFILE_LEN_S or now - self.t_open
                    >= self.seconds):
                prof.stop()
                self.log.profiled_admits = self.log.admit_order[mark[0]:]
                self.log.profiled_steps = list(range(
                    mark[1], self.engine.steps_run))
                self.prof_result = prof
            if now - self.t_open >= self.seconds:
                break
        self.t_close = now

    prof_result = None

    # -- end-to-end metrics -------------------------------------------------
    def requests(self) -> list:
        eng = self.engine
        live = [s.request for s in eng.slots if s.request is not None]
        return list(eng.done.values()) + live

    def _in(self, t) -> bool:
        return t is not None and self.t_open < t <= self.t_close

    def end_to_end(self) -> dict:
        dur = self.t_close - self.t_open
        reqs = self.requests()
        firsts = [r for r in reqs if self._in(r.t_first_token)]
        vals = {
            "setup_s": self.t_open - self.t0,
            "prompt_tokens_per_s": sum(len(r.prompt) for r in firsts) / dur,
            "ttft_p90_ms": (_pct([(r.t_first_token - r.arrival_s) * 1e3
                                  for r in firsts], 90) if firsts else None),
            "output_tokens_per_s": sum(sum(1 for t in r.token_s
                                           if self._in(t))
                                       for r in reqs) / dur,
        }
        itl = [(b - a) * 1e3 for r in reqs
               for a, b in zip(r.token_s, r.token_s[1:]) if self._in(b)]
        vals["itl_p95_ms"] = _pct(itl, 95) if itl else None
        self.n_first = len(firsts)
        self.n_gaps = len(itl)
        return vals

    def attempted_failed(self) -> tuple[int, int]:
        """Requests with a token in the window, and those of them whose
        tokens outnumber what they asked for."""
        reqs = [r for r in self.requests()
                if any(self._in(t) for t in r.token_s)]
        return len(reqs), sum(len(r.generated) > r.max_new_tokens
                              for r in reqs)

    # -- work and the trace -------------------------------------------------
    def _tick_kv(self, tick: int) -> list[int]:
        """Keys each occupied row of decode step ``tick`` attends to."""
        out = []
        by_rid = {r.rid: r for r in self.requests()}
        for rid, d0 in self.log.decode0.items():
            r = by_rid.get(rid)
            if r is None:
                continue
            j = tick - d0 + 1                 # the token this step made
            if 1 <= j < len(r.generated):
                out.append(len(r.prompt) + j)
        return out

    def work(self, admits, ticks) -> work_mod.Work:
        w = work_mod.Work()
        by_rid = {r.rid: r for r in self.requests()}
        for rid in admits:
            w.add(work_mod.prefill_work(self.mc, len(by_rid[rid].prompt)))
        for t in ticks:
            kv = self._tick_kv(t)
            if kv:
                w.add(work_mod.decode_work(self.mc, kv))
        return w

    def window_calls(self) -> tuple[list, list]:
        """Admissions and decode steps that ended inside the window."""
        by_rid = {r.rid: r for r in self.requests()}
        admits = [rid for rid in self.log.admit_order
                  if self._in(by_rid[rid].t_first_token)]
        ticks = list(range(self.first_tick, self.engine.steps_run))
        return admits, ticks

    def metric_context(self) -> dict:
        eng = self.engine
        by_rid = {r.rid: r for r in self.requests()}
        admits, ticks = self.window_calls()
        pos = {rid: k for k, rid in enumerate(self.log.admit_order)}
        ctx = {
            "mc": self.mc, "cell": self.cell.name,
            "window_s": self.t_close - self.t_open,
            "admit_ms": [eng.admit_ms[pos[rid]] for rid in admits
                         if pos[rid] < len(eng.admit_ms)],
            "decode_ms": [eng.decode_ms[t] for t in ticks
                          if t < len(eng.decode_ms)],
            "window_work": self.work(admits, ticks),
            "first_tokens": len([r for r in by_rid.values()
                                 if self._in(r.t_first_token)]),
        }
        if self.prof_result is not None:
            tr = self.prof_result.result()
            ctx["trace"] = tr
            ctx["trace_work"] = self.work(self.log.profiled_admits,
                                          self.log.profiled_steps)
        return ctx

    # -- the output check ---------------------------------------------------
    def _slots_at_close(self) -> dict:
        """{slot: request} of the requests in the slots at the close."""
        return {s.index: s.request for s in self.engine.slots
                if s.request is not None}

    def check_rows(self) -> tuple[list, dict]:
        """The rows the reference recomputes and the program's cache they
        read (`reference.model`).

        ``slots``: at the window's close, that many slots drawn from the
        seed: every position of the request each holds (its prompt rows
        and its decode rows, every token it served judged), against the
        cache the engine holds for it then.  ``snapshots``: after the
        snapshot steps of the window, every slot's decode row of that step
        and each admission of that step whole (prompt and pad rows),
        against the cache copied after the step: the mixture of experts
        couples a call's rows, so every row of a call is recomputed."""
        from tdbench.reference.model import Row
        chk = self.cell.spec["check"]
        tr = self.cell.traffic
        by_rid = {r.rid: r for r in self.requests()}
        rows, cache = [], {}
        if "slots" in chk:
            live = self._slots_at_close()
            rng = np.random.default_rng([int(self.seed) % (2 ** 63), 13])
            pick = sorted(rng.choice(sorted(live), min(chk["slots"],
                                                       len(live)),
                                     replace=False).tolist())
            layers = self.engine._state["layers"]
            for s in pick:
                r = live[s]
                plen, served = len(r.prompt), list(r.generated)
                n_pos = plen + len(served) - 1
                cache[s] = (torch.stack([c["k"][s, :n_pos] for c in layers]),
                            torch.stack([c["v"][s, :n_pos] for c in layers]))
                for p in range(plen):
                    rows.append(Row(slot=s, pos=p, tok=int(r.prompt[p]),
                                    kind=0, m=p, call=("p", r.rid), ctx=p,
                                    judge=served[0] if p == plen - 1
                                    else -1))
                for j in range(1, len(served)):
                    rows.append(Row(slot=s, pos=plen + j - 1,
                                    tok=served[j - 1], kind=1, m=s,
                                    call=("d", self.log.decode0[r.rid] + j
                                          - 1),
                                    ctx=plen + j - 1, judge=served[j]))
            return rows, cache
        for n, snap in enumerate(self.log.snapshots):
            tick = snap["tick"]
            here = {self.log.slot[rid]: rid for rid, d0 in
                    self.log.decode0.items()
                    if d0 <= tick <= d0 + len(by_rid[rid].generated) - 2}
            if sorted(here) != list(range(tr["capacity"])):
                raise RuntimeError(f"decode step {tick}: slots "
                                   f"{sorted(here)}, not all")
            for s, rid in sorted(here.items()):
                r = by_rid[rid]
                plen, served = len(r.prompt), list(r.generated)
                j = tick - self.log.decode0[rid] + 1
                key = (n, s)
                cache[key] = (torch.stack([k[s] for k in snap["k"]]),
                              torch.stack([v[s] for v in snap["v"]]))
                rows.append(Row(slot=key, pos=plen + j - 1,
                                tok=served[j - 1], kind=1, m=s,
                                call=("d", tick), ctx=plen + j - 1,
                                judge=served[j]))
                if j != 1:
                    continue
                # admitted in this step: its prefill call, pads included
                for p in range(tr["prompt_pad"]):
                    real = p < plen
                    rows.append(Row(slot=key, pos=p,
                                    tok=int(r.prompt[p]) if real else 0,
                                    kind=0, m=p, call=("p", rid), ctx=p,
                                    judge=served[0] if p == plen - 1
                                    else -1, kv=real, own_ctx=not real))
            snap["k"] = snap["v"] = None
        return rows, cache

    def free_engine(self) -> None:
        """Drop the engine's state; keep the weights and the telemetry
        the result needs."""
        eng = self.engine
        eng._state = None
        eng._tok = None
        eng._prefill = eng._decode = eng._insert = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def recompute(run: Run, rows: list, cache: dict, rnd=None):
    """The reference's (or with ``rnd``, the control's) logits of the
    judged rows and the rows' own keys and values, with the rows."""
    cfg, tr = run.cell.config, run.cell.traffic
    op, td = cfg["operating_point"], cfg["td"]
    macro = ref_td.TDMacro(td["bits_a"], td["bits_w"], td["n_chain"],
                           op["sigma_chain"], op["tdc_q"],
                           ref_td.derive_seed(0, 0), run.device)
    rs = ref_model.Rows(rows, cache, tr["prompt_pad"], tr["capacity"],
                        run.device)
    logits, kv = ref_model.Model(run.mc, run.params, macro, rnd=rnd).run(rs)
    return logits, kv, rs


def kv_mismatch(kv: list, rs) -> float:
    """The share of (row, layer) pairs whose recomputed keys or values
    differ from what the engine's cache holds for that row."""
    idx = rs.kv_rows.tolist()
    bad = total = 0
    groups: dict = {}
    for n, i in enumerate(idx):
        groups.setdefault(rs.rows[i].slot, ([], []))
        groups[rs.rows[i].slot][0].append(n)
        groups[rs.rows[i].slot][1].append(rs.rows[i].pos)
    dev = rs.device
    groups = {key: (torch.tensor(a, device=dev), torch.tensor(b, device=dev))
              for key, (a, b) in groups.items()}
    for li, (k, v) in enumerate(kv):
        pk = torch.empty_like(k)
        pv = torch.empty_like(v)
        for key, (at, pos) in groups.items():
            pk[at] = rs.cache[key][0][li][pos]
            pv[at] = rs.cache[key][1][li][pos]
        diff = (k != pk).flatten(1).any(1) | (v != pv).flatten(1).any(1)
        bad += int(diff.sum())
        total += diff.numel()
    return bad / max(1, total)


def readings(g: torch.Tensor, kvm: float) -> dict:
    """Every number the check can compare, from the judged tokens' gaps
    and the cache's mismatch share; a cell's ``limits`` name the ones it
    compares."""
    return {"median_logit_gap": float(g.median()),
            "mean_logit_gap": float(g.mean()),
            "widest_logit_gap": float(g.max()),
            "off_best_share": float((g > 0).to(torch.float32).mean()),
            "kv_mismatch": kvm}


def check(run: Run, rows: list, cache: dict,
          control: bool = False) -> tuple[dict, dict]:
    """The numbers compared ({name: (value, limit)}) and what else the
    check read.  With ``control`` the control's readings are compared in
    the program's place (the program's own go to ``program_*``), so that
    a sound control comes out not correct."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        logits, kv, rs = recompute(run, rows, cache)
        toks = torch.tensor([rs.rows[i].judge for i in rs.judged],
                            device=logits.device)
        g = judge_mod.gaps(logits, toks)
        kvm = kv_mismatch(kv, rs)
        del kv
        read = readings(g, kvm)
        extra = {"judged_tokens": int(g.numel()), "rows": len(rows)}
        if control:
            # the control in the program's place: the reference at float8,
            # its first choices judged as the program's tokens are
            clog, ckv, _ = recompute(run, rows, cache, rnd=judge_mod.fp8)
            cg = judge_mod.gaps(logits, clog.to(torch.float32).argmax(-1))
            extra.update({"program_" + k: v for k, v in read.items()})
            read = readings(cg, kv_mismatch(ckv, rs))
        out = {k: (read[k], lim) for k, lim in
               run.cell.spec["limits"].items()}
        extra.update({k: v for k, v in read.items() if k not in out})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return out, extra


# ---------------------------------------------------------------------------
# the metrics' readers
# ---------------------------------------------------------------------------
def read_metric(root: str, name: str, ctx: dict):
    return _load(root, "metrics", name).read(ctx)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, control: bool = False, hook=None) -> tuple[dict, list]:
    """One run: the result object and the lines to print last on
    standard error.  ``hook(run)``, when given, runs after set-up (tests
    break the engine's timed path there)."""
    run = Run(cell, seed, seconds, trace, device, t0)
    run.setup()
    if hook is not None:
        hook(run)
    run.window()
    e2e = run.end_to_end()
    attempted, failed = run.attempted_failed()
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if cuda else 0)}
    metrics: dict = {}
    breakdown = None
    if trace:
        ctx = run.metric_context()
        for m in cell.per_layer:
            v = read_metric(cell.root, m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if "trace" in ctx:
            dev["busy_s"] = ctx["trace"]["busy_s"]
            dev["window_s"] = ctx["trace"]["window_s"]
            breakdown = {"device_ops": ctx["trace"]["device_ops"],
                         "idle_gaps": ctx["trace"]["idle_gaps"]}
    else:
        for m in cell.end_to_end:
            v = e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    found = _isolation()
    if found:
        raise SystemExit("modules of the JAX package or JAX are loaded: "
                         + ", ".join(found))
    op = run.operating_point()
    rows, cache = run.check_rows()
    run.free_engine()
    checks, extra = check(run, rows, cache, control=control)
    del cache
    checks["operating_point"] = (
        float(sum(a != b for a, b in op.values())), 0.0)
    checks["overlong"] = (float(failed), 0.0)
    correct = all(v <= lim for v, lim in checks.values())
    missing = [m["name"] for m in (cell.per_layer if trace
                                   else cell.end_to_end)
               if m["name"] not in metrics]
    if not trace and missing:
        correct = False
        extra["missing_metrics"] = missing
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["info"] = {"first_tokens_in_window": run.n_first,
                      "token_gaps_in_window": run.n_gaps,
                      "window_s": run.t_close - run.t_open,
                      "decode_steps": run.engine.steps_run, **extra,
                      "operating_point": {k: list(v) for k, v in op.items()}}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    lines = [f"check {k}: {v!r} (limit {lim!r})"
             for k, (v, lim) in checks.items()]
    return result, lines


def main(argv: list[str], t0: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the control (the reference at float8) in "
                         "the program's place, which must come out not "
                         "correct; not part of a measured run")
    args = ap.parse_args(argv)
    cell = load_cell(os.path.dirname(HERE), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA device(s), this machine "
              f"has {torch.cuda.device_count()}: the benchmark measures "
              "the port on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             device, t0, control=bool(args.control))
    found = _isolation()
    if found:
        print("modules of the JAX package or JAX are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    sys.stdout.flush()
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
