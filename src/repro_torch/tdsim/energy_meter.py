"""Per-layer energy/throughput/area accounting for a model under a policy
(port of `repro/tdsim/energy_meter.py`).

Host-side only (reads static shapes): given the ledger of matmul shapes a
model registers (`models.matmul_shapes`) and an execution domain,
evaluates the core design-space model per layer and aggregates -- the
bridge from the language models to the paper's Figs. 9/11/12 axes.  These
are the paper's circuit-model energies, not measurements of the card.
Every pricing call takes ``device=None`` (where the design-space
evaluation runs; None = CUDA).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import design_space
from repro_torch.tdsim.policy import TDPolicy


@dataclasses.dataclass(frozen=True)
class MatmulShape:
    name: str
    k: int            # contraction length
    n_out: int        # output features
    calls_per_token: float = 1.0   # e.g. layer count folded in by caller


@dataclasses.dataclass
class EnergyReport:
    domain: str
    per_layer: dict            # name -> dict(e_mac, macs, energy_j, ...)
    total_macs_per_token: float
    total_energy_per_token: float

    def summary(self) -> str:
        lines = [f"domain={self.domain} "
                 f"macs/token={self.total_macs_per_token:.3e} "
                 f"J/token={self.total_energy_per_token:.3e}"]
        for name, d in self.per_layer.items():
            lines.append(f"  {name}: E/MAC={d['e_mac']:.3e} J "
                         f"macs={d['macs']:.3e} R={d['r']}")
        return "\n".join(lines)


def account(shapes: list[MatmulShape], pol: TDPolicy, domain: str = "td",
            sigma_max: float | None = None,
            m: int | None = None, device=None) -> EnergyReport:
    """Energy per generated/processed token for a list of matmul shapes.

    Each (k, n_out) matmul maps to n_out hardware chains; a chain of length k
    is tiled into segments of pol.n_chain, evaluated at the segment length
    (that is the 'array dimension' axis of the paper's figures).

    The accounting runs at the policy's operating point: `pol.vdd` (e.g. a
    scenario grid-argmin supply), `pol.m`/`pol.tdc_arch` (the periphery the
    solve assumed; `m=` overrides), `pol.techlib` (the corner-resolved
    technology library the (R, q) solve ran against -- so --corner reports
    match the physics the policy actually executes), the input statistics
    the solve assumed (`pol.p_x_one`/`pol.w_bit_sparsity` -- drift-adapted
    policies re-price at the measured activity) and, when `sigma_max` is
    not given, the budget the policy was solved for (`pol.sigma_max`;
    exact regime when the policy carries none).
    """
    if sigma_max is None:
        sigma_max = pol.sigma_max
    s_max = (design_space.sigma_exact() if sigma_max is None else sigma_max)
    m = pol.m if m is None else m
    kw = {"tdc_arch": pol.tdc_arch} if domain == "td" else {}
    kw.update(p_x_one=pol.p_x_one, w_bit_sparsity=pol.w_bit_sparsity)
    per_layer = {}
    tot_macs = 0.0
    tot_e = 0.0
    for sh in shapes:
        # A k-long contraction tiles into floor(k / n_chain) full-length
        # segments plus a k % n_chain tail segment.  The tail runs at its
        # own (shorter, less efficient — Fig. 9 scaling) array length, so
        # full and tail MACs are priced SEPARATELY; pricing everything at
        # e_mac(min(k, n_chain)) overstated efficiency whenever
        # k % n_chain != 0.
        n_full, tail = divmod(sh.k, pol.n_chain)
        segments = []                  # (chain length, MACs per out chain)
        if n_full:
            segments.append((pol.n_chain, n_full * pol.n_chain))
        if tail:
            segments.append((tail, tail))
        calls = sh.n_out * sh.calls_per_token
        macs = sh.k * calls
        # bit-serial activations: one pass per activation bit-plane
        passes = pol.bits_a if domain == "td" else 1
        energy = 0.0
        pts = []
        for n_eval, k_seg in segments:
            pt = design_space.evaluate(domain, n_eval, pol.bits_w, s_max, m,
                                       vdd=pol.vdd, lib=pol.techlib,
                                       device=device, **kw)
            pts.append(pt)
            energy += k_seg * calls * pt.e_mac * passes
        pt0 = pts[0]   # longest segment = the dominant operating point
        per_layer[sh.name] = {"e_mac": energy / (macs * passes),
                              "macs": macs,
                              "energy_j": energy, "r": pt0.redundancy,
                              "throughput": pt0.throughput,
                              "area_per_mac": pt0.area_per_mac}
        tot_macs += macs
        tot_e += energy
    return EnergyReport(domain, per_layer, tot_macs, tot_e)


def compare_domains(shapes: list[MatmulShape], pol: TDPolicy,
                    sigma_max: float | None = None,
                    device=None) -> dict[str, EnergyReport]:
    return {d: account(shapes, pol, d, sigma_max, device=device)
            for d in design_space.DOMAINS}


# ---------------------------------------------------------------------------
# per-request accumulation (serving engine telemetry)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RequestUsage:
    """Token + energy tally for one in-flight request.  ``energy_j`` is
    banked incrementally at the rate in force when each token was
    processed, so a mid-run policy hot-swap re-prices only the FUTURE."""
    prefill_tokens: int = 0
    decode_tokens: int = 0
    energy_j: float = 0.0

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens


class RequestMeter:
    """Per-request TD energy accumulation for the serving engine.

    `account()` prices one processed token for the model/policy; the meter
    banks that rate against each request's own token tally (prompt tokens
    processed at prefill + generated tokens), so the serve loop gets
    J/token PER REQUEST rather than per run.  By construction the sum of
    per-request energies equals `run_total_energy()` (which the serving
    tests pin) -- under a fixed policy that is simply rate * total tokens.

    `set_policy` re-prices the meter for a new operating point: energy
    already banked stays priced at the rate in force when it was spent;
    only tokens processed after the swap run at the new rate.  The
    re-price splits in two: `price(pol)` runs the expensive `account`
    without touching meter state, and `install(report)` adopts the result
    at a step boundary.  ``tokens_at_rate[i]`` tallies the tokens banked
    while ``rate_history[i]`` was in force.  ``device`` is where pricing
    evaluates the design space (None = CUDA).
    """

    def __init__(self, shapes: list[MatmulShape], pol: TDPolicy,
                 domain: str = "td", sigma_max: float | None = None,
                 device=None):
        self.domain = domain
        self.device = device
        self._shapes = list(shapes)
        self._usage: dict = {}
        self.policy_swaps = 0
        self.rate_history: list[float] = []
        self.tokens_at_rate: list[int] = []
        self.set_policy(pol, sigma_max)
        self.policy_swaps = 0       # the initial pricing is not a swap

    def price(self, pol: TDPolicy,
              sigma_max: float | None = None) -> EnergyReport:
        """Pure pricing of `pol` (no meter state touched): the expensive
        half of a re-price, safe to run on a staged-rebuild thread."""
        return account(self._shapes, pol, self.domain, sigma_max,
                       device=self.device)

    def install(self, report: EnergyReport) -> float:
        """Adopt a priced report as the rate in force (the cheap, atomic
        half -- call between decode steps).  Returns the new J/token."""
        self.per_token_report = report
        self.e_token = report.total_energy_per_token
        self.macs_token = report.total_macs_per_token
        self.policy_swaps += 1
        self.rate_history.append(self.e_token)
        self.tokens_at_rate.append(0)
        return self.e_token

    def set_policy(self, pol: TDPolicy,
                   sigma_max: float | None = None) -> float:
        """Re-price future tokens at `pol`'s operating point (drift
        adaptation hot-swap).  Returns the new J/token rate."""
        return self.install(self.price(pol, sigma_max))

    def _u(self, rid) -> RequestUsage:
        return self._usage.setdefault(rid, RequestUsage())

    def _bank(self, u: RequestUsage, n: int) -> None:
        u.energy_j += n * self.e_token
        self.tokens_at_rate[-1] += n

    def on_prefill(self, rid, n_tokens: int) -> None:
        u = self._u(rid)
        u.prefill_tokens += int(n_tokens)
        self._bank(u, int(n_tokens))

    def on_decode(self, rid, n_tokens: int = 1) -> None:
        u = self._u(rid)
        u.decode_tokens += int(n_tokens)
        self._bank(u, int(n_tokens))

    def request_energy(self, rid) -> float:
        """Joules attributed to a request so far (prefill + decode)."""
        return self._u(rid).energy_j

    def request_report(self, rid) -> dict:
        u = self._u(rid)
        e = u.energy_j
        return {"request": rid, "domain": self.domain,
                "prefill_tokens": u.prefill_tokens,
                "decode_tokens": u.decode_tokens,
                "energy_j": e,
                "j_per_token": (e / u.total_tokens if u.total_tokens
                                else 0.0),
                "j_per_decoded_token": (e / u.decode_tokens
                                        if u.decode_tokens else 0.0)}

    def rows(self) -> list[dict]:
        """CSV-ready per-request reports, admission order preserved."""
        return [self.request_report(rid) for rid in self._usage]

    def run_total_tokens(self) -> int:
        return sum(u.total_tokens for u in self._usage.values())

    def run_total_energy(self) -> float:
        return sum(u.energy_j for u in self._usage.values())

    def rate_epochs(self) -> list[dict]:
        """One row per pricing epoch: the J/token rate in force and the
        tokens banked at it (the adaptive energy curve, exact by
        construction: sum(rate*tokens) == run_total_energy())."""
        return [{"epoch": i, "j_per_token": r, "tokens": t,
                 "energy_j": r * t}
                for i, (r, t) in enumerate(zip(self.rate_history,
                                               self.tokens_at_rate))]

    def static_worst_energy(self) -> float:
        """What the whole run WOULD have cost priced end-to-end at the
        most expensive rate ever in force (the no-adaptation margin a
        static deployment must carry)."""
        return max(self.rate_history) * self.run_total_tokens()
