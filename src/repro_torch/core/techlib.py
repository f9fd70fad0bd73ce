"""Technology library: the SPICE-derived device tables as a frozen,
corner-aware value (port of `repro/core/techlib.py`).

The classes, the registry and `content_hash` are the reference's own, so a
library hashes to the same digest in both packages.

``TechLib``
    A frozen, hashable bundle of every device table the three domains
    consume (TD unit cells, TDC periphery, the analog charge domain, the
    digital adder tree, leakage and the Fig. 3b delay cells).  Every
    physics entry point takes ``lib=`` (default ``DEFAULT_LIB``, built from
    the exact floats of `core.constants`).  Being hashable, it keys the
    scalar memos (`chain.cell_stats`) and the explorer's caches.

``TechLib.at_corner(corner)``
    Applies a corner's per-table multipliers (duck-typed off
    `core.scenario.Corner`); the identity corner returns ``self``.

``TECHLIBS`` / ``get_techlib``
    Named base libraries for `Scenario.techlib`.
"""
from __future__ import annotations

import dataclasses
import hashlib

from repro_torch.core import constants as C
from repro_torch.core.constants import DelayCellSpec

__all__ = ["DelayCellSpec", "TechLib", "DEFAULT_LIB", "TECHLIBS",
           "get_techlib"]


def _feed_value(h, v) -> None:
    """Canonical byte encoding of a library value for `content_hash`.

    Floats hash by `float.hex()` (exact bits, locale/repr independent),
    dataclasses by *declared field order* (`dataclasses.fields`), never by
    `id()`/`repr()`/builtin `hash()` -- builtin str hashing is salted per
    process (PYTHONHASHSEED), so a frozen dataclass's `hash()` is NOT a
    valid cross-process cache key.  This encoding is: stable across
    processes and hash-seed values, injective on the field tree (every
    value is length-delimited by type tags), and ordered by the dataclass
    definition, so two structurally equal libraries always map to the same
    digest."""
    if isinstance(v, str):
        b = v.encode("utf-8")
        h.update(b"s%d:" % len(b) + b)
    elif isinstance(v, bool):
        h.update(b"b1" if v else b"b0")
    elif isinstance(v, float):
        h.update(b"f" + v.hex().encode("ascii") + b";")
    elif isinstance(v, int):
        h.update(b"i%d;" % v)
    elif isinstance(v, (tuple, list)):
        h.update(b"t%d:" % len(v))
        for x in v:
            _feed_value(h, x)
    elif dataclasses.is_dataclass(v):
        fields = dataclasses.fields(v)
        h.update(b"d%d:" % len(fields))
        for f in fields:
            _feed_value(h, f.name)
            _feed_value(h, getattr(v, f.name))
    else:
        raise TypeError(f"unhashable techlib value {type(v).__name__}")


def _scale_cell(c: DelayCellSpec, energy_mult: float, delay_mult: float,
                sig_mult: float) -> DelayCellSpec:
    return dataclasses.replace(c, energy=c.energy * energy_mult,
                               delay=c.delay * delay_mult,
                               sig_rel=c.sig_rel * sig_mult)


_MULT_FIELDS = ("cell_delay_mult", "cell_energy_mult", "mismatch_mult",
                "cap_mismatch_mult", "digital_energy_mult", "leakage_mult")


@dataclasses.dataclass(frozen=True)
class TechLib:
    """Frozen per-corner device-table bundle (see module docstring).

    Hashable by construction (floats + tuples only): safe as an
    `lru_cache` key and a frozen-dataclass field
    (`tdsim.policy.TDLayerSpec.techlib`).
    """
    name: str
    # Fig. 3b delay-element library (eta_ESNR comparison)
    delay_cells: tuple[DelayCellSpec, ...]
    # TD-MAC unit cells (Fig. 4a / Eq. 6-7)
    e_td_and: float          # J / transition, one TD-AND unit cell
    e_td_nand: float         # J / transition, TD-NAND bypass
    tau_unit: float          # s, one unit-cell delay (= 1 step at R=1)
    sig_u_rel: float         # relative mismatch sigma of one unit cell
    sig_nand_rel: float      # bypass delay sigma in unit-cell delays
    delta_nand_steps: float  # INL contribution per bypassed subcell [steps]
    # TDC periphery (Eq. 8-10)
    e_sample: float          # J, one sampling flipflop event
    e_cnt: float             # J, gray-counter increment incl. clock tree
    e_cnt_load: float        # J, driving one chain's MSB sampling register
    # analog charge domain (Eq. 11-13)
    k1_adc: float            # J / ENOB
    k2_adc: float            # J / 4^ENOB
    c_unit: float            # F, unit MOSCAP
    sig_cap_rel: float       # relative unit-capacitor mismatch
    e_pass_logic: float      # J, pass-transistor AND drive
    f_adc_base: float        # Hz, conversion-rate envelope at low ENOB
    f_adc_decay: float       # envelope decay exponent per ENOB
    adc_area_base: float     # m^2, smallest qualifying ADC
    adc_area_per_enob: float  # area multiplier per extra ENOB
    # digital adder tree (Section IV)
    e_fa_bit: float          # J, full-adder bit incl. local wiring
    e_seq_mac: float         # J, clock/register overhead per MAC
    e_wire_per_log2n: float  # J, global routing growth per tree level
    e_and_gate_bit: float    # J, AND gating stage per weight bit
    alpha_sw_digital: float  # switching activity at the paper's input stats
    f_dig: float             # Hz, single-cycle VMM synthesis target
    a_fa_bit: float          # m^2, full-adder bit after P&R
    a_seq_mac: float         # m^2, sequential/clock area per MAC
    # shared
    leakage_fraction: float  # static energy adder on all dynamic energies

    def content_hash(self) -> str:
        """Deterministic cross-process digest of every table value.

        This is the cache-key component the persistent explorer service
        (`core.explorer`) uses to key compiled/on-disk sweeps on the
        library *content*: stable field ordering (dataclass declaration
        order), exact float bits (`float.hex`), no `id()`/`repr()`/builtin
        `hash()` anywhere -- two processes (or two hash-seed values) always
        agree, and any table change changes the digest."""
        h = hashlib.sha256(b"techlib-v1:")
        _feed_value(h, self)
        return h.hexdigest()

    def cell(self, name: str) -> DelayCellSpec:
        for c in self.delay_cells:
            if c.name == name:
                return c
        raise KeyError(f"unknown delay cell {name!r} "
                       f"(have {[c.name for c in self.delay_cells]})")

    def at_corner(self, corner) -> "TechLib":
        """Library at a process corner: per-table multipliers applied.

        `corner` is duck-typed (any object carrying the ``*_mult``
        attributes; missing attributes default to 1.0) so
        `core.scenario.Corner` can use this without an import cycle.  The
        identity corner returns ``self`` -- TT sweeps stay bit-identical to
        the default library.
        """
        mult = {f: float(getattr(corner, f, 1.0)) for f in _MULT_FIELDS}
        if all(v == 1.0 for v in mult.values()):
            return self
        md, me = mult["cell_delay_mult"], mult["cell_energy_mult"]
        ms = mult["mismatch_mult"]
        name = getattr(corner, "name", "corner")
        return dataclasses.replace(
            self,
            name=f"{self.name}-{name}",
            delay_cells=tuple(_scale_cell(c, me, md, ms)
                              for c in self.delay_cells),
            e_td_and=self.e_td_and * me,
            e_td_nand=self.e_td_nand * me,
            tau_unit=self.tau_unit * md,
            sig_u_rel=self.sig_u_rel * ms,
            sig_nand_rel=self.sig_nand_rel * ms,
            delta_nand_steps=self.delta_nand_steps * ms,
            e_sample=self.e_sample * me,
            e_cnt=self.e_cnt * me,
            e_cnt_load=self.e_cnt_load * me,
            sig_cap_rel=self.sig_cap_rel * mult["cap_mismatch_mult"],
            e_fa_bit=self.e_fa_bit * mult["digital_energy_mult"],
            e_seq_mac=self.e_seq_mac * mult["digital_energy_mult"],
            e_wire_per_log2n=(self.e_wire_per_log2n
                              * mult["digital_energy_mult"]),
            e_and_gate_bit=(self.e_and_gate_bit
                            * mult["digital_energy_mult"]),
            leakage_fraction=self.leakage_fraction * mult["leakage_mult"],
        )


def _default_lib() -> TechLib:
    """The paper's synthesized 22FDX TT tables (see core.constants for the
    per-value anchors).  Every field is the exact float from constants, so
    the default-library path is bit-identical to the pre-TechLib engine."""
    return TechLib(
        name="22fdx", delay_cells=tuple(C.DELAY_CELLS.values()),
        e_td_and=C.E_TD_AND, e_td_nand=C.E_TD_NAND, tau_unit=C.TAU_UNIT,
        sig_u_rel=C.SIG_U_REL, sig_nand_rel=C.SIG_NAND_REL,
        delta_nand_steps=C.DELTA_NAND_STEPS,
        e_sample=C.E_SAMPLE, e_cnt=C.E_CNT, e_cnt_load=C.E_CNT_LOAD,
        k1_adc=C.K1_ADC, k2_adc=C.K2_ADC, c_unit=C.C_UNIT,
        sig_cap_rel=C.SIG_CAP_REL, e_pass_logic=C.E_PASS_LOGIC,
        f_adc_base=C.F_ADC_BASE, f_adc_decay=C.F_ADC_DECAY,
        adc_area_base=C.ADC_AREA_BASE,
        adc_area_per_enob=C.ADC_AREA_PER_ENOB,
        e_fa_bit=C.E_FA_BIT, e_seq_mac=C.E_SEQ_MAC,
        e_wire_per_log2n=C.E_WIRE_PER_LOG2N,
        e_and_gate_bit=C.E_AND_GATE_BIT,
        alpha_sw_digital=C.ALPHA_SW_DIGITAL, f_dig=C.F_DIG,
        a_fa_bit=C.A_FA_BIT, a_seq_mac=C.A_SEQ_MAC,
        leakage_fraction=C.LEAKAGE_FRACTION,
    )


DEFAULT_LIB = _default_lib()


class _LP:
    """Multiplier view for the synthesized low-power library flavor."""
    name = "lp"
    cell_delay_mult = 1.25
    cell_energy_mult = 0.80
    mismatch_mult = 0.90
    cap_mismatch_mult = 0.90
    digital_energy_mult = 0.85
    leakage_mult = 0.50


TECHLIBS: dict[str, TechLib] = {
    "22fdx": DEFAULT_LIB,
    # synthesized low-power flavor (HVT-like: slower, lower-energy cells,
    # slightly tighter mismatch, half the leakage) -- a second base library
    # so --techlib is a real axis, not a single point
    "22fdx-lp": dataclasses.replace(DEFAULT_LIB.at_corner(_LP()),
                                    name="22fdx-lp"),
}


def get_techlib(lib) -> TechLib:
    """Resolve a library argument: None -> DEFAULT_LIB, a name -> registry
    lookup, a TechLib -> itself."""
    if lib is None:
        return DEFAULT_LIB
    if isinstance(lib, TechLib):
        return lib
    try:
        return TECHLIBS[lib]
    except KeyError:
        raise ValueError(f"unknown techlib {lib!r} "
                         f"(have {sorted(TECHLIBS)})") from None
