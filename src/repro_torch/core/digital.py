"""Digital adder-tree VMM reference model (port of `repro/core/digital.py`,
paper Section IV).

A 1xB AND-stage feeding a binary adder tree with N leaves, synthesized at
1 GHz; level k of the tree has N/2^k adders of width ~ B + k.  Digital
computation is exact: no R, no SNR dependence.

Python scalars keep the reference's float math; float32 tensors broadcast
elementwise (closed-form partial sums replace the per-point tree-depth
loop).  Synthesis energies and areas come from a `core.techlib.TechLib`
(``lib=``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import constants as C
from repro_torch.core import fp
from repro_torch.core.cells import f32
from repro_torch.core.techlib import DEFAULT_LIB, TechLib


def _is_scalar(*xs) -> bool:
    return all(isinstance(x, (int, float)) for x in xs)


def _adder_bits_per_mac(n, bits: int):
    """sum_{k=1..d} (B + k) / 2^k with d = ceil(log2 N), exact partial sum:
    B (1 - 2^-d) + 2 - (d + 2) 2^-d."""
    if _is_scalar(n):
        depth = max(1, int(math.ceil(math.log2(max(2.0, n)))))
        total = 0.0
        for k in range(1, depth + 1):
            total += (bits + k) / 2.0 ** k
        return total
    nf = torch.clamp(f32(n), min=2.0)
    depth = torch.clamp(torch.ceil(fp.log2(nf)), min=1.0)
    inv = fp.pow(2.0, -depth)
    return bits * (1.0 - inv) + 2.0 - (depth + 2.0) * inv


def digital_energy_per_mac(n, bits: int, vdd=C.VDD_NOM, p_x_one=C.P_X_ONE,
                           w_bit_sparsity=C.W_BIT_SPARSITY,
                           lib: TechLib = DEFAULT_LIB):
    """Per-MAC energy of the single-cycle N-long 1xB VMM array; the
    switching activity rescales with the active-bit probability p_x_one *
    (1 - w_bit_sparsity) against the paper's statistics."""
    act = p_x_one * (1.0 - w_bit_sparsity)
    act_base = C.P_X_ONE * (1.0 - C.W_BIT_SPARSITY)
    alpha_sw = lib.alpha_sw_digital * act / act_base
    scale = (vdd / C.VDD_NOM) ** 2
    e_adder = _adder_bits_per_mac(n, bits) * lib.e_fa_bit * alpha_sw
    e_and = bits * lib.e_and_gate_bit * alpha_sw          # AND gating stage
    if _is_scalar(n):
        log2n = math.log2(max(2.0, n))
    else:
        log2n = fp.log2(torch.clamp(f32(n), min=2.0))
    e_wire = log2n * lib.e_wire_per_log2n
    e = (e_adder + e_and + e_wire) * scale + lib.e_seq_mac * scale
    return e * (1.0 + lib.leakage_fraction)


def digital_throughput(n, bits: int, m=C.M_DEFAULT,
                       lib: TechLib = DEFAULT_LIB):
    """Single-cycle array at f_dig: N*M MACs retire per cycle."""
    return n * m * lib.f_dig


def digital_area(n, bits: int, lib: TechLib = DEFAULT_LIB):
    """Per-MAC area after P&R: AND stage + amortized adder tree + seq."""
    a_adder = _adder_bits_per_mac(n, bits) * lib.a_fa_bit
    a_and = bits * 0.30e-12
    return a_adder + a_and + lib.a_seq_mac
