"""Core: the paper's quantitative three-domain VMM framework (port of
`repro.core`).

Modules
-------
constants     synthesized-but-anchored 22nm FD-SOI calibration tables
techlib       TechLib: frozen per-corner device tables (at_corner)
fp            float32 arithmetic with the same bits on the CPU and the card
cells         delay elements, eta_ESNR (Eq. 1), TD-MAC cell (Fig. 4)
chain         chain error statistics (Eq. 2-6) + redundancy solver
tdc           SAR + hybrid TDC (Eq. 8-10), L_osc optimizer
analog        charge-domain model (Eq. 11-13)
digital       adder-tree reference
design_grid   batched sweep engine: DesignGrid, Pareto, crossovers,
              m/tdc_arch axes + minimize_over_* reductions
design_space  the Figs. 9/11/12 comparison engine (size-1 grid wrappers)
scenario      named scenario / technology-corner sweeps over the grid
explorer      in-process explorer service: sweep cache and point memo
noise_tolerance  Fig. 10 sigma_array_max search, scalar and batched
"""
from repro_torch.core import noise_tolerance

__all__ = ["noise_tolerance"]
