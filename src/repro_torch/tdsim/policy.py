"""Per-layer execution policy of the TD-simulated matmul, as data (port of
the dataclasses of `repro/tdsim/policy.py`).

The solves of that module (`solve_td_policies` and friends) need the
design-space engine of `repro/core`, which is not ported yet (ROADMAP §1,
step 6).  Until it is, `models.common.resolve_policy` reads the reference's
solutions from `SOLVED`, a table keyed by ``(bits_a, bits_w, n_chain,
sigma_max)``; a test pins every row against `repro.tdsim.policy`.
"""
from __future__ import annotations

import dataclasses

import torch

# the port's copy of the `repro.core.constants` values the policy defaults
# name (paper Section III-A / IV)
N_BASELINE = 576        # 3*3*64 ResNet18 conv chain length
M_DEFAULT = 8           # parallel compute chains sharing periphery
VDD_NOM = 0.80          # [V] nominal supply
P_X_ONE = 0.5           # P(activation bit == 1)
W_BIT_SPARSITY = 0.70   # P(weight bit == 0)


@dataclasses.dataclass(frozen=True)
class TDPolicy:
    """Static (hashable) execution policy of one matmul."""
    mode: str = "precise"        # "precise" | "quant" | "td"
    bits_a: int = 4              # activation bits (bit-serial planes)
    bits_w: int = 4              # weight bits (in-cell)
    n_chain: int = N_BASELINE    # hardware chain length (contraction tile)
    redundancy: int = 1          # R
    sigma_chain: float = 0.0     # injected per-chain noise std (LSB units)
    tdc_q: int = 1               # TDC LSB coarsening factor
    m: int = M_DEFAULT           # delay-line parallelism the solve assumed
    tdc_arch: str = "hybrid"     # TDC architecture the solve assumed
    vdd: float = VDD_NOM         # operating supply the (R, q) solve assumed
    p_x_one: float = P_X_ONE     # activation bit density the solve assumed
    w_bit_sparsity: float = W_BIT_SPARSITY  # weight bit sparsity assumed
    sigma_max: float | None = None   # error budget the solve ran at
    techlib: object | None = None    # technology library (None = default)

    def replace(self, **kw) -> "TDPolicy":
        return dataclasses.replace(self, **kw)


PRECISE = TDPolicy(mode="precise")


def quant_policy(bits_a: int = 4, bits_w: int = 4) -> TDPolicy:
    return TDPolicy(mode="quant", bits_a=bits_a, bits_w=bits_w)


# (bits_a, bits_w, n_chain, sigma_max) -> (redundancy, sigma_chain, tdc_q)
# as `repro.tdsim.policy.solve_td_policy` gives them at the default supply,
# input statistics and technology library (vdd 0.8, m 8, hybrid TDC).
# sigma_max None is the exact regime (3 sigma <= 0.5).
SOLVED: dict[tuple, tuple[int, float, int]] = {
    (4, 4, 576, None): (76, 0.16601820290088654, 1),
    (4, 4, 576, 2.0): (1, 1.9179178476333618, 2),
    (4, 4, 64, None): (10, 0.1575535237789154, 1),
    (4, 4, 64, 2.0): (1, 0.6393059492111206, 6),
    (4, 4, 48, None): (7, 0.16557468473911285, 1),
    (4, 4, 48, 2.0): (1, 0.5536551475524902, 6),
    (4, 4, 16, None): (3, 0.1554127037525177, 1),
    (4, 4, 16, 2.0): (1, 0.3196529746055603, 6),
}


def solved_td_policy(bits_a: int = 4, bits_w: int = 4,
                     n_chain: int = N_BASELINE,
                     sigma_max: float | None = None) -> TDPolicy:
    """The reference's `solve_td_policy` result for a key of `SOLVED`."""
    key = (bits_a, bits_w, n_chain,
           None if sigma_max is None else float(sigma_max))
    if key not in SOLVED:
        raise NotImplementedError(
            f"no solved TD policy for (bits_a, bits_w, n_chain, sigma_max)="
            f"{key}: the port reads solutions from tdsim.policy.SOLVED "
            f"until the core/ design-space solve is ported (ROADMAP.md §1, "
            f"step 6)")
    r, sigma, q = SOLVED[key]
    return TDPolicy(mode="td", bits_a=bits_a, bits_w=bits_w,
                    n_chain=n_chain, redundancy=r, sigma_chain=sigma,
                    tdc_q=q, sigma_max=key[3])


@dataclasses.dataclass(frozen=True)
class NetworkPolicy:
    """Heterogeneous per-layer execution policy of a whole network:
    `layers[i]` drives layer i, `top` the shared top-level matmuls
    (lm_head), `attn` per-head attention-engine policies (None = precise
    fused attention)."""
    layers: tuple[TDPolicy, ...]
    top: TDPolicy = PRECISE
    attn: tuple[TDPolicy, ...] | None = None

    def at(self, i: int) -> TDPolicy:
        return self.layers[i]

    def __len__(self) -> int:
        return len(self.layers)

    @property
    def homogeneous(self) -> bool:
        """True when every layer runs the same policy; a policy with a
        tensor-valued field counts as heterogeneous, as in the reference."""
        for p in self.layers:
            for f in dataclasses.fields(p):
                if isinstance(getattr(p, f.name), torch.Tensor):
                    return False
        return all(p == self.layers[0] for p in self.layers)


def pol_at(pol, i: int) -> TDPolicy:
    """Layer-i view of a policy."""
    return pol.at(i) if isinstance(pol, NetworkPolicy) else pol


def pol_top(pol) -> TDPolicy:
    """Policy of the shared top-level matmuls (lm_head)."""
    return pol.top if isinstance(pol, NetworkPolicy) else pol


def pol_attn(pol) -> tuple[TDPolicy, ...] | None:
    """Per-head attention-engine policies (None = precise fused kernels)."""
    return pol.attn if isinstance(pol, NetworkPolicy) else None
