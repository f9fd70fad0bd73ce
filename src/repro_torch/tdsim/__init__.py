"""TD execution simulator (port of `repro.tdsim`): policies and the
TD-simulated matmul."""
from repro_torch.tdsim.policy import (NetworkPolicy, PRECISE, TDPolicy,
                                      pol_at, pol_attn, pol_top,
                                      quant_policy)

__all__ = ["NetworkPolicy", "PRECISE", "TDPolicy", "pol_at", "pol_attn",
           "pol_top", "quant_policy"]
