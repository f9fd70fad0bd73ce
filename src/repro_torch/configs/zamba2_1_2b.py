"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks
(arXiv:2411.15242; hf).

38L d_model=2048 32H (kv=32 -> MHA) d_ff=8192 vocab=32000 ssm_state=64.
Shared attention applied at 6 depths (weight-tied block, private per-site
norms); mamba layers are mixer-only (no FFN) as in the published model.
Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, ModelCfg, SSMCfg, TrainCfg

_SHARED_AT = (5, 11, 17, 23, 29, 35)
_PATTERN = tuple("shared_attn" if i in _SHARED_AT else "mamba2"
                 for i in range(38))
_FFN = tuple("swiglu" if i in _SHARED_AT else "none" for i in range(38))

CONFIG = ArchConfig(
    model=ModelCfg(
        name="zamba2-1.2b", n_layers=38, d_model=2048, n_heads=32,
        n_kv_heads=32, d_ff=8192, vocab=32000, rope_theta=1e4,
        ssm=SSMCfg(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
        layer_pattern=_PATTERN, ffn_pattern=_FFN, subquadratic=True,
    ),
    train=TrainCfg(n_microbatches=4, remat="full"),
    microbatch_by_shape={"train_4k": 4},
)


def smoke() -> ArchConfig:
    shared_at = (1,)
    pat = tuple("shared_attn" if i in shared_at else "mamba2"
                for i in range(3))
    ffn = tuple("swiglu" if i in shared_at else "none" for i in range(3))
    return ArchConfig(model=ModelCfg(
        name="zamba2-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab=128,
        ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
        layer_pattern=pat, ffn_pattern=ffn, subquadratic=True))
