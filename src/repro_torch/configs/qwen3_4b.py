"""qwen3-4b [dense]: qk_norm + GQA (hf:Qwen/Qwen3-8B family; hf).

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.  head_dim=128 as in
the published Qwen3 configs (q/k/v project 2560 -> 32*128).
"""
from repro_torch.configs.base import ArchConfig, ModelCfg, TrainCfg

CONFIG = ArchConfig(
    model=ModelCfg(
        name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32,
        n_kv_heads=8, d_ff=9728, vocab=151936, qk_norm=True,
        head_dim=128, rope_theta=1e6,
    ),
    train=TrainCfg(n_microbatches=4, remat="full"),
    microbatch_by_shape={"train_4k": 4},
)


def smoke() -> ArchConfig:
    return ArchConfig(model=ModelCfg(
        name="qwen3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=128, qk_norm=True, head_dim=32))
