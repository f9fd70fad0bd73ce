"""qwen2.5-3b [dense]: GQA with QKV bias (hf:Qwen/Qwen2.5; hf).

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, ModelCfg, TrainCfg

CONFIG = ArchConfig(
    model=ModelCfg(
        name="qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16,
        n_kv_heads=2, d_ff=11008, vocab=151936, qkv_bias=True,
        rope_theta=1e6,
    ),
    train=TrainCfg(n_microbatches=4, remat="full"),
    microbatch_by_shape={"train_4k": 4},
)


def smoke() -> ArchConfig:
    return ArchConfig(model=ModelCfg(
        name="qwen2.5-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=128, qkv_bias=True))
