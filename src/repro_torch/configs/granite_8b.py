"""granite-8b [dense]: llama-arch code model (arXiv:2405.04324; hf).

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.configs.base import ArchConfig, ModelCfg, TrainCfg

CONFIG = ArchConfig(
    model=ModelCfg(
        name="granite-8b", n_layers=36, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=49152, rope_theta=1e6,
    ),
    train=TrainCfg(n_microbatches=8, remat="full"),
    microbatch_by_shape={"train_4k": 8},
)


def smoke() -> ArchConfig:
    return ArchConfig(model=ModelCfg(
        name="granite-8b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=128))
