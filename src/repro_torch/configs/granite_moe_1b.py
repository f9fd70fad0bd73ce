"""granite-moe-1b-a400m [moe]: 32 experts top-8, fine-grained
(hf:ibm-granite/granite-3.0-1b-a400m-base; hf).

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155 (padded 49408).
"""
from repro_torch.configs.base import ArchConfig, ModelCfg, MoECfg, TrainCfg

CONFIG = ArchConfig(
    model=ModelCfg(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, d_ff=512, vocab=49408, rope_theta=1e4,
        moe=MoECfg(num_experts=32, top_k=8, d_ff_expert=512),
    ),
    train=TrainCfg(n_microbatches=2, remat="dots"),
    microbatch_by_shape={"train_4k": 2},
)


def smoke() -> ArchConfig:
    return ArchConfig(model=ModelCfg(
        name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=128,
        moe=MoECfg(num_experts=8, top_k=2, d_ff_expert=64)))
