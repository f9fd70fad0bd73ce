"""dbrx-132b [moe]: 16 experts top-4, fine-grained
(hf:databricks/dbrx-base; unverified).

40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert vocab=100352.
"""
from repro_torch.configs.base import ArchConfig, ModelCfg, MoECfg, TrainCfg

CONFIG = ArchConfig(
    model=ModelCfg(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=10752, vocab=100352, rope_theta=5e5,
        moe=MoECfg(num_experts=16, top_k=4, d_ff_expert=10752),
    ),
    train=TrainCfg(n_microbatches=16, remat="full"),
    microbatch_by_shape={"train_4k": 16},
)


def smoke() -> ArchConfig:
    return ArchConfig(model=ModelCfg(
        name="dbrx-132b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128,
        moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=128)))
