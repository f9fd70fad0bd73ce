"""internvl2-26b [vlm]: InternViT frontend + InternLM2 backbone
(arXiv:2404.16821; hf).  Backbone only; the vision frontend is a STUB —
input_specs provide 1024 precomputed patch embeddings (d=3200, InternViT-6B
output width) which an adapter projects to d_model.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 (padded to 92672 for
16-way tensor sharding; the pad ids are never emitted by the pipeline).
"""
from repro_torch.configs.base import ArchConfig, ModelCfg, TrainCfg

N_PATCHES = 1024

CONFIG = ArchConfig(
    model=ModelCfg(
        name="internvl2-26b", n_layers=48, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=16384, vocab=92672, rope_theta=1e6,
        frontend="vision", d_frontend=3200,
    ),
    train=TrainCfg(n_microbatches=16, remat="full"),
    microbatch_by_shape={"train_4k": 16},
)


def smoke() -> ArchConfig:
    return ArchConfig(model=ModelCfg(
        name="internvl2-26b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=128, frontend="vision",
        d_frontend=48))
