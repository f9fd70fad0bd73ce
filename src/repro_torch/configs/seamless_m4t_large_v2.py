"""seamless-m4t-large-v2 [audio]: enc-dec multimodal (arXiv:2308.11596; hf).

24L d_model=1024 16H (kv=16 -> MHA) d_ff=8192 vocab=256206 (padded to
256256).  Audio frontend is a STUB: input_specs provide precomputed frame
embeddings (d=1024).  24 encoder + 24 decoder layers.

Shape conventions (documented in DESIGN.md): decode shapes put seq_len on
the decoder self-attention cache with the cross-attention memory capped at
8192 frames; prefill_32k puts seq_len on the encoder with a 2048-token
decoder prefill.
"""
from repro_torch.configs.base import ArchConfig, ModelCfg, TrainCfg

CROSS_MEMORY_CAP = 8192
DEC_PREFILL = 2048

CONFIG = ArchConfig(
    model=ModelCfg(
        name="seamless-m4t-large-v2", family="encdec", n_layers=24,
        n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=256256, rope_theta=1e4,
        frontend="audio", d_frontend=1024,
    ),
    train=TrainCfg(n_microbatches=4, remat="full"),
    microbatch_by_shape={"train_4k": 4},
)


def smoke() -> ArchConfig:
    return ArchConfig(model=ModelCfg(
        name="seamless-smoke", family="encdec", n_layers=2, n_enc_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=128,
        frontend="audio", d_frontend=48))
