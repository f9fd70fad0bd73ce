"""rwkv6-1.6b [ssm]: Finch — data-dependent decay, attention-free
(arXiv:2404.05892; unverified).

24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, ModelCfg, RWKVCfg, TrainCfg

CONFIG = ArchConfig(
    model=ModelCfg(
        name="rwkv6-1.6b", n_layers=24, d_model=2048, n_heads=32,
        n_kv_heads=32, d_ff=7168, vocab=65536,
        rwkv=RWKVCfg(head_dim=64, decay_lora=64, mix_lora=32),
        layer_pattern=tuple("rwkv6" for _ in range(24)),
        subquadratic=True,
    ),
    train=TrainCfg(n_microbatches=4, remat="full"),
    microbatch_by_shape={"train_4k": 4},
)


def smoke() -> ArchConfig:
    return ArchConfig(model=ModelCfg(
        name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=128,
        rwkv=RWKVCfg(head_dim=16, decay_lora=8, mix_lora=8),
        layer_pattern=("rwkv6", "rwkv6"), subquadratic=True))
