"""End-to-end training driver on the PyTorch port: a ~100M-param
granite-family LM with LSQ-4bit QAT + TD noise injection for a few hundred
steps on synthetic data, with checkpoints and fault-tolerant resume.

    PYTHONPATH=src python examples/train_qat_lm_torch.py [--steps 300]
        [--small] [--device cpu]

The same flags and printed lines as `examples/train_qat_lm.py`, through
`repro_torch.launch.train.run` under `repro_torch.ft.run_with_retries`
(CUDA by default).  --small shrinks to ~2M params, so that the example
finishes in about a minute on a CPU; the default ~100M config is sized
for a card.  A session resumes from the newest intact checkpoint in
--ckpt-dir (saved every `CKPT_EVERY` steps; default under the system's
temporary directory).  `main` returns (params, losses of the session).
"""
import argparse
import os
import tempfile

from repro_torch import ft
from repro_torch.configs.base import (ArchConfig, ModelCfg, ShapeCfg,
                                      TDExecCfg, TrainCfg)
from repro_torch.launch.train import run

CKPT_EVERY = 100


def make_arch(small: bool) -> ArchConfig:
    if small:
        model = ModelCfg(name="granite-2m-qat", n_layers=2, d_model=128,
                         n_heads=4, n_kv_heads=2, d_ff=384, vocab=2048)
    else:
        # ~100M params, llama/granite-style
        model = ModelCfg(name="granite-100m-qat", n_layers=12, d_model=768,
                         n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32768)
    return ArchConfig(
        model=model,
        train=TrainCfg(lr=1e-3, warmup=20, total_steps=400,
                       n_microbatches=1, remat="none"),
        td=TDExecCfg(mode="td", bits_a=4, bits_w=4,
                     n_chain=min(576, model.d_model), sigma_max=2.0),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "qat_lm_ckpt_torch"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    arch = make_arch(args.small)
    shape = ShapeCfg("example", seq_len=128 if args.small else 512,
                     global_batch=8, kind="train")

    print(f"[example] arch={arch.model.name} td={arch.td.mode} "
          f"bits={arch.td.bits_a}x{arch.td.bits_w} "
          f"n_chain={arch.td.n_chain}")

    def session():
        return run(arch, shape, steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=CKPT_EVERY, log_every=20, device=args.device)

    params, losses = ft.run_with_retries(session)
    k = max(1, len(losses) // 10)
    first, last = (sum(losses[:k]) / k), (sum(losses[-k:]) / k)
    print(f"[example] loss {first:.3f} -> {last:.3f} "
          f"({'DECREASED' if last < first else 'no decrease'}) over "
          f"{len(losses)} steps with TD-noise QAT")
    return params, losses


if __name__ == "__main__":
    main()
