"""Serving example on the PyTorch port: batched prefill + greedy decode on
a TD-simulated model, with per-token latency stats and the paper's J/token
energy accounting.

    PYTHONPATH=src python examples/serve_decode_torch.py [--arch qwen3-8b]
        [--device cpu]

The same flags and printed lines as `examples/serve_decode.py`, through
`repro_torch.launch.serve.run` (CUDA by default).  `main` returns the
(batch, gen) greedy tokens.
"""
import argparse

import repro_torch.configs as cfgs
from repro_torch.configs.base import TDExecCfg
from repro_torch.launch.serve import run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    arch = cfgs.get_smoke(args.arch).replace(
        td=TDExecCfg(mode="td", bits_a=4, bits_w=4, n_chain=64,
                     sigma_max=2.0))
    return run(arch, args.batch, args.prompt_len, args.gen,
               device=args.device)


if __name__ == "__main__":
    main()
