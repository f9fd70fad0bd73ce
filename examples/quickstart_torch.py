"""Quickstart on the PyTorch port: the paper's three-domain design space,
a solved TD policy, a noisy TD matmul and the batched noise search.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The same steps and printed lines as `examples/quickstart.py`, through
`repro_torch` (CUDA by default):

1. Pick an error budget (exact or relaxed-from-noise-tolerance).
2. Evaluate energy/throughput/area of TD vs analog vs digital for your VMM.
3. Solve the TD execution policy (R, TDC coarsening, injected sigma) and run
   an actual noisy matmul through the TD execution simulator.
4. Close the Fig. 10 -> Fig. 11 loop: measure per-layer noise tolerance
   with ONE batched eval call and solve a heterogeneous per-layer policy.

`main` returns the numbers it prints (the design points, the winner, the
policy, the matmul's relative noise and the per-layer policies).
"""
import argparse

import torch

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.core import design_space as ds
from repro_torch.core.noise_tolerance import find_sigma_max_batched
from repro_torch.tdsim.policy import solve_network_policies, solve_td_policy
from repro_torch.tdsim.td_linear import td_matmul

# --- 1. hardware design point: ResNet18 3x3x64 kernel, 4-bit, relaxed ----
N_CHAIN, BITS, SIGMA_MAX = 576, 4, 2.0
FRAGILITY = (0.08, 0.02, 0.005)
SIGMAS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    out: dict = {"points": {}}

    print(f"== VMM design point: N={N_CHAIN}, B={BITS}, "
          f"sigma_max={SIGMA_MAX} ==")
    for domain in ds.DOMAINS:
        p = ds.evaluate(domain, N_CHAIN, BITS, SIGMA_MAX, device=dev)
        out["points"][domain] = p
        print(f"  {domain:8s}: {p.e_mac*1e15:8.2f} fJ/MAC   "
              f"{p.throughput:.2e} MAC/s   {p.area_per_mac*1e12:8.2f} "
              f"um^2/MAC   (R={p.redundancy})")

    best = ds.best_domain(N_CHAIN, BITS, SIGMA_MAX, device=dev)
    out["winner"] = best.domain
    print(f"  -> winner: {best.domain} "
          f"(paper Fig. 11: TD wins small/medium arrays)")

    # --- 2. solve the TD execution policy and simulate it ----------------
    pol = solve_td_policy(bits_a=4, bits_w=4, n_chain=N_CHAIN,
                          sigma_max=SIGMA_MAX, device=dev)
    out["policy"] = pol
    print(f"\n== solved TD policy: R={pol.redundancy}, TDC q={pol.tdc_q}, "
          f"injected sigma={pol.sigma_chain:.3f} LSB ==")

    key = prng.key(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((4, N_CHAIN), generator=gen, device=dev)
    w = torch.randn((N_CHAIN, 8), generator=gen, device=dev) * 0.05
    s_a = torch.tensor(0.08, device=dev)
    s_w = torch.tensor(0.004, device=dev)
    y_clean = td_matmul(x, w, s_a, s_w, pol.replace(sigma_chain=0.0), key)
    y_noisy = td_matmul(x, w, s_a, s_w, pol, key)
    rel = float((y_noisy - y_clean).abs().mean() / y_clean.abs().mean())
    out["rel"] = rel
    print(f"TD-simulated matmul: mean |noisy-clean|/|clean| = {rel:.4f} "
          f"(bounded by the sigma_max budget)")

    # --- 4. the closed Fig. 10 -> Fig. 11 loop, batched -------------------
    # a toy 3-"layer" network whose layers tolerate noise differently; the
    # whole (layers x sigma x repeats) sweep is ONE batched call
    fragility = torch.tensor(FRAGILITY, device=dev)

    def eval_fn(sigma_vecs, keys):      # "accuracy" under per-layer noise
        return 1.0 - (sigma_vecs * fragility).sum(-1)

    res = find_sigma_max_batched(eval_fn, SIGMAS, key, n_layers=3,
                                 n_repeats=2, device=dev)
    net = solve_network_policies(res.sigma_max, bits_w=BITS, n_chain=N_CHAIN,
                                 device=dev)
    out["sigma_max"], out["net"] = res.sigma_max, net
    print("\n== per-layer sigma_max -> heterogeneous policy (one pass) ==")
    for i, (s, p) in enumerate(zip(res.sigma_max, net.layers)):
        print(f"  layer {i}: sigma_max={s:5.2f} -> R={p.redundancy}, "
              f"q={p.tdc_q}, injected sigma={p.sigma_chain:.3f} LSB")
    print("OK")
    return out


if __name__ == "__main__":
    main()
