"""PyTorch/CUDA port of the `repro` package (time-domain VMM simulation).

Mirrors `repro`'s layout module for module (`repro_torch.quant.lsq` is the
port of `repro.quant.lsq`, and so on).  It imports torch and numpy only:
never jax and never `repro`, so it runs on a GPU host without JAX.  The
hand-written Hopper kernels (td_vmm, flash_attn, decode_gqa, lsq_quant)
live in `csrc/` and are built with nvcc at first use (`kernels/build.py`).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
GPU they raise instead of falling back (`device.resolve`).
"""
