"""Hand-written Hopper kernels of the port and their plain PyTorch twins.

Each kernel module (`td_vmm.td_vmm`, `flash_attn.flash_attn`,
`decode_gqa.decode_gqa`, `lsq_quant.lsq_quant`) holds a wrapper that
launches the CUDA kernel for CUDA tensors, the plain PyTorch version of the
same function (which the wrapper runs for CPU tensors, and only for them;
lsq_quant's lives in its `ref.py`), and ``launches``, the count of kernel
launches.  `build` compiles `csrc/*.cu` with nvcc at first
use.
"""
