"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is one shared library with a plain C interface,
compiled with nvcc for sm_90a at first use and loaded with ctypes (no
PyTorch headers, so a build takes seconds).  Libraries go to
``<repo>/build/kernels/lib<name>-<hash>.so``; the hash covers the source
and the flags, so an edited source rebuilds.  ``build()`` starts one nvcc
per missing library, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS = ("td_vmm", "flash_attn", "decode_gqa", "lsq_quant")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# no --use_fast_math: logf/cosf/sqrtf and division stay IEEE-accurate,
# which td_vmm's noise and TDC rounding rely on
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with nvcc at first use (set CUDA_HOME)")


def lib_path(name: str) -> Path:
    """Library of kernel ``name``, keyed by its source, the shared headers
    of csrc/ and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every missing library of ``names`` in parallel.  Returns
    {name: ptxas report} for the libraries built now; raises with nvcc's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not lib_path(n).exists()]
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {p.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib_path(n))
        lib_path(n).with_suffix(".log").write_text(out)
        reports[n] = out
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    if name not in _loaded:
        path = lib_path(name)
        if not path.exists():
            build([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]


def stream_ptr(device) -> int:
    """Handle of PyTorch's current CUDA stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel's launcher."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
