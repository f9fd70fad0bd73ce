"""Time this tree's flash_attn kernel against another build of
csrc/flash_attn.cu, in turns on one card.

    python3 scripts/compare_flash_attn.py OTHER_DIR

OTHER_DIR holds another revision's `src/repro_torch/csrc` (flash_attn.cu
and the headers it includes), for example

    mkdir -p build/other && git archive REV src/repro_torch/csrc \\
        | tar -x -C build/other --strip-components 3

It is built with the tree's nvcc flags (`kernels/build.NVCC_FLAGS`) into
OTHER_DIR and called through the same C entry, `flash_attn_launch`.  At
each shape (the LM sweep's f32 attention of granite-8b, granite-moe and
zamba2's shared block at batches 8, 24 and 104, Sq 32, causal; the bf16
tensor-core route at serve prefill, the train microbatch and train_4k)
both builds are checked against the plain version, then timed in turns
(this tree, the other, this tree, the other): device time behind a spin,
each launch between its own event pair, the median of each build's
launches (`chip_smoke.device_ms`).  Needs one CUDA card and nvcc.
"""
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

F32_MODELS = [("granite-8b", 32, 8, 128), ("granite-moe", 16, 8, 64),
              ("zamba2", 32, 32, 64)]
F32_BATCHES = (8, 24, 104)
SEQ = 32
# (label, B, Sq, S_cache, kv_len) at Hq 32, Hkv 8, D 128, bf16, causal
BF16_SHAPES = [("serve prefill", 4, 128, 144, 128),
               ("train microbatch", 1, 128, 128, 128),
               ("train_4k microbatch", 1, 4096, 4096, 4096)]


def _other(other_dir: Path):
    """The other build's `flash_attn_launch`, compiled into other_dir."""
    from repro_torch.kernels import build
    so = other_dir / "libflash_attn_other.so"
    out = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                          str(other_dir / "flash_attn.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc of the other build failed:\n{out.stdout}"
                         f"{out.stderr}")
    fn = ctypes.CDLL(str(so)).flash_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__)
        return 2
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.attn_common import DTYPE_FLAG
    from repro_torch.kernels.flash_attn import flash_attn as fa
    if not torch.cuda.is_available():
        print("compare_flash_attn: no CUDA card", file=sys.stderr)
        return 1
    print(cs.gpu_line())
    build.build(["flash_attn"])
    other = _other(Path(args[0]).resolve())

    def other_call(q, k, v, lens, off, causal=True):
        b, sq, hq, d = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        split = (fa.flash_plan(b, sq, hq, hkv, skv)
                 if fa.tensor_core_route(q, k) else 1)
        o = torch.empty_like(q)
        rc = other(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   lens.data_ptr(), off.data_ptr(), o.data_ptr(), b, sq, skv,
                   hq, hkv, d, int(causal), d ** -0.5, DTYPE_FLAG[q.dtype],
                   DTYPE_FLAG[k.dtype], split,
                   torch.cuda.current_stream().cuda_stream)
        build.check(rc, "flash_attn (other build)")
        return o

    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(f"f32 {m} B {b}", b, SEQ, SEQ, hq, hkv, d, SEQ, torch.float32)
              for m, hq, hkv, d in F32_MODELS for b in F32_BATCHES]
    shapes += [(f"bf16 {label}", b, sq, skv, 32, 8, 128, n, torch.bfloat16)
               for label, b, sq, skv, n in BF16_SHAPES]
    for label, b, sq, skv, hq, hkv, d, n, dt in shapes:
        q = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((b, skv, hkv, d), generator=gen, device="cuda")
                .to(dt) for _ in range(2))
        call = (q, k, v, cs._i32([n] * b), cs._i32([0]))
        want = fa.flash_attn_plain(*call).float()
        errs = [float((f(*call).float() - want).abs().max())
                for f in (fa.flash_attn, other_call)]
        times = {"tree": [], "other": []}
        for name in ("tree", "other", "tree", "other"):
            f = fa.flash_attn if name == "tree" else other_call
            times[name] += cs.device_ms(lambda: f(*call), 20)[0]
        t, o = (statistics.median(times[n]) for n in ("tree", "other"))
        b_ms, b_by = cs.flash_bound(b, sq, [n] * b, hq, hkv, d, True,
                                    elem=q.element_size(),
                                    op_type="f32" if dt == torch.float32
                                    else "bf16")
        print(f"[compare_flash_attn] {label}: B={b} Sq={sq} S_cache={skv} "
              f"Hq={hq} Hkv={hkv} D={d} causal: this tree {t:.5f} ms, the "
              f"other {o:.5f} ms (other / tree {o / t:.2f}x); bound "
              f"{b_ms:.5f} ms ({b_by}): {b_ms / t:.1%} / {b_ms / o:.1%}; max "
              f"|kernel - plain| {errs[0]:.3g} / {errs[1]:.3g}", flush=True)
        del q, k, v, call, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
