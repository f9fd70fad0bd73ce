"""The port stands alone: no module of `repro_torch`, not
`chip_smoke.py`, no port-side example (`examples/*_torch.py`) and no
port-side script (`scripts/compare_flash_attn.py`) imports jax or the
reference package `repro`, and the port's entry points and
examples run on CUDA by default, raising (not falling back to the CPU)
where there is none."""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import ast
import dataclasses
import importlib.util
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES \
    + [ROOT / "scripts" / "compare_flash_attn.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = _imported_roots(path) & set(BANNED)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_with_jax_and_reference_poisoned():
    """Import every module of the port (and chip_smoke) in a fresh
    interpreter where importing jax or repro fails."""
    code = f"""
import importlib, pkgutil, runpy, sys
for name in {BANNED!r}:
    sys.modules[name] = None
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
runpy.run_path({str(ROOT / "chip_smoke.py")!r}, run_name="chip_smoke")
for path in {[str(p) for p in EXAMPLES]!r}:
    runpy.run_path(path, run_name="example")
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in {BANNED!r} and sys.modules[n] is not None)
assert not leaked, leaked
print(len(mods))
"""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    import repro_torch.configs as cfgs
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import serve, train
    from repro_torch.models import get_api, transformer
    from repro_torch.tdsim.policy import quant_policy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = cfgs.get_smoke("qwen3-8b")
    cfg = arch.model
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(arch, 1, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--batch", "1", "--prompt-len", "2",
                    "--gen", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(arch, ShapeCfg("t", 4, 2, "train"), 1, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1", "--seq", "4", "--batch", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        get_api(cfg)["init"](0, cfg, quant_policy())
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_caches(1, 4, cfg)
    # an explicit CPU device runs
    caches = transformer.init_caches(1, 4, cfg, device="cpu")
    assert caches[0]["k"].device.type == "cpu"
    # the stacked caches of a scan config, under its policy
    scan = dataclasses.replace(cfg, scan_layers=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_caches(1, 4, scan, pol=quant_policy())
    caches = transformer.init_caches(1, 4, scan, device="cpu",
                                     pol=quant_policy())
    assert caches["k"].device.type == "cpu"
    assert caches["k"].shape[0] == cfg.n_layers


def _example(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"ex_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# each example's smallest run (its device left to the default)
EXAMPLE_ARGS = {
    "quickstart_torch": [],
    "serve_decode_torch": ["--batch", "1", "--prompt-len", "2", "--gen", "2"],
    "train_qat_lm_torch": ["--small", "--steps", "1"],
    "hw_design_explorer_torch": ["--grid", "n=16", "bits=4", "sigma=2.0",
                                 "--format", "json"],
}


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_examples_default_to_cuda_and_raise_without_it(path, monkeypatch,
                                                       tmp_path):
    from repro_torch.core import explorer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = explorer.set_service(None)
    args = EXAMPLE_ARGS[path.stem]
    if path.stem == "train_qat_lm_torch":
        args = args + ["--ckpt-dir", str(tmp_path)]
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            _example(path).main(args)
    finally:
        explorer.set_service(prev)


def test_kernel_wrappers_use_plain_version_only_for_cpu_tensors():
    """A tensor on neither the CPU nor CUDA is refused, never computed by
    the plain version; CPU tensors do not count as kernel launches."""
    from repro_torch.kernels.decode_gqa import decode_gqa as dec
    from repro_torch.kernels.lsq_quant import lsq_quant as lq
    from repro_torch.kernels.td_vmm import td_vmm as tv
    x = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    w = torch.zeros((8, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tv.td_vmm(x, w, torch.zeros(2, device="meta"),
                  torch.zeros(1, dtype=torch.int64, device="meta"),
                  bits_a=4, bits_w=4, n_chain=8)
    n = dec.launches
    q = torch.zeros((1, 4, 8))
    kv = torch.zeros((1, 5, 2, 8))
    dec.decode_gqa(q, kv, kv, torch.tensor([3], dtype=torch.int32))
    assert dec.launches == n
    with pytest.raises(ValueError, match="cuda or cpu"):
        lq.lsq_quant(torch.zeros(8, device="meta"),
                     torch.zeros((), device="meta"), -8, 7)
    n = lq.launches
    lq.lsq_quant(torch.zeros(8), torch.tensor(0.5), -8, 7)
    assert lq.launches == n
