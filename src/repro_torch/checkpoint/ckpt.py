"""Checkpointing: atomic, async, integrity-checked (port of
`repro/checkpoint/ckpt.py`).

Format: one directory per step holding
  manifest.json   {step, names, shapes, dtypes, digests, meta}
  arrays.npz      a0, a1, ... : the leaves as host numpy arrays

The reference writes its manifest as msgpack (`ckpt.py:36,130,176`); the
port writes the same fields as JSON, so it needs no package beyond numpy.
Leaf names are the reference's (`_flatten`, `ckpt.py:45-49`): dict keys
(sorted) and sequence indices joined by "/", a dataclass (the optimizer's
`OptState`) by its field indices, as a pytree node without keys is in
JAX.  The digest is sha256 of the array's bytes, as there; a bfloat16
leaf is stored as its uint16 view and recorded as "bfloat16", so its
bytes and digest are those of the reference's bfloat16 array.

  * atomic publish: write into <dir>.tmp, then rename; a reader never sees
    a partial checkpoint, and `latest_steps` skips ``.tmp`` litter.
  * async save: the leaves are copied to the host (device tensors by a
    device-to-host copy, host tensors by a clone, since AdamW updates the
    parameters in place) before the writer thread starts; digests and the
    disk write run on the thread.  The returned `SaveHandle` captures a
    failure: `wait()` re-raises it, and so does the next `save()` into
    the same directory.
  * integrity: `restore()` verifies every digest and, when no step is
    named, falls back to the newest intact step; a named step never falls
    back.
  * retention: keep the newest ``keep_last`` steps.

`restore(..., device=)` puts the leaves on a device (the reference's
``shardings=``); None leaves them on the host.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
_HASH_THREADS = min(8, os.cpu_count() or 1)


class CorruptCheckpoint(RuntimeError):
    """A checkpoint step failed integrity verification (bad digest,
    unreadable archive, missing manifest, missing arrays)."""


def _children(node):
    """[(key, child)] of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(i, getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    return None


def _flatten(tree, prefix: str = "") -> tuple[list[str], list]:
    kids = _children(tree)
    if kids is None:
        return [prefix[:-1]], [tree]
    names, leaves = [], []
    for k, v in kids:
        n, lv = _flatten(v, f"{prefix}{k}/")
        names += n
        leaves += lv
    return names, leaves


def _rebuild(like, leaf_of, prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``leaf_of(name)``."""
    kids = _children(like)
    if kids is None:
        return leaf_of(prefix[:-1])
    new = {k: _rebuild(v, leaf_of, f"{prefix}{k}/") for k, v in kids}
    if isinstance(like, dict):
        return {k: new[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(new[i] for i in range(len(like)))
    return dataclasses.replace(like, **{
        f.name: new[i] for i, f in enumerate(dataclasses.fields(like))})


def _to_host(v) -> tuple[np.ndarray, str]:
    """(a host array that nothing else writes, its dtype name)."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    a = np.array(v, copy=True)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    # ascontiguousarray makes a 0-d array 1-d: keep the saved shape
    a = np.ascontiguousarray(a).reshape(a.shape)
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a).reshape(-1).view(np.uint8)).hexdigest()


def _digests(arrays) -> list[str]:
    """sha256 of each array, on a few threads (hashlib releases the
    interpreter lock on large buffers)."""
    with concurrent.futures.ThreadPoolExecutor(_HASH_THREADS) as ex:
        return list(ex.map(_digest, arrays))


class SaveHandle:
    """Join handle of one async save.  The writer thread never raises
    into the void: its exception is captured here and re-raised by
    `wait()` (and by the next `save()` into the same directory, so a train
    loop that never waits still finds out on the following interval).
    ``copy_s`` is the seconds `save` spent copying the tree to the host,
    ``write_s`` the writer thread's (digests and disk), once done."""

    def __init__(self, step: int):
        self.step = int(step)
        self.error: BaseException | None = None
        self.copy_s = 0.0
        self.write_s: float | None = None
        self._thread: threading.Thread | None = None

    def _run(self, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except BaseException as e:      # noqa: BLE001 -- captured, re-raised
            self.error = e
        finally:
            self.write_s = time.perf_counter() - t0

    def start(self, fn) -> "SaveHandle":
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        daemon=True)
        self._thread.start()
        return self

    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def wait(self, timeout: float | None = None) -> None:
        """Block until the write finishes; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join(timeout)
        if self.error is not None:
            err, self.error = self.error, None   # observed exactly once
            raise RuntimeError(
                f"async checkpoint save of step {self.step} failed"
            ) from err

    def join(self, timeout: float | None = None) -> None:
        self.wait(timeout)


# last unobserved handle per checkpoint dir: lets the next save() surface
# a background failure whose wait() nobody called
_last_handle: dict[str, SaveHandle] = {}
_last_handle_lock = threading.Lock()


def save(ckpt_dir: str, step: int, tree, meta: dict | None = None,
         keep_last: int = 3, async_write: bool = True) -> SaveHandle | None:
    """Save ``tree`` (nested dicts, lists, tuples and dataclasses of
    tensors or arrays) at ``step``."""
    key = os.path.abspath(ckpt_dir)
    with _last_handle_lock:
        prev = _last_handle.pop(key, None)
    if prev is not None and prev.done() and prev.error is not None:
        prev.wait()     # re-raises: a dropped checkpoint is not survivable
    elif prev is not None and not prev.done():
        with _last_handle_lock:     # still writing: keep tracking it
            _last_handle[key] = prev

    t0 = time.perf_counter()
    names, vals = _flatten(tree)
    host = [_to_host(v) for v in vals]
    arrays = [a for a, _ in host]
    copy_s = time.perf_counter() - t0

    def _write():
        manifest = {
            "step": int(step),
            "names": names,
            "shapes": [list(a.shape) for a in arrays],
            "dtypes": [d for _, d in host],
            "digests": _digests(arrays),
            "meta": meta or {},
        }
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        np.savez(os.path.join(tmp, ARRAYS),
                 **{f"a{i}": a for i, a in enumerate(arrays)})
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _retain(ckpt_dir, keep_last)

    if async_write:
        handle = SaveHandle(step)
        handle.copy_s = copy_s
        handle.start(_write)
        with _last_handle_lock:
            _last_handle[key] = handle
        return handle
    _write()
    return None


def _retain(ckpt_dir: str, keep_last: int):
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return sorted(out)


def _load_verified(ckpt_dir: str, step: int) -> tuple[dict, list[np.ndarray]]:
    """Read and integrity-check one step; any failure (missing manifest,
    unreadable or truncated archive, digest mismatch) is a
    CorruptCheckpoint."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, ARRAYS)) as data:
            arrays = [data[f"a{i}"] for i in range(len(manifest["names"]))]
    except Exception as e:   # noqa: BLE001 -- any read failure is corruption
        raise CorruptCheckpoint(f"step {step} unreadable: {e!r}") from e
    digests = manifest.get("digests")
    if digests is not None:
        bad = [manifest["names"][i] for i, (got, want)
               in enumerate(zip(_digests(arrays), digests)) if got != want]
        if bad:
            raise CorruptCheckpoint(
                f"step {step} digest mismatch: {bad[:5]}")
    return manifest, arrays


def verify(ckpt_dir: str, step: int) -> None:
    """Integrity-check one step (raises CorruptCheckpoint)."""
    _load_verified(ckpt_dir, step)


def restore(ckpt_dir: str, like_tree, step: int | None = None,
            device=None) -> tuple[int, object, dict]:
    """Restore into the structure of ``like_tree``: (step, tree, meta).

    With ``step=None`` the steps are tried newest first and the first one
    that passes verification wins: a corrupt or partly written newest
    checkpoint falls back to the last intact step.  A named step never
    falls back: a corrupt one raises CorruptCheckpoint.  The leaves come
    back as tensors of their saved dtypes on ``device`` (None: the host).
    """
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    candidates = [step] if step is not None else list(reversed(steps))
    manifest = arrays = None
    reasons: list[str] = []
    for cand in candidates:
        try:
            manifest, arrays = _load_verified(ckpt_dir, cand)
            step = cand
            break
        except CorruptCheckpoint as e:
            if len(candidates) == 1:
                raise
            reasons.append(str(e))
    if manifest is None:
        raise CorruptCheckpoint(
            f"no intact checkpoint in {ckpt_dir}: {reasons}")

    names, _ = _flatten(like_tree)
    index = {n: i for i, n in enumerate(manifest["names"])}
    missing = [n for n in names if n not in index]
    if missing:
        raise ValueError(f"checkpoint missing keys: {missing[:5]}...")
    tree = _rebuild(like_tree, lambda n: _from_host(
        arrays[index[n]], manifest["dtypes"][index[n]], device))
    return step, tree, manifest["meta"]
