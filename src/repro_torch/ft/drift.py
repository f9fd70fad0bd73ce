"""Operating-point drift: measurement, detection, degraded resolution
(port of `repro/ft/drift.py`).

The solved TD operating point (R, q, Vdd) depends on the input statistics
the solve assumed: `p_x_one` (activation bit density) and
`w_bit_sparsity`.  When live traffic drifts away from them the deployed
policy is mispriced.  This module is the serving side's feedback loop:

`measure_p_x_one`
    The activation bit density in torch, on the tensor's device: maxabs
    quantize to the policy's bit width, offset-encode, average the bit
    planes (the statistic `cells.input_distribution` prices).  The
    adaptive decode step returns it beside the tokens as a device scalar.
`weight_bit_sparsity`
    The weight-side statistic, measured once from the deployed params.
    It counts the ones of each code in chunks of rows instead of
    materializing the bit planes (qwen3-8b's embedding table has 622M
    values: its f32 planes would take 10 GB); `measure_p_x_one` of the
    same weights is the plain formula it equals.
`DriftEstimator`, `StagedRebuild`, `ResolverChain`
    Pure Python, as in the reference: the EMA + threshold detector, the
    off-thread rebuild with its error contract, and the primary-then-
    fallback resolver.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import torch

from repro_torch.quant import bitserial

_CHUNK = 1 << 24          # values a chunk of `weight_bit_sparsity`


def _scale(x: torch.Tensor, bits: int) -> torch.Tensor:
    """max(max|x|, 1e-8) / qmax, divided by a device tensor: CUDA turns a
    division by a Python scalar into a multiply by its reciprocal."""
    qmax = torch.full((), 2.0 ** (bits - 1) - 1.0, dtype=x.dtype,
                      device=x.device)
    return torch.clamp(torch.max(torch.abs(x)), min=1e-8) / qmax


def _offset_codes(x: torch.Tensor, s: torch.Tensor, bits: int
                  ) -> torch.Tensor:
    qmax = 2.0 ** (bits - 1) - 1.0
    codes = torch.clamp(torch.round(x / s), -(qmax + 1.0), qmax)
    return bitserial.to_offset(codes.to(torch.int32), bits)


def measure_p_x_one(x: torch.Tensor, bits: int = 4,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Activation bit density of ``x`` under B-bit maxabs quantization:
    the fraction of ones across all offset-encoded bit planes, a 0-d f32
    tensor on x's device (nothing here waits for the device).

    ``mask`` (optional, broadcastable to ``x.shape[0]``) selects which
    leading-axis rows count: the continuous-batching engine passes its
    occupancy, so the stale last tokens of free slots do not enter the
    statistic.  The scale is taken over all of ``x``, as in the
    reference.  An all-zero mask gives 0.5 (the uninformative prior)
    rather than NaN."""
    planes = bitserial.bit_planes(_offset_codes(x, _scale(x, bits), bits),
                                  bits).to(torch.float32)
    if mask is None:
        return torch.mean(planes)
    m = mask.to(torch.float32).reshape((-1,) + (1,) * (x.ndim - 1))
    w = torch.broadcast_to(m, x.shape)
    tot = float(bits) * torch.sum(w)
    return torch.where(tot > 0,
                       torch.sum(planes * w[None, ...])
                       / torch.clamp(tot, min=1.0),
                       torch.full((), 0.5, device=x.device))


def weight_bit_sparsity(w: torch.Tensor, bits: int = 4) -> float:
    """Fraction of zero bits in the B-bit maxabs codes of ``w`` (the
    Section IV 'weight bitwise sparsity'), ``1 - measure_p_x_one(w)``.
    The ones are counted per code (a table of 2^B popcounts), _CHUNK
    values at a time, so memory stays bounded at any size; one host read
    at the end."""
    flat = w.reshape(-1)
    s = _scale(flat, bits)
    pop = torch.tensor([bin(v).count("1") for v in range(2 ** bits)],
                       dtype=torch.int64, device=w.device)
    ones = torch.zeros((), dtype=torch.int64, device=w.device)
    for i in range(0, flat.numel(), _CHUNK):
        ones += pop[_offset_codes(flat[i:i + _CHUNK], s, bits)].sum()
    return 1.0 - int(ones) / (bits * flat.numel())


@dataclasses.dataclass
class DriftEstimator:
    """EMA drift detector over a running operating-point statistic.

    ``anchor`` is the value the current policy was resolved at; `update`
    folds one measurement into the EMA and returns True when the smoothed
    value has left ``(1 +/- threshold) * anchor``.  ``warmup`` raw samples
    must arrive before the detector may fire.  After the caller
    re-resolves, `rearm(new)` moves the anchor and re-enters warmup, so
    the detector tracks the new operating point instead of re-firing on
    the old excursion.
    """
    anchor: float
    alpha: float = 0.1          # EMA weight of each new sample
    threshold: float = 0.2      # relative band half-width around anchor
    warmup: int = 4
    value: float | None = None  # current EMA (None until first sample)
    samples: int = 0
    excursions: int = 0

    def update(self, measured: float) -> bool:
        m = float(measured)
        self.value = m if self.value is None else \
            (1.0 - self.alpha) * self.value + self.alpha * m
        self.samples += 1
        if self.samples < self.warmup:
            return False
        drifted = abs(self.value - self.anchor) > \
            self.threshold * abs(self.anchor)
        if drifted:
            self.excursions += 1
        return drifted

    def rearm(self, anchor: float) -> None:
        self.anchor = float(anchor)
        self.value = None
        self.samples = 0


class StagedRebuild:
    """A policy rebuild running off-thread, to be installed at a later
    step boundary.

    The supply-spanning re-resolve (Vdd argmin over the scenario grid,
    the per-layer policy solve, the meter's re-price) is too slow to run
    inside a decode step, so the engine stages it: ``fn`` runs on a
    daemon thread and the engine polls at each step boundary.

    Error contract (the checkpoint `SaveHandle`'s): an exception in the
    worker is captured and re-raised exactly once, wrapped in RuntimeError
    with the original as __cause__, on the next `poll()` / `wait()`.
    """

    def __init__(self, fn: Callable[[], object],
                 name: str = "staged-rebuild"):
        self.result: object | None = None
        self.error: BaseException | None = None
        self._raised = False
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        name=name, daemon=True)
        self._thread.start()

    def _run(self, fn: Callable[[], object]) -> None:
        try:
            self.result = fn()
        except BaseException as e:       # noqa: BLE001 -- re-raised on poll
            self.error = e

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()

    def _surface(self) -> None:
        if self.error is not None and not self._raised:
            self._raised = True
            raise RuntimeError(
                f"staged rebuild '{self._thread.name}' failed: "
                f"{self.error!r}") from self.error

    def poll(self) -> object | None:
        """Non-blocking: the result if the rebuild finished, else None.
        Raises (once) if the rebuild thread died with an exception."""
        if not self.done:
            return None
        self._surface()
        return self.result

    def wait(self, timeout: float | None = None) -> object | None:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("staged rebuild still running")
        self._surface()
        return self.result


class ResolverChain:
    """Primary-then-fallback policy resolution.

    ``primary`` and ``fallback`` share a call signature; a primary failure
    of one of the ``catches`` types degrades to the fallback (counted in
    ``fallbacks``, shown by ``degraded``); anything else propagates.  A
    later primary success clears ``degraded``.  Both resolve on the
    device the caller's policy solve uses: the chain never moves a solve
    to another device.
    """

    def __init__(self, primary: Callable, fallback: Callable,
                 catches: tuple[type[BaseException], ...] = (OSError,
                                                            TimeoutError),
                 on_fallback: Callable[[BaseException], None] | None = None):
        self.primary = primary
        self.fallback = fallback
        self.catches = catches
        self.on_fallback = on_fallback
        self.calls = 0
        self.fallbacks = 0
        self.degraded = False

    def __call__(self, *args, **kwargs):
        self.calls += 1
        try:
            out = self.primary(*args, **kwargs)
        except self.catches as e:
            self.fallbacks += 1
            self.degraded = True
            if self.on_fallback is not None:
                self.on_fallback(e)
            return self.fallback(*args, **kwargs)
        self.degraded = False
        return out
