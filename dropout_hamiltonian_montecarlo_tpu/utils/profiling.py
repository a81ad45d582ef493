"""Tracing / throughput observability.

SURVEY.md §5: the reference's only tracing is ad-hoc time.time() in notebooks.
Here: a jax.profiler wrapper for device traces plus a SamplerStats counter
giving draws/sec, grad-evals/sec and (with diagnostics) ESS/sec — the numbers
BASELINE.json grades.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import jax


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a device/host profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class SamplerStats:
    """Accumulates wall-clock + draw counts across sampling phases."""

    num_chains: int = 1
    draws: int = 0
    grad_evals: int = 0
    seconds: float = 0.0
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()
        return self

    def stop(self, draws: int = 0, grad_evals: int = 0):
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        self.seconds += time.time() - self._t0
        self.draws += draws
        self.grad_evals += grad_evals
        self._t0 = None
        return self

    @property
    def draws_per_sec(self) -> float:
        return self.draws / self.seconds if self.seconds else 0.0

    @property
    def grads_per_sec(self) -> float:
        return self.grad_evals / self.seconds if self.seconds else 0.0

    def ess_per_sec(self, ess) -> float:
        import numpy as np

        return float(np.median(np.asarray(ess).ravel())) / self.seconds

    def summary(self) -> Dict[str, Any]:
        return {
            "chains": self.num_chains,
            "draws": self.draws,
            "seconds": round(self.seconds, 3),
            "draws_per_sec": round(self.draws_per_sec, 1),
            "grads_per_sec": round(self.grads_per_sec, 1),
        }
