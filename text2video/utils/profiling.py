"""Per-stage wall-clock timing and JAX device tracing.

Replaces the reference's observability story (print statements only;
SURVEY.md §5) with: a :class:`StageTimer` that pipeline stages wrap
themselves in, and :func:`device_trace` producing a TensorBoard-loadable
XLA profile for kernel-level analysis on the device.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional, Tuple


class StageTimer:
    """Collects (stage, seconds) pairs; nestable via context manager."""

    def __init__(self):
        self.records: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.records:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> str:
        totals = self.totals()
        whole = sum(totals.values()) or 1.0
        lines = [
            f"  {name:<24s} {dt * 1e3:9.1f} ms  ({dt / whole:5.1%})"
            for name, dt in sorted(totals.items(), key=lambda kv: -kv[1])
        ]
        return "stage timings:\n" + "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """XLA profiler trace (TensorBoard format). No-op when log_dir is
    None, so call sites can be unconditional."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
