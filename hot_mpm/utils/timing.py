"""Per-phase wall-clock timers with hierarchical aggregation.

Reference equivalent: Lib/Ziran/CS/Util/Timer.h (ZIRAN_TIMER, component #2)
— the scoped timers whose per-phase breakdown produced the paper's timing
tables. On an accelerator device work is async, so scopes explicitly
block_until_ready on exit when given a result to fence on, and each scope
also emits a jax.profiler TraceAnnotation so phases line up with the
device trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class PhaseTimer:
    """Aggregates wall-clock seconds per named phase."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str, fence=None):
        """Time a phase. If `fence` is a jax array/pytree, block on it so the
        measured time includes device execution, not just dispatch."""
        with jax.profiler.TraceAnnotation(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if fence is not None:
                    jax.block_until_ready(fence)
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def time(self, name: str, fn, *args, **kwargs):
        """Run fn and block on its result, attributing the time to `name`."""
        with jax.profiler.TraceAnnotation(name):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            jax.block_until_ready(out)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
        return out

    def snapshot(self) -> dict:
        return {k: {"total_s": self.totals[k], "count": self.counts[k]} for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        lines = ["phase                          total(s)    count   mean(ms)"]
        for name in sorted(self.totals, key=lambda k: -self.totals[k]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<30} {t:9.3f} {c:8d} {1e3 * t / max(c, 1):10.2f}")
        return "\n".join(lines)
