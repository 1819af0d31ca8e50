"""Device timing.

JAX analog of reference glu/gl_utils.hpp:249-265
(measure_gl_elapsed_time: a GL_TIME_ELAPSED query around a callback) and
test/util/StopWatch.hpp: wall-clock around a fully synchronized dispatch,
ended by `jax.block_until_ready` on every output. For deeper traces,
`jax.profiler` is the analog of RenderDoc capture and is exposed via
`trace()`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


def measure_elapsed_time(callback: Callable[[], object]) -> tuple[int, object]:
    """Run `callback`, returning (elapsed nanoseconds, result).

    The result (any pytree of jax.Arrays) is blocked on before the clock
    stops, so the measurement covers device execution — the analog of the
    reference's GL timer query (gl_utils.hpp:249-265), which also measures
    device time for the whole callback.
    """
    start = time.perf_counter_ns()
    result = jax.block_until_ready(callback())
    elapsed = time.perf_counter_ns() - start
    return elapsed, result


def ns_to_human_string(ns: float) -> str:
    """Autoscaling time formatter (reference test/util/StopWatch.hpp:11-32)."""
    if ns >= 1e9:
        return f"{ns / 1e9:.3f} s"
    if ns >= 1e6:
        return f"{ns / 1e6:.3f} ms"
    if ns >= 1e3:
        return f"{ns / 1e3:.3f} us"
    return f"{ns:.0f} ns"


class StopWatch:
    """Wall-clock stopwatch (reference test/util/StopWatch.hpp:34-59)."""

    def __init__(self):
        self._start = time.perf_counter_ns()

    def restart(self) -> None:
        self._start = time.perf_counter_ns()

    def elapsed_ns(self) -> int:
        return time.perf_counter_ns() - self._start

    def elapsed_human(self) -> str:
        return ns_to_human_string(self.elapsed_ns())


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context — the RenderDoc-capture analog
    (the reference links renderdoc_app.h but never invokes it; we wire the
    equivalent through so it is actually usable)."""
    with jax.profiler.trace(log_dir):
        yield log_dir
