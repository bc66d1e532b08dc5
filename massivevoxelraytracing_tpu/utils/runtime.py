"""Process-level runtime setup: persistent XLA compilation cache + timers.

The persistent cache makes every app/bench invocation after the first skip
XLA compilation of shapes it has seen. Plays the role the reference's
JIT-compile cache of `Shader` kernels plays (hipUtil.hpp:112-157) at the
XLA level.
"""

from __future__ import annotations

import os
import time

# One fixed directory per checkout, so every process finds the same cache.
DEFAULT_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def setup() -> None:
    """Platform choice and compilation cache, before the first device use.

    MVRT_PLATFORM=cpu runs an app or script on the host CPU (an explicit
    choice, never a fallback). JAX_COMPILATION_CACHE_DIR, when set, is left
    for JAX to use; otherwise the cache lives at DEFAULT_CACHE."""
    plat = os.environ.get("MVRT_PLATFORM")
    if plat:
        os.environ["JAX_PLATFORMS"] = plat

    import jax

    if plat:
        jax.config.update("jax_platforms", plat)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE)


import contextlib


@contextlib.contextmanager
def profile(trace_dir: str | None):
    """jax.profiler trace wrapper (the reference ships --generate-line-info
    kernels for external profilers, PathTracer.hpp:56-66; ours emits a
    TensorBoard/XProf trace)."""
    if not trace_dir:
        yield
        return
    import jax

    os.makedirs(trace_dir, exist_ok=True)
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Stopwatch:
    """Per-phase wall timers with the reference's stats-line spirit
    (RTCamp.cpp:195: '[frame N] res() total() / update / render')."""

    def __init__(self):
        self.t0 = time.time()
        self.marks: dict[str, float] = {}

    def lap(self, name: str, block_on=None) -> float:
        if block_on is not None:
            import jax

            jax.block_until_ready(block_on)
        now = time.time()
        dt = now - self.t0
        self.marks[name] = self.marks.get(name, 0.0) + dt
        self.t0 = now
        return dt
