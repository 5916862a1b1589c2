"""Tracing / profiling hooks (SURVEY.md section 5: the reference has none —
only ad-hoc println stats; this is the jax.profiler-based replacement).

Usage:
    with trace("frave-trace"):               # XLA device timeline -> TensorBoard
        encode(...)

    with stage_timer("encode/device"):        # wall-clock per stage -> metrics
        ...
"""

from __future__ import annotations

from contextlib import contextmanager

from .metrics import get_metrics


@contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a region (device + host timeline)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextmanager
def stage_timer(name: str):
    """Wall-clock stage timing recorded into the global metrics sink."""
    with get_metrics().timer(name):
        yield


@contextmanager
def annotate(name: str):
    """Named region visible in profiler timelines (TraceAnnotation)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
