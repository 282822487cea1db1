"""Tracing / profiling hooks (SURVEY.md §5.1).

`trace_render(dir)` wraps any render call in a jax profiler trace
(Perfetto/XProf dump); `annotate(name)` adds named scopes per pipeline
stage. Zero-cost when unused.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace_render(profile_dir: str | None):
    """Profile a render: `with trace_render('/tmp/prof'): render(...)`."""
    if not profile_dir:
        yield
        return
    with jax.profiler.trace(profile_dir):
        yield


def annotate(name: str):
    """Named profiler scope for a pipeline stage."""
    return jax.profiler.TraceAnnotation(name)
