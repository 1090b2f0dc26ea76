"""Tracing / profiling utilities.

The reference's instrumentation is host std::clock around plan (KGMT.cu:82,
294-296) and cudaEvent elapsed-ms around prototype kernels
(NaivePlanner.cu:104-115). Upgrade here (SURVEY.md §5): jax.profiler
traces viewable in TensorBoard/Perfetto, block_until_ready walls, and
jax.named_scope phase annotation (the planner phases score/expand/commit are
already named inside kgmt_iteration, so they show up as labeled regions in a
trace).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import jax


class Timer:
    """Wall timer with block_until_ready semantics: ``with Timer() as t: ...``
    then ``t.elapsed_s``. Pass the result pytree to ``stop`` for a
    device-synchronized reading (the analog of cudaEventSynchronize)."""

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        self.elapsed_s = None
        return self

    def __exit__(self, *exc) -> None:
        if self.elapsed_s is None:
            self.elapsed_s = time.perf_counter() - self.start

    def stop(self, result=None) -> float:
        if result is not None:
            jax.block_until_ready(result)
        self.elapsed_s = time.perf_counter() - self.start
        return self.elapsed_s


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace of the enclosed block (open in
    TensorBoard or Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def phase_scope(name: str) -> Iterator[None]:
    """Named scope visible in profiler traces and HLO metadata."""
    with jax.named_scope(name):
        yield
