"""Profiling & observability hooks.

The reference has no tracing at all (SURVEY §5 — only stderr progress
lines, ``PoseEstimator.cpp:350-351``).  Here:

* ``trace(path)``          — context manager around ``jax.profiler``
  (open the dump with TensorBoard / xprof),
* ``timed``                — wall-clock timing with device sync,
* ``StepLogger``           — the stderr progress line, rate-limited
  (the ``iteration: N found: M`` analogue).
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time

import jax


@contextlib.contextmanager
def trace(path=None):
    path = path or os.path.join(tempfile.gettempdir(), "slam_eslam_trace")
    jax.profiler.start_trace(path)
    try:
        yield path
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label, out=None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    msg = f"[timing] {label}: {dt * 1e3:.2f} ms"
    if out is not None:
        out[label] = dt
    print(msg, file=sys.stderr)


def sync():
    """Block until all device work is done (accurate timing boundaries)."""
    jax.effects_barrier()
    jax.block_until_ready(jax.live_arrays())


class StepLogger:
    """Rate-limited progress line: ``iteration: i  ess: .. found: ..``."""

    def __init__(self, every=10, stream=sys.stderr):
        self.every = every
        self.stream = stream
        self.i = 0

    def log(self, **kv):
        if self.every and self.i % self.every == 0:
            parts = "\t".join(f"{k}: {v}" for k, v in kv.items())
            print(f"iteration: {self.i}\t{parts}", file=self.stream)
        self.i += 1
