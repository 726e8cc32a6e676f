"""Profiling hooks on ``torch.profiler`` (port of
``swnerf_tpu/utils/profiling.py``).

Set ``SWNERF_PROFILE_DIR=/path`` to trace ``SWNERF_PROFILE_STEPS`` (default
20) training steps of ``run_nerf`` from the first dispatch after the
resume, CPU and, on a card, CUDA activity, written as a Chrome trace
(``trace_<first>-<last>.json``, open it in chrome://tracing or Perfetto)
into that directory; or use :func:`trace` around any block.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional


def _profile():
    from torch.profiler import ProfilerActivity, profile, supported_activities

    acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA) if a in supported_activities()]
    return profile(activities=acts)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[None]:
    """``torch.profiler`` over the block, its Chrome trace written to
    ``<logdir>/trace.json``; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    prof = _profile()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepProfiler:
    """Traces the steps from the dispatch that starts at ``start + 1`` to the
    one that reaches ``start + n`` when SWNERF_PROFILE_DIR is set (the JAX
    package's rule, per dispatch); otherwise free. :meth:`step` runs before
    each dispatch; the trace is written when it stops."""

    def __init__(self):
        self.logdir = os.environ.get("SWNERF_PROFILE_DIR")
        self.n = int(os.environ.get("SWNERF_PROFILE_STEPS", 20))
        self._prof = None
        self._first = 0
        self.path: Optional[str] = None

    def step(self, i: int, start: int) -> None:
        if self.logdir is None:
            return
        if i == start + 1 and self._prof is None:
            self._prof = _profile()
            self._prof.start()
            self._first = i
        elif self._prof is not None and i >= start + self.n:
            self._stop(i - 1)

    def _stop(self, last: int) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(self.logdir, f"trace_{self._first}-{last}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None

    def close(self, last: int) -> None:
        """At the end of training: stop a trace still running (``last``:
        the last iteration run)."""
        if self._prof is not None:
            self._stop(last)
