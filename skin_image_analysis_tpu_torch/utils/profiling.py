"""Timing spans and profiler hooks (port of the JAX package's
``utils.profiling``).

:class:`Timer` is a wall-clock stopwatch. :func:`trace` records a
``torch.profiler`` session (host operators, and the card's kernels and
copies when it is in use) and writes it as a Chrome trace JSON, which
``chrome://tracing`` and Perfetto open. :class:`annotate` is the
program's span: under an active ``torch.profiler`` session it marks a
``record_function`` range named ``sia.<name>``, on the profiler's clock
(the one its device operations carry), and outside one it costs a single
check.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


class Timer:
    """Context-manager stopwatch: ``with Timer('x') as t: ...; t.elapsed``."""

    def __init__(self, name: str = ""):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._start


@contextlib.contextmanager
def trace(log_dir: str, device: bool | None = None) -> Iterator[str]:
    """Profile the ``with`` block and write its Chrome trace to
    ``<log_dir>/trace_<pid>_<time>.json``; yields that path.

    ``device`` adds the card's activity (CUDA); by default it is added
    when a card is available. The first profiler session of a process can
    come back with no device records, so with the card a discarded
    session around one small device operation runs first (as
    ``tools.perf_attrib.device_kernels`` discards its first session)."""
    from torch.profiler import ProfilerActivity, profile

    if device is None:
        device = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if device:
        activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
        if device:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


#: the prefix of the program's spans in a trace
SPAN_PREFIX = "sia."


class annotate:
    """``with annotate("train.step"): ...``: a span named ``sia.<name>``
    in the timeline of the ``torch.profiler`` session that is active when
    the block is entered (the train CLI's ``--profile``, the benchmark's
    traced epoch). Without one it reads no clock and records nothing."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "annotate":
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(
                SPAN_PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
