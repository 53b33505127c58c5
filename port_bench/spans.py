"""The harness's own spans: host-clock intervals around the calls it makes
into the program, by name, and the wrapper it puts around the train
preprocess function it hands to the step.

Under a profiler (``profiling``) each span is also a
``torch.profiler.record_function`` range named ``port_bench.<name>``, so
that the device work launched inside it can be read from the trace
(``port_bench.trace``). Outside one a span costs two clock reads.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Iterator

import torch

PREFIX = "port_bench."


class Spans:
    """Seconds and counts of each named span; ``profiling`` also marks
    them in a profiler's trace."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        if self.profiling:
            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield
        self.seconds[name] += time.perf_counter() - start
        self.counts[name] += 1


class PreprocessProbe:
    """Wraps a preprocess function: marks each call as the span
    ``preprocess`` while profiling and keeps a copy of the next call's
    output once :meth:`arm` is called. The wrapper carries the wrapped
    function's attributes (``supports_rows``, ``augment``, ...), so the
    step treats it as the function itself."""

    def __init__(self, spans: Spans) -> None:
        self.spans = spans
        self.kept: torch.Tensor | None = None
        self._armed = False

    def arm(self) -> None:
        self._armed, self.kept = True, None

    def wrap(self, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            if self.spans.profiling:
                with torch.profiler.record_function(PREFIX + "preprocess"):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if self._armed:
                self.kept, self._armed = out.detach().clone(), False
            return out

        wrapped.__dict__.update(fn.__dict__)
        return wrapped
