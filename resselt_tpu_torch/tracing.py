"""Spans at the layer boundaries of the served path and of training.

``with span(name, **counts) as s:`` marks one layer's work.  While tracing
is off it returns one shared no-op context, after one flag read: no clock
read, no record, no profiler range.  Tracing is on while a
``torch.profiler`` is recording, and between :func:`enable` and
:func:`disable`.  While it is on, a span

* opens a ``torch.profiler.record_function(name)`` range, so that it lies
  in the profiler's trace on the profiler's own clock, beside the kernels
  it issued;
* keeps a :class:`Span` in a bounded ring in memory, read with
  :func:`spans` and emptied with :func:`clear`: its ``name``, ``id``, the
  enclosing span's id (``parent``), the outermost span's id (``request``,
  shared by every span of one call into the library), ``t0_ns`` and
  ``t1_ns`` on ``time.perf_counter_ns()``, and its ``counts``.

``s.set(**counts)`` adds counts known only inside the span.  Nesting is
per thread (the CLI decodes and writes images on a second thread; autograd
runs backward passes on its own).

The spans (``README.md``, the CLI section, lists them with their counts):
``tile.request``, ``tile.plan``, ``tile.capture``, ``tile.replay`` and
``tile.batch`` in ``parallel/tiling.py``; ``model.forward`` and
``model.prepare`` in ``core/factory.py``; ``load``, ``load.detect`` and
``load.build`` in ``core/registry.py``; ``train_step.forward`` and
``train_step.optimizer`` in ``train.py``, and the backward passes'
``conv.backward.weight`` and ``window_mha.backward`` in ``ops/``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler

_ring: deque = deque(maxlen=1 << 16)  # the spans kept; the oldest go first
_ids = itertools.count(1)
_local = threading.local()
_enabled = False


class Span:
    """One span's record; ``t1_ns`` is None while it is open."""

    __slots__ = ('name', 'id', 'parent', 'request', 't0_ns', 't1_ns', 'counts', '_range')

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts
        self.id = next(_ids)
        self.t0_ns = self.t1_ns = None

    def set(self, **counts) -> None:
        self.counts.update(counts)

    def __enter__(self) -> 'Span':
        stack = getattr(_local, 'stack', None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer is not None else None
        self.request = outer.request if outer is not None else self.id
        stack.append(self)
        _ring.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        self._range = None
        _local.stack.remove(self)
        return False


class _Off:
    """The span of tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> '_Off':
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **counts) -> None:
        pass


_OFF = _Off()


def span(name: str, **counts):
    """A context manager around one layer's work (module docstring)."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name, counts)


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler runs (the default)."""
    global _enabled
    _enabled = False


def spans() -> list[Span]:
    """The kept spans, in the order they opened."""
    return list(_ring)


def clear() -> None:
    """Forget the kept spans."""
    _ring.clear()
