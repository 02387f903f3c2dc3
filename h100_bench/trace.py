"""What a ``torch.profiler`` trace of the traced window says: device time
by kernel, the device's busy share, and the idle gaps with what the host
was doing in them.

The window is the span of the host range named :data:`WINDOW`.  Device
operations are the trace's events on the card (kernels, copies, sets),
clipped to the window; the ranges that the profiler mirrors onto the card
for ``record_function`` are not operations and are left out.
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = 'h100_bench.traced_window'
_NOT_KERNELS = ('Memcpy', 'Memset', 'Command Buffer Full')
_GLOBAL = re.compile(r'__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)')


def kernels_in(cu_file: str) -> set[str]:
    """The names of the ``__global__`` functions of one of the program's
    ``.cu`` sources: its hand-written kernels."""
    with open(cu_file) as fh:
        return set(_GLOBAL.findall(fh.read()))


def kernel_base_name(name: str) -> str:
    """A demangled kernel name without its return type, namespaces,
    template arguments and parameters: ``void (anonymous
    namespace)::conv3x3_wgmma_kernel<__nv_bfloat16, 8>(...)`` ->
    ``conv3x3_wgmma_kernel``."""
    name = name.replace('(anonymous namespace)::', '').split('(', 1)[0].split('<', 1)[0]
    return name.rsplit(' ', 1)[-1].rsplit('::', 1)[-1]


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict[str, float] = field(default_factory=dict)  # device seconds by kernel name
    kernel_n: dict[str, int] = field(default_factory=dict)  # launches by kernel name
    idle_by_host: dict[str, float] = field(default_factory=dict)  # idle seconds by the host's innermost range

    def kernel_seconds(self, match) -> float:
        return sum(s for name, s in self.kernel_s.items() if match(name))

    def kernel_launches(self, match) -> int:
        return sum(n for name, n in self.kernel_n.items() if match(name))


def _times(e):
    if hasattr(e, 'start_ns'):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


def read(prof) -> Trace:
    """The window's :class:`Trace` from a finished ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    host, device, window = [], [], None
    for e in events:
        name = e.name()
        t0, t1 = _times(e)
        if str(e.device_type()).endswith('CPU'):
            if name == WINDOW:
                window = (t0, t1)
            host.append((t0, t1, name))
        elif not name.startswith(_NOT_KERNELS[2]) and not name.startswith('h100_bench.') and not (
                hasattr(e, 'is_user_annotation') and e.is_user_annotation()):
            device.append((t0, t1, name))
    if window is None:
        raise RuntimeError(f'the trace holds no {WINDOW!r} range')
    w0, w1 = window
    kernel_s: dict[str, float] = defaultdict(float)
    kernel_n: dict[str, int] = defaultdict(int)
    spans = []
    for t0, t1, name in device:
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        spans.append((t0, t1))
        if not name.startswith(_NOT_KERNELS):
            kernel_s[name] += (t1 - t0) / 1e9
            kernel_n[name] += 1
    busy, gaps = _union(sorted(spans), w0, w1)
    return Trace((w1 - w0) / 1e9, busy / 1e9, dict(kernel_s), dict(kernel_n), _attribute(gaps, host))


def _union(spans, w0, w1):
    """Busy nanoseconds of sorted ``spans`` and the idle gaps between them
    inside [w0, w1]."""
    busy, gaps, cursor = 0, [], w0
    for t0, t1 in spans:
        if t0 > cursor:
            gaps.append((cursor, t0))
        if t1 > cursor:
            busy += t1 - max(t0, cursor)
            cursor = t1
    if cursor < w1:
        gaps.append((cursor, w1))
    return busy, gaps


def _attribute(gaps, host) -> dict[str, float]:
    """Idle seconds summed by the innermost host range (the one that began
    last) open at each gap's midpoint; 'idle host' where none is."""
    out: dict[str, float] = defaultdict(float)
    host = sorted(r for r in host if r[2] != WINDOW)
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    open_, i = [], 0  # max-heap on start: (-start, end, name)
    for mid, length in mids:
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(open_, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while open_ and open_[0][1] < mid:
            heapq.heappop(open_)
        out[open_[0][2] if open_ else 'idle host'] += length / 1e9
    return dict(out)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time and the host's activities that the longest idle time fell in."""
    def largest(d):
        return [[name[:160], s] for name, s in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {'device_ops': largest(trace.kernel_s), 'idle_gaps': largest(trace.idle_by_host)}
