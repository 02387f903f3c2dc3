"""A hand-written kernel's launches in the traced window, by shape.

The program's kernel wrappers count each launch in Python (``by_shape``):
an eager launch as it runs, a CUDA graph's launches while the graph is
made, and a replay nothing.  A graph's first call makes it: some eager
warm-up passes and the capture, ``k`` passes of the launches one replay
runs, ``k`` being the program's own choice.  The trace settles ``k``: the
kernel's launches that ran on the device in the window are the eager ones
plus, for each graph, its replays times its launches a pass.  A ``k``
that is no whole number, or that does not divide every shape's count of
a first call, means the counts and the trace disagree (a launch counted
twice or not at all, a capture inside the window): no launches are
returned, and the roofline that reads them is left out of the line.
"""

from __future__ import annotations

from collections import Counter


def in_window(eager: Counter, first_calls: list[tuple[Counter, int]],
              traced: int) -> tuple[Counter | None, int | None]:
    """``(launches by shape, k)`` from the eager counts in the window,
    each graph's (first-call counts, replays in the window), and the
    kernel's launches in the trace; ``(None, None)`` where they disagree.
    ``k`` is None where no graph replayed."""
    total = Counter(eager)
    replayed = sum(replays * sum(counts.values()) for counts, replays in first_calls)
    from_graphs = traced - sum(eager.values())
    if replayed == 0:
        return (total, None) if from_graphs == 0 else (None, None)
    if from_graphs <= 0 or replayed % from_graphs:
        return None, None
    k = replayed // from_graphs
    for counts, replays in first_calls:
        if any(n % k for n in counts.values()):
            return None, None
        for key, n in counts.items():
            total[key] += n // k * replays
    return total, k
