"""The launches of a kernel in the traced window: the wrappers' counts of
each graph's first call divided by the passes that call made, which the
trace settles, whatever the program's warm-up policy; nothing where the
counts and the trace disagree."""

from collections import Counter

import pytest

from h100_bench import launches

PASS = Counter({('a', 8): 3, ('b', 8): 1})  # the launches one replay runs


@pytest.mark.parametrize('k', [1, 2, 3])
def test_any_number_of_passes_a_first_call_gives_the_same_launches(k):
    eager = Counter({('c', 1): 5})
    first = Counter({key: n * k for key, n in PASS.items()})
    got, passes = launches.in_window(eager, [(first, 7)], traced=5 + 7 * 4)
    assert passes == k
    assert got == Counter({('a', 8): 21, ('b', 8): 7, ('c', 1): 5})


def test_two_graphs_and_eager_launches():
    g1 = Counter({('a', 8): 4})  # 2 passes of 2
    g2 = Counter({('b', 4): 6})  # 2 passes of 3
    got, passes = launches.in_window(Counter({('a', 1): 1}), [(g1, 3), (g2, 2), (Counter(), 0)], traced=1 + 6 + 6)
    assert passes == 2 and got == Counter({('a', 8): 6, ('b', 4): 6, ('a', 1): 1})


def test_eager_only():
    assert launches.in_window(Counter({'x': 4}), [], traced=4) == (Counter({'x': 4}), None)


@pytest.mark.parametrize('traced', [0, 20, 27, 31, 60])
def test_counts_and_trace_that_disagree_give_nothing(traced):
    """A launch missed or counted twice, or a graph made inside the window."""
    first = Counter({key: 2 * n for key, n in PASS.items()})
    assert launches.in_window(Counter(), [(first, 7)], traced=traced) == (None, None)


def test_a_shape_count_that_the_passes_do_not_divide_gives_nothing():
    assert launches.in_window(Counter(), [(Counter({'a': 3, 'b': 1}), 2)], traced=4) == (None, None)


def test_eager_launches_the_trace_does_not_hold_give_nothing():
    assert launches.in_window(Counter({'x': 4}), [], traced=3) == (None, None)
