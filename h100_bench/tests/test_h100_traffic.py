"""The traffic generator: deterministic by seed, the same sizes for every
seed, and the serving paths' rules."""

from collections import Counter

import numpy as np
import pytest

from h100_bench import traffic
from h100_bench.lookup import module


@pytest.mark.parametrize('name', ['frames720', 'photos'])
def test_mixes_find_their_size_kind_and_path(name):
    mix = traffic.load(name)
    assert callable(module('sizes', mix['sizes']['kind']).arrivals)
    path = module('paths', mix['path'])
    assert callable(path.server) and callable(path.program)
    assert 0 < mix['check_share'] <= 1


def test_photos_are_set5_and_set14_at_their_published_sizes():
    mix = traffic.load('photos')
    images = mix['sizes']['images']
    names = [i['name'] for i in images]
    assert len(set(names)) == len(names) == mix['distinct'] == 19
    assert sum(n.startswith('Set5/') for n in names) == 5 and sum(n.startswith('Set14/') for n in names) == 14
    sizes = Counter((i['height'], i['width']) for i in images)
    assert {s: n for s, n in sizes.items() if n > 1} == {(512, 512): 5, (288, 352): 2}
    assert any(i['height'] > i['width'] for i in images) and any(i['width'] > i['height'] for i in images)


@pytest.mark.parametrize('seed', [0, 7, 2**31 + 5, -3])
def test_every_seed_gets_the_same_sizes_in_the_same_order(seed):
    mix = traffic.load('photos')
    published = [(i['height'], i['width']) for i in mix['sizes']['images']]
    assert traffic.arrivals(mix, seed) == published


def test_listed_makes_each_image_once():
    mix = {'sizes': {'kind': 'listed', 'images': [{'name': 'a', 'width': 4, 'height': 3}]}, 'distinct': 2}
    with pytest.raises(ValueError, match='once'):
        traffic.arrivals(mix, 1)


def test_generation_is_deterministic_by_seed():
    mix = {'sizes': {'kind': 'listed', 'images': [{'name': f'i{k}', 'width': 8 + k, 'height': 6 + 2 * k}
                                                  for k in range(6)]},
           'distinct': 6, 'path': 'cli', 'check_share': 0.5}
    a, b, c = (traffic.generate(mix, s, 'cpu') for s in (5, 5, 6))
    assert all(np.array_equal(x, y) for x, y in zip(a.images, b.images))
    assert not all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a.images, c.images))
    ra, rb = a.requests(), b.requests()
    assert [next(ra)[2] for _ in range(40)] == [next(rb)[2] for _ in range(40)]


def test_frames_cycle_their_distinct_images():
    mix = {'sizes': {'kind': 'fixed', 'height': 9, 'width': 16}, 'distinct': 3, 'path': 'tiled', 'check_share': 1.0}
    t = traffic.generate(mix, 1, 'cpu')
    reqs = t.requests()
    got = [next(reqs) for _ in range(7)]
    assert [g[0] for g in got] == list(range(7))
    assert got[0][1] is got[3][1] is got[6][1] and got[0][1].shape == (9, 16, 3)
    assert len(t.first_of_each_size()) == 1


def test_cli_path_sends_shared_sizes_to_a_graph_and_the_rest_to_the_host_loop():
    """The CLI's folder rule: a side over the tile runs tiled, on a graph
    where another image of the folder has its size; the rest runs whole."""
    cli = module('paths', 'cli')
    folder = [np.zeros(s + (3,), np.uint8) for s in [(40, 40), (40, 40), (50, 30), (20, 20), (20, 40)]]
    shared = cli._shared(folder)
    assert shared == {(40, 40)}
    assert [cli._on_graph(img, 32, shared) for img in folder] == [True, True, False, None, False]
