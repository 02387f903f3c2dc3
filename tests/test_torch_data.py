"""The port's data pipeline (resselt_tpu_torch.data) against
resselt_tpu.data on the CPU: its native sampler (its own copy of
``native/sampler.cpp``, built with g++ into ``_build/``) and its numpy
sampler give batches bit-equal to the JAX package's on the same images and
seed; the sampler contract (exact uint8 / 255 HR values, LR the exact box
mean, thread-count invariance); the prefetcher; the validation; and
``backend='native'`` raising instead of falling back."""

import numpy as np
import pytest

import resselt_tpu.data as jdata
from resselt_tpu_torch import data


def _images(n=3, size=96, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size + 7 * i, 3), np.uint8) for i in range(n)]


@pytest.mark.parametrize('backend', ['native', 'numpy'])
@pytest.mark.parametrize('crop,scale,seed', [(32, 2, 7), (48, 4, 0), (24, 3, 123)])
def test_batches_bit_equal_to_jax(backend, crop, scale, seed):
    imgs = _images()
    ours = data.CropSampler(imgs, crop=crop, scale=scale, seed=seed, backend=backend)
    theirs = jdata.CropSampler(imgs, crop=crop, scale=scale, seed=seed, backend=backend)
    assert ours.backend == theirs.backend == backend
    for batch in (8, 5, 16):
        (lo, ho), (lt, ht) = ours.next_batch(batch), theirs.next_batch(batch)
        assert lo.dtype == ho.dtype == np.float32
        np.testing.assert_array_equal(ho, ht)
        np.testing.assert_array_equal(lo, lt)


@pytest.mark.parametrize('backend', ['numpy', 'native'])
def test_sampler_contract(backend):
    s = data.CropSampler(_images(), crop=32, scale=2, seed=7, backend=backend)
    assert s.backend == backend
    lr, hr = s.next_batch(8)
    assert hr.shape == (8, 32, 32, 3) and lr.shape == (8, 16, 16, 3)
    assert 0.0 <= hr.min() and hr.max() <= 1.0
    q = hr * 255.0
    np.testing.assert_allclose(q, np.round(q), atol=1e-4)
    np.testing.assert_allclose(lr, hr.reshape(8, 16, 2, 16, 2, 3).mean(axis=(2, 4)), atol=1e-6)
    assert not np.array_equal(hr, s.next_batch(8)[1])


def test_native_sampler_thread_invariant_and_built_in_the_package():
    imgs = _images()
    a = data.CropSampler(imgs, crop=32, scale=4, seed=3, backend='native', n_threads=1)
    b = data.CropSampler(imgs, crop=32, scale=4, seed=3, backend='native', n_threads=8)
    for _ in range(3):
        (la, ha), (lb, hb) = a.next_batch(16), b.next_batch(16)
        np.testing.assert_array_equal(ha, hb)
        np.testing.assert_array_equal(la, lb)
    assert data._native_lib()._name.startswith(data.BUILD_DIR)


def test_native_backend_raises_without_the_library(monkeypatch):
    monkeypatch.setattr(data, '_native_lib', lambda: None)
    with pytest.raises(RuntimeError, match='native sampler unavailable'):
        data.CropSampler(_images(), crop=16, scale=2, backend='native')
    assert data.CropSampler(_images(), crop=16, scale=2, backend='auto').backend == 'numpy'


def test_prefetcher_matches_the_sampler():
    p = data.Prefetcher(data.CropSampler(_images(), crop=16, scale=2, seed=0, backend='native'), batch=4)
    ref = data.CropSampler(_images(), crop=16, scale=2, seed=0, backend='native')
    try:
        for _ in range(3):
            (lr, hr), (lw, hw) = p.next(), ref.next_batch(4)
            np.testing.assert_array_equal(hr, hw)
            np.testing.assert_array_equal(lr, lw)
    finally:
        p.close()


def test_prefetcher_propagates_producer_errors():
    class Boom:
        def next_batch(self, n):
            raise RuntimeError('corrupt image')

    p = data.Prefetcher(Boom(), batch=4)
    try:
        with pytest.raises(RuntimeError, match='corrupt image'):
            p.next()
    finally:
        p.close()


def test_sampler_validation():
    with pytest.raises(ValueError):
        data.CropSampler(_images(), crop=33, scale=2)
    with pytest.raises(ValueError):
        data.CropSampler(_images(size=8), crop=32, scale=2)
