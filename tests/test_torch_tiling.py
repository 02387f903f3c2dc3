"""The port's tiling (resselt_tpu_torch.parallel.tiling) against
resselt_tpu.parallel.tiling: grid planning, halo derivation and hint
resolution must be equal over sweeps of sizes; tiled and padded outputs of
a small ESRGAN must agree within test_conv_archs.py's TOL (5e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel.tiling as jt
import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu_torch.zoo import make_esrgan


torch.set_num_threads(2)

TOL = 5e-4


def test_plan_grid_sweep():
    for h in (1, 7, 40, 64, 70, 100, 257, 720):
        for w in (1, 9, 64, 90, 300, 1280):
            for tile, halo in ((32, 8), (64, 4), ((16, 48), (2, 6)), (256, 16)):
                assert tt.plan_grid(h, w, tile, halo).__dict__ == jt.plan_grid(h, w, tile, halo).__dict__


def test_derive_halo_sweep():
    for tile in (16, 31, 64, 128, 192, 256):
        for floor in (0, 4, 8, 16):
            for multiple in (None, 0, 1, 2, 4, 8, 12, 16, 64):
                assert tt.derive_halo(tile, floor, multiple) == jt.derive_halo(tile, floor, multiple)


class _Hints:
    def __init__(self, tile_batch=None, serving_tile=None, serving_halo=None, size_multiple=None):
        self.tile_batch, self.serving_tile = tile_batch, serving_tile
        self.serving_halo, self.size_multiple = serving_halo, size_multiple


_HINTS = [
    _Hints(),
    _Hints(serving_halo=4),
    _Hints(tile_batch={'f32': 2, 'bf16': 6}, serving_tile={'f32': 128, 'bf16': 192}, serving_halo={'f32': 16, 'bf16': 8}),
    _Hints(tile_batch=3, serving_tile=96, serving_halo=12, size_multiple=16),
    _Hints(serving_tile={'f32': 64}, size_multiple=8),
]
_DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16),
           (np.uint8, torch.uint8)]


@pytest.mark.parametrize('hints', range(len(_HINTS)))
def test_hint_resolvers_match(hints):
    m = _HINTS[hints]
    for jd, td in _DTYPES:
        for val in (None, 5, {'f32': 1, 'bf16': 2}, {'f32': 3}):
            assert tt._resolve_dtype_hint(val, td) == jt._resolve_dtype_hint(val, jd)
        assert tt._resolve_tile_hint(m, td) == jt._resolve_tile_hint(m, jd)
        for tile in (32, 64, 96, 128, 192, 256):
            assert tt._resolve_halo_hint(m, tile, td) == jt._resolve_halo_hint(m, tile, jd)
        for h, w in ((40, 40), (70, 90), (20, 300), (300, 5), (720, 1280)):
            for tile, halo, bs in ((32, 8, None), (64, 4, 3), (16, 2, 100)):
                a = tt._plan_tiled(m, h, w, tile, halo, bs, td)
                b = jt._plan_tiled(m, h, w, tile, halo, bs, jd, None)
                assert (a is None and b is None) or (a[0].__dict__ == b[0].__dict__ and a[1] == b[1])


def test_extract_and_stitch_match():
    img = np.random.default_rng(0).random((70, 90, 3), dtype=np.float32)
    grid = tt.plan_grid(70, 90, 32, 8)
    tiles_t = tt.extract_tiles(torch.from_numpy(img), grid)
    tiles_j = np.asarray(jt.extract_tiles(jnp.asarray(img), grid))
    np.testing.assert_array_equal(tiles_t.numpy(), tiles_j)
    up = np.repeat(np.repeat(tiles_j, 2, axis=1), 2, axis=2)
    np.testing.assert_array_equal(tt.stitch_tiles(torch.from_numpy(up), grid, 2).numpy(),
                                  np.asarray(jt.stitch_tiles(jnp.asarray(up), grid, 2)))


@pytest.fixture(scope='module')
def models():
    sd = make_esrgan(16, 1, 2, gc=8, seed=21)
    return resselt_tpu_torch.load_from_state_dict(sd, device='cpu'), resselt_tpu.load_from_state_dict(sd)


@pytest.mark.parametrize('hw,kwargs', [
    ((70, 90), {'tile': 32, 'halo': 8}),
    ((20, 90), {'tile': 32, 'halo': 8}),      # narrow strip: the window shrinks along H
    ((70, 90), {'tile': 32, 'halo': 8, 'batch_size': 4}),
    ((70, 90), {'tile': 32, 'halo': 8, 'bucket': True}),
    ((70, 90), {'tile': 48}),                  # the loader's halo hint
])
def test_upscale_tiled_matches_jax(models, hw, kwargs):
    tm, jm = models
    img = np.random.default_rng(hw[0]).random(hw + (3,), dtype=np.float32)
    want = np.asarray(jt.upscale_tiled(jm, img, **kwargs))
    got = tt.upscale_tiled(tm, img, **kwargs)
    assert tuple(got.shape) == want.shape == (hw[0] * 2, hw[1] * 2, 3)
    assert float(np.abs(got.numpy() - want).max()) < TOL


def test_upscale_tiled_uint8_and_bf16(models):
    tm, jm = models
    img = (np.random.default_rng(3).random((40, 70, 3)) * 255).astype(np.uint8)
    got = tt.upscale_tiled(tm, img, tile=24, halo=4)
    want = np.asarray(jt.upscale_tiled(jm, img, tile=24, halo=4))
    assert float(np.abs(got.numpy() - want).max()) < TOL
    bf = tt.upscale_tiled(tm, img, tile=24, halo=4, dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert float(((bf.float() - got) ** 2).mean()) < 10 ** -3.5  # > 35 dB


def test_upscale_tiled_whole_image_and_defaults(models):
    tm, jm = models
    img = np.random.default_rng(4).random((30, 20, 3), dtype=np.float32)
    got = tt.upscale_tiled(tm, img)  # fits one 256 window: runs whole
    np.testing.assert_allclose(got.numpy(), np.asarray(jm(img)), rtol=0, atol=TOL)
    with pytest.raises(TypeError):  # a mesh is a DeviceMesh
        tt.upscale_tiled(tm, img, mesh=object())
    import torch_mesh_ranks as ranks
    from resselt_tpu_torch.parallel import make_mesh

    with ranks.one_rank():  # a one-rank gloo mesh: the meshless run, here one window
        assert torch.equal(tt.upscale_tiled(tm, img, mesh=make_mesh(device='cpu')), got)
    with pytest.raises(ValueError):
        tt.upscale_tiled(tm, img[None])


@pytest.mark.parametrize('hw', [(30, 45), (3, 5)])
def test_upscale_padded_matches_jax(models, hw):
    tm, jm = models
    img = np.random.default_rng(5).random(hw + (3,), dtype=np.float32)
    want = np.asarray(jt.upscale_padded(jm, img, multiple=16))
    got = tt.upscale_padded(tm, img, multiple=16)
    assert tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) < TOL
