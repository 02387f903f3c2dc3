"""The port's CLI (resselt_tpu_torch.upscale, --device cpu) against
resselt_tpu.upscale.main on the same .safetensors and .pth checkpoints:
the written PNGs must agree within 1 LSB, whole-image and tiled."""

import numpy as np
import pytest
import torch

from resselt_tpu.upscale import adapt_channels as jax_adapt, main as jax_main
from resselt_tpu_torch.io import write_safetensors
from resselt_tpu_torch.upscale import adapt_channels, main as port_main
from resselt_tpu_torch.zoo import make_esrgan


torch.set_num_threads(2)


def _png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


def _read(path):
    from PIL import Image

    img = Image.open(path)
    return img.mode, np.asarray(img).astype(np.int16)


@pytest.fixture(scope='module')
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp('ckpt')
    sd = make_esrgan(16, 1, 2, gc=8, seed=31)
    st, pth = str(d / 'm.safetensors'), str(d / 'm.pth')
    write_safetensors(sd, st)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    return {'safetensors': st, 'pth': pth}


@pytest.mark.parametrize('fmt', ['safetensors', 'pth'])
@pytest.mark.parametrize('extra', [[], ['--tile', '32', '--halo', '8'], ['--tile', '24', '--bucket']],
                         ids=['whole', 'tiled', 'bucket'])
def test_cli_matches_jax(tmp_path, ckpts, fmt, extra):
    src = str(tmp_path / 'in.png')
    _png(src, (np.random.default_rng(1).random((40, 52, 3)) * 255).astype(np.uint8))
    a, b = str(tmp_path / 'jax.png'), str(tmp_path / 'port.png')
    assert jax_main([ckpts[fmt], src, a, *extra]) == 0
    assert port_main([ckpts[fmt], src, b, '--device', 'cpu', *extra]) == 0
    (ma, ja), (mb, pb) = _read(a), _read(b)
    assert ma == mb == 'RGB' and ja.shape == pb.shape == (80, 104, 3)
    assert int(np.abs(ja - pb).max()) <= 1


def test_cli_rgba_and_directory(tmp_path, ckpts):
    indir, oj, op = tmp_path / 'in', tmp_path / 'oj', tmp_path / 'op'
    indir.mkdir()
    rng = np.random.default_rng(2)
    _png(str(indir / 'a.png'), (rng.random((20, 24, 4)) * 255).astype(np.uint8))
    _png(str(indir / 'b.png'), (rng.random((18, 22, 3)) * 255).astype(np.uint8))
    assert jax_main([ckpts['pth'], str(indir), str(oj)]) == 0
    assert port_main([ckpts['pth'], str(indir), str(op), '--device', 'cpu']) == 0
    for name, mode in (('a.png', 'RGBA'), ('b.png', 'RGB')):
        (ma, ja), (mb, pb) = _read(oj / name), _read(op / name)
        assert ma == mb == mode and ja.shape == pb.shape
        assert int(np.abs(ja - pb).max()) <= 1


def test_cli_bf16_and_bad_args(tmp_path, ckpts):
    src = str(tmp_path / 'in.png')
    _png(src, (np.random.default_rng(3).random((16, 20, 3)) * 255).astype(np.uint8))
    assert port_main([ckpts['safetensors'], src, str(tmp_path / 'o.png'), '--device', 'cpu', '--bf16']) == 0
    assert _read(tmp_path / 'o.png')[1].shape == (32, 40, 3)
    assert port_main([ckpts['safetensors'], src, str(tmp_path / 'o.png'), '--device', 'cpu', '--tile', 'x']) == 1
    assert port_main([ckpts['safetensors'], src, str(tmp_path / 'o.png'), '--device', 'cpu', '--scale', '3']) == 1


def test_adapt_channels_matches_jax():
    rgb = np.random.default_rng(0).random((6, 7, 3)).astype(np.float32)
    rgba = np.concatenate([rgb, np.full((6, 7, 1), 0.5, np.float32)], axis=-1)
    for img in (rgb, rgba):
        for c in (1, 3, 4):
            (m1, a1), (m2, a2) = adapt_channels(img, c), jax_adapt(img, c)
            np.testing.assert_array_equal(m1, m2)
            assert (a1 is None and a2 is None) or np.array_equal(a1, a2)
    with pytest.raises(ValueError):
        adapt_channels(rgb, 2)
