"""The port's PLKSR / RealPLKSR (resselt_tpu_torch) against resselt_tpu on
the same state dicts, on the CPU in f32, with test_conv_archs.py's TOL
(5e-4): every lk_type and ccm_type, EA on and off, RealPLKSR with and
without DySample at scales 2/3/4 (scale 3 takes the groups = C DySample
branch); config, metadata and serving halo equal; detection; the zoo's
state dicts; params carried across from a JAX model; tiled and CLI
output."""

import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel.tiling as jt
import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu.zoo import make_plksr as jax_make_plksr
from resselt_tpu_torch.core import ModelMetadata, params_from_numpy
from resselt_tpu_torch.ops import fused_conv as fc
from resselt_tpu_torch.zoo import make_esrgan, make_plksr, make_realplksr


torch.set_num_threads(2)

TOL = 5e-4

_CCM = {'CCM': (3, 1), 'DCCM': (3, 3), 'ICCM': (1, 3)}


def _plksr_sd(ccm='DCCM', lk_type='PLK', use_ea=True, dim=16, pdim=8, n_blocks=2, scale=2, k=9, seed=0):
    """A PLKSR state dict in the reference's key layout for any mixer and
    large-kernel variant (SparsePLK: three dilated convs; RectSparsePLK:
    k x k/3, k/3 x k and k/3 x k/3 convs)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, cout, cin, kh, kw=None):
        sd[f'{key}.weight'] = (rng.standard_normal((cout, cin, kh, kw or kh)) * 0.05).astype(np.float32)
        sd[f'{key}.bias'] = (rng.standard_normal(cout) * 0.05).astype(np.float32)

    d, pk = dim, pdim
    conv('feats.0', d, 3, 3)
    m0, m2 = _CCM[ccm]
    for i in range(1, n_blocks + 1):
        conv(f'feats.{i}.channe_mixer.0', 2 * d, d, m0)
        conv(f'feats.{i}.channe_mixer.2', d, 2 * d, m2)
        if lk_type == 'PLK':
            conv(f'feats.{i}.lk.conv', pk, pk, k)
        elif lk_type == 'SparsePLK':
            for j, kj in enumerate((5, 3, 3)):
                conv(f'feats.{i}.lk.convs.{j}', pk, pk, kj)
        else:
            conv(f'feats.{i}.lk.mn_conv', pk, pk, k, k // 3)
            conv(f'feats.{i}.lk.nm_conv', pk, pk, k // 3, k)
            conv(f'feats.{i}.lk.nn_conv', pk, pk, k // 3)
        if use_ea:
            conv(f'feats.{i}.attn.f.0', d, d, 3)
        conv(f'feats.{i}.refine', d, d, 1)
    conv(f'feats.{n_blocks + 1}', 3 * scale * scale, d, 3)
    return sd


def _both(sd, x):
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert tm.arch_id == jm.arch_id == 'PLKSR'
    assert tm.metadata == ModelMetadata(**vars(jm.metadata))
    assert tm.config.__dict__ == jm.config.__dict__
    assert tm.serving_halo == jm.serving_halo == 4
    want = np.asarray(jm(x))
    got = tm(x).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err < TOL, f'max err {err}'
    return tm, jm


def _x(h, w, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


# pdim 8 takes the lk kernel's path (its plain version here), pdim 4 the plain conv
@pytest.mark.parametrize('lk_type,ccm,use_ea,k,pdim', [
    ('PLK', 'CCM', True, 9, 8), ('PLK', 'DCCM', True, 17, 8), ('PLK', 'ICCM', True, 5, 8), ('PLK', 'DCCM', False, 13, 8),
    ('PLK', 'DCCM', True, 7, 4), ('SparsePLK', 'DCCM', True, 9, 4), ('RectSparsePLK', 'DCCM', True, 9, 4),
    ('RectSparsePLK', 'CCM', False, 15, 8),
])
def test_plksr(lk_type, ccm, use_ea, k, pdim):
    sd = _plksr_sd(ccm, lk_type, use_ea, pdim=pdim, k=k, seed=k)
    tm, _ = _both(sd, _x(14, 13))
    assert (tm.config.lk_type, tm.config.ccm_type, tm.config.use_ea) == (lk_type, ccm, use_ea)
    assert tm.metadata == ModelMetadata(3, 3, 2, 'PLKSR')


@pytest.mark.parametrize('dys,use_ea,scale', [(False, True, 4), (True, True, 2), (False, False, 2),
                                              (True, False, 3), (True, True, 4), (False, True, 3)])
def test_realplksr(dys, use_ea, scale):
    sd = make_realplksr(16, 2, scale, kernel_size=9, split_ratio=0.5, use_ea=use_ea, dysample=dys, seed=scale)
    tm, _ = _both(sd, _x(12, 10))
    assert tm.metadata.name == 'RealPLKSR' and tm.config.dys is dys and tm.config.variant == 'realplksr'


def test_zoo_make_plksr_is_the_jax_one():
    a, b = make_plksr(16, 2, 4, kernel_size=9, seed=3), jax_make_plksr(16, 2, 4, kernel_size=9, seed=3)
    assert list(a) == list(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_zoo_plksr_full_width_layout():
    sd = make_plksr(64, 2, 4)
    assert sd['feats.1.lk.conv.weight'].shape == (16, 16, 17, 17)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert tm.config.__dict__ == resselt_tpu.load_from_state_dict(sd).config.__dict__


def test_detection_esrgan_and_plksr():
    for sd, arch, name in ((make_esrgan(16, 1, 2, gc=8), 'ESRGAN', 'ESRGAN'), (make_plksr(16, 1, 2), 'PLKSR', 'PLKSR'),
                           (make_realplksr(16, 1, 2), 'PLKSR', 'RealPLKSR')):
        tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
        jm = resselt_tpu.load_from_state_dict(sd)
        assert tm.arch_id == jm.arch_id == arch and tm.metadata.name == jm.metadata.name == name
    # the port registers its families in the JAX package's order
    port = [a.id for a in resselt_tpu_torch.archs.internal_registry]
    assert port == [a.id for a in resselt_tpu.archs.internal_registry if a.id in port]


def test_params_from_numpy_carries_jax_params():
    sd = make_plksr(16, 2, 2, kernel_size=7, seed=10)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, 'cpu')
    assert set(carried) == set(tm.params)
    x = _x(11, 9)
    want = np.asarray(jm(x))
    got = tm.apply(carried, torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) < TOL


@pytest.mark.parametrize('make', ['plksr', 'realplksr_dys'])
def test_tiled_matches_jax(make):
    sd = make_plksr(16, 1, 2, kernel_size=9, split_ratio=0.5, seed=4) if make == 'plksr' else \
        make_realplksr(16, 1, 2, kernel_size=9, split_ratio=0.5, dysample=True, seed=4)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    # tile 16 at the loader's halo (4): a 3 x 3 grid of 24 x 24 windows
    assert tt._resolve_halo_hint(tm, 16, torch.float32) == jt._resolve_halo_hint(jm, 16, np.float32) == 4
    want = np.asarray(jt.upscale_tiled(jm, img, tile=16, batch_size=4))
    got = tt.upscale_tiled(tm, img, tile=16, batch_size=4).numpy()
    assert got.shape == want.shape == (80, 92, 3)
    assert float(np.abs(got - want).max()) < TOL


def test_prepared_lk_weights_and_cpu_launch_count():
    tm = resselt_tpu_torch.load_from_state_dict(make_plksr(16, 2, 2, kernel_size=9, split_ratio=0.5, seed=6),
                                                device='cpu')
    w32 = tm.weights(torch.float32)
    assert tm.weights(torch.float32) is w32
    taps, bias = w32['feats.1.lk.conv.lk_kernel']
    assert taps.shape == (81, 8, 8) and bias.dtype == torch.float32
    wb = tm.weights(torch.bfloat16)
    assert wb['feats.1.lk.conv.lk_kernel'][0].dtype == wb['feats.1.refine.weight'].dtype == torch.bfloat16
    # split 0.25 of dim 16 puts 4 channels in the partial conv, outside the kernel's shapes
    plain = resselt_tpu_torch.load_from_state_dict(make_plksr(16, 1, 2, kernel_size=9), device='cpu')
    assert not any(k.endswith('lk_kernel') for k in plain.weights(torch.float32))
    before = fc.fused_conv_lk.launches
    y32 = tm(_x(10, 12))
    yb = tm(_x(10, 12), dtype=torch.bfloat16)
    assert fc.fused_conv_lk.launches == before
    assert yb.dtype == torch.bfloat16
    mse = float(((yb.float() - y32) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 35


@pytest.mark.parametrize('make,extra', [('plksr', []), ('realplksr_dys', ['--tile', '24'])], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, make, extra):
    from PIL import Image

    from resselt_tpu.upscale import main as jax_main
    from resselt_tpu_torch.io import write_safetensors
    from resselt_tpu_torch.upscale import main as port_main

    sd = make_plksr(16, 1, 2, kernel_size=9, split_ratio=0.5, seed=7) if make == 'plksr' else \
        make_realplksr(16, 1, 2, kernel_size=9, split_ratio=0.5, dysample=True, seed=7)
    ckpt = str(tmp_path / 'm.safetensors')
    write_safetensors(sd, ckpt)
    src = str(tmp_path / 'in.png')
    Image.fromarray((np.random.default_rng(8).random((40, 46, 3)) * 255).astype(np.uint8)).save(src)
    a, b = str(tmp_path / 'jax.png'), str(tmp_path / 'port.png')
    assert jax_main([ckpt, src, a, *extra]) == 0
    assert port_main([ckpt, src, b, '--device', 'cpu', *extra]) == 0
    ja, pb = (np.asarray(Image.open(p)).astype(np.int16) for p in (a, b))
    assert ja.shape == pb.shape == (80, 92, 3)
    assert int(np.abs(ja - pb).max()) <= 1
