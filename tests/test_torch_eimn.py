"""The port's EIMN (resselt_tpu_torch) against resselt_tpu on the same
state dicts (``zoo.make_eimn``), on the CPU in f32, with test_rcan_eimn.py's
TOL (5e-4): test_rcan_eimn.py's shape (embed 16, 2 stages x 2 blocks, mlp
1.5, 2x; outside the MOLRCM kernel's gate) and EIMN_L's width (embed 64,
mlp 2.66, 4x; inside it, so ``prepare`` packs every block's MOLRCM) on
images that are not multiples of the kernel's tile; config, metadata and
the float mlp_ratio equal; detection (ESRGAN, PLKSR and SwinIR still
detect as themselves); params carried across from a JAX model; tiled and
CLI output; the inference BatchNorm and silu."""

import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel.tiling as jt
import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu_torch.core import ModelMetadata, params_from_numpy
from resselt_tpu_torch.ops import molrcm as mo
from resselt_tpu_torch.zoo import make_eimn, make_esrgan, make_plksr, make_swinir


torch.set_num_threads(2)

TOL = 5e-4

SMALL = dict(embed_dims=16, num_stages=2, depths=2, mlp_ratio=1.5, scale=2)
WIDE = dict(embed_dims=64, num_stages=2, depths=1, mlp_ratio=2.66, scale=4)


def _x(h, w, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


def _both(sd, x):
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert tm.arch_id == jm.arch_id == 'eimn'
    assert tm.metadata == ModelMetadata(**vars(jm.metadata))
    assert tm.config.__dict__ == jm.config.__dict__
    want = np.asarray(jm(x))
    got = tm(x).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err < TOL, f'max err {err}'
    return tm, jm


@pytest.mark.parametrize('cfg,hw', [(SMALL, (12, 14)), (WIDE, (12, 14)), (WIDE, (19, 5))],
                         ids=['embed16', 'embed64', 'embed64_narrow'])
def test_eimn_matches_jax(cfg, hw):
    tm, _ = _both(make_eimn(**cfg, seed=cfg['scale']), _x(*hw))
    d = cfg['embed_dims']
    assert tm.metadata == ModelMetadata(3, 3, cfg['scale'], 'EIMN')
    assert tm.config.mlp_ratio == 2 * int(d * cfg['mlp_ratio']) // 2 / d
    packed = [k for k in tm.weights(torch.float32) if k.endswith('.attn.molrcm')]
    assert len(packed) == (cfg['num_stages'] * cfg['depths'] if d == 64 else 0)


def test_eimn_l_config_inference():
    """The reference's eimn() defaults (EIMN_L): hidden 170, so the float
    mlp_ratio read back is 340 // 2 / 64; 16 stages of one block."""
    sd = make_eimn()
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert tm.config.__dict__ == resselt_tpu.load_from_state_dict(sd).config.__dict__
    assert (tm.config.embed_dims, tm.config.num_stages, tm.config.depths, tm.config.scale) == (64, 16, 1, 4)
    assert tm.config.mlp_ratio == 2.65625 and int(64 * tm.config.mlp_ratio) == 170
    assert sd['block16.0.mlp.SAL.weight'].shape == (340, 1, 3, 3)
    assert sd['block1.0.norm1.num_batches_tracked'].shape == () and (sd['block3.0.norm2.running_var'] >= 0.5).all()
    assert mo.molrcm_supported(tm.config.embed_dims, 256, 256)


def test_detection_with_eimn_registered():
    for sd, arch, name in ((make_eimn(**SMALL), 'eimn', 'EIMN'), (make_eimn(**WIDE), 'eimn', 'EIMN'),
                           (make_esrgan(16, 1, 2, gc=8), 'ESRGAN', 'ESRGAN'), (make_plksr(16, 1, 2), 'PLKSR', 'PLKSR'),
                           (make_swinir(24, (2,), (3,), 8, upscale=2, img_size=32), 'SwinIR', 'SwinIR')):
        tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
        jm = resselt_tpu.load_from_state_dict(sd)
        assert tm.arch_id == jm.arch_id == arch and tm.metadata.name == jm.metadata.name == name
    # the port registers its families in the JAX package's order
    port = [a.id for a in resselt_tpu_torch.archs.internal_registry]
    assert port == [a.id for a in resselt_tpu.archs.internal_registry if a.id in port]
    assert port == ['SwinIR', 'HAT', 'OmniSR', 'DRCT', 'FDAT', 'dat', 'RGT', 'ATD', 'SpanPP', 'SPAN', 'ESRGAN', 'PLKSR',
                    'MoSRv2', 'MoESR', 'RTMoSR', 'SMoSR', 'RHA', 'FlexNet', 'GateRV3', 'GateRv2', 'LAWFFT',
                    'GFISRV2', 'FIGSR', 'GFISR', 'GateR', 'CuGAN', 'RCAN', 'eimn', 'MoSR', 'Compact', 'spanplus']


def test_params_from_numpy_carries_jax_params():
    sd = make_eimn(**WIDE, seed=7)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, 'cpu')
    assert set(carried) == set(tm.params)
    x = _x(11, 9, seed=1)
    want = np.asarray(jm(x))
    got = tm.apply(carried, torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) < TOL


def test_tiled_matches_jax():
    """DFFM's global mean makes tiled differ from whole-image in both
    packages, so tiled is compared with tiled, on the same grid (the
    default halo 16 for a model without hints)."""
    sd = make_eimn(**WIDE, seed=4)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(5).random((40, 70, 3), dtype=np.float32)
    assert tt._resolve_halo_hint(tm, 16, torch.float32) == jt._resolve_halo_hint(jm, 16, np.float32) == 16
    want = np.asarray(jt.upscale_tiled(jm, img, tile=16))
    got = tt.upscale_tiled(tm, img, tile=16).numpy()
    assert got.shape == want.shape == (160, 280, 3)
    assert float(np.abs(got - want).max()) < TOL


def test_prepare_packs_casts_and_cpu_launches_nothing():
    tm = resselt_tpu_torch.load_from_state_dict(make_eimn(**WIDE, seed=6), device='cpu')
    wb = tm.weights(torch.bfloat16)
    assert tm.weights(torch.bfloat16) is wb
    packed = wb['block2.0.attn.molrcm']
    assert packed.dtype == torch.float32 and packed.shape == (mo.packed_size(64),)
    wq = tm.params['block2.0.attn.proj_query.0.weight']
    assert torch.equal(mo._unpack(packed, 64)['wq'], wq.to(torch.bfloat16).float().reshape(64, 64))
    assert wb['block1.0.mlp.SAL.weight'].dtype == torch.bfloat16
    assert wb['block1.0.norm1.num_batches_tracked'].dtype == torch.int64
    before = mo.fused_molrcm.launches
    x = _x(20, 28, seed=2)
    y32 = tm(x)
    yb = tm(x, dtype=torch.bfloat16)
    assert mo.fused_molrcm.launches == before
    assert yb.dtype == torch.bfloat16
    mse = float(((yb.float() - y32) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 35


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    from PIL import Image

    from resselt_tpu.upscale import main as jax_main
    from resselt_tpu_torch.io import write_safetensors
    from resselt_tpu_torch.upscale import main as port_main

    ckpt = str(tmp_path / 'm.safetensors')
    write_safetensors(make_eimn(**SMALL, seed=8), ckpt)
    src = str(tmp_path / 'in.png')
    Image.fromarray((np.random.default_rng(8).random((40, 46, 3)) * 255).astype(np.uint8)).save(src)
    a, b = str(tmp_path / 'jax.png'), str(tmp_path / 'port.png')
    assert jax_main([ckpt, src, a, *extra]) == 0
    assert port_main([ckpt, src, b, '--device', 'cpu', *extra]) == 0
    ja, pb = (np.asarray(Image.open(p)).astype(np.int16) for p in (a, b))
    assert ja.shape == pb.shape == (80, 92, 3)
    assert int(np.abs(ja - pb).max()) <= 1


def test_batch_norm_and_silu_match_jax():
    from resselt_tpu.nn import functional as JF
    from resselt_tpu_torch.nn import functional as TF

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 7, 16)).astype(np.float32)
    w, b, m = (rng.standard_normal(16).astype(np.float32) for _ in range(3))
    v = (rng.random(16) + 0.5).astype(np.float32)
    want = np.asarray(JF.batch_norm_2d(x, w, b, m, v))
    got = TF.batch_norm_2d(*map(torch.from_numpy, (x, w, b, m, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TF.silu(torch.from_numpy(x)).numpy(), np.asarray(JF.silu(x)), rtol=1e-6, atol=1e-6)
