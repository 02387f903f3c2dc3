"""The port's OmniSR (resselt_tpu_torch) against resselt_tpu on the same state
dicts (``zoo.make_omni``), on the CPU in f32, with test_omni.py's TOL
(1e-3): test_omni.py's two variants (the relative-position bias on and off,
scales 2 and 4, one and two residual groups) on its 22x18 input (constant
pad to the window), a window of 4 read from the bias table, scale 3 and a
model without conv biases; weights strong enough that both window
attentions matter; config and metadata equal, and the profiling keys
dropped; the prepared biases (the table's gather, or zeros); the zoo's
published OmniSR layout; params carried across from a JAX model; tiled and
CLI output.  Also the eight window transformers (swinir, hat, omni, drct,
fdat, dat, rgt, atd) detected as themselves in both packages, and the
port's registration order against JAX's."""

import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel.tiling as jt
import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu_torch.core import ModelMetadata, params_from_numpy
from resselt_tpu_torch.nn.window import multi_head_attention, relative_position_index
from resselt_tpu_torch.ops import window_attention as wa
from resselt_tpu_torch.zoo import (make_atd, make_dat, make_drct, make_fdat, make_hat, make_omni, make_rgt,
                                   make_swinir)
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 1e-3


def _sd(pe=True, scale=2, res_num=1, window=8, bias=True, block_num=1, seed=0):
    return strong(make_omni(16, block_num, pe, window, res_num, scale, bias, seed=seed), seed)


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('pe,scale,res_num,window,bias,block_num', [
    (True, 2, 1, 8, True, 1), (False, 4, 2, 8, True, 1),  # tests/test_omni.py's
    (True, 3, 1, 4, True, 2), (True, 2, 2, 8, False, 1), (False, 1, 1, 8, True, 1),
])
def test_omni_variants(pe, scale, res_num, window, bias, block_num):
    tm, _ = both(_sd(pe, scale, res_num, window, bias, block_num, seed=scale), _x(22, 18), 'OmniSR', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'OmniSR')
    cfg = tm.config
    assert (cfg.num_feat, cfg.block_num, cfg.pe, cfg.window_size, cfg.res_num, cfg.up_scale, cfg.bias) == (
        16, block_num, pe, window if pe else 8, res_num, scale, bias)
    assert (tm.tile_batch, tm.serving_tile, tm.serving_halo, tm.size_multiple) == (None, None, None, None)


def test_profiling_keys_are_dropped():
    sd = _sd(seed=2)
    sd['total_ops'] = np.zeros((1,), np.float64)
    sd['residual_layer.0.esa.conv1.total_params'] = np.zeros((1,), np.float64)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert tm.arch_id == 'OmniSR' and not any(k.endswith(('total_ops', 'total_params')) for k in tm.params)
    assert set(tm.params) == set(resselt_tpu.load_from_state_dict(sd).params)


def test_attention_moves_the_output():
    """Zeroing q in the block and in the grid attention moves the output
    beyond the parity tolerance."""
    sd = _sd(seed=4)
    x = _x(22, 18)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    for layer in ('2', '8'):
        key = f'residual_layer.0.residual_layer.0.layer.{layer}.fn.to_qkv.weight'
        off = dict(sd)
        off[key] = sd[key].copy()
        off[key][:16] = 0
        without = resselt_tpu_torch.load_from_state_dict(off, device='cpu')(x)
        assert float((tm(x) - without).abs().max()) > 2 * TOL, layer


@pytest.mark.parametrize('pe', [True, False])
def test_prepared_biases_and_cpu_counts_nothing(pe):
    sd = _sd(pe, res_num=2, seed=6)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    w32 = tm.weights(torch.float32)
    keys = sorted(k for k in w32 if k.endswith('relative_position_bias'))
    assert keys == sorted(f'residual_layer.{r}.residual_layer.0.layer.{a}.fn.relative_position_bias'
                          for r in (0, 1) for a in (2, 8))
    rpi = relative_position_index(8, 8)
    for k in keys:
        got = w32[k]
        assert got.shape == (4, 64, 64) and got.dtype == torch.float32 and got.is_contiguous()
        if pe:
            table = sd[k.replace('relative_position_bias', 'rel_pos_bias.weight')]
            np.testing.assert_array_equal(got.numpy(), table[rpi.reshape(-1)].reshape(64, 64, 4).transpose(2, 0, 1))
        else:
            assert not bool(got.any())
    b = tm.weights(torch.bfloat16)[keys[0]]
    assert b.dtype == torch.float32 and torch.equal(b, b.to(torch.bfloat16).float())  # rounded to bf16
    before = wa.window_mha.launches, multi_head_attention.plain_calls
    y32 = tm(_x(22, 18))
    yb = tm(_x(22, 18), dtype=torch.bfloat16)
    assert (wa.window_mha.launches, multi_head_attention.plain_calls) == before
    assert yb.dtype == torch.bfloat16
    mse = float(((yb.float() - y32) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 35


def test_zoo_omni_full_width_layout():
    """The published OmniSR 4x: num_feat 64, one OSA block in each of five
    groups, window 8 with the relative-position bias (a (225, 4) table),
    4 heads of 16."""
    sd = make_omni()
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    cfg = tm.config
    assert cfg.__dict__ == resselt_tpu.load_from_state_dict(sd).config.__dict__
    assert (cfg.num_feat, cfg.block_num, cfg.pe, cfg.window_size, cfg.res_num, cfg.up_scale, cfg.bias) == (
        64, 1, True, 8, 5, 4, True)
    tables = [k for k in sd if k.endswith('rel_pos_bias.weight')]
    assert len(tables) == 10 and all(sd[k].shape == (225, 4) for k in tables)
    assert sd['up.0.weight'].shape == (48, 64, 3, 3)


def test_params_from_numpy_carries_jax_params():
    sd = _sd(seed=10)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, 'cpu')
    assert set(carried) == set(tm.params)
    x = _x(11, 9)
    want = np.asarray(jm(x))
    got = tm.apply(carried, torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) < TOL


def test_tiled_matches_jax():
    sd = _sd(seed=4)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tt._resolve_halo_hint(tm, 16, torch.float32) == jt._resolve_halo_hint(jm, 16, np.float32)
    want = np.asarray(jt.upscale_tiled(jm, img, tile=16))
    got = tt.upscale_tiled(tm, img, tile=16).numpy()
    assert got.shape == want.shape == (80, 92, 3)
    assert float(np.abs(got - want).max()) < TOL


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    from PIL import Image

    from resselt_tpu.upscale import main as jax_main
    from resselt_tpu_torch.io import write_safetensors
    from resselt_tpu_torch.upscale import main as port_main

    ckpt = str(tmp_path / 'm.safetensors')
    write_safetensors(_sd(seed=8), ckpt)
    src = str(tmp_path / 'in.png')
    Image.fromarray((np.random.default_rng(8).random((30, 38, 3)) * 255).astype(np.uint8)).save(src)
    a, b = str(tmp_path / 'jax.png'), str(tmp_path / 'port.png')
    assert jax_main([ckpt, src, a, *extra]) == 0
    assert port_main([ckpt, src, b, '--device', 'cpu', *extra]) == 0
    ja, pb = (np.asarray(Image.open(p)).astype(np.int16) for p in (a, b))
    assert ja.shape == pb.shape == (60, 76, 3)
    assert int(np.abs(ja - pb).max()) <= 1


_TRANSFORMERS = [
    ('swinir', lambda: make_swinir(24, (2,), (3,), 8, upscale=2, img_size=32), 'SwinIR', 'SwinIR'),
    ('hat', lambda: make_hat(24, (2,), (3,), 8, upscale=2), 'HAT', 'HAT'),
    ('omni', lambda: make_omni(16, 1, True, 8, 1, 2), 'OmniSR', 'OmniSR'),
    ('omni_no_pe', lambda: make_omni(16, 1, False, 8, 1, 4, bias=False), 'OmniSR', 'OmniSR'),
    ('drct', lambda: make_drct(24, 1, 3, 8, 8, 2.0, 2, img_size=32), 'DRCT', 'DRCT'),
    ('fdat', lambda: make_fdat(32, 1, 1, 4, 8, 1.5, 8, 32, 'pixelshuffledirect', 2), 'FDAT', 'FDAT'),
    ('fdat_unshuffle', lambda: make_fdat(32, 1, 1, 4, 8, 1.5, 8, 32, 'lda', 2, unshuffle=True), 'FDAT', 'FDAT'),
    ('dat', lambda: make_dat(24, (2,), (2,), (2, 4), 2.0, 2), 'dat', 'DAT'),
    ('rgt', lambda: make_rgt(24, (2,), (2,), (4, 4), 2.0, 0.5, 2), 'RGT', 'RGT'),
    ('atd', lambda: make_atd(24, (2,), (3,), 8, upscale=2), 'ATD', 'ATD'),
]


@pytest.mark.parametrize('family,make,arch,name', _TRANSFORMERS, ids=[t[0] for t in _TRANSFORMERS])
def test_eight_window_transformers_detect_as_themselves(family, make, arch, name):
    """Each of the eight window transformers (swinir, hat, omni, drct, fdat,
    dat, rgt, atd, in the JAX package's order) is detected as itself, and
    only as itself, in both packages."""
    sd = make()
    hits = [a.id for a in resselt_tpu_torch.archs.internal_registry if a.detect(sd)]
    assert hits == [a.id for a in resselt_tpu.archs.internal_registry if a.detect(sd)] == [arch]
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    jm = resselt_tpu.load_from_state_dict(sd)
    assert tm.arch_id == jm.arch_id == arch and tm.metadata.name == jm.metadata.name == name


def test_registration_order_is_jax_order():
    """The port's families, in the JAX package's order; the eight window
    transformers first."""
    port = [a.id for a in resselt_tpu_torch.archs.internal_registry]
    assert port == [a.id for a in resselt_tpu.archs.internal_registry if a.id in port]
    assert port == ['SwinIR', 'HAT', 'OmniSR', 'DRCT', 'FDAT', 'dat', 'RGT', 'ATD', 'SpanPP', 'SPAN', 'ESRGAN', 'PLKSR',
                    'MoSRv2', 'MoESR', 'RTMoSR', 'SMoSR', 'RHA', 'FlexNet', 'GateRV3', 'GateRv2', 'LAWFFT',
                    'GFISRV2', 'FIGSR', 'GFISR', 'GateR', 'CuGAN', 'RCAN', 'eimn', 'MoSR', 'Compact', 'spanplus']
    assert [t[2] for t in _TRANSFORMERS if '_' not in t[0]] == port[:8]
