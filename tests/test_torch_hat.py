"""The port's HAT (resselt_tpu_torch) against resselt_tpu on the same state
dicts (``zoo.make_hat``), on the CPU in f32, with test_hat.py's TOL (2e-3):
that test's three parameter sets (x2 and x4 at window 8, x2 at window 16;
embed 24, depths (2, 2), heads (3, 3), compress 3, squeeze 8, overlap 0.5)
on its 21x19 input (reflect pad to the window), with weights strong enough
that the attention matters; ``_overlap_windows`` alone against the JAX
function; the loader's ``_get_overlap_ratio`` and ``_inv_int_div``, with
their float cases; ``img_size`` from ``absolute_pos_embed`` and the
'identity' residual; config, metadata and serving hints equal; the zoo's
state dicts; params carried across from a JAX model; tiled and CLI
output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel.tiling as jt
import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu.archs import hat as jhat
from resselt_tpu.zoo import make_hat as jax_make_hat
from resselt_tpu_torch.archs import hat as that
from resselt_tpu_torch.core import ModelMetadata, params_from_numpy
from resselt_tpu_torch.ops import window_mha
from resselt_tpu_torch.zoo import make_hat


torch.set_num_threads(2)

TOL = 2e-3

_HINTS = ('tile_batch', 'serving_tile', 'serving_halo', 'size_multiple')


def _strong(sd, seed):
    """The layout of ``sd`` with weights of order 1 / sqrt(fan in) and norm
    scales near one, so that every branch moves the output."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        if v.dtype.kind != 'f':
            out[k] = v
        elif k.endswith('relative_position_bias_table'):
            out[k] = rng.standard_normal(v.shape).astype(np.float32)
        elif v.ndim >= 2:
            out[k] = (rng.standard_normal(v.shape) * 0.7 / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
        elif 'norm' in k and k.endswith('weight'):
            out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def _sd(upscale=2, window=8, overlap=0.5, seed=0, **kw):
    return _strong(make_hat(24, (2, 2), (3, 3), window, overlap, 3, 8, 2.0, upscale, seed=seed, **kw), seed)


def _both(sd, x):
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert tm.arch_id == jm.arch_id == 'HAT'
    assert tm.metadata == ModelMetadata(**vars(jm.metadata))
    assert tm.config.__dict__ == jm.config.__dict__
    assert all(getattr(tm, h) == getattr(jm, h) for h in _HINTS)
    want = np.asarray(jm(x))
    got = tm(x).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err < TOL, f'max err {err}'
    return tm, jm


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('upscale,window,overlap', [(2, 8, 0.5), (4, 8, 0.5), (2, 16, 0.5), (2, 8, 0.25)])
def test_hat_variants(upscale, window, overlap):
    tm, _ = _both(_sd(upscale, window, overlap, seed=upscale + window), _x(21, 19))
    assert tm.metadata == ModelMetadata(3, 3, upscale, 'HAT')
    cfg = tm.config
    assert (cfg.window_size, cfg.overlap_win_size) == (window, window + int(overlap * window))
    assert (cfg.compress_ratio, cfg.squeeze_factor, cfg.conv_scale, cfg.mlp_ratio) == (3, 8, 0.01, 2.0)
    assert (cfg.resi_connection, cfg.num_feat, cfg.img_size) == ('1conv', 32, 64)
    assert (tm.tile_batch, tm.serving_tile, tm.serving_halo, tm.size_multiple) == (2, 192, 16, window)


def test_attention_moves_the_output():
    """The parity above is a check of the attention only if it matters."""
    sd = _sd(2, 8, seed=4)
    x = _x(21, 19)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    for part in ('blocks.0.attn.proj', 'overlap_attn.proj.weight'):
        off = {k: np.zeros_like(v) if part in k else v for k, v in sd.items()}
        without = resselt_tpu_torch.load_from_state_dict(off, device='cpu')(x)
        assert float((tm(x) - without).abs().max()) > 0.02, part


def test_hat_identity_resi_and_img_size():
    sd = _sd(2, 8, seed=5)
    sd = {k: v for k, v in sd.items() if not (k.startswith('conv_after_body') or k in (
        'layers.0.conv.weight', 'layers.0.conv.bias', 'layers.1.conv.weight', 'layers.1.conv.bias'))}
    sd['absolute_pos_embed'] = np.zeros((1, 48 * 48, 24), np.float32)
    tm, _ = _both(sd, _x(16, 24))
    assert tm.config.resi_connection == 'identity' and tm.config.img_size == 48


@pytest.mark.parametrize('ws,owin,h,w', [(8, 12, 16, 24), (16, 24, 32, 16), (8, 10, 8, 16), (4, 8, 8, 12)])
def test_overlap_windows_match_jax(ws, owin, h, w):
    kv = np.random.default_rng(owin).standard_normal((2, h, w, 6)).astype(np.float32)
    want = np.asarray(jhat._overlap_windows(jnp.asarray(kv), ws, owin))
    got = that._overlap_windows(torch.from_numpy(kv), ws, owin)
    assert got.shape == want.shape == (2 * (h // ws) * (w // ws), owin * owin, 6)
    assert np.array_equal(got.numpy(), want)


def test_loader_helpers_match_jax():
    for ws in (7, 8, 12, 16):
        for with_overlap in range(ws, 2 * ws + 2):
            assert that._get_overlap_ratio(ws, with_overlap) == jhat._get_overlap_ratio(ws, with_overlap)
    assert that._get_overlap_ratio(16, 24) == 0.5
    # integer quotients, ceil / floor cases, the float cases, and no answer
    for a, c in ((180, 60), (144, 6), (180, 7), (144, 24), (60, 7), (50, 3), (10, 4), (96, 36), (7, 5), (3, 2)):
        try:
            want = jhat._inv_int_div(a, c)
        except ValueError:
            with pytest.raises(ValueError):
                that._inv_int_div(a, c)
            continue
        got = that._inv_int_div(a, c)
        assert got == want and type(got) is type(want) and a // got == c


def test_zoo_make_hat_is_the_jax_one():
    for kw in (dict(), dict(embed_dim=36, depths=(2, 3), num_heads=(3, 6), window_size=16, overlap_ratio=0.25,
                            compress_ratio=3, squeeze_factor=12, mlp_ratio=1.5, upscale=4, num_feat=16, seed=5)):
        a, b = make_hat(**kw), jax_make_hat(**kw)
        assert list(a) == list(b)
        assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def test_zoo_hat_s_full_width_layout():
    """HAT-S 4x: embed 144, depths and heads (6,) x 6, window 16, overlap
    0.5, compress 24, squeeze 24, mlp ratio 2, 64 features."""
    sd = make_hat(144, (6,) * 6, (6,) * 6, 16, 0.5, 24, 24, 2.0, 4, num_feat=64)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    cfg = tm.config
    assert cfg.__dict__ == resselt_tpu.load_from_state_dict(sd).config.__dict__
    assert (cfg.embed_dim, cfg.depths, cfg.num_heads, cfg.window_size) == (144, (6,) * 6, (6,) * 6, 16)
    assert (cfg.overlap_win_size, cfg.compress_ratio, cfg.squeeze_factor, cfg.num_feat) == (24, 24, 24, 64)
    assert sd['relative_position_index_OCA'].shape == (256, 576)
    assert tm.params['relative_position_index_OCA'].dtype == torch.int64


def test_hat_l_published_layout():
    """HAT-L 4x (``options/test/HAT-L_SRx4_ImageNet-pretrain.yml``): embed
    180, 12 groups of 6 blocks, 6 heads, window 16, overlap 0.5, compress 3,
    squeeze 30, mlp ratio 2, 64 features, 1conv.  The port infers the
    configuration and the serving hints that JAX infers."""
    sd = make_hat(180, (6,) * 12, (6,) * 12, 16, 0.5, 3, 30, 2.0, 4, num_feat=64)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    jm = resselt_tpu.load_from_state_dict(sd)
    cfg = tm.config
    assert cfg.__dict__ == jm.config.__dict__
    assert (cfg.embed_dim, cfg.depths, cfg.num_heads, cfg.window_size) == (180, (6,) * 12, (6,) * 12, 16)
    assert (cfg.overlap_win_size, cfg.compress_ratio, cfg.squeeze_factor, cfg.num_feat) == (24, 3, 30, 64)
    assert (cfg.resi_connection, cfg.mlp_ratio, cfg.conv_scale, cfg.upscale) == ('1conv', 2.0, 0.01, 4)
    assert all(getattr(tm, h) == getattr(jm, h) for h in _HINTS)
    assert (tm.tile_batch, tm.serving_tile, tm.serving_halo, tm.size_multiple) == (2, 192, 16, 16)
    assert sum(int(np.prod(v.shape)) for k, v in sd.items() if 'relative_position_index' not in k) == 40_846_215


def test_params_from_numpy_carries_jax_params():
    sd = _sd(2, 8, seed=10)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, 'cpu')
    assert set(carried) == set(tm.params)
    assert not carried['relative_position_index_OCA'].is_floating_point()  # JAX holds it as int32
    x = _x(11, 9)
    want = np.asarray(jm(x))
    got = tm.apply(carried, torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) < TOL


def test_tiled_matches_jax():
    sd = _sd(2, 8, seed=4)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    # tile 16 off the hint: halo 16 makes 48x48 windows, multiples of the
    # window size; two windows a batch (tile_batch 2)
    assert tt._resolve_halo_hint(tm, 16, torch.float32) == jt._resolve_halo_hint(jm, 16, np.float32) == 16
    want = np.asarray(jt.upscale_tiled(jm, img, tile=16))
    got = tt.upscale_tiled(tm, img, tile=16).numpy()
    assert got.shape == want.shape == (80, 92, 3)
    assert float(np.abs(got - want).max()) < TOL


def test_prepared_biases_masks_and_cpu_launch_count():
    tm = resselt_tpu_torch.load_from_state_dict(_sd(2, 8, seed=6), device='cpu')
    w32 = tm.weights(torch.float32)
    assert tm.weights(torch.float32) is w32
    sa = w32['layers.1.residual_group.blocks.1.attn.relative_position_bias']
    oca = w32['layers.1.residual_group.overlap_attn.relative_position_bias']
    assert sa.shape == (3, 64, 64) and oca.shape == (3, 64, 144)
    assert sa.dtype == oca.dtype == torch.float32 and sa.is_contiguous() and oca.is_contiguous()
    table = tm.params['layers.1.residual_group.overlap_attn.relative_position_bias_table']
    rpi = tm.params['relative_position_index_OCA']
    assert torch.equal(oca[2, 5, 100], table[rpi[5, 100], 2])
    wb = tm.weights(torch.bfloat16)
    assert torch.equal(wb['layers.1.residual_group.overlap_attn.relative_position_bias'],
                       oca.to(torch.bfloat16).float())
    assert wb['layers.0.residual_group.blocks.0.attn.qkv.weight'].dtype == torch.bfloat16
    before = window_mha.launches
    y32 = tm(_x(20, 28))
    assert set(w32['shift_masks']) == {(24, 32, 8, 4, 'cpu')}  # one mask for every shifted block
    yb = tm(_x(20, 28), dtype=torch.bfloat16)
    assert window_mha.launches == before
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
    write_safetensors(_sd(2, 8, seed=8), ckpt)
    src = str(tmp_path / 'in.png')
    Image.fromarray((np.random.default_rng(8).random((40, 46, 3)) * 255).astype(np.uint8)).save(src)
    a, b = str(tmp_path / 'jax.png'), str(tmp_path / 'port.png')
    assert jax_main([ckpt, src, a, *extra]) == 0
    assert port_main([ckpt, src, b, '--device', 'cpu', *extra]) == 0
    ja, pb = (np.asarray(Image.open(p)).astype(np.int16) for p in (a, b))
    assert ja.shape == pb.shape == (80, 92, 3)
    assert int(np.abs(ja - pb).max()) <= 1
