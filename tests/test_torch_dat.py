"""The port's DAT (resselt_tpu_torch) against resselt_tpu on the same state
dicts (``zoo.make_dat``), on the CPU in f32, with test_dat.py's TOL (2e-3):
pixelshuffle x2 / x3 / x4 and pixelshuffledirect x4, splits (2, 4) and
(4, 8), the 1conv and 3conv residuals, four blocks in each of two groups
(so that both shift rules run: block 2 of an even group, blocks 0 and 4 of
an odd one) on test_dat.py's 18x22 input (the attention pads inside), with
weights strong enough that the attention matters; ``rect_attn_mask``
against the JAX function and the mask-window flags on it; each branch's
prepared position bias against the JAX MLP; config, metadata and serving
hints equal; the zoo's DAT-S layout; params carried across from a JAX model;
tiled and CLI output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel.tiling as jt
import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu.archs import dat as jdat
from resselt_tpu.nn.params import PTree as JPTree
from resselt_tpu.nn.window import rect_attn_mask as jax_rect_attn_mask
from resselt_tpu_torch.core import ModelMetadata, params_from_numpy
from resselt_tpu_torch.nn.window import multi_head_attention, rect_attn_mask
from resselt_tpu_torch.ops import window_attention as wa
from resselt_tpu_torch.zoo import make_dat


torch.set_num_threads(2)

TOL = 2e-3

_HINTS = ('tile_batch', 'serving_tile', 'serving_halo', 'size_multiple')


def strong(sd, seed, gain=0.7):
    """The layout of ``sd`` with weights of order ``gain`` / sqrt(fan in),
    norm scales and temperatures near one, and bias tables of order one, so
    that every branch moves the output; the geometry (``rpe_biases``,
    indices, masks) and BatchNorm statistics stay."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        if v.dtype.kind != 'f' or k.endswith(('rpe_biases', 'running_mean', 'running_var')) or '.attn_mask' in k:
            out[k] = v
        elif k.endswith('relative_position_bias_table'):
            out[k] = rng.standard_normal(v.shape).astype(np.float32)
        elif k.endswith('temperature') or ('norm' in k and k.endswith('weight')):
            out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif v.ndim >= 2:
            out[k] = (rng.standard_normal(v.shape) * gain / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
        else:
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def both(sd, x, arch: str, tol: float = TOL):
    """Load ``sd`` in both packages, check that they agree on the family,
    config, metadata and hints, and compare the forward on ``x``."""
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert tm.arch_id == jm.arch_id == arch
    assert tm.metadata == ModelMetadata(**vars(jm.metadata))
    assert tm.config.__dict__ == jm.config.__dict__
    assert all(getattr(tm, h) == getattr(jm, h) for h in _HINTS)
    want = np.asarray(jm(x))
    got = tm(x).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err < tol, f'max err {err}'
    return tm, jm


def _sd(upsampler='pixelshuffle', upscale=2, split=(2, 4), resi='1conv', depth=(4, 4), heads=(4, 2), seed=0):
    return strong(make_dat(24, depth, heads, split, 2.0, upscale, upsampler, resi, seed=seed), seed)


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('upsampler,upscale,split,resi,depth,heads', [
    ('pixelshuffle', 2, (2, 4), '1conv', (4, 4), (4, 2)),
    ('pixelshuffledirect', 4, (4, 8), '3conv', (4, 4), (2, 4)),
    ('pixelshuffle', 4, (4, 8), '1conv', (2,), (2,)),
    ('pixelshuffle', 3, (2, 4), '3conv', (5,), (4,)),
])
def test_dat_variants(upsampler, upscale, split, resi, depth, heads):
    tm, _ = both(_sd(upsampler, upscale, split, resi, depth, heads, seed=upscale), _x(18, 22), 'dat')
    assert tm.metadata == ModelMetadata(3, 3, upscale, 'DAT')
    cfg = tm.config
    assert (cfg.split_size, cfg.depth, cfg.num_heads, cfg.upsampler, cfg.resi_connection) == (
        split, depth, heads, upsampler, resi)
    assert (tm.tile_batch, tm.serving_tile, tm.serving_halo, tm.size_multiple) == (
        {'f32': 4, 'bf16': 8}, {'f32': 128, 'bf16': 96}, 8, max(split))


def test_attention_moves_the_output():
    """The parity above is a check of the window attention only if it
    matters: zeroing q in an unshifted and in a shifted spatial block (q
    reaches nothing else) moves the output."""
    sd = _sd(seed=4)
    x = _x(18, 22)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    for block in ('layers.0.blocks.0', 'layers.0.blocks.2', 'layers.1.blocks.0'):
        off = dict(sd)
        for part in ('weight', 'bias'):
            off[f'{block}.attn.qkv.{part}'] = sd[f'{block}.attn.qkv.{part}'].copy()
            off[f'{block}.attn.qkv.{part}'][:24] = 0
        without = resselt_tpu_torch.load_from_state_dict(off, device='cpu')(x)
        assert float((tm(x) - without).abs().max()) > 2 * TOL, block  # beyond the parity tolerance


@pytest.mark.parametrize('h,w,sp_h,sp_w', [(16, 32, 2, 4), (32, 16, 4, 2), (64, 64, 8, 16), (64, 64, 16, 8),
                                           (64, 96, 8, 32), (96, 64, 32, 8), (24, 24, 4, 4)])
def test_rect_attn_mask_matches_jax_and_flags_its_windows(h, w, sp_h, sp_w):
    got = rect_attn_mask(h, w, sp_h, sp_w, sp_h // 2, sp_w // 2)
    want = jax_rect_attn_mask(h, w, sp_h, sp_w, sp_h // 2, sp_w // 2)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    mask = torch.from_numpy(got)
    flags = wa.mask_window_flags(mask)
    assert torch.equal(flags.bool(), (mask != 0).flatten(1).any(1))
    rows, cols = h // sp_h, w // sp_w
    grid = flags.reshape(rows, cols).bool()  # row-major windows: the last row and column are cut
    assert bool(grid[-1].all()) and bool(grid[:, -1].all()) and not bool(grid[:-1, :-1].any())
    assert int(flags.sum()) == rows + cols - 1


def test_prepared_position_biases_match_the_jax_mlp():
    sd = _sd(split=(4, 8), seed=6)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    w32 = tm.weights(torch.float32)
    assert tm.weights(torch.float32) is w32
    for a, (sh, sw) in (('layers.1.blocks.2.attn.attns.0', (4, 8)), ('layers.1.blocks.2.attn.attns.1', (8, 4))):
        p = JPTree(jm.params).sub(a)
        pos = np.asarray(jdat._dyn_pos_bias(p.sub('pos'), jnp.asarray(p['rpe_biases']), 1))
        n = sh * sw
        want = pos[np.asarray(p['relative_position_index']).reshape(-1)].reshape(n, n, -1).transpose(2, 0, 1)
        got = w32[f'{a}.relative_position_bias']
        assert got.shape == (1, n, n) and got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    wb = tm.weights(torch.bfloat16)
    b = wb['layers.0.blocks.0.attn.attns.1.relative_position_bias']
    assert b.dtype == torch.float32 and torch.equal(b, b.to(torch.bfloat16).float())  # rounded to bf16
    assert wb['layers.0.blocks.0.attn.qkv.weight'].dtype == torch.bfloat16


def test_shift_masks_cached_and_cpu_counts_nothing():
    tm = resselt_tpu_torch.load_from_state_dict(_sd(split=(2, 4), seed=7), device='cpu')
    before = wa.window_mha.launches, multi_head_attention.plain_calls
    y32 = tm(_x(18, 22))
    masks = tm.weights(torch.float32)['shift_masks']
    # the image is padded to 20 x 24 inside; one mask per branch for every shifted block
    assert set(masks) == {('rect', 20, 24, 2, 4, 1, 2, 'cpu'), ('rect', 20, 24, 4, 2, 2, 1, 'cpu')}
    yb = tm(_x(18, 22), dtype=torch.bfloat16)
    assert (wa.window_mha.launches, multi_head_attention.plain_calls) == before
    assert yb.dtype == torch.bfloat16
    mse = float(((yb.float() - y32) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 35


def test_zoo_dat_s_full_width_layout():
    """DAT-S 4x: embed 180, depth and heads (6,) x 6, split (8, 16),
    expansion 2; the attn_mask buffers give img_size 64 and are dropped."""
    sd = make_dat()
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    cfg = tm.config
    assert cfg.__dict__ == resselt_tpu.load_from_state_dict(sd).config.__dict__
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.split_size) == (180, (6,) * 6, (6,) * 6, (8, 16))
    assert (cfg.expansion_factor, cfg.upsampler, cfg.resi_connection, cfg.img_size) == (2.0, 'pixelshuffle', '1conv', 64)
    assert sd['layers.0.blocks.0.attn.attns.0.pos.pos3.2.weight'].shape == (3, 5)
    assert sd['layers.0.blocks.0.attn.attns.1.rpe_biases'].shape == (31 * 15, 2)
    masks = [k for k in sd if '.attn_mask_' in k]
    assert len(masks) == 2 * 9 and not any('.attn_mask_' in k for k in tm.params)
    assert sd['layers.1.blocks.0.attn.attn_mask_1'].shape == (32, 128, 128)


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
    sd = _sd(split=(2, 4), seed=4)
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
