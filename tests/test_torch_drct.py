"""The port's DRCT (resselt_tpu_torch) against resselt_tpu on the same state
dicts (``zoo.make_drct``), on the CPU in f32, with test_drct.py's TOL
(2e-3): x2 and x4 at window 8 on test_drct.py's 21x19 input (reflect pad to
the window), with the ``attn_mask`` buffers of a 32-pixel ``img_size`` (the
second and fourth blocks of a group shifted) and without them (``img_size``
falls to the window and every shift is off), and a width whose later
blocks' head_dim exceeds the kernel's (the plain path); weights strong
enough that the attention matters; config, metadata and serving hints
equal; the zoo's DRCT layout at full width; params carried across from a
JAX model; tiled and CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel.tiling as jt
import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu_torch.core import ModelMetadata, params_from_numpy
from resselt_tpu_torch.nn.window import multi_head_attention
from resselt_tpu_torch.ops import window_attention as wa
from resselt_tpu_torch.zoo import make_drct
from tests.test_torch_dat import both, strong


torch.set_num_threads(2)

TOL = 2e-3


def _sd(upscale=2, attn_masks=True, embed=24, heads=3, gc=8, layers=2, seed=0):
    # gain 1: the dense groups' 0.2 residual scale damps the blocks more than DAT's and RGT's stacks
    return strong(make_drct(embed, layers, heads, 8, gc, 2.0, upscale, img_size=32, attn_masks=attn_masks,
                            seed=seed), seed, gain=1.0)


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('upscale,attn_masks', [(2, True), (4, True), (2, False), (4, False)])
def test_drct_variants(upscale, attn_masks):
    tm, _ = both(_sd(upscale, attn_masks, seed=upscale), _x(21, 19), 'DRCT')
    assert tm.metadata == ModelMetadata(3, 3, upscale, 'DRCT')
    cfg = tm.config
    assert (cfg.embed_dim, cfg.num_layers, cfg.num_heads, cfg.window_size, cfg.gc) == (24, 2, (3, 3), 8, 8)
    assert (cfg.img_size, cfg.resi_connection, cfg.upsampler) == (32 if attn_masks else 8, '1conv', 'pixelshuffle')
    assert (tm.tile_batch, tm.serving_tile, tm.serving_halo, tm.size_multiple) == (
        1, {'f32': 96, 'bf16': 128}, 8, 8)


def test_drct_with_plain_path_blocks():
    """Embed 128, two heads, gc 16: swin1 at head_dim 64 on the kernel's
    path, swin2..5 at 72..96 on the plain path (on the CPU both run the
    plain versions; the split is what the card counts)."""
    tm, _ = both(_sd(2, embed=128, heads=2, gc=16, layers=1, seed=7), _x(21, 19), 'DRCT')
    assert tm.config.num_heads == (2,)


def test_attention_moves_the_output():
    """Zeroing q in an unshifted and in a shifted block moves the output."""
    sd = _sd(seed=4)
    x = _x(21, 19)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    for key, rows in (('layers.0.swin1.attn.qkv', 24), ('layers.1.swin2.attn.qkv', 32), ('layers.1.swin4.attn.qkv', 48)):
        off = dict(sd)
        for part in ('weight', 'bias'):
            off[f'{key}.{part}'] = sd[f'{key}.{part}'].copy()
            off[f'{key}.{part}'][:rows] = 0
        without = resselt_tpu_torch.load_from_state_dict(off, device='cpu')(x)
        assert float((tm(x) - without).abs().max()) > 2 * TOL, key  # beyond the parity tolerance


def test_prepared_biases_masks_and_cpu_counts_nothing():
    tm = resselt_tpu_torch.load_from_state_dict(_sd(seed=6), device='cpu')
    w32 = tm.weights(torch.float32)
    for k, heads in ((1, 3), (2, 1), (3, 2), (4, 3), (5, 1)):  # 3 - width % 3 heads at 24 + (k - 1) 8 channels
        bias = w32[f'layers.1.swin{k}.attn.relative_position_bias']
        assert bias.shape == (heads, 64, 64) and bias.dtype == torch.float32 and bias.is_contiguous()
    before = wa.window_mha.launches, multi_head_attention.plain_calls
    y32 = tm(_x(20, 28))
    assert set(w32['shift_masks']) == {(24, 32, 8, 4, 'cpu')}  # swin2 and swin4 share it
    yb = tm(_x(20, 28), dtype=torch.bfloat16)
    assert (wa.window_mha.launches, multi_head_attention.plain_calls) == before
    assert yb.dtype == torch.bfloat16
    mse = float(((yb.float() - y32) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 35


def test_zoo_drct_full_width_layout():
    """DRCT 4x: embed 180, six groups, 6 heads, window 16, gc 32, mlp ratio
    2; the blocks' heads 6 / 4 / 2 / 6 / 4 (head_dim 30 / 53 / 122 / 46 /
    77); the attn_mask buffers give img_size 64 and are dropped."""
    sd = make_drct()
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    cfg = tm.config
    assert cfg.__dict__ == resselt_tpu.load_from_state_dict(sd).config.__dict__
    assert (cfg.embed_dim, cfg.num_layers, cfg.num_heads, cfg.window_size, cfg.gc) == (180, 6, (6,) * 6, 16, 32)
    assert (cfg.img_size, cfg.upscale) == (64, 4)
    heads = [sd[f'layers.0.swin{k}.attn.relative_position_bias_table'].shape[1] for k in range(1, 6)]
    assert heads == [6, 4, 2, 6, 4]
    assert [(180 + 32 * k) // h for k, h in enumerate(heads)] == [30, 53, 122, 46, 77]
    masks = [k for k in sd if k.endswith('.attn_mask')]
    assert len(masks) == 12 and sd[masks[0]].shape == (16, 256, 256) and not set(masks) & set(tm.params)


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
