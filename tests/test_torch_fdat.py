"""The port's FDAT (resselt_tpu_torch) against resselt_tpu on the same state
dicts (``zoo.make_fdat``), on the CPU in f32, with test_fdat.py's TOL
(1e-3): the ten variants of test_fdat.py (every UniUpsampleV3 mode, the
unshuffle stem, scale 1 whose tail is one conv whatever MetaUpsample says)
on its 17x21 input (the spatial attention pads inside), and two groups of
four blocks with qkv biases and a mid width unlike the embedding's; weights
strong enough that both attentions matter; config, metadata and serving
hints equal; the prepared biases; the zoo's FDAT-M layout; params carried
across from a JAX model; tiled (FDAT's channel attention sees the whole
tile, so tiled output is held against JAX's tiled output at the same tile
and halo) and CLI output."""

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
from resselt_tpu_torch.zoo import make_fdat
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 1e-3


def _sd(upsampler='pixelshuffledirect', scale=2, unshuffle=False, groups=1, depth_per_group=1, mid=32,
        qkv_bias=False, seed=0):
    return strong(make_fdat(32, groups, depth_per_group, 4, 8, 1.5, 8, mid, upsampler, scale, unshuffle,
                            qkv_bias=qkv_bias, seed=seed), seed)


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('upsampler,scale,unshuffle', [
    ('pixelshuffledirect', 2, False),
    ('transpose+conv', 4, False),
    ('transpose+conv', 2, False),
    ('pa_up', 4, False),
    ('lda', 2, False),
    ('dysample', 2, False),
    ('pixelshuffledirect', 2, True),
    ('conv', 1, False),
    ('dysample', 1, False),
    ('lda', 1, False),
])
def test_fdat_variants(upsampler, scale, unshuffle):
    tm, _ = both(_sd(upsampler, scale, unshuffle, seed=scale), _x(17, 21), 'FDAT', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'FDAT')
    cfg = tm.config
    assert (cfg.embed_dim, cfg.num_groups, cfg.depth, cfg.num_heads, cfg.window_size) == (32, 1, 2, 4, 8)
    assert (cfg.upsampler_type, cfg.unshuffle_mod, cfg.mid_dim, cfg.ffn_expansion_ratio) == (
        upsampler, unshuffle, 32, 1.5)
    assert (tm.tile_batch, tm.serving_tile, tm.serving_halo, tm.size_multiple) == (2, 128, 8, 16 if unshuffle else 8)
    assert 'upsampler.MetaUpsample' not in tm.params


@pytest.mark.parametrize('upsampler,scale', [('dysample', 4), ('lda', 2), ('nearest+conv', 3)])
def test_fdat_two_groups_with_qkv_bias_and_a_narrow_mid(upsampler, scale):
    tm, _ = both(_sd(upsampler, scale, groups=2, depth_per_group=2, mid=24, qkv_bias=True, seed=5), _x(17, 21),
                 'FDAT', TOL)
    assert (tm.config.num_groups, tm.config.depth, tm.config.mid_dim) == (2, 4, 24)


def test_attention_moves_the_output():
    """Zeroing q in a spatial and in a channel block moves the output beyond
    the parity tolerance."""
    sd = _sd('pixelshuffledirect', 2, groups=1, depth_per_group=2, seed=4)
    x = _x(17, 21)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    for block in ('groups.0.blocks.0', 'groups.0.blocks.1', 'groups.0.blocks.2'):
        off = dict(sd)
        off[f'{block}.attn.qkv.weight'] = sd[f'{block}.attn.qkv.weight'].copy()
        off[f'{block}.attn.qkv.weight'][:32] = 0
        without = resselt_tpu_torch.load_from_state_dict(off, device='cpu')(x)
        assert float((tm(x) - without).abs().max()) > 2 * TOL, block


def test_prepared_biases_and_cpu_counts_nothing():
    sd = _sd('transpose+conv', 2, groups=2, depth_per_group=2, seed=6)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    w32 = tm.weights(torch.float32)
    assert tm.weights(torch.float32) is w32
    keys = sorted(k for k in w32 if k.endswith('relative_position_bias'))
    assert keys == [f'groups.{g}.blocks.{b}.attn.relative_position_bias' for g in (0, 1) for b in (0, 2)]
    for k in keys:
        assert w32[k].shape == (4, 64, 64) and w32[k].dtype == torch.float32 and w32[k].is_contiguous()
        assert torch.equal(w32[k], torch.from_numpy(sd[k.replace('relative_position_bias', 'bias')]))
    wb = tm.weights(torch.bfloat16)
    b = wb[keys[0]]
    assert b.dtype == torch.float32 and torch.equal(b, b.to(torch.bfloat16).float())  # rounded to bf16
    assert wb['groups.0.blocks.0.attn.qkv.weight'].dtype == torch.bfloat16
    before = wa.window_mha.launches, multi_head_attention.plain_calls
    y32 = tm(_x(17, 21))
    yb = tm(_x(17, 21), dtype=torch.bfloat16)
    assert (wa.window_mha.launches, multi_head_attention.plain_calls) == before
    assert yb.dtype == torch.bfloat16
    mse = float(((yb.float() - y32) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 35


def test_zoo_fdat_m_full_width_layout():
    """FDAT-M 4x, the reference class defaults: embed 120, 4 groups of 3 x
    (spatial, channel), 4 heads, window 8, ffn 2.0, AIM reduction 8, mid 64,
    transpose+conv; 12 spatial blocks, each a (4, 64, 64) bias."""
    sd = make_fdat()
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    cfg = tm.config
    assert cfg.__dict__ == resselt_tpu.load_from_state_dict(sd).config.__dict__
    assert (cfg.embed_dim, cfg.num_groups, cfg.depth, cfg.num_heads, cfg.window_size) == (120, 4, 6, 4, 8)
    assert (cfg.ffn_expansion_ratio, cfg.aim_reduction_ratio, cfg.mid_dim, cfg.upsampler_type, cfg.scale) == (
        2.0, 8, 64, 'transpose+conv', 4)
    biases = [k for k in sd if k.endswith('.attn.bias')]
    assert len(biases) == 12 and all(sd[k].shape == (4, 64, 64) for k in biases)
    assert sd['upsampler.MetaUpsample'].tolist() == [3, 5, 4, 120, 3, 64, 4]
    assert sd['upsampler.MetaUpsample'].dtype == np.uint8
    assert sd['upsampler.0.weight'].shape == (120, 64, 4, 4) and sd['upsampler.2.weight'].shape == (64, 64, 4, 4)


def test_params_from_numpy_carries_jax_params():
    sd = _sd('dysample', 2, seed=10)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, 'cpu')
    assert set(carried) == set(tm.params)
    x = _x(11, 9)
    want = np.asarray(jm(x))
    got = tm.apply(carried, torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) < TOL


@pytest.mark.parametrize('unshuffle', [False, True], ids=['plain', 'unshuffle'])
def test_tiled_matches_jax(unshuffle):
    sd = _sd('pixelshuffledirect', 2, unshuffle, seed=4)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    halo = tt._resolve_halo_hint(tm, 16, torch.float32)
    assert halo == jt._resolve_halo_hint(jm, 16, np.float32)
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
    write_safetensors(_sd('transpose+conv', 2, seed=8), ckpt)
    src = str(tmp_path / 'in.png')
    Image.fromarray((np.random.default_rng(8).random((30, 38, 3)) * 255).astype(np.uint8)).save(src)
    a, b = str(tmp_path / 'jax.png'), str(tmp_path / 'port.png')
    assert jax_main([ckpt, src, a, *extra]) == 0
    assert port_main([ckpt, src, b, '--device', 'cpu', *extra]) == 0
    ja, pb = (np.asarray(Image.open(p)).astype(np.int16) for p in (a, b))
    assert ja.shape == pb.shape == (60, 76, 3)
    assert int(np.abs(ja - pb).max()) <= 1
