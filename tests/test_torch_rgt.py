"""The port's RGT (resselt_tpu_torch) against resselt_tpu on the same state
dicts (``zoo.make_rgt``), on the CPU in f32, with test_rgt.py's TOL (2e-3):
a square split (4, 4) and non-square ones ((2, 8), (4, 8)) through
``_get_split_size``, the 1conv and 3conv residuals, x2 / x3 / x4, on
test_rgt.py's 64x64 and odd 50x38 inputs (RG_SA needs 16 pixels a side),
with weights strong enough that both attentions matter; the loader's
``_get_split_size`` against the JAX function; config, metadata and serving
hints equal; the zoo's RGT-S layout; params carried across from a JAX
model; tiled and CLI output.  The window branches are DAT's
(tests/test_torch_dat.py)."""

import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel.tiling as jt
import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu.archs import rgt as jrgt
from resselt_tpu_torch.archs import rgt as trgt
from resselt_tpu_torch.core import ModelMetadata, params_from_numpy
from resselt_tpu_torch.zoo import make_rgt
from tests.test_torch_dat import both, strong


torch.set_num_threads(2)

TOL = 2e-3


def _sd(split=(4, 4), upscale=2, resi='1conv', depth=(4,), heads=(4,), seed=0):
    return strong(make_rgt(24, depth, heads, split, 2.0, 0.5, upscale, resi, seed=seed), seed)


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('split,upscale,resi,depth,heads,hw', [
    ((4, 4), 2, '1conv', (4,), (4,), (64, 64)),
    ((2, 8), 4, '1conv', (2, 4), (2, 4), (50, 38)),
    ((4, 8), 3, '3conv', (5,), (2,), (50, 38)),
])
def test_rgt_variants(split, upscale, resi, depth, heads, hw):
    tm, _ = both(_sd(split, upscale, resi, depth, heads, seed=upscale), _x(*hw), 'RGT')
    assert tm.metadata == ModelMetadata(3, 3, upscale, 'RGT')
    cfg = tm.config
    assert (cfg.split_size, cfg.depth, cfg.num_heads, cfg.resi_connection, cfg.c_ratio) == (
        split, depth, heads, resi, 0.5)
    assert (tm.tile_batch, tm.serving_tile, tm.serving_halo, tm.size_multiple) == (
        2, {'f32': 128, 'bf16': 160}, 8, max(split))


def test_both_attentions_move_the_output():
    """Zeroing q in an L_SA block (the window branches) or an RG_SA block
    (the recursive cross-attention) moves the output."""
    sd = _sd(seed=4)
    x = _x(32, 48)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    for key, rows in (('layers.0.blocks.0.attn.qkv', 24), ('layers.0.blocks.2.attn.qkv', 24),
                      ('layers.0.blocks.1.attn.q', 12)):
        off = dict(sd)
        for part in ('weight', 'bias'):
            off[f'{key}.{part}'] = sd[f'{key}.{part}'].copy()
            off[f'{key}.{part}'][:rows] = 0
        without = resselt_tpu_torch.load_from_state_dict(off, device='cpu')(x)
        assert float((tm(x) - without).abs().max()) > 2 * TOL, key  # beyond the parity tolerance


def test_get_split_size_matches_jax():
    from resselt_tpu_torch.nn.window import relative_position_index
    from resselt_tpu_torch.zoo import rpe_biases

    def sd_for(a, b):
        return {'layers.0.blocks.0.attn.attns.0.relative_position_index': np.zeros((a, a), np.int64),
                'layers.0.blocks.0.attn.attns.0.rpe_biases': np.zeros((b, 2), np.float32)}

    for sh, sw in ((4, 4), (8, 8), (2, 8), (8, 32), (32, 8), (4, 16), (16, 16)):
        sd = {'layers.0.blocks.0.attn.attns.0.relative_position_index': relative_position_index(sh, sw),
              'layers.0.blocks.0.attn.attns.0.rpe_biases': rpe_biases(sh, sw)}
        assert trgt._get_split_size(sd) == jrgt._get_split_size(sd) == (min(sh, sw), max(sh, sw))
    for a, b in ((12, 35), (7, 9)):  # (3, 4): no power-of-two pair; no solution at all
        with pytest.raises(ValueError):
            jrgt._get_split_size(sd_for(a, b))
        with pytest.raises(ValueError):
            trgt._get_split_size(sd_for(a, b))


def test_zoo_rgt_s_full_width_layout():
    """RGT-S 4x: embed 180, depth and heads (6,) x 6, split (8, 32), mlp
    ratio 2, c_ratio 0.5; the attn_mask buffers are dropped."""
    sd = make_rgt()
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    cfg = tm.config
    assert cfg.__dict__ == resselt_tpu.load_from_state_dict(sd).config.__dict__
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.split_size) == (180, (6,) * 6, (6,) * 6, (8, 32))
    assert (cfg.mlp_ratio, cfg.c_ratio, cfg.upscale, cfg.resi_connection) == (2.0, 0.5, 4, '1conv')
    assert sd['layers.0.blocks.1.attn.conv.weight'].shape == (90, 180, 1, 1)
    assert not any('.attn_mask_' in k for k in tm.params) and any('.attn_mask_' in k for k in sd)


def test_prepared_weights_and_bfloat16():
    tm = resselt_tpu_torch.load_from_state_dict(_sd((2, 8), seed=6), device='cpu')
    wb = tm.weights(torch.bfloat16)
    bias = wb['layers.0.blocks.0.attn.attns.1.relative_position_bias']
    assert bias.shape == (2, 16, 16) and torch.equal(bias, bias.to(torch.bfloat16).float())
    y32 = tm(_x(32, 40))
    yb = tm(_x(32, 40), dtype=torch.bfloat16)
    assert yb.dtype == torch.bfloat16
    mse = float(((yb.float() - y32) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 35


def test_params_from_numpy_carries_jax_params():
    sd = _sd(seed=10)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, 'cpu')
    assert set(carried) == set(tm.params)
    x = _x(19, 17)
    want = np.asarray(jm(x))
    got = tm.apply(carried, torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) < TOL


def test_tiled_matches_jax():
    sd = _sd((2, 8), seed=4)
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
