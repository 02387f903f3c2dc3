"""``ops/conv_route.py``, the one rule that sends a conv of the six 3x3-conv
families (Compact, SPAN, SPANPlus, MoSR, SpanPP, RCAN) to the 3x3 kernel:
which convs it routes, what ``prepare_convs`` keeps, and that its plain
path is ``F.conv2d`` plus the activation.  Also the helpers the six
families' test files share (each family's routed convs counted on the CPU,
parity of tiled and CLI output with resselt_tpu), and the twenty-three
ported families detected as themselves in both packages, registered in
JAX's order."""

import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel.tiling as jt
import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu_torch.nn import functional as F
from resselt_tpu_torch.ops import conv_route as cr
from resselt_tpu_torch.ops import fused_conv as fc
from resselt_tpu_torch.zoo import (make_atd, make_compact, make_cugan, make_dat, make_drct, make_eimn, make_esrgan,
                                   make_fdat, make_gater, make_gaterv2, make_gaterv3, make_hat, make_moesr, make_mosr,
                                   make_mosrv2, make_omni, make_plksr, make_rcan, make_rgt, make_span, make_spanplus,
                                   make_spanpp, make_swinir)


torch.set_num_threads(2)


# -- helpers of the six families' tests -------------------------------------------


class RoutedCalls:
    """Records every conv that ``conv_route.conv`` sends to the 3x3
    kernel's wrapper, as (cin, cout, act), then calls the wrapper: on the
    CPU the wrapper counts nothing, so this is how a CPU test reads the
    launches a forward would make on the card."""

    def __init__(self, monkeypatch):
        self.calls = []
        wrapped = cr.fused_conv3x3_act

        def record(x, w, b=None, act='linear'):
            self.calls.append((x.shape[-1], w.shape[-1], act))
            return wrapped(x, w, b, act)

        monkeypatch.setattr(cr, 'fused_conv3x3_act', record)

    def acts(self) -> dict:
        out = {}
        for _, _, act in self.calls:
            out[act] = out.get(act, 0) + 1
        return out


def tiled_both(sd, img, tile, halo=None, tol=5e-4, overrides=None):
    """``upscale_tiled`` in both packages on ``img`` agree within ``tol``
    (``overrides``: ``with_config`` fields for both models)."""
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    if overrides:
        jm, tm = jm.with_config(**overrides), tm.with_config(**overrides)
    assert tt._resolve_halo_hint(tm, tile, torch.float32) == jt._resolve_halo_hint(jm, tile, np.float32)
    want = np.asarray(jt.upscale_tiled(jm, img, tile=tile, halo=halo))
    got = tt.upscale_tiled(tm, img, tile=tile, halo=halo).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) < tol
    return got


def cli_both(tmp_path, sd, extra, hw=(30, 38)):
    """The two CLIs on one PNG give pixels within 1 of each other; returns
    the output shape."""
    from PIL import Image

    from resselt_tpu.upscale import main as jax_main
    from resselt_tpu_torch.io import write_safetensors
    from resselt_tpu_torch.upscale import main as port_main

    ckpt = str(tmp_path / 'm.safetensors')
    write_safetensors(sd, ckpt)
    src = str(tmp_path / 'in.png')
    Image.fromarray((np.random.default_rng(8).random((*hw, 3)) * 255).astype(np.uint8)).save(src)
    a, b = str(tmp_path / 'jax.png'), str(tmp_path / 'port.png')
    assert jax_main([ckpt, src, a, *extra]) == 0
    assert port_main([ckpt, src, b, '--device', 'cpu', *extra]) == 0
    ja, pb = (np.asarray(Image.open(p)).astype(np.int16) for p in (a, b))
    assert ja.shape == pb.shape
    assert int(np.abs(ja - pb).max()) <= 1
    return ja.shape


def carried_params_match(sd, x, tol=5e-4):
    """``params_from_numpy`` carries a JAX model's params across: the port's
    ``apply`` on them matches the JAX forward."""
    from resselt_tpu_torch.core import params_from_numpy

    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, 'cpu')
    assert set(carried) == set(tm.params)
    want = np.asarray(jm(x))
    got = tm.apply(carried, torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) < tol


# -- the rule ------------------------------------------------------------------------


@pytest.mark.parametrize('shape,groups,routed', [
    ((64, 64, 3, 3), 1, True), ((12, 48, 3, 3), 1, True), ((64, 3, 3, 3), 1, True),
    ((64, 64, 1, 1), 1, False), ((64, 1, 7, 7), 64, False), ((64, 64, 5, 5), 1, False),
    ((64, 1, 3, 3), 64, False), ((64, 64, 3, 1), 1, False),
])
def test_routes_to_kernel(shape, groups, routed):
    assert cr.routes_to_kernel(shape, groups) is routed


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_prepare_convs_packs_the_routed_and_casts_the_rest(dtype):
    g = torch.Generator().manual_seed(0)
    params = {'a.weight': torch.randn(8, 4, 3, 3, generator=g), 'a.bias': torch.randn(8, generator=g),
              'b.weight': torch.randn(8, 8, 1, 1, generator=g), 'b.bias': torch.randn(8, generator=g),
              'dw.weight': torch.randn(8, 1, 3, 3, generator=g), 'n.weight': torch.randn(8, generator=g),
              'idx': torch.arange(3)}
    w = cr.prepare_convs(params, dtype, {'dw': 8})
    assert set(w) == {'a', 'a.bias', 'b', 'b.weight', 'b.bias', 'dw', 'dw.weight', 'n.weight', 'idx'}
    assert w['a'].kernel and w['a'].w.shape == (9, 4, 8) and w['a'].w.dtype == dtype
    assert w['a'].b.dtype == torch.float32 and torch.equal(w['a'].w, fc.pack_conv3x3_weight(params['a.weight'], dtype))
    assert not w['b'].kernel and w['b'].padding == (0, 0) and w['b'].w.dtype == dtype
    assert not w['dw'].kernel and (w['dw'].padding, w['dw'].groups) == ((1, 1), 8)
    assert w['n.weight'].dtype == dtype and w['idx'].dtype == torch.int64


@pytest.mark.parametrize('act', ['linear', 'lrelu', 'silu', 'mish'])
def test_conv_plain_path_and_kernel_path_on_the_cpu(act):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 9, 11, 8, generator=g)
    w3, b3 = torch.randn(16, 8, 3, 3, generator=g) / 8, torch.randn(16, generator=g)
    w1 = torch.randn(16, 8, 1, 1, generator=g) / 3
    ref_act = {'linear': lambda y: y, 'lrelu': lambda y: F.leaky_relu(y, 0.2), 'silu': F.silu, 'mish': F.mish}[act]
    got = cr.conv(cr.prepare_conv(w3, b3, torch.float32), x, act)
    want = ref_act(F.conv2d(x, w3, b3, padding=1))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got = cr.conv(cr.prepare_conv(w1, None, torch.float32), x, act)
    torch.testing.assert_close(got, ref_act(F.conv2d(x, w1)), rtol=0, atol=0)
    before = fc.fused_conv3x3_act.launches
    cr.conv(cr.prepare_conv(w3, b3, torch.bfloat16), x.bfloat16(), act)
    assert fc.fused_conv3x3_act.launches == before  # the CPU runs the plain version and counts nothing


def test_prelu_and_dysample_scale_match_jax():
    from resselt_tpu.core.state_dict import dysample_scale as jax_dysample_scale
    from resselt_tpu.nn import functional as JF
    from resselt_tpu_torch.core.state_dict import dysample_scale

    x = np.random.default_rng(2).standard_normal((2, 5, 6, 4)).astype(np.float32)
    for w in (np.asarray([0.25], np.float32), np.asarray([0.1, -0.5, 2.0, 0.0], np.float32)):
        want = np.asarray(JF.prelu(x, w))
        np.testing.assert_array_equal(F.prelu(torch.from_numpy(x), torch.from_numpy(w)).numpy(), want)
    assert [dysample_scale(n) for n in (8, 32, 72, 128)] == [jax_dysample_scale(n) for n in (8, 32, 72, 128)] == [
        1, 2, 3, 4]


# -- detection and registration of the twenty-three families ------------------------------

_FAMILIES = [
    ('swinir', lambda: make_swinir(24, (2,), (3,), 8, upscale=2, img_size=32), 'SwinIR', 'SwinIR'),
    ('hat', lambda: make_hat(24, (2,), (3,), 8, upscale=2), 'HAT', 'HAT'),
    ('omni', lambda: make_omni(16, 1, True, 8, 1, 2), 'OmniSR', 'OmniSR'),
    ('drct', lambda: make_drct(24, 1, 3, 8, 8, 2.0, 2, img_size=32), 'DRCT', 'DRCT'),
    ('fdat', lambda: make_fdat(32, 1, 1, 4, 8, 1.5, 8, 32, 'pixelshuffledirect', 2), 'FDAT', 'FDAT'),
    ('dat', lambda: make_dat(24, (2,), (2,), (2, 4), 2.0, 2), 'dat', 'DAT'),
    ('rgt', lambda: make_rgt(24, (2,), (2,), (4, 4), 2.0, 0.5, 2), 'RGT', 'RGT'),
    ('atd', lambda: make_atd(24, (2,), (3,), 8, upscale=2), 'ATD', 'ATD'),
    ('spanpp', lambda: make_spanpp(16, implicit_dim=32, latent_layers=2), 'SpanPP', 'SpanPP'),
    ('span', lambda: make_span(16, 2), 'SPAN', 'SPAN'),
    ('esrgan', lambda: make_esrgan(16, 1, 2, gc=8), 'ESRGAN', 'ESRGAN'),
    ('plksr', lambda: make_plksr(16, 1, 2), 'PLKSR', 'PLKSR'),
    ('mosrv2', lambda: make_mosrv2(16, 2, 2), 'MoSRv2', 'MoSRv2'),
    ('moesr', lambda: make_moesr(16, 2, 2, 2, upsample_dim=16), 'MoESR', 'MoESR'),
    ('gaterv3', lambda: make_gaterv3(16, (1, 1), (1, 1), 1, span_blocks=1), 'GateRV3', 'GateRV3'),
    ('gaterv2', lambda: make_gaterv2(16, (1, 1), (1, 1), 1), 'GateRv2', 'GateRv2'),
    ('gater', lambda: make_gater(16), 'GateR', 'GateR'),
    ('cugan', lambda: make_cugan('2x'), 'CuGAN', 'CUGAN'),
    ('rcan', lambda: make_rcan(16, 2, 2, 4, 2), 'RCAN', 'RCAN'),
    ('eimn', lambda: make_eimn(16, 1, 1, 1.5, 2), 'eimn', 'EIMN'),
    ('mosr', lambda: make_mosr(16, 2, 2), 'MoSR', 'MoSR'),
    ('compact', lambda: make_compact(16, 2, 2), 'Compact', 'Compact'),
    ('spanplus', lambda: make_spanplus(16, (2,), 2), 'spanplus', 'SPANPlus'),
    ('span_no_norm', lambda: make_span(16, 2, norm=False), 'SPAN', 'SPAN'),
    ('rcan_unshuffle', lambda: make_rcan(16, 1, 1, 4, 1, unshuffle=True), 'RCAN', 'RCAN'),
    ('mosr_gps', lambda: make_mosr(16, 1, 4, upsampler='gps'), 'MoSR', 'MoSR'),
    ('spanplus_dys', lambda: make_spanplus(16, (1,), 2, upsampler='dys'), 'spanplus', 'SPANPlus'),
    ('cugan_3x_pro', lambda: make_cugan('3x', True), 'CuGAN', 'CUGAN'),
    ('cugan_4x', lambda: make_cugan('4x'), 'CuGAN', 'CUGAN'),
    ('cugan_2x_fast', lambda: make_cugan('2x_fast'), 'CuGAN', 'CUGAN'),
    ('gater_latent_att', lambda: make_gater(16, latent_att=True), 'GateR', 'GateR'),
    ('mosrv2_unshuffle_ln', lambda: make_mosrv2(16, 2, 2, unshuffle_mod=True, rms_norm=False), 'MoSRv2', 'MoSRv2'),
    ('gaterv2_sr', lambda: make_gaterv2(16, (1, 1), (1, 1), 1, 2), 'GateRv2', 'GateRv2'),
    ('gaterv3_attention_dysample', lambda: make_gaterv3(16, (1, 1), (1, 1), 1, 2, upsampler='dysample',
                                                        upsample_mid_dim=16, span_blocks=1, end_kernel=3),
     'GateRV3', 'GateRV3'),
]


@pytest.mark.parametrize('family,make,arch,name', _FAMILIES, ids=[f[0] for f in _FAMILIES])
def test_seventeen_families_detect_as_themselves(family, make, arch, name):
    """Each ported family is detected as itself, and only as itself, in
    both packages."""
    sd = make()
    hits = [a.id for a in resselt_tpu_torch.archs.internal_registry if a.detect(sd)]
    assert hits == [a.id for a in resselt_tpu.archs.internal_registry if a.detect(sd)] == [arch]
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    jm = resselt_tpu.load_from_state_dict(sd)
    assert tm.arch_id == jm.arch_id == arch and tm.metadata.name == jm.metadata.name == name


def test_registration_order_is_jax_order():
    port = [a.id for a in resselt_tpu_torch.archs.internal_registry]
    assert port == [a.id for a in resselt_tpu.archs.internal_registry]
    assert [f[2] for f in _FAMILIES[:23]] == [a for a in port if a in {f[2] for f in _FAMILIES}]
    assert len(port) == 31 and port[-1] == 'spanplus'  # its one-key fingerprint comes last
