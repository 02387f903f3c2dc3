"""The 31-family detection matrix, in both packages: a numpy state dict of
each family (and of its other layouts: unshuffle stems, other tails, other
pipelines), from the port's zoo and, where it has one, the JAX package's
zoo, is detected as its own family, and only as it, by every detection
condition of resselt_tpu's and of resselt_tpu_torch's registry, and loads
as it in both; both registries list the same 31 ids in the same order, and
the port's ``_ARCH_MODULES`` is the JAX package's.  No torch oracle is
imported: every dict comes from a numpy builder."""

import pytest
import torch

import resselt_tpu
import resselt_tpu.archs
import resselt_tpu.zoo as jzoo
import resselt_tpu_torch
import resselt_tpu_torch.archs
from resselt_tpu_torch import zoo


torch.set_num_threads(2)

# (label, builder, the family's id, the metadata name), in resselt_tpu's registration order
_MATRIX = [
    ('swinir', lambda: zoo.make_swinir(24, (2,), (3,), 8, upscale=2, img_size=32), 'SwinIR', 'SwinIR'),
    ('swinir_jax_zoo', lambda: jzoo.make_swinir(24, (2,), (3,), 8, upscale=2), 'SwinIR', 'SwinIR'),
    ('hat', lambda: zoo.make_hat(24, (2,), (3,), 8, upscale=2), 'HAT', 'HAT'),
    ('omni', lambda: zoo.make_omni(16, 1, True, 8, 1, 2), 'OmniSR', 'OmniSR'),
    ('drct', lambda: zoo.make_drct(24, 1, 3, 8, 8, 2.0, 2, img_size=32), 'DRCT', 'DRCT'),
    ('fdat', lambda: zoo.make_fdat(32, 1, 1, 4, 8, 1.5, 8, 32, 'pixelshuffledirect', 2), 'FDAT', 'FDAT'),
    ('dat', lambda: zoo.make_dat(24, (2,), (2,), (2, 4), 2.0, 2), 'dat', 'DAT'),
    ('rgt', lambda: zoo.make_rgt(24, (2,), (2,), (4, 4), 2.0, 0.5, 2), 'RGT', 'RGT'),
    ('atd', lambda: zoo.make_atd(24, (2,), (3,), 8, upscale=2), 'ATD', 'ATD'),
    ('spanpp', lambda: zoo.make_spanpp(16, implicit_dim=32, latent_layers=2), 'SpanPP', 'SpanPP'),
    ('span', lambda: zoo.make_span(16, 2), 'SPAN', 'SPAN'),
    ('span_jax_zoo', lambda: jzoo.make_span(16, 2), 'SPAN', 'SPAN'),
    ('esrgan', lambda: zoo.make_esrgan(16, 1, 2, gc=8), 'ESRGAN', 'ESRGAN'),
    ('esrgan_jax_zoo', lambda: jzoo.make_esrgan(16, 1, 2, gc=8), 'ESRGAN', 'ESRGAN'),
    ('plksr', lambda: zoo.make_plksr(16, 1, 2), 'PLKSR', 'PLKSR'),
    ('realplksr', lambda: zoo.make_realplksr(16, 2, 2), 'PLKSR', 'RealPLKSR'),
    ('mosrv2', lambda: zoo.make_mosrv2(16, 2, 2), 'MoSRv2', 'MoSRv2'),
    ('mosrv2_unshuffle', lambda: zoo.make_mosrv2(16, 2, 2, unshuffle_mod=True, rms_norm=False), 'MoSRv2', 'MoSRv2'),
    ('moesr', lambda: zoo.make_moesr(16, 2, 2, 2, upsample_dim=16), 'MoESR', 'MoESR'),
    ('rtmosr', lambda: zoo.make_rtmosr(16, 2, 2), 'RTMoSR', 'RTMoSR'),
    ('rtmosr_plain', lambda: zoo.make_rtmosr(16, 1, 4, unshuffle_mod=False, dccm=False, se=False), 'RTMoSR',
     'RTMoSR'),
    ('smosr', lambda: zoo.make_smosr(16, 1, 2), 'SMoSR', 'SMoSR'),
    ('smosr_rep_dysample', lambda: zoo.make_smosr(16, 1, 2, rep=True, upsampler='dysample'), 'SMoSR', 'SMoSR'),
    ('rha', lambda: zoo.make_rha(16, 2, down_list=(1,), res_blocks=1), 'RHA', 'RHA'),
    ('rha_unshuffle', lambda: zoo.make_rha(16, 2, down_list=(2,), res_blocks=1, unshuffle_mod=True), 'RHA', 'RHA'),
    ('flexnet', lambda: zoo.make_flexnet(16, (3,)), 'FlexNet', 'FlexNet'),
    ('flexnet_meta', lambda: zoo.make_flexnet(16, (1, 1, 1, 1), pipeline_type='meta', upsampler='dys'), 'FlexNet',
     'FlexNet'),
    ('gaterv3', lambda: zoo.make_gaterv3(16, (1, 1), (1, 1), 1, span_blocks=1), 'GateRV3', 'GateRV3'),
    ('gaterv2', lambda: zoo.make_gaterv2(16, (1, 1), (1, 1), 1), 'GateRv2', 'GateRv2'),
    ('lawfft', lambda: zoo.make_lawfft(16, 1, 2), 'LAWFFT', 'LAWFFT'),
    ('lawfft_unshuffle', lambda: zoo.make_lawfft(16, 1, 2, 2, unshuffle_mod=True), 'LAWFFT', 'LAWFFT'),
    ('gfisrv2', lambda: zoo.make_gfisrv2(16, 2), 'GFISRV2', 'GFISRV2'),
    ('gfisrv2_unshuffle', lambda: zoo.make_gfisrv2(16, 4, 2, pixel_unshuffle=True), 'GFISRV2', 'GFISRV2'),
    ('figsr', lambda: zoo.make_figsr(16, 2, gc=2), 'FIGSR', 'FIGSR'),
    ('gfisr', lambda: zoo.make_gfisr(16, 2), 'GFISR', 'GFISR'),
    ('gfisr_unshuffle_no_fft', lambda: zoo.make_gfisr(16, 2, 1, fft_mode=False, pixel_unshuffle=True), 'GFISR',
     'GFISR'),
    ('gater', lambda: zoo.make_gater(16), 'GateR', 'GateR'),
    ('gater_jax_zoo', lambda: jzoo.make_gater(16), 'GateR', 'GateR'),
    ('cugan', lambda: zoo.make_cugan('2x'), 'CuGAN', 'CUGAN'),
    ('rcan', lambda: zoo.make_rcan(16, 2, 2, 4, 2), 'RCAN', 'RCAN'),
    ('eimn', lambda: zoo.make_eimn(16, 1, 1, 1.5, 2), 'eimn', 'EIMN'),
    ('mosr', lambda: zoo.make_mosr(16, 2, 2), 'MoSR', 'MoSR'),
    ('mosr_jax_zoo', lambda: jzoo.make_mosr(16, 2, 2), 'MoSR', 'MoSR'),
    ('compact', lambda: zoo.make_compact(16, 2, 2), 'Compact', 'Compact'),
    ('compact_jax_zoo', lambda: jzoo.make_compact(16, 2, 2), 'Compact', 'Compact'),
    ('spanplus', lambda: zoo.make_spanplus(16, (2,), 2), 'spanplus', 'SPANPlus'),
    ('spanplus_jax_zoo', lambda: jzoo.make_spanplus(16, (2,), 2), 'spanplus', 'SPANPlus'),
]


@pytest.mark.parametrize('label,make,arch,name', _MATRIX, ids=[m[0] for m in _MATRIX])
def test_every_family_detects_as_itself(label, make, arch, name):
    sd = make()
    port = [a.id for a in resselt_tpu_torch.archs.internal_registry if a.detect(sd)]
    jax = [a.id for a in resselt_tpu.archs.internal_registry if a.detect(sd)]
    assert port == jax == [arch]
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    jm = resselt_tpu.load_from_state_dict(sd)
    assert tm.arch_id == jm.arch_id == arch and tm.metadata.name == jm.metadata.name == name


def test_the_matrix_covers_all_31_families():
    assert [a.id for a in resselt_tpu.archs.internal_registry] == list(dict.fromkeys(m[2] for m in _MATRIX))


def test_both_registries_list_the_31_ids_in_one_order():
    port = [a.id for a in resselt_tpu_torch.archs.internal_registry]
    assert port == [a.id for a in resselt_tpu.archs.internal_registry]
    assert len(port) == len(set(port)) == 31


def test_arch_modules_are_the_jax_packages():
    assert resselt_tpu_torch.archs._ARCH_MODULES == resselt_tpu.archs._ARCH_MODULES
