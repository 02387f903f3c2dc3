"""GFISRV2: gated Fourier-inception SR, v2.

Counterpart of ``resselt_tpu/archs/gfisrv2.py``: the same config inference
(the ``upscale.MetaUpsample`` buffer decoded and dropped; the
pixel-unshuffle stem's real scale recovered as GFISR's), metadata and
forward.  RMSNorm (eps outside the sqrt) SiLU-gated blocks whose token
mixer is a rotating four-branch inception: the FourierUnit v2 (an ortho
rfft2 in f32, the real and imaginary planes stacked block-wise on the
channels, RMSNorm, a depthwise positional conv, a 1x1 and GELU, then the
reference's reassembly that pairs consecutive channels as (real, imaginary),
irfft2, RMSNorm), a depthwise square and two depthwise bands; the conv
tail and the UniUpsampleV3 with a 3x3 DySample end conv.  The spectrum's
RMSNorm runs in f32: its squares of the DC terms overflow in fp16.  Every
same-padded 3x3 conv with groups 1 runs through ``ops.fused_conv3x3_act``
(``csrc/conv3x3.cu``): the stem, ``fc1``, ``fc2`` and the tail's first conv
with their SiLU fused, the tail's second and the UniUpsampleV3's 3x3
convs.  The depthwise convs, the 1x1 convs and the FFTs (``nn.spectral``)
stay plain torch.  The weights are built once per compute dtype
(``prepare``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn import spectral
from ..nn.params import PTree
from ..nn.upsample import SAMPLE_MODS3, uni_upsample_v3, uni_upsample_v3_convs
from ..ops.conv_route import conv, prepare_convs
from .gfisr import mixer_groups, unshuffle_stem


@dataclass(frozen=True)
class GFISRV2Config:
    in_nc: int
    out_nc: int
    dim: int
    expansion_ratio: float
    scale: int
    upsampler: str
    mid_dim: int
    pixel_unshuffle: bool
    n_blocks: int


def _rms(p: PTree, name: str, x):
    return F.rms_norm_ref(x, p[f'{name}.scale'], p[f'{name}.offset'])


def fourier_unit_v2(p: PTree, x, norm=_rms):
    """FourierUnit v2 (gfisrv2/arch.py:449-497) on NHWC ``x``, with
    ``norm`` (FIGSR's: its serialized-eps RMSNorm) as ``rn`` and
    ``post_norm``; ``rn`` runs in f32."""
    b, h, w, c = x.shape
    dtype = x.dtype
    fre, fim = spectral.rfft2_planes(x.permute(0, 3, 1, 2), norm='ortho')
    wf = fre.shape[-1]
    ff = norm(p, 'rn', torch.cat([fre, fim], dim=1).permute(0, 2, 3, 1).to(dtype).float()).to(dtype)
    ff = conv(p['fpe'], ff) + ff
    ff = F.gelu(conv(p['fdc'], ff)).reshape(b, h, wf, c, 2)  # consecutive channels as (real, imaginary)
    out = spectral.irfft2_planes(ff[..., 0].permute(0, 3, 1, 2), ff[..., 1].permute(0, 3, 1, 2), s=(h, w),
                                 norm='ortho')
    return norm(p, 'post_norm', out.permute(0, 2, 3, 1).to(dtype))


def _inception_v2(p: PTree, x, gc: int, shift: int):
    """Rotating 4-branch InceptionDWConv2d (gfisrv2/arch.py:499-580): the
    branch at position ``o`` (module ``names[o]``) runs op ``(shift + o) %
    4`` of (FourierUnit, square, band w, band h) on its slice."""
    sizes = [x.shape[-1] - 3 * gc, gc, gc, gc]
    parts = []
    start = 0
    for offset, name in enumerate(('pconv', 'dwconv_hw', 'dwconv_w', 'dwconv_h')):
        slot = (shift + offset) % 4
        t = x[..., start : start + sizes[slot]]
        start += sizes[slot]
        parts.append(fourier_unit_v2(p.sub(name), t) if slot == 0 else conv(p[name], t))
    return torch.cat(parts, dim=-1)


def _gated_block(p: PTree, x, cfg: GFISRV2Config, shift: int):
    """GatedCNNBlock v2 (gfisrv2/arch.py:582-628), SiLU-gated."""
    shortcut = x
    hidden = int(cfg.expansion_ratio * cfg.dim)
    x = conv(p['fc1'], _rms(p, 'norm', x))
    g = x[..., :hidden]
    i = x[..., hidden : 2 * hidden - cfg.dim]
    c = _inception_v2(p.sub('conv'), x[..., 2 * hidden - cfg.dim :], int(cfg.dim * 0.125), shift)
    x = conv(p['fc2'], F.silu(g) * torch.cat([i, c], dim=-1), 'silu')
    return x * p['gamma'].reshape(-1).to(x.dtype) + shortcut


def prepare(cfg: GFISRV2Config, params, dtype):
    groups, skip = uni_upsample_v3_convs(params, 'upscale', cfg.upsampler, cfg.scale)
    return prepare_convs(params, dtype, {**mixer_groups(params, 'gfisr_body.'), **groups}, skip)


def apply(cfg: GFISRV2Config, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    h0, w0 = x.shape[1], x.shape[2]
    if cfg.pixel_unshuffle and cfg.scale in (1, 2):
        down = 4 // cfg.scale
        feat = conv(p['in_to_dim.1'], F.pixel_unshuffle(F.pad_to_multiple(x, down, mode='reflect'), down))
        up_scale = 4
    else:
        feat = conv(p['in_to_dim'], x)
        up_scale = cfg.scale
    out = feat
    for i in range(cfg.n_blocks):
        out = _gated_block(p.sub(f'gfisr_body.{i}'), out, cfg, i)
    out = conv(p[f'gfisr_body.{cfg.n_blocks}'], out, 'silu')
    out = conv(p[f'gfisr_body.{cfg.n_blocks + 2}'], out) + feat
    out = uni_upsample_v3(p.sub('upscale'), out, cfg.upsampler, up_scale, cfg.out_nc, cfg.mid_dim,
                          dysample_end_kernel=3)
    return out[:, : h0 * cfg.scale, : w0 * cfg.scale]


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/gfisrv2.py::_load``."""
    _, upsampler_idx, scale, dim, out_ch, mid_dim, _ = [int(v) for v in sd['upscale.MetaUpsample'].reshape(-1)]
    if 'in_to_dim.weight' in sd:
        pixel_unshuffle = False
        in_nc = sd['in_to_dim.weight'].shape[1]
    else:
        in_nc, scale = unshuffle_stem(sd['in_to_dim.1.weight'].shape[1], out_ch)
        pixel_unshuffle = True

    cfg = GFISRV2Config(in_nc=in_nc, out_nc=out_ch, dim=dim,
                        expansion_ratio=sd['gfisr_body.0.fc1.weight'].shape[0] // 2 / dim, scale=scale,
                        upsampler=SAMPLE_MODS3[upsampler_idx], mid_dim=mid_dim, pixel_unshuffle=pixel_unshuffle,
                        n_blocks=get_seq_len(sd, 'gfisr_body') - 3)
    params = {k: v for k, v in sd.items() if k != 'upscale.MetaUpsample'}
    meta = ModelMetadata(in_channels=in_nc, out_channels=out_ch, upscale=scale, name='GFISRV2')
    return SRModel('GFISRV2', cfg, params_from_numpy(params, device), meta, apply, prepare)


ARCH = Architecture(
    id='GFISRV2',
    detect_condition=KeyCondition.has_all(
        'gfisr_body.0.gamma',
        'gfisr_body.0.norm.scale',
        'gfisr_body.0.norm.offset',
        'gfisr_body.0.fc1.weight',
        'gfisr_body.0.fc1.bias',
        'gfisr_body.0.conv.pconv.rn.scale',
        'gfisr_body.0.conv.pconv.rn.offset',
        'gfisr_body.0.conv.pconv.post_norm.scale',
        'gfisr_body.0.conv.pconv.post_norm.offset',
        'gfisr_body.0.conv.pconv.fdc.weight',
        'gfisr_body.0.conv.pconv.fdc.bias',
        'gfisr_body.0.conv.pconv.fpe.weight',
        'gfisr_body.0.conv.pconv.fpe.bias',
        'gfisr_body.0.conv.dwconv_hw.weight',
        'gfisr_body.0.conv.dwconv_hw.bias',
        'gfisr_body.0.conv.dwconv_w.weight',
        'gfisr_body.0.conv.dwconv_w.bias',
        'gfisr_body.0.conv.dwconv_h.weight',
        'gfisr_body.0.conv.dwconv_h.bias',
        'gfisr_body.0.fc2.weight',
        'gfisr_body.0.fc2.bias',
        'upscale.MetaUpsample',
    ),
    load_fn=_load,
)
