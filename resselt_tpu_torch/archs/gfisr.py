"""GFISR: gated Fourier-inception SR.

Counterpart of ``resselt_tpu/archs/gfisr.py``: the same config inference
(the ``dim_to_out.MetaUpsample`` buffer decoded and dropped; the
pixel-unshuffle stem detected and its real scale recovered, non-RGB inputs
told apart by the buffer's output width), metadata and forward.  Gated
blocks whose token mixer is a rotating five-branch inception (identity,
depthwise square, two depthwise bands, and with ``fft_mode`` a
FourierUnit: the eval-time reflect halo of 2 evened out, an ortho rfft2 in
f32 with interleaved real / imaginary channels, LayerNorm, a depthwise
positional conv, a softmax-weighted dynamic grouped 1x1, GELU, irfft2 and
the unpad), the UniUpsampleV3 tail with a 3x3 DySample end conv.  Every
same-padded 3x3 conv with groups 1 runs through ``ops.fused_conv3x3_act``
(``csrc/conv3x3.cu``): the stem, ``fc1``, ``fc2`` with its Mish fused and
the tail's 3x3 convs.  The depthwise and grouped convs and the FFTs
(``nn.spectral``) stay plain torch.  The weights are built once per
compute dtype (``prepare``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn import spectral
from ..nn.params import PTree
from ..nn.upsample import SAMPLE_MODS3, uni_upsample_v3, uni_upsample_v3_convs
from ..ops.conv_route import conv, prepare_convs


@dataclass(frozen=True)
class GFISRConfig:
    in_nc: int
    out_nc: int
    dim: int
    expansion_ratio: float
    fft_mode: bool
    scale: int
    upsampler: str
    mid_dim: int
    pixel_unshuffle: bool
    n_blocks: int


def fourier_unit(p: PTree, x):
    """FourierUnit eval path (gfisr/arch.py:416-472) on NHWC ``x``."""
    b, h0, w0, c = x.shape
    pr, pb = (w0 + 4) % 2, (h0 + 4) % 2  # the eval halo of 2, evened out (arch.py:385-410)
    x = F.pad2d(x, (2, 2 + pr, 2, 2 + pb), mode='reflect')
    h, w = x.shape[1], x.shape[2]
    dtype = x.dtype
    fre, fim = spectral.rfft2_planes(x.permute(0, 3, 1, 2), norm='ortho')
    wf = fre.shape[-1]
    # real / imaginary interleaved per channel: channel 2i + d
    ff = torch.stack([fre, fim], dim=2).reshape(b, 2 * c, h, wf).permute(0, 2, 3, 1).to(dtype)
    ff = F.layer_norm(ff, p['ln.weight'], p['ln.bias'], eps=1e-6)
    ff = conv(p['fpe'], ff) + ff

    dyw = F.softmax(conv(p['weight.0'], ff))  # (b, h, wf, groups)
    groups = dyw.shape[-1]
    fdc = conv(p['fdc'], ff).reshape(b, h, wf, groups, 2 * c)
    ff = F.gelu(torch.einsum('bhwgc,bhwg->bhwc', fdc.float(), dyw.float()).to(dtype))

    ff = ff.reshape(b, h, wf, c, 2)
    out = spectral.irfft2_planes(ff[..., 0].permute(0, 3, 1, 2), ff[..., 1].permute(0, 3, 1, 2), s=(h, w),
                                 norm='ortho')
    return out.permute(0, 2, 3, 1).to(dtype)[:, 2 : h - 2 - pb, 2 : w - 2 - pr, :]


def _inception_shift(p: PTree, x, gc: int, shift: int, fft_mode: bool):
    """Rotating InceptionDWConv2d (gfisr/arch.py:474-539): the branch at
    position ``o`` (module ``names[o]``) runs op ``(shift + o) % 5`` of
    (identity, square, band w, band h, FourierUnit) on its slice."""
    sizes = [x.shape[-1] - 4 * gc, gc, gc, gc, gc]
    parts = []
    start = 0
    for offset, name in enumerate(('pconv', 'dwconv_hw', 'dwconv_w', 'dwconv_h', 'fsas')):
        slot = (shift + offset) % 5
        t = x[..., start : start + sizes[slot]]
        start += sizes[slot]
        if slot in (1, 2, 3):
            t = conv(p[name], t)
        elif slot == 4 and fft_mode:
            t = fourier_unit(p.sub(name), t)
        parts.append(t)
    return torch.cat(parts, dim=-1)


def _gated_block(p: PTree, x, cfg: GFISRConfig, shift: int):
    """GatedCNNBlock (gfisr/arch.py:541-578)."""
    shortcut = x
    x = F.layer_norm(x, p['norm.weight'], p['norm.bias'], eps=1e-6)
    hidden = int(cfg.expansion_ratio * cfg.dim)
    x = conv(p['fc1'], x)
    g = x[..., :hidden]
    i = x[..., hidden : 2 * hidden - cfg.dim]
    c = _inception_shift(p.sub('conv'), x[..., 2 * hidden - cfg.dim :], int(cfg.dim * 0.125), shift, cfg.fft_mode)
    x = conv(p['fc2'], F.mish(g) * torch.cat([i, c], dim=-1), 'mish')
    return x * p['gamma'].reshape(-1).to(x.dtype) + shortcut


def mixer_groups(params, prefix: str) -> dict:
    """``prepare_convs``'s groups for the token mixers (``{prefix}{i}.conv.*``):
    every conv with one input channel a group is depthwise, and each
    FourierUnit's dynamic ``fdc`` (out 2c x G, in 2c / G) has G groups."""
    groups = {}
    for k, v in params.items():
        if k.startswith(prefix) and '.conv.' in k and k.endswith('.weight') and v.ndim == 4:
            if k.endswith('.fdc.weight'):
                groups[k[: -len('.weight')]] = math.isqrt(v.shape[0] // v.shape[1])
            elif v.shape[1] == 1:
                groups[k[: -len('.weight')]] = v.shape[0]
    return groups


def prepare(cfg: GFISRConfig, params, dtype):
    groups, skip = uni_upsample_v3_convs(params, 'dim_to_out', cfg.upsampler, cfg.scale)
    return prepare_convs(params, dtype, {**mixer_groups(params, 'net.'), **groups}, skip)


def apply(cfg: GFISRConfig, w: dict, x):
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
        out = _gated_block(p.sub(f'net.{i}'), out, cfg, i)
    out = uni_upsample_v3(p.sub('dim_to_out'), out + feat, cfg.upsampler, up_scale, cfg.out_nc, cfg.mid_dim,
                          dysample_end_kernel=3)
    return out[:, : h0 * cfg.scale, : w0 * cfg.scale]


def unshuffle_stem(stem_cin: int, out_ch: int) -> tuple[int, int]:
    """(in_nc, scale) of a pixel-unshuffle stem with ``stem_cin`` input
    channels, as the JAX loaders infer it: stem cin = in_nc * (4 // scale)²
    with in_nc equal to the MetaUpsample's output width wherever that
    divides (a 4-channel 2x stem and a 1-channel 1x stem both read 16),
    else the reference's rule by cin % 16."""
    r = stem_cin // out_ch
    if stem_cin % out_ch == 0 and math.isqrt(r) ** 2 == r and math.isqrt(r) in (2, 4):
        return out_ch, 4 // math.isqrt(r)
    if stem_cin % 16 == 0:
        return stem_cin // 16, 1
    return stem_cin // 4, 2


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/gfisr.py::_load``."""
    _, index, scale, _, out_ch, upsample_dim, _ = [int(v) for v in sd['dim_to_out.MetaUpsample'].reshape(-1)]
    if 'in_to_dim.weight' in sd:
        dim, in_nc = sd['in_to_dim.weight'].shape[:2]
        pixel_unshuffle = False
    else:
        dim, stem_cin = sd['in_to_dim.1.weight'].shape[:2]
        in_nc, scale = unshuffle_stem(stem_cin, out_ch)
        pixel_unshuffle = True

    cfg = GFISRConfig(in_nc=in_nc, out_nc=out_ch, dim=dim, expansion_ratio=sd['net.0.fc1.bias'].shape[0] / 2 / dim,
                      fft_mode='net.0.conv.fsas.ln.weight' in sd, scale=scale, upsampler=SAMPLE_MODS3[index],
                      mid_dim=upsample_dim, pixel_unshuffle=pixel_unshuffle, n_blocks=get_seq_len(sd, 'net'))
    params = {k: v for k, v in sd.items() if k != 'dim_to_out.MetaUpsample'}
    meta = ModelMetadata(in_channels=in_nc, out_channels=out_ch, upscale=scale, name='GFISR')
    return SRModel('GFISR', cfg, params_from_numpy(params, device), meta, apply, prepare)


ARCH = Architecture(
    id='GFISR',
    detect_condition=KeyCondition.has_all(
        KeyCondition.has_any('in_to_dim.weight', 'in_to_dim.1.weight'),
        'net.0.gamma',
        'net.0.norm.weight',
        'net.0.norm.bias',
        'net.0.fc1.weight',
        'net.0.fc1.bias',
        'net.0.conv.dwconv_hw.weight',
        'net.0.conv.dwconv_hw.bias',
        'net.0.conv.dwconv_w.weight',
        'net.0.conv.dwconv_w.bias',
        'net.0.conv.dwconv_h.weight',
        'net.0.conv.dwconv_h.bias',
        'net.0.fc2.weight',
        'net.0.fc2.bias',
        'dim_to_out.MetaUpsample',
    ),
    load_fn=_load,
)
