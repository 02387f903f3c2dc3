"""MoSRv2: Mamba-Out SR v2 with UniUpsample and a MetaUpsample config buffer.

Counterpart of ``resselt_tpu/archs/mosrv2.py``: the same config inference
(the ``to_img.MetaUpsample`` uint8 buffer decoded and dropped), metadata and
forward.  Gated CNN blocks with the InceptionDWConv2d token mixer and the
RMSNorm (eps outside the sqrt) / LayerNorm switch, the pixel-unshuffle stem
below 3x, the bilinear ``short`` branch and the UniUpsample tail.  Each
same-padded 3x3 conv runs through ``ops.fused_conv3x3_act``
(``csrc/conv3x3.cu``): the stem, ``fc1`` (linear), ``fc2`` and the conv
tail's two convs with their Mish fused, and the UniUpsample's 3x3 convs
(through ``PTree.conv``).  The grouped square and band convs of the token mixer, the
1x1 convs and the norms stay plain torch.  The weights are built once per
compute dtype (``prepare``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.upsample import SAMPLE_MODS, uni_upsample
from ..ops.conv_route import conv, prepare_convs


@dataclass(frozen=True)
class MoSRv2Config:
    in_ch: int
    scale: int
    n_block: int
    dim: int
    upsampler: str
    expansion_ratio: float
    mid_dim: int
    group: int
    unshuffle_mod: bool
    rms_norm: bool


def _inception_dwconv(p: PTree, x):
    """InceptionDWConv2d (mosrv2/arch.py:174-209): the identity share, then
    a square, a 1 x band and a band x 1 depthwise conv on the last three
    ``gc``-channel slices."""
    gc = p['dwconv_hw'].groups
    c = x.shape[-1]
    return torch.cat([
        x[..., : c - 3 * gc],
        conv(p['dwconv_hw'], x[..., c - 3 * gc : c - 2 * gc]),
        conv(p['dwconv_w'], x[..., c - 2 * gc : c - gc]),
        conv(p['dwconv_h'], x[..., c - gc :]),
    ], dim=-1)


def inception_groups(params) -> dict:
    """``prepare_convs``'s groups for every InceptionDWConv2d: each of its
    convs is depthwise."""
    return {k[: -len('.weight')]: v.shape[0] for k, v in params.items()
            if k.endswith(('.dwconv_hw.weight', '.dwconv_w.weight', '.dwconv_h.weight'))}


def _gated_block(p: PTree, x, cfg: MoSRv2Config):
    """GatedCNNBlock v2 (mosrv2/arch.py:244-278)."""
    shortcut = x
    if cfg.rms_norm:
        x = F.rms_norm_ref(x, p['norm.scale'], p['norm.offset'])
    else:
        x = F.layer_norm(x, p['norm.weight'], p['norm.bias'], eps=1e-6)
    hidden = int(cfg.expansion_ratio * cfg.dim)
    x = conv(p['fc1'], x)
    g = x[..., :hidden]
    i = x[..., hidden : 2 * hidden - cfg.dim]
    c = _inception_dwconv(p.sub('conv'), x[..., 2 * hidden - cfg.dim :])
    x = conv(p['fc2'], F.mish(g) * torch.cat([i, c], dim=-1), 'mish')
    return x * p['gamma'].reshape(-1) + shortcut


def prepare(cfg: MoSRv2Config, params, dtype):
    return prepare_convs(params, dtype, inception_groups(params))


def apply(cfg: MoSRv2Config, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    h, wd = x.shape[1], x.shape[2]
    unshuffle = cfg.unshuffle_mod and cfg.scale < 3
    pad = 4 // cfg.scale if unshuffle else 1
    x = F.pad_to_multiple(x, pad, mode='reflect')
    short = F.interpolate_bilinear(x, scale_factor=cfg.scale)

    if unshuffle:
        out = conv(p['gblocks.1'], F.pixel_unshuffle(x, pad))
        first = 2
    else:
        out = conv(p['gblocks.0'], x)
        first = 1
    for i in range(cfg.n_block):
        out = _gated_block(p.sub(f'gblocks.{first + i}'), out, cfg)
    i0 = first + cfg.n_block
    out = conv(p[f'gblocks.{i0}'], out, 'mish')
    out = conv(p[f'gblocks.{i0 + 2}'], out, 'mish')
    out = conv(p[f'gblocks.{i0 + 4}'], out)

    to_img_scale = 4 if unshuffle else cfg.scale
    out = uni_upsample(p.sub('to_img'), out, cfg.upsampler, to_img_scale, cfg.in_ch, cfg.mid_dim, cfg.group)
    return (out + short)[:, : h * cfg.scale, : wd * cfg.scale]


def _load(sd, device='cuda') -> SRModel:
    """Config inference with the MetaUpsample decoding, as
    ``resselt_tpu/archs/mosrv2.py::_load``."""
    meta_buf = [int(i) for i in sd['to_img.MetaUpsample'].reshape(-1)]
    _, upsampler_idx, scale, dim, in_ch, mid_dim, group = meta_buf
    upsampler = SAMPLE_MODS[upsampler_idx]
    n_block = get_seq_len(sd, 'gblocks')
    if 'gblocks.0.weight' in sd:
        unshuffle_mod = False
        n_block -= 6
        expansion_ratio = sd['gblocks.1.fc1.weight'].shape[0] // 2 / dim
        rms_norm = 'gblocks.1.norm.scale' in sd
    else:
        scale = math.isqrt(sd['gblocks.1.weight'].shape[1] // in_ch)
        n_block -= 7
        unshuffle_mod = True
        expansion_ratio = sd['gblocks.2.fc1.weight'].shape[0] // 2 / dim
        rms_norm = 'gblocks.2.norm.scale' in sd

    cfg = MoSRv2Config(
        in_ch=in_ch, scale=scale, n_block=n_block, dim=dim, upsampler=upsampler,
        expansion_ratio=expansion_ratio, mid_dim=mid_dim, group=group,
        unshuffle_mod=unshuffle_mod, rms_norm=rms_norm,
    )
    params = {k: v for k, v in sd.items() if k != 'to_img.MetaUpsample'}
    meta = ModelMetadata(in_channels=in_ch, out_channels=in_ch, upscale=scale, name='MoSRv2')
    return SRModel('MoSRv2', cfg, params_from_numpy(params, device), meta, apply, prepare)


def _block_cond(idx: int) -> KeyCondition:
    g = f'gblocks.{idx}'
    return KeyCondition.has_all(
        f'gblocks.{idx - 1}.weight',
        f'gblocks.{idx - 1}.bias',
        f'{g}.gamma',
        KeyCondition.has_any(
            KeyCondition.has_all(f'{g}.norm.scale', f'{g}.norm.offset'),
            KeyCondition.has_all(f'{g}.norm.weight', f'{g}.norm.bias'),
        ),
        f'{g}.fc1.weight',
        f'{g}.fc1.bias',
        f'{g}.conv.dwconv_hw.weight',
        f'{g}.conv.dwconv_hw.bias',
        f'{g}.conv.dwconv_w.weight',
        f'{g}.conv.dwconv_w.bias',
        f'{g}.conv.dwconv_h.weight',
        f'{g}.conv.dwconv_h.bias',
        f'{g}.fc2.weight',
        f'{g}.fc2.bias',
        'to_img.MetaUpsample',
        'to_img.0.weight',
        'to_img.0.bias',
    )


ARCH = Architecture(
    id='MoSRv2',
    detect_condition=KeyCondition.has_any(_block_cond(2), _block_cond(1)),
    load_fn=_load,
)
