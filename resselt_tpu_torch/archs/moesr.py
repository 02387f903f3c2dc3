"""MoESR: Mamba-out Excitation Super-Resolution.

Counterpart of ``resselt_tpu/archs/moesr.py``: the same config inference
(the ``upscale.MetaUpsample`` buffer decoded and dropped), metadata and
forward.  LayerNorm gated CNN blocks with the InceptionDWConv2d mixer
(``mosrv2._inception_dwconv``), grouped into Blocks each closed by an MSG
(a pixel-unshuffled gated refinement), reflect padding to a multiple of 2
and the UniUpsample tail.  Each same-padded 3x3 conv runs through
``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``): ``in_to_dim``, ``fc1``,
``fc2`` with its Mish fused, the MSG's ``down.0`` / ``up.0`` (linear: their
lrelu 0.1 follows the pixel (un)shuffle in torch; the kernel's slope is
0.2) and the tail's 3x3 convs.  The grouped token-mixer convs and the
layer norms stay plain torch.  The weights are built once per compute dtype
(``prepare``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.upsample import SAMPLE_MODS, uni_upsample
from ..ops.conv_route import conv, prepare_convs
from .mosrv2 import _inception_dwconv, inception_groups


@dataclass(frozen=True)
class MoESRConfig:
    in_ch: int
    out_ch: int
    scale: int
    dim: int
    n_blocks: int
    n_block: int
    expansion_factor: float
    expansion_msg: float
    upsampler: str
    upsample_dim: int


def _gated_block(p: PTree, x, dim: int, expansion_ratio: float):
    """GatedCNNBlock with LayerNorm and the Inception mixer
    (moesr/arch.py:125-165)."""
    shortcut = x
    x = F.layer_norm(x, p['norm.weight'], p['norm.bias'], eps=1e-6)
    hidden = int(expansion_ratio * dim)
    x = conv(p['fc1'], x)
    g = x[..., :hidden]
    i = x[..., hidden : 2 * hidden - dim]
    c = _inception_dwconv(p.sub('conv'), x[..., 2 * hidden - dim :])
    x = conv(p['fc2'], F.mish(g) * torch.cat([i, c], dim=-1), 'mish')
    return x * p['gamma'].reshape(-1) + shortcut


def _msg(p: PTree, x, dim: int, expansion_msg: float):
    """MSG (moesr/arch.py:167-178)."""
    out = F.leaky_relu(F.pixel_unshuffle(conv(p['down.0'], x), 2), 0.1)
    for i in range(3):
        out = _gated_block(p.sub(f'gated.{i}'), out, dim, expansion_msg)
    out = F.leaky_relu(F.pixel_shuffle(conv(p['up.0'], out), 2), 0.1)
    return out + x


def prepare(cfg: MoESRConfig, params, dtype):
    return prepare_convs(params, dtype, inception_groups(params))


def apply(cfg: MoESRConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    h, wd = x.shape[1], x.shape[2]
    x = conv(p['in_to_dim'], F.pad_to_multiple(x, 2, mode='reflect'))
    out = x
    for bi in range(cfg.n_blocks):
        bp = p.sub(f'blocks.{bi}')
        for i in range(cfg.n_block):
            out = _gated_block(bp.sub(f'blocks.{i}'), out, cfg.dim, cfg.expansion_factor)
        out = _msg(bp.sub('msg'), out, cfg.dim, cfg.expansion_msg)
    out = uni_upsample(p.sub('upscale'), out + x, cfg.upsampler, cfg.scale, cfg.out_ch, cfg.upsample_dim)
    return out[:, : h * cfg.scale, : wd * cfg.scale]


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/moesr.py::_load``."""
    dim, in_ch = sd['in_to_dim.weight'].shape[:2]
    n_blocks = get_seq_len(sd, 'blocks')
    n_block = get_seq_len(sd, 'blocks.0.blocks')
    ef = sd['blocks.0.blocks.0.fc1.weight'].shape
    expansion_factor = (ef[0] / ef[1]) / 2
    em = sd['blocks.0.msg.gated.0.fc1.weight'].shape
    expansion_msg = (em[0] / em[1]) / 2
    meta_buf = [int(i) for i in sd['upscale.MetaUpsample'].reshape(-1)]
    _, index, scale, _, out_ch, upsample_dim, _ = meta_buf
    upsampler = SAMPLE_MODS[index]
    if upsampler == 'conv':
        scale = 1

    cfg = MoESRConfig(
        in_ch=in_ch, out_ch=out_ch, scale=scale, dim=dim, n_blocks=n_blocks,
        n_block=n_block, expansion_factor=expansion_factor, expansion_msg=expansion_msg,
        upsampler=upsampler, upsample_dim=upsample_dim,
    )
    params = {k: v for k, v in sd.items() if k != 'upscale.MetaUpsample'}
    meta = ModelMetadata(in_channels=in_ch, out_channels=out_ch, upscale=scale, name='MoESR')
    return SRModel('MoESR', cfg, params_from_numpy(params, device), meta, apply, prepare)


ARCH = Architecture(
    id='MoESR',
    detect_condition=KeyCondition.has_all(
        'in_to_dim.weight',
        'in_to_dim.bias',
        'blocks.0.blocks.0.gamma',
        'blocks.0.blocks.0.norm.weight',
        'blocks.0.blocks.0.norm.bias',
        'blocks.0.blocks.0.fc1.weight',
        'blocks.0.blocks.0.fc1.bias',
        'blocks.0.blocks.0.conv.dwconv_hw.weight',
        'blocks.0.blocks.0.conv.dwconv_hw.bias',
        'blocks.0.blocks.0.conv.dwconv_w.weight',
        'blocks.0.blocks.0.conv.dwconv_w.bias',
        'blocks.0.blocks.0.conv.dwconv_h.weight',
        'blocks.0.blocks.0.conv.dwconv_h.bias',
        'blocks.0.blocks.0.fc2.weight',
        'blocks.0.blocks.0.fc2.bias',
        'upscale.MetaUpsample',
    ),
    load_fn=_load,
)
