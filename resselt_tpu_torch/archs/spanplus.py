"""SPANPlus: the Swift Parameter-free Attention Network, plus variant.

Counterpart of ``resselt_tpu/archs/spanplus.py``: the same config
inference, metadata and forward.  Every Conv3XC bundle is collapsed to one
3x3 conv at load (``nn.reparam.conv3xc_collapse``; the reference recomputes
them on every forward).  Each 3x3 conv runs through
``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``; 21 launches per forward of
``spanplus 2x``, blocks (4,), 48 features, ``ps``), the Mish that follows
c1 and c2 fused into the kernel; ``conv_cat`` (1x1) and DySample's 1x1
convs stay ``F.conv2d``.  The weights are packed once per compute dtype
(``prepare``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import dysample_scale, get_seq_len, pixelshuffle_scale
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.reparam import conv3xc_collapse
from ..nn.upsample import dysample
from ..ops.conv_route import conv, prepare_convs


@dataclass(frozen=True)
class SpanPlusConfig:
    num_in_ch: int
    num_out_ch: int
    blocks: tuple[int, ...]
    feature_channels: int
    upscale: int
    upsampler: str  # 'ps' | 'dys' | 'conv'


def _spab(p: PTree, x):
    """SPAB block (reference arch.py:105-131).  Returns (out, out1).

    The reference's ``nn.Mish(inplace=True)`` mutates ``out1`` before it is
    returned, so the second output is the *activated* out1: c1's fused Mish.
    ``out2`` is read only through its Mish, so c2 fuses it too."""
    out1_act = conv(p['c1_r.eval_conv'], x, 'mish')
    out2_act = conv(p['c2_r.eval_conv'], out1_act, 'mish')
    out3 = conv(p['c3_r.eval_conv'], out2_act)
    sim_att = F.sigmoid(out3) - 0.5
    return (out3 + x) * sim_att, out1_act


def _spabs(p: PTree, x, n_blocks: int):
    """SPABS group (reference arch.py:133-151)."""
    out_b1, _ = _spab(p.sub('block_1'), x)
    out_x = out_b1
    for i in range(n_blocks):
        out_x, _ = _spab(p.sub(f'block_n.{i}'), out_x)
    out_end, out_x_2 = _spab(p.sub('block_end'), out_x)
    out_end = conv(p['conv_2.eval_conv'], out_end)
    return conv(p['conv_cat'], torch.cat([x, out_end, out_b1, out_x_2], dim=-1))


def prepare(cfg: SpanPlusConfig, params, dtype):
    return prepare_convs(params, dtype)


def apply(cfg: SpanPlusConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    out = conv(p['feats.0.eval_conv'], x)
    for i, n_blocks in enumerate(cfg.blocks):
        out = _spabs(p.sub(f'feats.{i + 1}'), out, n_blocks)
    if cfg.upsampler == 'ps':
        return F.pixel_shuffle(conv(p['upsampler.0'], out), cfg.upscale)
    if cfg.upsampler == 'dys':
        return dysample(p.sub('upsampler'), out, cfg.upscale)
    return conv(p['upsampler'], out)


def transform_params(sd) -> dict:
    """Collapse every Conv3XC; keep only runtime keys (numpy)."""
    out = {}
    prefixes = sorted({k.rsplit('.', 2)[0] for k in sd if k.endswith('.sk.weight')})
    collapsed = set()
    for prefix in prefixes:
        w, b = conv3xc_collapse(sd, prefix)
        out[f'{prefix}.eval_conv.weight'] = w
        out[f'{prefix}.eval_conv.bias'] = b
        collapsed.add(prefix)
    for k, v in sd.items():
        root = k.rsplit('.', 2)[0]
        if root in collapsed or any(k.startswith(c + '.') for c in collapsed):
            continue
        out[k] = v
    return out


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/spanplus.py::_load``."""
    n_feats = get_seq_len(sd, 'feats') - 1
    blocks = tuple(get_seq_len(sd, f'feats.{i + 1}.block_n') for i in range(n_feats))
    num_in_ch = sd['feats.0.eval_conv.weight'].shape[1]
    feature_channels = sd['feats.0.eval_conv.weight'].shape[0]
    if 'upsampler.0.weight' in sd:
        upsampler = 'ps'
        num_out_ch = num_in_ch
        upscale = pixelshuffle_scale(sd['upsampler.0.weight'].shape[0], num_out_ch)
    elif 'upsampler.offset.weight' in sd:
        upsampler = 'dys'
        num_out_ch = sd['upsampler.end_conv.weight'].shape[0]
        upscale = dysample_scale(sd['upsampler.offset.weight'].shape[0])
    else:
        upsampler = 'conv'
        num_out_ch = sd['upsampler.weight'].shape[0]
        upscale = 1

    cfg = SpanPlusConfig(
        num_in_ch=num_in_ch,
        num_out_ch=num_out_ch,
        blocks=blocks,
        feature_channels=feature_channels,
        upscale=upscale,
        upsampler=upsampler,
    )
    meta = ModelMetadata(in_channels=num_in_ch, out_channels=num_out_ch, upscale=upscale, name='SPANPlus')
    return SRModel('spanplus', cfg, params_from_numpy(transform_params(sd), device), meta, apply, prepare)


ARCH = Architecture(
    id='spanplus',
    detect_condition=KeyCondition.has_all('feats.0.eval_conv.weight'),
    load_fn=_load,
)
