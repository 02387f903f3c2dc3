"""SPAN: the Swift Parameter-free Attention Network.

Counterpart of ``resselt_tpu/archs/span.py``: the same config inference,
metadata, serving hint and forward.  Conv3XC bundles are collapsed at load
(the reference recomputes them per forward, span/arch.py:152-154).  Like
the reference, the input is normalized ``(x - mean) * img_range`` but the
output is never un-normalized (span/arch.py:231-248), kept as it is.  Each
3x3 conv runs through ``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``; 21
launches per forward of ``span 4x``, 48 features), the SiLU that follows
c1 and c2 fused into the kernel; ``conv_cat`` (1x1) stays ``F.conv2d``.
The weights are packed once per compute dtype (``prepare``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import pixelshuffle_scale
from ..nn import functional as F
from ..nn.params import MEAN, PTree, input_mean
from ..ops.conv_route import conv, prepare_convs
from .spanplus import transform_params

_RGB_MEAN = (0.4488, 0.4371, 0.4040)


@dataclass(frozen=True)
class SpanConfig:
    num_in_ch: int
    num_out_ch: int
    feature_channels: int
    upscale: int
    norm: bool
    img_range: float = 255.0


def _spab(p: PTree, x, rep: str = 'eval_conv'):
    """SPAB with in-place SiLU (span/arch.py:157-180): the second return
    value is the activated out1 (c1's fused SiLU), because
    ``nn.SiLU(inplace=True)`` mutates it; ``out2`` is read only through its
    SiLU, so c2 fuses it too.  ``rep``: the collapsed conv's name (SpanPP:
    ``conv_3x3_rep``)."""
    out1_act = conv(p[f'c1_r.{rep}'], x, 'silu')
    out2_act = conv(p[f'c2_r.{rep}'], out1_act, 'silu')
    out3 = conv(p[f'c3_r.{rep}'], out2_act)
    sim_att = F.sigmoid(out3) - 0.5
    return (out3 + x) * sim_att, out1_act


def body(p: PTree, feat, rep: str = 'eval_conv'):
    """The six SPABs, ``conv_2`` and ``conv_cat`` after the stem ``feat``."""
    out_b1, _ = _spab(p.sub('block_1'), feat, rep)
    out_b2, _ = _spab(p.sub('block_2'), out_b1, rep)
    out_b3, _ = _spab(p.sub('block_3'), out_b2, rep)
    out_b4, _ = _spab(p.sub('block_4'), out_b3, rep)
    out_b5, _ = _spab(p.sub('block_5'), out_b4, rep)
    out_b6, out_b5_2 = _spab(p.sub('block_6'), out_b5, rep)
    out_b6 = conv(p[f'conv_2.{rep}'], out_b6)
    return conv(p['conv_cat'], torch.cat([feat, out_b6, out_b1, out_b5_2], dim=-1))


def prepare(cfg: SpanConfig, params, dtype):
    out = prepare_convs(params, dtype)
    out[MEAN] = input_mean(params, _RGB_MEAN, dtype)
    return out


def apply(cfg: SpanConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    if cfg.norm:
        x = (x - p[MEAN]) * cfg.img_range
    out = body(p, conv(p['conv_1.eval_conv'], x))
    return F.pixel_shuffle(conv(p['upsampler.0'], out), cfg.upscale)


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/span.py::_load``."""
    num_in_ch = sd['conv_1.sk.weight'].shape[1]
    feature_channels = sd['conv_1.sk.weight'].shape[0]
    num_out_ch = num_in_ch
    upscale = pixelshuffle_scale(sd['upsampler.0.weight'].shape[0], num_in_ch)
    norm = 'no_norm' not in sd

    cfg = SpanConfig(
        num_in_ch=num_in_ch,
        num_out_ch=num_out_ch,
        feature_channels=feature_channels,
        upscale=upscale,
        norm=norm,
    )
    params = {k: v for k, v in transform_params(sd).items() if k != 'no_norm'}
    meta = ModelMetadata(in_channels=num_in_ch, out_channels=num_out_ch, upscale=upscale, name='SPAN')
    model = SRModel('SPAN', cfg, params_from_numpy(params, device), meta, apply, prepare)
    # the JAX package's hint, kept so that tiled outputs match it; its
    # value has not been re-measured on a GPU
    model.serving_halo = 4
    return model


ARCH = Architecture(
    id='SPAN',
    detect_condition=KeyCondition.has_all(
        'conv_1.sk.weight',
        'block_1.c1_r.sk.weight',
        'block_1.c1_r.eval_conv.weight',
        'block_1.c3_r.eval_conv.weight',
        'conv_cat.weight',
        'conv_2.sk.weight',
        'conv_2.eval_conv.weight',
        'upsampler.0.weight',
    ),
    load_fn=_load,
)
