"""RCAN: the Residual Channel Attention Network.

Counterpart of ``resselt_tpu/archs/rcan.py``: the same config inference,
metadata and forward, with the MeanShift 1x1 convs (their weights come from
the checkpoint when norm=True), RCAB channel attention, the pixel-shuffle
tail and the optional pixel-unshuffle head.  Each 3x3 conv runs through
``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``; 415 launches per forward of
``rcan 4x``, 10 groups of 20 RCABs, 64 features) with act ``linear``: the
ReLU after an RCAB's first conv stays plain torch (the kernel's only
rectifier is the 0.2 leaky ReLU), as do the channel attention, the 1x1
convs and any conv with ``kernel_size`` other than 3.  The weights are
packed once per compute dtype (``prepare``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_pixelshuffle_params, get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..ops.conv_route import conv, prepare_convs


@dataclass(frozen=True)
class RCANConfig:
    scale: int
    n_resgroups: int
    n_resblocks: int
    n_feats: int
    n_colors: int
    rgb_range: int
    norm: bool
    kernel_size: int
    reduction: int
    unshuffle_mod: bool


def _rcab(p: PTree, x):
    """Residual Channel Attention Block (rcan/arch.py:168-196)."""
    res = F.relu(conv(p['body.0'], x))
    res = conv(p['body.2'], res)
    # CALayer at body.3
    y = res.mean(dim=(1, 2), keepdim=True)
    y = F.relu(conv(p['body.3.conv_du.0'], y))
    y = F.sigmoid(conv(p['body.3.conv_du.2'], y))
    return res * y + x


def prepare(cfg: RCANConfig, params, dtype):
    return prepare_convs(params, dtype)


def apply(cfg: RCANConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    h, wd = x.shape[1], x.shape[2]
    unshuffle = cfg.unshuffle_mod and cfg.scale <= 2
    downscale = 4 // cfg.scale if unshuffle else 1
    x = F.pad_to_multiple(x, downscale, mode='reflect')
    x = x * cfg.rgb_range
    if cfg.norm:
        x = conv(p['sub_mean'], x)
    if unshuffle:
        x = conv(p['head.1'], F.pixel_unshuffle(x, downscale))
    else:
        x = conv(p['head.0'], x)

    res = x
    for g in range(cfg.n_resgroups):
        gp = p.sub(f'body.{g}')
        r = res
        for b in range(cfg.n_resblocks):
            r = _rcab(gp.sub(f'body.{b}'), r)
        res = res + conv(gp[f'body.{cfg.n_resblocks}'], r)
    x = x + conv(p[f'body.{cfg.n_resgroups}'], res)

    tail_scale = 4 if unshuffle else cfg.scale
    if tail_scale & (tail_scale - 1) == 0:
        for i in range(int(math.log2(tail_scale))):
            x = F.pixel_shuffle(conv(p[f'tail.0.{2 * i}'], x), 2)
    elif tail_scale == 3:
        x = F.pixel_shuffle(conv(p['tail.0.0'], x), 3)
    x = conv(p['tail.1'], x)
    if cfg.norm:
        x = conv(p['add_mean'], x)
    return (x / cfg.rgb_range)[:, : h * cfg.scale, : wd * cfg.scale]


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/rcan.py::_load``."""
    n_resgroups = get_seq_len(sd, 'body') - 1
    n_resblocks = get_seq_len(sd, 'body.0.body') - 1
    head_index = 0
    scale, n_feats = get_pixelshuffle_params(sd, 'tail.0')
    unshuffle_mod = get_seq_len(sd, 'head') > 1
    n_colors = sd['tail.1.weight'].shape[0]
    if unshuffle_mod:
        head_index += 1
        unshuffled_channels = sd[f'head.{head_index}.weight'].shape[1]
        downscale_factor = int(math.sqrt(unshuffled_channels / n_colors))
        scale = 4 // downscale_factor
    norm = 'sub_mean.weight' in sd
    rgb_range = 255 if norm else 1  # undetectable; runtime uses 1 when no norm (arch.py:264-270)
    kernel_size = sd[f'head.{head_index}.weight'].shape[-1]
    reduction = n_feats // sd['body.0.body.0.body.3.conv_du.0.weight'].shape[0]

    cfg = RCANConfig(
        scale=scale, n_resgroups=n_resgroups, n_resblocks=n_resblocks, n_feats=n_feats,
        n_colors=n_colors, rgb_range=rgb_range, norm=norm, kernel_size=kernel_size,
        reduction=reduction, unshuffle_mod=unshuffle_mod,
    )
    meta = ModelMetadata(in_channels=n_colors, out_channels=n_colors, upscale=scale, name='RCAN')
    return SRModel('RCAN', cfg, params_from_numpy(sd, device), meta, apply, prepare)


ARCH = Architecture(
    id='RCAN',
    detect_condition=KeyCondition.has_any(
        KeyCondition.has_all(
            'head.0.weight', 'tail.1.weight', 'body.0.body.0.body.0.weight',
            'body.0.body.0.body.3.conv_du.0.weight',
        ),
        KeyCondition.has_all(
            'head.1.weight', 'tail.1.weight', 'body.0.body.0.body.0.weight',
            'body.0.body.0.body.3.conv_du.0.weight',
        ),
    ),
    load_fn=_load,
)
