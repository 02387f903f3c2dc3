"""RTMoSR: Real-Time MoSR with reparameterized conv bundles.

Counterpart of ``resselt_tpu/archs/rtmosr.py``: the same config inference,
metadata (the true scale, where the reference reports 2 for every
checkpoint) and forward.  Each RepConv (SeqConv3x3 + 3x3 + Conv3XC with
alphas) and OmniShift (identity + depthwise 1x1 / 3x3 / 5x5 with
per-channel alphas) is collapsed once at load into one conv
(``nn.reparam``).  Every same-padded 3x3 conv runs through
``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``): the stem, per block
``fc1``, the pooled branch's ``poll.1`` and (with DCCM) ``fc2`` with its
Mish fused, and the ``to_img`` head.  The OmniShift's depthwise 5x5, the
CSE's 1x1 convs and a 1x1 ``fc2`` stay plain torch.  The weights are built
once per compute dtype (``prepare``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.reparam import collapse_all, omnishift_collapse, repconv_collapse
from ..ops.conv_route import conv, prepare_convs


@dataclass(frozen=True)
class RTMoSRConfig:
    scale: int
    dim: int
    ffn_expansion: float
    n_blocks: int
    unshuffle_mod: bool
    dccm: bool
    se: bool


def _cse(p: PTree, x):
    """CSELayer (rtmosr/arch.py:7-21): mean, 1x1, ReLU, 1x1, hardsigmoid."""
    s = x.mean(dim=(1, 2), keepdim=True)
    s = F.relu(conv(p['squeezing.0'], s))
    return x * F.hardsigmoid(conv(p['squeezing.2'], s))


def _gated_block(p: PTree, x, cfg: RTMoSRConfig):
    """GatedCNNBlock (rtmosr/arch.py:302-337)."""
    shortcut = x
    x = F.rms_norm_ref(x, p['norm.scale'], p['norm.offset'])
    hidden = int(cfg.ffn_expansion * cfg.dim)
    x = conv(p['fc1.conv_3x3_rep'], x)
    g = x[..., :hidden]
    i = x[..., hidden : 2 * hidden - cfg.dim]
    c = x[..., 2 * hidden - cfg.dim :]

    # ParPixelUnshuffle(dim, 4 dim, 2) -> OmniShift(4 dim) -> [CSE] -> PixelShuffle(2)
    c = F.pixel_unshuffle(c, 2) + conv(p['conv.0.poll.1.conv_3x3_rep'], F.max_pool2d(c, 2))
    c = conv(p['conv.1.conv5x5_reparam'], c)
    if cfg.se:
        c = _cse(p.sub('conv.2'), c)
    c = F.pixel_shuffle(c, 2)

    x = F.mish(g) * torch.cat([i, c], dim=-1)
    if cfg.dccm:
        return conv(p['fc2.conv_3x3_rep'], x, 'mish') + shortcut
    return F.mish(conv(p['fc2'], x)) + shortcut


def prepare(cfg: RTMoSRConfig, params, dtype):
    """The convs for ``dtype``: each collapsed OmniShift is depthwise."""
    groups = {k[: -len('.weight')]: v.shape[0] for k, v in params.items()
              if k.endswith('.conv5x5_reparam.weight')}
    return prepare_convs(params, dtype, groups)


def apply(cfg: RTMoSRConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    h, wd = x.shape[1], x.shape[2]
    unshuffle = 0
    scale = cfg.scale
    if cfg.scale < 4 and cfg.unshuffle_mod:
        unshuffle = 4 // cfg.scale
        scale = 4
    out = F.pad_to_multiple(x, (unshuffle if unshuffle > 0 else 1) * 2, mode='reflect')
    if unshuffle:
        out = conv(p['to_feat.1.conv_3x3_rep'], F.pixel_unshuffle(out, unshuffle))
    else:
        out = conv(p['to_feat.conv_3x3_rep'], out)
    for i in range(cfg.n_blocks):
        out = _gated_block(p.sub(f'body.{i}'), out, cfg)
    out = F.pixel_shuffle(conv(p['to_img.0.conv_3x3_rep'], out), scale)
    return out[:, : h * cfg.scale, : wd * cfg.scale] + F.interpolate_nearest(x, scale_factor=cfg.scale)


_MARKERS = {
    'alpha': (repconv_collapse, 'conv_3x3_rep'),
    'alpha1': (omnishift_collapse, 'conv5x5_reparam'),
}


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/rtmosr.py::_load``."""
    unshuffle = False
    if 'to_feat.1.alpha' in sd:
        unshuffle = True
        scale = math.isqrt(sd['to_feat.1.conv_3x3_rep.weight'].shape[1] // 3)
        dim = sd['to_feat.1.conv_3x3_rep.weight'].shape[0]
    else:
        scale = math.isqrt(sd['to_img.0.conv_3x3_rep.weight'].shape[0] // 3)
        dim = sd['to_feat.conv_3x3_rep.weight'].shape[0]
    dccm = 'body.0.fc2.alpha' in sd
    se = 'body.0.conv.2.squeezing.0.weight' in sd
    ffn = sd['body.0.fc1.conv_3x3_rep.weight'].shape[0] / dim / 2
    n_blocks = get_seq_len(sd, 'body')
    if unshuffle:
        # the stem reads a pixel-unshuffled input of 3 u^2 channels; the real scale is 4 / u
        scale = 4 // scale if scale in (1, 2, 4) else scale

    cfg = RTMoSRConfig(scale=scale, dim=dim, ffn_expansion=ffn, n_blocks=n_blocks, unshuffle_mod=unshuffle,
                       dccm=dccm, se=se)
    meta = ModelMetadata(in_channels=3, out_channels=3, upscale=scale, name='RTMoSR')
    return SRModel('RTMoSR', cfg, params_from_numpy(collapse_all(sd, _MARKERS), device), meta, apply, prepare)


ARCH = Architecture(
    id='RTMoSR',
    detect_condition=KeyCondition.has_all(
        'body.0.norm.scale',
        'body.0.norm.offset',
        'body.0.fc1.alpha',
        'body.0.fc1.conv1.k0',
        'body.0.fc1.conv1.b1',
        'body.0.fc1.conv2.weight',
        'body.0.fc1.conv3.sk.weight',
        'body.0.fc1.conv3.eval_conv.weight',
        'body.0.fc1.conv_3x3_rep.weight',
        'body.0.conv.0.poll.1.alpha',
        'body.0.conv.0.poll.1.conv_3x3_rep.weight',
        'body.0.conv.1.alpha1',
        'body.0.conv.1.alpha4',
        'body.0.conv.1.conv1x1.weight',
        'body.0.conv.1.conv3x3.weight',
        'body.0.conv.1.conv5x5.weight',
        'body.0.conv.1.conv5x5_reparam.weight',
        'to_img.0.alpha',
        'to_img.0.conv_3x3_rep.weight',
    ),
    load_fn=_load,
)
