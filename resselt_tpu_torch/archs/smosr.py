"""SMoSR: Simple MoSR with over-parameterized convs.

Counterpart of ``resselt_tpu/archs/smosr.py``: the same config inference
(the ``upsampler.MetaUpsample`` buffer decoded and dropped; DySample's end
conv kernel read where DySample sits), metadata and forward.  The DOConv2d
and ConvNXC bundles are collapsed to plain convs at load, ConvNXC first,
and the stale nested ``eval_conv`` buffers of ``rep=True`` checkpoints are
dropped (``transform_params``).  SMB tanh-gated blocks, learnable-identity
``short`` convs, the UniUpsampleV4_light tail (six modes), the fixed reflect
pad of 2 and the ``scale * 2`` output crop.  Every same-padded 3x3 conv
runs through ``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``), an SMB's
first two with their SiLU fused; the 1x1 convs and DySample's offset and
scope stay plain torch.  The upsampler's leaky ReLU of slope 0.01 runs
after its conv (the kernel's slope is 0.2).  The weights are built once
per compute dtype (``prepare``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.reparam import convnxc_collapse, doconv_collapse
from ..nn.upsample import dysample
from ..ops.conv_route import conv, prepare_convs

_V4_MODS = ('conv', 'pixelshuffledirect', 'pixelshuffle', 'nearest+conv', 'dysample', 'pa_up')


@dataclass(frozen=True)
class SMoSRConfig:
    in_ch: int
    out_ch: int
    dim: int
    scale: int
    rep: bool
    n_mb: int
    upsampler: str
    mid_dim: int
    group: int
    d_kernel: int


def _ec(p: PTree, name: str, x, act: str = 'linear'):
    """The collapsed ``{name}.eval_conv``, same-padded, then ``act``."""
    return conv(p[f'{name}.eval_conv'], x, act)


def _smb(p: PTree, x):
    """SMB (smosr/arch.py:379-416)."""
    y = _ec(p, 'body.2', _ec(p, 'body.0', x, 'silu'), 'silu')
    y = _ec(p, 'body.4', y)
    c = y.shape[-1] // 2
    short = conv(p['short'], x) if 'short' in p else x
    return (y[..., :c] + short) * torch.tanh(y[..., c:])


def _uni_v4(p: PTree, x, cfg: SMoSRConfig):
    """UniUpsampleV4_light (smosr/arch.py:87-209)."""
    mode, scale = cfg.upsampler, cfg.scale
    pow2 = scale & (scale - 1) == 0
    if scale == 1 or mode == 'conv':
        return _ec(p, '0', x)
    if mode == 'pixelshuffledirect':
        return F.pixel_shuffle(_ec(p, '0', x), scale)
    if mode == 'pixelshuffle':
        x = F.leaky_relu(_ec(p, '0', x), 0.01)
        idx = 2
        for r in [2] * int(math.log2(scale)) if pow2 else [3] if scale == 3 else []:
            x = F.pixel_shuffle(_ec(p, str(idx), x), r)
            idx += 2
        return _ec(p, str(idx), x)
    if mode == 'nearest+conv':
        if pow2:
            idx = 0
            for _ in range(int(math.log2(scale))):
                x = F.leaky_relu(F.interpolate_nearest(_ec(p, str(idx), x), scale_factor=2), 0.2)
                idx += 3
            return _ec(p, str(idx + 2), _ec(p, str(idx), x, 'lrelu'))
        x = F.leaky_relu(F.interpolate_nearest(_ec(p, '0', x), scale_factor=3), 0.2)
        return _ec(p, '5', _ec(p, '3', x, 'lrelu'))
    if mode == 'dysample':
        if '0.eval_conv' in p:
            x = F.leaky_relu(_ec(p, '0', x), 0.01)
            dys = p.sub('2')
        else:
            dys = p.sub('0')
        out = dysample(dys, x, scale, groups=cfg.group, end_convolution=False)
        return dys.conv('end_conv', out, padding=cfg.d_kernel // 2)
    if mode == 'pa_up':
        stages, factor = (int(math.log2(scale)), 2) if pow2 else (1, 3)
        idx = 0
        for _ in range(stages):
            x = _ec(p, str(idx + 1), F.interpolate_nearest(x, scale_factor=factor))
            x = F.leaky_relu(x * F.sigmoid(_ec(p, f'{idx + 2}.conv.0', x)), 0.2)
            x = _ec(p, str(idx + 4), x, 'lrelu')
            idx += 6
        return _ec(p, str(idx), x)
    raise ValueError(f'Unknown UniUpsampleV4 mode {mode}')


def prepare(cfg: SMoSRConfig, params, dtype):
    return prepare_convs(params, dtype)


def apply(cfg: SMoSRConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    x = F.pad2d(x, (2, 2, 2, 2), mode='reflect')
    short = conv(p['short'], x)
    x = _smb(p.sub('blocks_1.1'), _smb(p.sub('blocks_1.0'), x))
    y = x
    for i in range(cfg.n_mb):
        y = _smb(p.sub(f'blocks_2.{i}'), y)
    x = _ec(p, 'end_block.1', _smb(p.sub('end_block.0'), y + x))
    out = _uni_v4(p.sub('upsampler'), torch.cat([short, x], dim=-1), cfg)
    crop = cfg.scale * 2
    return out[:, crop:-crop, crop:-crop, :]


def transform_params(sd) -> dict:
    """Collapse every ConvNXC (found by ``.sk.W``), then every remaining
    DOConv2d (found by ``.W``), into ``{prefix}.eval_conv`` weights (numpy);
    under a collapsed prefix only the collapsed outputs stay (a ``rep=True``
    checkpoint also holds the torch modules' nested ``eval_conv`` buffers,
    several times the weights the forward needs)."""
    out = dict(sd)
    consumed: list[str] = []
    collapsed: set[str] = set()

    def emit(prefix, w, b):
        out[f'{prefix}.eval_conv.weight'] = w
        out[f'{prefix}.eval_conv.bias'] = b
        collapsed.update((f'{prefix}.eval_conv.weight', f'{prefix}.eval_conv.bias'))
        consumed.append(prefix + '.')

    for prefix in sorted({k[: -len('.sk.W')] for k in sd if k.endswith('.sk.W')}):
        emit(prefix, *convnxc_collapse(sd, prefix))
    for prefix in sorted({k[: -len('.W')] for k in sd
                          if k.endswith('.W') and not any(k.startswith(c) for c in consumed)}):
        emit(prefix, *doconv_collapse(sd, prefix))
    return {k: v for k, v in out.items() if k in collapsed or not any(k.startswith(c) for c in consumed)}


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/smosr.py::_load``."""
    dim, in_ch = sd['blocks_1.0.body.0.eval_conv.weight'].shape[:2]
    n_mb = get_seq_len(sd, 'blocks_2')
    _, upsampler_idx, scale, _, out_dim, mid_dim, group, rep = [int(i) for i in sd['upsampler.MetaUpsample'].reshape(-1)]
    # DySample sits at 'upsampler.0' without a leading conv (mid_dim == in_dim), else at 'upsampler.2'
    d_conv = 1
    if upsampler_idx == 4:
        for k in ('upsampler.2.end_conv.weight', 'upsampler.0.end_conv.weight'):
            if k in sd:
                d_conv = int(sd[k].shape[2])
                break

    cfg = SMoSRConfig(in_ch=in_ch, out_ch=out_dim, dim=dim, scale=scale, rep=bool(rep), n_mb=n_mb,
                      upsampler=_V4_MODS[upsampler_idx], mid_dim=mid_dim, group=group, d_kernel=d_conv)
    params = {k: v for k, v in transform_params(sd).items() if k != 'upsampler.MetaUpsample'}
    meta = ModelMetadata(in_channels=in_ch, out_channels=out_dim, upscale=scale, name='SMoSR')
    return SRModel('SMoSR', cfg, params_from_numpy(params, device), meta, apply, prepare)


ARCH = Architecture(
    id='SMoSR',
    detect_condition=KeyCondition.has_all(
        'short.weight',
        'short.bias',
        'blocks_1.0.short.weight',
        'blocks_1.0.short.bias',
        'blocks_1.0.body.0.eval_conv.weight',
        'blocks_1.0.body.0.eval_conv.bias',
        'blocks_1.0.body.2.eval_conv.weight',
        'blocks_1.0.body.4.eval_conv.weight',
        'blocks_1.1.body.0.eval_conv.weight',
        'blocks_1.1.body.2.eval_conv.weight',
        'blocks_1.1.body.4.eval_conv.weight',
        'blocks_2.0.body.0.eval_conv.weight',
        'blocks_2.0.body.2.eval_conv.weight',
        'blocks_2.0.body.4.eval_conv.weight',
        'end_block.0.body.0.eval_conv.weight',
        'end_block.0.body.2.eval_conv.weight',
        'end_block.0.body.4.eval_conv.weight',
        'end_block.1.eval_conv.weight',
        'end_block.1.eval_conv.bias',
        'upsampler.MetaUpsample',
    ),
    load_fn=_load,
)
