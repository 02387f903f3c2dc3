"""LAWFFT: Local Adaptive Weighted Fourier Feature Transformer.

Counterpart of ``resselt_tpu/archs/lawfft.py``: the same config inference
(the ``upscale.MetaUpsample`` and scalar ``window_size`` buffers decoded
and dropped; the unshuffle stem's real scale recovered from its conv),
metadata and forward.  Meta blocks of a split token mixer (DynamicLocal:
per-sample depthwise 3x3 and 5x5 kernels generated from the channel means,
run as one grouped conv with the batch folded into the groups; FSAS:
frequency-domain q-k correlation by rfft2 / irfft2 in f32, over the whole
map in even blocks and over window x window patches in odd ones, then a
LayerNorm and the v gate), a gated depthwise-conv FFN, and the UniUpsample
tail.  Every same-padded 3x3 conv with groups 1 runs through
``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``): the stem and the tail's
3x3 convs (through ``PTree.conv``).  The 1x1 and depthwise convs, the
generated kernels (run in f32) and the FFTs (``nn.spectral``) stay plain
torch.  The weights are built once per compute dtype (``prepare``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as TF

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn import spectral
from ..nn.params import PTree
from ..nn.upsample import SAMPLE_MODS, uni_upsample
from ..ops.conv_route import conv, prepare_convs


@dataclass(frozen=True)
class LAWFFTConfig:
    in_ch: int
    dim: int
    split: float
    scale: int
    n_rblock: int
    n_mblock: int
    t_mid_factor: float
    window_size: int
    mlp_factor: float
    unshuffle_mod: bool
    unshuffle: int
    upsampler: str
    mid_dim: int


def _ln(p: PTree, name: str, x):
    return F.layer_norm(x, p[f'{name}.weight'], p[f'{name}.bias'], eps=1e-6)


def dynamic_local(p: PTree, x, k: int):
    """DynamicLocal (lawfft/arch.py:220-243): a depthwise k x k conv whose
    kernels (channel-major, as torch lays them out) are generated per
    sample from the channel means, as one conv of groups B x C over the
    batch folded into the channels.  That conv runs in f32 and its result
    is taken to ``x``'s dtype: on an H100, cuDNN's fp16 conv of this form
    (NCHW, one channel a group, 1 x 64 x 24 x 32 with groups 64) returned
    NaN after some earlier calls in the same process, and a later model's
    fp16 forward in that process lost accuracy; in f32 both stay right."""
    b, h, w, c = x.shape
    g = F.relu(conv(p['kernel_gen.1'], x.mean(dim=(1, 2), keepdim=True)))
    kern = conv(p['kernel_gen.3'], g).reshape(b * c, 1, k, k).float()
    out = TF.conv2d(x.permute(0, 3, 1, 2).reshape(1, b * c, h, w).float(), kern, padding=k // 2, groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _corr(q, k, s):
    """irfft2(rfft2(q) * rfft2(k)) over the last two axes, in f32."""
    qr, qi = spectral.rfft2_planes(q)
    kr, ki = spectral.rfft2_planes(k)
    return spectral.irfft2_planes(qr * kr - qi * ki, qr * ki + qi * kr, s=s)


def _fsas(p: PTree, x, patch_size: int, windowed: bool):
    """FSAS (lawfft/arch.py:245-307) on NHWC ``x``."""
    b, h, w, _ = x.shape
    hidden = conv(p['to_hidden_dw'], conv(p['to_hidden'], x))
    third = hidden.shape[-1] // 3
    q = hidden[..., :third].permute(0, 3, 1, 2)
    k = hidden[..., third : 2 * third].permute(0, 3, 1, 2)
    if windowed:
        ps = patch_size

        def patches(t):
            return t.reshape(b, third, h // ps, ps, w // ps, ps).transpose(3, 4)

        out = _corr(patches(q), patches(k), (ps, ps)).transpose(3, 4).reshape(b, third, h, w)
    else:
        out = _corr(q, k, (h, w))
    out = _ln(p, 'norm', out.permute(0, 2, 3, 1).to(x.dtype))
    return conv(p['project_out'], hidden[..., 2 * third :] * out)


def _meta_block(p: PTree, x, cfg: LAWFFTConfig, windowed: bool):
    """MetaFormer block (lawfft/arch.py:310-357): SFSAS (the DynamicLocal
    pair on the first ``split`` of the channels, FSAS on the rest, a 1x1
    ``last``), then the gated conv FFN, each after a LayerNorm, with a
    residual each."""
    y = _ln(p, 'token_mix.0', x)
    t = p.sub('token_mix.1')
    local = int(cfg.split * cfg.dim)
    y1 = dynamic_local(t.sub('local.1'), dynamic_local(t.sub('local.0'), y[..., :local], 3), 5)
    y2 = _fsas(t.sub('att'), y[..., local:], cfg.window_size, windowed)
    x = conv(t['last'], torch.cat([y1, y2], dim=-1)) + x

    f = p.sub('channel_mix1.1')
    y = conv(f['dwconv'], conv(f['project_in'], _ln(p, 'channel_mix1.0', x)))
    half = y.shape[-1] // 2
    return conv(f['project_out'], F.gelu(y[..., :half]) * y[..., half:]) + x


def prepare(cfg: LAWFFTConfig, params, dtype):
    """The convs for ``dtype``: FSAS's ``to_hidden_dw`` and the FFN's
    ``dwconv`` are depthwise."""
    groups = {k[: -len('.weight')]: v.shape[0] for k, v in params.items()
              if k.endswith(('.to_hidden_dw.weight', '.dwconv.weight'))}
    return prepare_convs(params, dtype, groups)


def apply(cfg: LAWFFTConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    h0, w0 = x.shape[1], x.shape[2]
    x = F.pad_to_multiple(x, cfg.window_size * (cfg.unshuffle if cfg.unshuffle_mod else 1), mode='reflect')
    if cfg.unshuffle_mod:
        feat = conv(p['in_to_dim.1'], F.pixel_unshuffle(x, cfg.unshuffle))
        up_scale = 4
    else:
        feat = conv(p['in_to_dim'], x)
        up_scale = cfg.scale

    out = feat
    for ri in range(cfg.n_rblock):
        rp = p.sub(f'body.{ri}')
        y = out
        for mi in range(cfg.n_mblock):
            y = _meta_block(rp.sub(f'residual.{mi}'), y, cfg, bool(mi % 2))
        out = dynamic_local(rp.sub(f'residual.{cfg.n_mblock}'), y, 3) + out
    out = uni_upsample(p.sub('upscale'), out + feat, cfg.upsampler, up_scale, cfg.in_ch, cfg.mid_dim)
    return out[:, : h0 * cfg.scale, : w0 * cfg.scale]


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/lawfft.py::_load``."""
    _, upsampler_idx, scale, dim, in_ch, mid_dim, _ = [int(v) for v in sd['upscale.MetaUpsample'].reshape(-1)]
    unshuffle_mod = 'in_to_dim.1.weight' in sd
    unshuffle = 1
    if unshuffle_mod:
        unshuffle = math.isqrt(sd['in_to_dim.1.weight'].shape[1] // in_ch)
        scale = 4 // unshuffle
    r = 'body.0.residual'
    split = 1 / (dim / sd[f'{r}.0.token_mix.1.local.0.kernel_gen.1.bias'].shape[0])
    global_dim = dim - int(dim * split)
    cfg = LAWFFTConfig(
        in_ch=in_ch, dim=dim, split=split, scale=scale, n_rblock=get_seq_len(sd, 'body'),
        n_mblock=get_seq_len(sd, r) - 1,
        t_mid_factor=sd[f'{r}.1.token_mix.1.att.to_hidden.bias'].shape[0] / global_dim / 3,
        window_size=int(np.asarray(sd['window_size']).reshape(-1)[0]),
        mlp_factor=sd[f'{r}.1.channel_mix1.1.project_in.bias'].shape[0] / dim / 2, unshuffle_mod=unshuffle_mod,
        unshuffle=unshuffle, upsampler=SAMPLE_MODS[upsampler_idx], mid_dim=mid_dim)
    params = {k: v for k, v in sd.items() if k not in ('upscale.MetaUpsample', 'window_size')}
    meta = ModelMetadata(in_channels=in_ch, out_channels=in_ch, upscale=scale, name='LAWFFT')
    return SRModel('LAWFFT', cfg, params_from_numpy(params, device), meta, apply, prepare)


def _mblock_keys(r: str) -> list[str]:
    """The keys of one meta block that detection asks for."""
    t, f = f'{r}.token_mix', f'{r}.channel_mix1'
    names = [f'{t}.0', *(f'{t}.1.local.{i}.kernel_gen.{j}' for i in (0, 1) for j in (1, 3)),
             *(f'{t}.1.att.{n}' for n in ('to_hidden', 'to_hidden_dw', 'project_out', 'norm')), f'{t}.1.last',
             f'{f}.0', *(f'{f}.1.{n}' for n in ('project_in', 'dwconv', 'project_out'))]
    return [f'{n}.{s}' for n in names for s in ('weight', 'bias')]


ARCH = Architecture(
    id='LAWFFT',
    detect_condition=KeyCondition.has_all(
        KeyCondition.has_any('in_to_dim.weight', 'in_to_dim.1.weight'),
        *_mblock_keys('body.0.residual.0'),
    ),
    load_fn=_load,
)
