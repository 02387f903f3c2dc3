"""RHA: Residual Hybrid Attention.

Counterpart of ``resselt_tpu/archs/rha.py``: the same config inference
(the scalar ``down_sample`` / ``unshuffle`` buffers and the
``to_img.MetaUpsample`` buffer decoded and dropped), metadata and forward,
with the JAX package's crop to the true scale (the reference crops an
unshuffle checkpoint's output with the internal scale 4).  Gated blocks
whose token mixer splits the channels: an OmniShift (collapsed at load
into one depthwise 5x5) on one half, focused linear window attention on
the other, max-pooled by the group's ``down`` factor, rolled by half a
window in every other block and upsampled bilinearly back; the
UniUpsample tail.  Every same-padded 3x3 conv runs through
``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``): the stem, ``fc1``, ``fc2``
with its Mish fused, and the tail's 3x3 convs (through ``PTree.conv``).
The depthwise and 1x1 convs, the linears and the attention stay plain
torch.  The weights are built once per compute dtype (``prepare``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.reparam import collapse_all, omnishift_collapse
from ..nn.upsample import SAMPLE_MODS, uni_upsample
from ..ops.conv_route import conv, prepare_convs


@dataclass(frozen=True)
class RHAConfig:
    dim: int
    scale: int
    in_ch: int
    out_ch: int
    mid_dim: int
    down_list: tuple[int, ...]
    expansion_ratio: float
    group_blocks: int
    res_blocks: int
    upsample: str
    unshuffle_mod: bool
    unshuffle: int
    window_size: int


def _norm(t):
    return torch.linalg.vector_norm(t, dim=-1, keepdim=True)


def _fla(p: PTree, x, ws: int, focusing_factor: int = 3):
    """FocusedLinearAttention (rha/arch.py:188-302) over ``ws`` x ``ws``
    windows of NHWC ``x``.  The linears and the depthwise ``dwc`` run in
    ``x``'s dtype; the focusing (``q ** 3`` of softplus-scaled
    activations), the norms, the two products and the ``z`` normaliser in
    f32 (the JAX package's f32 accumulation), the result taken to ``x``'s
    dtype: in fp16 the cube overflows or underflows and its norm divides by
    zero."""
    b0, h, w, c = x.shape
    windows = x.reshape(b0, h // ws, ws, w // ws, ws, c).transpose(2, 3).reshape(-1, ws * ws, c)
    b, n, _ = windows.shape
    hd = p.shape('dwc.weight')[0]
    nh = c // hd

    qkv = p.linear('qkv', windows)
    q, v = qkv[..., :c].float(), qkv[..., 2 * c :]
    k = (qkv[..., c : 2 * c] + p['positional_encoding'].to(x.dtype).reshape(1, n, c)).float()
    scale = torch.nn.functional.softplus(p['scale'].float()).reshape(1, 1, c)
    q = (F.relu(q) + 1e-6) / scale
    k = (F.relu(k) + 1e-6) / scale
    qn, kn = _norm(q), _norm(k)
    q, k = q**focusing_factor, k**focusing_factor
    q = q / _norm(q) * qn
    k = k / _norm(k) * kn

    q = q.reshape(b, n, nh, hd).transpose(1, 2)
    k = k.reshape(b, n, nh, hd).transpose(1, 2)
    v = v.reshape(b, n, nh, hd).transpose(1, 2)
    z = 1.0 / (q @ k.mean(dim=2, keepdim=True).transpose(-1, -2) + 1e-6)
    kv = (k * n**-0.5).transpose(-1, -2) @ (v.float() * n**-0.5)
    out = ((q @ kv) * z).to(x.dtype).transpose(1, 2).reshape(b, n, c)

    dwc = conv(p['dwc'], v.reshape(b * nh, ws, ws, hd))
    out = out + dwc.reshape(b, nh, n, hd).transpose(1, 2).reshape(b, n, c)
    out = p.linear('proj', out)
    return out.reshape(b0, h // ws, w // ws, ws, ws, c).transpose(2, 3).reshape(b0, h, w, c)


def _hybrid_attention(p: PTree, x, down: int, shift: int, ws: int):
    """HybridAttention (rha/arch.py:398-415)."""
    half = x.shape[-1] // 2
    x1 = conv(p['conv.conv5x5_reparam'], x[..., :half])
    y = x[..., half:]
    if down > 1:
        y = F.max_pool2d(y, down)
    if shift:
        y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
    y = _fla(p.sub('att.2'), y, ws)
    if shift:
        y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    if down > 1:
        y = F.interpolate_bilinear(y, scale_factor=down)
    return conv(p['aggr.0'], torch.cat([x1, y], dim=-1), 'mish') * x


def _gated_block(p: PTree, x, cfg: RHAConfig, down: int, shift: int):
    """GatedCNNBlock (rha/arch.py:418-451)."""
    shortcut = x
    x = F.layer_norm(x, p['norm.weight'], p['norm.bias'], eps=1e-6)
    hidden = int(cfg.expansion_ratio * cfg.dim)
    x = conv(p['fc1'], x)
    g = x[..., :hidden]
    i = x[..., hidden : 2 * hidden - cfg.dim]
    c = _hybrid_attention(p.sub('conv'), x[..., 2 * hidden - cfg.dim :], down, shift, cfg.window_size)
    return conv(p['fc2'], F.mish(g) * torch.cat([i, c], dim=-1), 'mish') + shortcut


def prepare(cfg: RHAConfig, params, dtype):
    """The convs for ``dtype``: each collapsed OmniShift is depthwise, each
    attention's ``dwc`` grouped by its head dim."""
    groups = {k[: -len('.weight')]: v.shape[0] for k, v in params.items()
              if k.endswith(('.conv5x5_reparam.weight', '.dwc.weight'))}
    return prepare_convs(params, dtype, groups)


def apply(cfg: RHAConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    h0, w0 = x.shape[1], x.shape[2]
    x = F.pad_to_multiple(x, cfg.unshuffle * max(cfg.down_list) * cfg.window_size, mode='reflect')
    if cfg.unshuffle_mod:
        feat = conv(p['to_feat.1'], F.pixel_unshuffle(x, cfg.unshuffle))
    else:
        feat = conv(p['to_feat'], x)

    out = feat
    for gi in range(cfg.group_blocks):
        gp = p.sub(f'body.{gi}')
        y = out
        for bi in range(cfg.res_blocks):
            y = _gated_block(gp.sub(f'body.{bi}'), y, cfg, cfg.down_list[gi], cfg.window_size // 2 if bi % 2 else 0)
        y = conv(gp[f'body.{cfg.res_blocks}.conv5x5_reparam'], y)
        out = conv(gp[f'body.{cfg.res_blocks + 1}'], y) + out
    out = out + feat

    to_img_scale = 4 if cfg.unshuffle_mod else cfg.scale
    out = uni_upsample(p.sub('to_img'), out, cfg.upsample, to_img_scale, cfg.out_ch, cfg.mid_dim)
    return out[:, : h0 * cfg.scale, : w0 * cfg.scale]


_MARKERS = {'alpha1': (omnishift_collapse, 'conv5x5_reparam')}


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/rha.py::_load``."""
    unshuffle = 1
    unshuffle_mod = False
    if 'unshuffle' in sd:
        unshuffle = int(sd['unshuffle'].reshape(-1)[0])
        unshuffle_mod = True
        dim, in_ch = sd['to_feat.1.weight'].shape[:2]
        in_ch //= unshuffle**2
    else:
        dim, in_ch = sd['to_feat.weight'].shape[:2]
    group_blocks = get_seq_len(sd, 'body')
    res_blocks = get_seq_len(sd, 'body.0.body') - 2
    down_list = tuple(int(sd[f'body.{i}.down_sample'].reshape(-1)[0]) for i in range(group_blocks))
    expansion_ratio = sd['body.0.body.0.fc1.weight'].shape[0] / 2 / dim
    _, index, scale, _, out_ch, upsample_dim, _ = [int(v) for v in sd['to_img.MetaUpsample'].reshape(-1)]
    window_size = math.isqrt(sd['body.0.body.0.conv.att.2.positional_encoding'].shape[1])

    cfg = RHAConfig(dim=dim, scale=scale // unshuffle, in_ch=in_ch, out_ch=out_ch, mid_dim=upsample_dim,
                    down_list=down_list, expansion_ratio=expansion_ratio, group_blocks=group_blocks,
                    res_blocks=res_blocks, upsample=SAMPLE_MODS[index], unshuffle_mod=unshuffle_mod,
                    unshuffle=unshuffle, window_size=window_size)
    params = {k: v for k, v in collapse_all(sd, _MARKERS).items()
              if k not in ('to_img.MetaUpsample', 'unshuffle') and not k.endswith('.down_sample')}
    meta = ModelMetadata(in_channels=in_ch, out_channels=out_ch, upscale=cfg.scale, name='RHA')
    return SRModel('RHA', cfg, params_from_numpy(params, device), meta, apply, prepare)


ARCH = Architecture(
    id='RHA',
    detect_condition=KeyCondition.has_all(
        'body.0.down_sample',
        'body.0.body.0.norm.weight',
        'body.0.body.0.fc1.weight',
        'body.0.body.0.conv.att.2.qkv.weight',
        'body.0.body.0.conv.att.2.positional_encoding',
        'body.0.body.0.conv.att.2.scale',
        'body.0.body.0.conv.att.2.dwc.weight',
        'body.0.body.0.conv.att.2.proj.weight',
        'body.0.body.0.conv.conv.alpha1',
        'body.0.body.0.conv.conv.conv1x1.weight',
        'body.0.body.0.conv.conv.conv3x3.weight',
        'body.0.body.0.conv.conv.conv5x5.weight',
        'body.0.body.0.conv.conv.conv5x5_reparam.weight',
        'body.0.body.0.conv.aggr.0.weight',
        'body.0.body.0.fc2.weight',
        'to_img.MetaUpsample',
    ),
    load_fn=_load,
)
