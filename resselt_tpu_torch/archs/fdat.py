"""FDAT — Fast Dual Aggregation Transformer.

Counterpart of ``resselt_tpu/archs/fdat.py``: the same config inference
(kept verbatim), the same serving hints and the same forward, NHWC: groups
of blocks that alternate spatial-window attention (a learned (heads, N, N)
bias per window position pair) and channel attention (XCiT-style, over all
H x W tokens of the tile), each beside a depthwise conv branch that it
modulates or is modulated by (SimplifiedAIM), a depthwise-mixed FFN, an
optional pixel-unshuffle stem and a UniUpsampleV3 tail read from the
``MetaUpsample`` buffer.

On the card every spatial attention runs through ``ops.window_mha``
(``csrc/window_attn.cu``): one launch per spatial block, q, k and v read in
place from the qkv projection, no mask.  ``prepare`` casts the params to the
compute dtype once and rounds each block's bias to it (as the JAX package
casts it on every forward), held in f32 for the kernel.  The channel
attention, convs, layer norms, linears and the upsampler are plain PyTorch;
the channel attention's L2 norms and products accumulate in f32 in 16-bit
(``torch.linalg.vector_norm`` and cuBLAS).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree, cast_params
from ..nn.upsample import SAMPLE_MODS3, uni_upsample_v3
from ..nn.window import multi_head_attention, window_partition, window_reverse

_BIAS = 'relative_position_bias'  # prepare's key for a block's rounded f32 bias


@dataclass(frozen=True)
class FDATConfig:
    num_in_ch: int
    num_out_ch: int
    scale: int
    embed_dim: int
    num_groups: int
    depth: int  # blocks per group (= depth_per_group * len(pattern))
    num_heads: int
    window_size: int
    ffn_expansion_ratio: float
    aim_reduction_ratio: int
    mid_dim: int
    upsampler_type: str
    unshuffle_mod: bool


def _spatial_attn(p: PTree, x, nh: int, ws: int):
    """FastSpatialWindowAttention: zero-padded to the window inside,
    windowed, attended with the prepared bias, put back and cropped."""
    b, h, w, c = x.shape
    pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_b or pad_r:
        x = F.pad2d(x, (0, pad_r, 0, pad_b))
    qkv = p.linear('qkv', window_partition(x, ws))
    out = multi_head_attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], nh, (c // nh) ** -0.5,
                               bias=p[_BIAS])
    out = window_reverse(p.linear('proj', out), ws, h + pad_b, w + pad_r)
    return out[:, :h, :w] if pad_b or pad_r else out


def _channel_attn(p: PTree, x, nh: int):
    """FastChannelAttention: attention across the channels of each head over
    all tokens, q and k L2-normalised over the tokens, scaled by a per-head
    temperature; the products in x's dtype (f32 accumulate, then cast), as
    the JAX package rounds."""
    b, h, w, c = x.shape
    n = h * w
    qkv = p.linear('qkv', x.reshape(b, n, c))
    hd = c // nh

    def per_head(t):  # (b, n, c) -> (b, nh, hd, n): channels are the tokens
        return t.reshape(b, n, nh, hd).permute(0, 2, 3, 1)

    q, k, v = per_head(qkv[..., :c]), per_head(qkv[..., c:2 * c]), per_head(qkv[..., 2 * c:])
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    k = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12)
    attn = F.softmax(torch.matmul(q, k.transpose(-1, -2)) * p['temp'].to(x.dtype).reshape(1, nh, 1, 1))
    out = torch.matmul(attn, v).permute(0, 3, 1, 2).reshape(b, n, c)
    return p.linear('proj', out).reshape(b, h, w, c)


def _block(p: PTree, x, cfg: FDATConfig, spatial: bool):
    """SimplifiedDATBlock: attention beside a depthwise conv branch, fused
    by SimplifiedAIM (the channel gate modulates a spatial block's
    attention, the spatial gate a channel block's conv branch), then the
    FFN with its depthwise mix."""
    n1 = p.layer_norm('n1', x)
    if spatial:
        attn_feat = _spatial_attn(p.sub('attn'), n1, cfg.num_heads, cfg.window_size)
    else:
        attn_feat = _channel_attn(p.sub('attn'), n1, cfg.num_heads)
    conv_feat = F.gelu(F.conv2d(n1, p['conv.0.weight'], padding=1, groups=cfg.embed_dim))
    if spatial:
        cm = F.gelu(F.conv2d(conv_feat.mean(dim=(1, 2), keepdim=True), p['inter.cg.1.weight']))
        fused = attn_feat * F.sigmoid(F.conv2d(cm, p['inter.cg.3.weight'])) + conv_feat
    else:
        fused = attn_feat + conv_feat * F.sigmoid(F.conv2d(attn_feat, p['inter.sg.0.weight']))
    x = x + fused

    y = F.gelu(F.linear(p.layer_norm('n2', x), p['ffn.fc1.weight']))
    y = F.conv2d(y, p['ffn.smix.weight'], padding=1, groups=y.shape[-1])
    return x + F.linear(y, p['ffn.fc2.weight'])


def prepare(cfg: FDATConfig, params, dtype: torch.dtype) -> dict:
    """The params in ``dtype``, plus each spatial block's bias under
    ``groups.{g}.blocks.{b}.attn.relative_position_bias`` ((heads, N, N),
    rounded to ``dtype``, held in f32, contiguous)."""
    out = cast_params(params, dtype)
    for gi in range(cfg.num_groups):
        for bi in range(0, cfg.depth, 2):
            a = f'groups.{gi}.blocks.{bi}.attn'
            out[f'{a}.{_BIAS}'] = params[f'{a}.bias'].to(dtype).float().contiguous()
    return out


def apply(cfg: FDATConfig, params, x):
    """Forward on NHWC ``x`` with ``params = prepare(cfg, ..., x.dtype)``."""
    p = PTree(params)
    h0, w0 = x.shape[1], x.shape[2]
    if cfg.unshuffle_mod and cfg.scale < 3:
        unshuffle = 4 // cfg.scale
        x = F.pixel_unshuffle(F.pad_to_multiple(x, unshuffle), unshuffle)
        shallow = p.conv('conv_first.1', x, padding=1)
        up_scale = 4
    else:
        shallow = p.conv('conv_first', x, padding=1)
        up_scale = cfg.scale

    deep = shallow
    for gi in range(cfg.num_groups):
        gp = p.sub(f'groups.{gi}')
        y = deep
        for bi in range(cfg.depth):
            y = _block(gp.sub(f'blocks.{bi}'), y, cfg, bi % 2 == 0)
        deep = gp.conv('conv', y, padding=1) + deep
    deep = p.conv('conv_after', deep, padding=1)

    out = uni_upsample_v3(p.sub('upsampler'), deep + shallow, cfg.upsampler_type, up_scale, cfg.num_out_ch,
                          cfg.mid_dim, group=4, dysample_end_kernel=1)
    return out[:, : h0 * cfg.scale, : w0 * cfg.scale].contiguous()


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/fdat.py::_load``."""
    meta_buf = [int(i) for i in sd['upsampler.MetaUpsample'].reshape(-1)]
    _, upsampler_index, scale, embed_dim, num_out_ch, mid_dim, _ = meta_buf
    upsampler_type = SAMPLE_MODS3[upsampler_index]

    if 'conv_first.1.weight' in sd:
        num_in_ch = num_out_ch
        scale = 4 // math.isqrt(sd['conv_first.1.weight'].shape[1] // num_in_ch)
        unshuffle_mod = True
    else:
        unshuffle_mod = False
        num_in_ch = sd['conv_first.weight'].shape[1]

    num_groups = get_seq_len(sd, 'groups')
    depth = get_seq_len(sd, 'groups.0.blocks')
    num_heads = sd['groups.0.blocks.0.attn.bias'].shape[0]
    window_size = math.isqrt(sd['groups.0.blocks.0.attn.bias'].shape[2])
    ffn_expansion_ratio = float(sd['groups.0.blocks.0.ffn.fc1.weight'].shape[0] / embed_dim)
    aim_reduction_ratio = embed_dim // sd['groups.0.blocks.0.inter.cg.1.weight'].shape[0]

    cfg = FDATConfig(
        num_in_ch=num_in_ch, num_out_ch=num_out_ch, scale=scale, embed_dim=embed_dim,
        num_groups=num_groups, depth=depth, num_heads=num_heads, window_size=window_size,
        ffn_expansion_ratio=ffn_expansion_ratio, aim_reduction_ratio=aim_reduction_ratio,
        mid_dim=mid_dim, upsampler_type=upsampler_type, unshuffle_mod=unshuffle_mod,
    )
    params = {k: v for k, v in sd.items() if k != 'upsampler.MetaUpsample'}
    meta = ModelMetadata(in_channels=num_in_ch, out_channels=num_out_ch, upscale=scale, name='FDAT')
    model = SRModel('FDAT', cfg, params_from_numpy(params, device), meta, apply, prepare)
    # the JAX package's hints, kept so that tiled outputs match it; their
    # values have not been re-measured on a GPU
    model.tile_batch = 2
    model.serving_tile = 128
    model.serving_halo = 8
    # an unshuffle stem sees (H / unshuffle, W / unshuffle): windows pad-free
    # at multiples of window_size * unshuffle
    unshuffle = 4 // scale if (unshuffle_mod and scale < 3) else 1
    model.size_multiple = window_size * unshuffle
    return model


ARCH = Architecture(
    id='FDAT',
    detect_condition=KeyCondition.has_all(
        'groups.0.blocks.0.attn.bias',
        'groups.0.blocks.0.inter.cg.1.weight',
        'groups.0.blocks.0.ffn.fc1.weight',
        'groups.0.blocks.0.n1.weight',
        'upsampler.MetaUpsample',
    ),
    load_fn=_load,
)
