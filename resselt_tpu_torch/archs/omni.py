"""OmniSR — omni-axis (spatial and channel) self-attention SR, MaxViT-style.

Counterpart of ``resselt_tpu/archs/omni.py``: the same config inference
(kept verbatim) and the same forward, NHWC: residual groups of OSA blocks
(MBConv with its squeeze-excitation gate, block and grid window attention
with an optional learned relative-position bias, channel attention over
each window and over each in-window offset's grid, gated conv FFNs) each
closed by a 1x1 conv and the ESA spatial gate; a constant pad to the window
and a pixel-shuffle tail.

On the card both window attentions of every OSA block run through
``ops.window_mha`` (``csrc/window_attn.cu``): q, k and v read in place from
the qkv projection, no mask, the bias gathered from ``rel_pos_bias`` (or,
without it, a zero bias: the same scores) once per dtype by ``prepare``.
The JAX package rounds the scores to the activations' dtype before the
bias; the kernel keeps them in f32, so 16-bit outputs differ from it by that
rounding (in f32 the two agree).  The channel attentions (in the JAX
package's window-first form), convs, norms and linears are plain PyTorch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len, pixelshuffle_scale
from ..nn import functional as F
from ..nn.params import PTree, cast_params
from ..nn.window import (multi_head_attention, relative_position_bias, relative_position_index, window_partition,
                         window_reverse)

_BIAS = 'relative_position_bias'  # prepare's key for an attention's (heads, N, N) f32 bias


@dataclass(frozen=True)
class OmniConfig:
    num_in_ch: int
    num_out_ch: int
    num_feat: int
    block_num: int
    pe: bool
    window_size: int
    res_num: int
    up_scale: int
    bias: bool


def _heads(dim: int) -> int:
    """The window attentions' heads: dim // dim_head with dim_head = dim // 4."""
    return dim // (dim // 4)


def _mbconv(p: PTree, x, dim: int):
    """MBConv with expansion 1, its squeeze-excitation gate and the residual."""
    fn = p.sub('fn')
    y = F.gelu(fn.conv('0', x))
    y = F.gelu(fn.conv('2', y, padding=1, groups=dim))
    g = F.silu(F.linear(y.mean(dim=(1, 2)), fn['4.gate.1.weight']))
    g = F.sigmoid(F.linear(g, fn['4.gate.3.weight']))
    return fn.conv('5', y * g[:, None, None, :]) + x


def _win_attention(p: PTree, xw, heads: int):
    """Attention over (B', N, C) windows with the prepared bias."""
    c = xw.shape[-1]
    qkv = F.linear(xw, p['to_qkv.weight'])
    out = multi_head_attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], heads, (c // heads) ** -0.5,
                               bias=p[_BIAS])
    return F.linear(out, p['to_out.0.weight'])


def _grid_windows(x, ws: int):
    """'b (w1 x) (w2 y) d' -> (b*x*y, w1*w2, d): strided (dilated) windows,
    the grid counterpart of ``window_partition``."""
    b, h, w, c = x.shape
    x = x.reshape(b, ws, h // ws, ws, w // ws, c).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, ws * ws, c)


def _grid_unwindows(xw, ws: int, shape):
    b, h, w, c = shape
    return xw.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 3, 1, 4, 2, 5).reshape(b, h, w, c)


def _ln2d(p: PTree, x):
    """LayerNorm2d: a channel norm with (var + eps).sqrt()."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) / (var + 1e-6).sqrt()
    return y * p['norm.weight'].to(x.dtype) + p['norm.bias'].to(x.dtype)


def _gcff(p: PTree, x, dim: int):
    """Gated_Conv_FeedForward, mult 1, no biases."""
    fn = p.sub('fn')
    y = F.conv2d(x, fn['project_in.weight'])
    y = F.conv2d(y, fn['dwconv.weight'], padding=1, groups=2 * dim)
    return F.conv2d(F.gelu(y[..., :dim]) * y[..., dim:], fn['project_out.weight'])


def _channel_attn(p: PTree, x, ws: int, heads: int, grid: bool):
    """Channel_Attention (``grid`` False: over each window's ws x ws tokens)
    and Channel_Attention_grid (True: over each in-window offset's grid of
    windows), in the JAX package's window-first form: q and k L2-normalised
    over the tokens, a per-head temperature, channels kept last."""
    fn = p.sub('fn')
    b, h, w, c = x.shape
    qkv = F.conv2d(x, fn['qkv.weight'])
    qkv = F.conv2d(qkv, fn['qkv_dwconv.weight'], padding=1, groups=3 * c)
    hd = c // heads
    nx, ny = h // ws, w // ws
    t = qkv.reshape(b, nx, ws, ny, ws, 3 * c)
    if grid:  # tokens span the (X, Y) grid; batch = in-window offset
        t, n = t.permute(0, 2, 4, 1, 3, 5), nx * ny
    else:  # tokens span the (ws, ws) window; batch = window
        t, n = t.permute(0, 1, 3, 2, 4, 5), ws * ws
    t = t.reshape(-1, n, 3 * c)
    q, k, v = (t[..., i * c:(i + 1) * c].reshape(-1, n, heads, hd) for i in range(3))
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp_min(1e-12)
    k = k / torch.linalg.vector_norm(k, dim=1, keepdim=True).clamp_min(1e-12)
    attn = torch.einsum('bnhd,bnhe->bhde', q, k)
    attn = F.softmax(attn * fn['temperature'].to(x.dtype).reshape(1, heads, 1, 1))
    out = torch.einsum('bhde,bnhe->bnhd', attn, v).reshape(-1, n, c)
    if grid:
        out = out.reshape(b, ws, ws, nx, ny, c).permute(0, 3, 1, 4, 2, 5)
    else:
        out = out.reshape(b, nx, ny, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return F.conv2d(out.reshape(b, h, w, c), fn['project_out.weight'])


def _osa_block(p: PTree, x, cfg: OmniConfig):
    """OSA_Block: MBConv, block attention, FFN, window channel attention,
    FFN, grid attention, FFN, grid channel attention, FFN."""
    ws, dim = cfg.window_size, cfg.num_feat
    heads = _heads(dim)
    x = _mbconv(p.sub('layer.0'), x, dim)
    for attn_key, ffn_keys, grid in (('2', ('4', '5', '6'), False), ('8', ('10', '11', '12'), True)):
        q = p.sub(f'layer.{attn_key}')
        xw = _grid_windows(x, ws) if grid else window_partition(x, ws)
        xw = xw + _win_attention(q.sub('fn'), q.layer_norm('norm', xw), heads)
        x = _grid_unwindows(xw, ws, x.shape) if grid else window_reverse(xw, ws, x.shape[1], x.shape[2])
        f1, ca, f2 = (p.sub(f'layer.{k}') for k in ffn_keys)
        x = _gcff(f1, _ln2d(f1, x), dim) + x
        x = _channel_attn(ca, _ln2d(ca, x), ws, 4, grid=grid) + x
        x = _gcff(f2, _ln2d(f2, x), dim) + x
    return x


def _esa(p: PTree, x):
    """ESA spatial gate: a strided conv, a 7x7 / 3 max pool, a conv, bilinear
    back to the input's size."""
    c1_ = p.conv('conv1', x)
    c1 = p.conv('conv2', c1_, stride=2)
    c3 = p.conv('conv3', F.max_pool2d(c1, 7, stride=3), padding=1)
    c3 = F.interpolate_bilinear(c3, size=(x.shape[1], x.shape[2]), align_corners=False)
    c4 = p.conv('conv4', c3 + p.conv('conv_f', c1_))
    return x * F.sigmoid(c4)


def prepare(cfg: OmniConfig, params, dtype: torch.dtype) -> dict:
    """The params in ``dtype``, plus each block and grid attention's bias
    under ``....layer.{2,8}.fn.relative_position_bias`` ((heads, N, N) f32,
    contiguous): its ``rel_pos_bias`` table gathered through the window's
    relative-position index and rounded to ``dtype``, or zeros without
    one."""
    out = cast_params(params, dtype)
    ws = cfg.window_size
    device = next(iter(params.values())).device
    rpi = torch.from_numpy(relative_position_index(ws, ws)).to(device)
    zero = None if cfg.pe else torch.zeros((_heads(cfg.num_feat), ws * ws, ws * ws), device=device)
    for ri in range(cfg.res_num):
        for bi in range(cfg.block_num):
            for layer in ('2', '8'):
                a = f'residual_layer.{ri}.residual_layer.{bi}.layer.{layer}.fn'
                out[f'{a}.{_BIAS}'] = (relative_position_bias(params[f'{a}.rel_pos_bias.weight'], rpi, dtype)
                                       if cfg.pe else zero)
    return out


def apply(cfg: OmniConfig, params, x):
    """Forward on NHWC ``x`` with ``params = prepare(cfg, ..., x.dtype)``."""
    p = PTree(params)
    h0, w0 = x.shape[1], x.shape[2]
    x = F.pad_to_multiple(x, cfg.window_size, mode='constant')

    residual = p.conv('input', x, padding=1)
    out = residual
    for ri in range(cfg.res_num):
        rp = p.sub(f'residual_layer.{ri}')
        y = out
        for bi in range(cfg.block_num):
            y = _osa_block(rp.sub(f'residual_layer.{bi}'), y, cfg)
        y = rp.conv(f'residual_layer.{cfg.block_num}', y) + out
        out = _esa(rp.sub('esa'), y)
    out = p.conv('output', out, padding=1) + residual
    out = F.pixel_shuffle(p.conv('up.0', out, padding=1), cfg.up_scale)
    return out[:, : h0 * cfg.up_scale, : w0 * cfg.up_scale].contiguous()


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/omni.py::_load``."""
    sd = {k: v for k, v in sd.items() if not k.endswith(('total_ops', 'total_params'))}
    window_size = 8

    num_feat = sd['input.weight'].shape[0]
    num_in_ch = sd['input.weight'].shape[1]
    bias = 'input.bias' in sd
    up_scale = pixelshuffle_scale(sd['up.0.weight'].shape[0], num_in_ch)
    res_num = get_seq_len(sd, 'residual_layer')
    block_num = get_seq_len(sd, 'residual_layer.0.residual_layer') - 1

    rel_key = 'residual_layer.0.residual_layer.0.layer.2.fn.rel_pos_bias.weight'
    if rel_key in sd:
        pe = True
        window_size = int((math.sqrt(sd[rel_key].shape[0]) + 1) / 2)
    else:
        pe = False

    cfg = OmniConfig(
        num_in_ch=num_in_ch, num_out_ch=num_in_ch, num_feat=num_feat, block_num=block_num,
        pe=pe, window_size=window_size, res_num=res_num, up_scale=up_scale, bias=bias,
    )
    meta = ModelMetadata(in_channels=num_in_ch, out_channels=num_in_ch, upscale=up_scale, name='OmniSR')
    return SRModel('OmniSR', cfg, params_from_numpy(sd, device), meta, apply, prepare)


ARCH = Architecture(
    id='OmniSR',
    detect_condition=KeyCondition.has_all(
        'residual_layer.0.residual_layer.0.layer.0.fn.0.weight',
        'input.weight',
        'up.0.weight',
    ),
    load_fn=_load,
)
