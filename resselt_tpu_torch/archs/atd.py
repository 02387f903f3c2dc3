"""ATD — Adaptive Token Dictionary transformer.

Counterpart of ``resselt_tpu/archs/atd.py``: the same config inference
(kept verbatim, including ``category_size`` 128 for the light model and 256
otherwise), the same serving hints and the same forward, NHWC.  Each layer
shares one qkv projection among three branches: the shifted-window
attention, the token-dictionary cross attention ATD_CA, and the
category-based attention AC_MSA, which sorts the tokens by their
dictionary category (argmax, then a stable sort: ties keep their original
order, so the output is deterministic), attends inside fixed-size groups
of the sorted sequence, and puts the rows back.

On the card the window attention runs through ``ops.window_mha``
(``csrc/window_attn.cu``, q, k and v read in place from the partitioned
qkv: one launch per layer) and both of AC_MSA's row shuffles through
``ops.row_gather`` (``csrc/row_gather.cu``: two launches per layer).
ATD_CA and AC_MSA's grouped attention have no bias and are plain matrix
products, with the JAX package's rounding points (scores accumulated in
f32, rounded to the activations' dtype, then scaled, then softmax).
``prepare`` casts the params once per dtype and gathers each layer's
relative-position bias once; the shift masks are built once per geometry
and device.

AC_MSA's grouping is discontinuous in the similarity scores: a token whose
two best categories lie a rounding step apart lands in another group under
another summation order (another device, dtype or batch), and its output
then differs by far more than rounding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_pixelshuffle_params, get_seq_len, pixelshuffle_scale
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.window import (
    multi_head_attention,
    relative_position_bias,
    shift_mask,
    window_partition,
    window_reverse,
)
from ..ops import row_gather

_RGB_MEAN = (0.4488, 0.4371, 0.4040)
_MASKS = 'shift_masks'  # prepare's key for the shift-mask cache


@dataclass(frozen=True)
class ATDConfig:
    in_chans: int
    embed_dim: int
    depths: tuple[int, ...]
    num_heads: tuple[int, ...]
    window_size: int
    category_size: int
    num_tokens: int
    reducted_dim: int
    convffn_kernel_size: int
    mlp_ratio: float
    qkv_bias: bool
    upscale: int
    img_range: float
    upsampler: str
    resi_connection: str
    norm: bool


def _attn_win(p: PTree, qkv_windows, heads: int, mask):
    """WindowAttention on the shared qkv: q, k and v are the channel slices
    of the partitioned (B*nW, N, 3C) projection, handed over in place;
    ``p['relative_position_bias']`` is ``prepare``'s."""
    c = qkv_windows.shape[-1] // 3
    scale = (c // heads) ** -0.5
    q, k, v = qkv_windows[..., :c], qkv_windows[..., c:2 * c], qkv_windows[..., 2 * c:]
    out = multi_head_attention(q, k, v, heads, scale, bias=p['relative_position_bias'], mask=mask)
    return p.linear('proj', out)


def _atd_ca(p: PTree, x, td, num_tokens: int):
    """ATD_CA: cosine-similarity cross attention of the tokens ``x``
    (B, N, C) to the dictionary ``td`` (B, T, C).  Returns (out, the
    post-softmax similarity (B, N, T))."""
    q = p.linear('wq', x)
    k = p.linear('wk', td)
    v = p.linear('wv', td)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    k = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12)
    attn = torch.matmul(q, k.transpose(-1, -2))
    scale = p['scale'].to(x.dtype).clamp(0, 1)
    attn = F.softmax(attn * (1 + scale * math.log(num_tokens)))
    return torch.matmul(attn, v), attn


def _ac_msa(p: PTree, qkv, sim, heads: int, category_size: int):
    """AC_MSA: argmax category -> stable sort -> attention inside groups of
    ``category_size`` sorted tokens -> unsort.  ``qkv``: (B, N, 3C),
    ``sim``: (B, N, T).  Both row shuffles are gathers of flattened rows
    (``ops.row_gather``); where N is not a multiple of the group size, the
    sorted sequence is padded with its own tail, mirrored, by gathering
    those rows a second time."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    gs = min(n, category_size)
    ng = (n + gs - 1) // gs
    pad_n = ng * gs - n

    tk_id = torch.argmax(sim, dim=-1)
    sort_idx = torch.sort(tk_id, dim=-1, stable=True).indices
    take = sort_idx
    if pad_n > 0:
        take = torch.cat([sort_idx, sort_idx[:, n - pad_n:].flip(1)], dim=1)
    boff = torch.arange(b, device=qkv.device)[:, None]
    shuffled = row_gather(qkv.reshape(b * n, c3), (take + boff * n).reshape(-1))

    y = shuffled.reshape(b, ng, gs, 3, heads, c // heads).permute(3, 0, 1, 4, 2, 5)
    q, k, v = y[0], y[1], y[2]
    logit_scale = torch.exp(p['logit_scale'].to(qkv.dtype).clamp_max(math.log(1.0 / 0.01)))
    attn = F.softmax(torch.matmul(q, k.transpose(-1, -2)) * logit_scale)
    out = torch.matmul(attn, v).permute(0, 1, 3, 2, 4).reshape(b * (n + pad_n), c)

    # unsort: invert the permutation with a small integer scatter, then
    # gather the rows back, skipping each image's pad tail
    inv = torch.empty_like(sort_idx).scatter_(1, sort_idx, torch.arange(n, device=qkv.device).expand(b, n))
    out = row_gather(out, (inv + boff * (n + pad_n)).reshape(-1)).reshape(b, n, c)
    return p.linear('proj', out)


def _convffn(p: PTree, x, h: int, w: int, k: int):
    """ConvFFN: fc1, gelu, a residual depthwise k x k conv on the (h, w)
    map, fc2; ``x``: (B, N, C)."""
    b, n, _ = x.shape
    x = F.gelu(p.linear('fc1', x))
    hid = x.shape[-1]
    img = F.gelu(p.conv('dwconv.depthwise_conv.0', x.reshape(b, h, w, hid), padding=(k - 1) // 2, groups=hid))
    return p.linear('fc2', x + img.reshape(b, n, hid))


def _instance_norm1d(x, weight, bias, eps: float = 1e-5):
    """InstanceNorm1d(affine) over (B, C, N): normalise per (b, c) over N."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) / torch.sqrt(var + eps)
    return y * weight.to(x.dtype)[None, :, None] + bias.to(x.dtype)[None, :, None]


def _atd_layer(p: PTree, x, td, cfg: ATDConfig, heads: int, shift: int, is_last: bool, h: int, w: int, masks: dict):
    """ATDTransformerLayer; ``x``: (B, N, C), ``td``: (B, T, C).  Returns
    the new (x, td)."""
    b, n, c = x.shape
    ws = cfg.window_size
    shortcut = x
    xn = p.layer_norm('norm1', x)
    qkv = p.linear('wqkv', xn)

    x_atd, sim_atd = _atd_ca(p.sub('attn_atd'), xn, td, cfg.num_tokens)
    x_aca = _ac_msa(p.sub('attn_aca'), qkv, sim_atd, heads, cfg.category_size)

    qkv_img = qkv.reshape(b, h, w, 3 * c)
    if shift > 0:
        qkv_img = torch.roll(qkv_img, shifts=(-shift, -shift), dims=(1, 2))
    mask = shift_mask(masks, h, w, ws, shift, x.device)
    attn_windows = _attn_win(p.sub('attn_win'), window_partition(qkv_img, ws), heads, mask)
    x_win = window_reverse(attn_windows, ws, h, w)
    if shift > 0:
        x_win = torch.roll(x_win, shifts=(shift, shift), dims=(1, 2))

    x = shortcut + x_win.reshape(b, n, c) + x_atd + x_aca
    x = x + _convffn(p.sub('convffn'), p.layer_norm('norm2', x), h, w, cfg.convffn_kernel_size)

    if not is_last:
        mask_soft = F.softmax(_instance_norm1d(sim_atd.transpose(-1, -2), p['norm3.weight'], p['norm3.bias']))
        s = F.sigmoid(p['sigma'].to(x.dtype))
        td = s * td + (1 - s) * torch.matmul(mask_soft, x)
    return x, td


def _resi_conv(p: PTree, key: str, x, resi_connection: str):
    if resi_connection == '1conv':
        return p.conv(key, x, padding=1)
    q = p.sub(key)
    x = F.leaky_relu(q.conv('0', x, padding=1), 0.2)
    x = F.leaky_relu(q.conv('2', x), 0.2)
    return q.conv('4', x, padding=1)


def prepare(cfg: ATDConfig, params, dtype: torch.dtype) -> dict:
    """The params in ``dtype``, plus each layer's relative-position bias
    under ``...attn_win.relative_position_bias`` ((heads, N, N), rounded to
    ``dtype``, held in f32 for the kernel) and an empty shift-mask cache."""
    out = {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}
    rpi = params['relative_position_index_SA']
    for li, depth in enumerate(cfg.depths):
        for bi in range(depth):
            a = f'layers.{li}.residual_group.layers.{bi}.attn_win'
            out[f'{a}.relative_position_bias'] = relative_position_bias(
                params[f'{a}.relative_position_bias_table'], rpi, dtype)
    out[_MASKS] = {}
    return out


def apply(cfg: ATDConfig, params, x):
    """Forward on NHWC ``x`` with ``params = prepare(cfg, ..., x.dtype)``."""
    p = PTree(params)
    masks = params[_MASKS]
    h0, w0 = x.shape[1], x.shape[2]
    ws = cfg.window_size
    h = ((h0 + ws - 1) // ws) * ws
    w = ((w0 + ws - 1) // ws) * ws
    # flip-mirror pad up to the window size
    x = torch.cat([x, x.flip(1)], dim=1)[:, :h]
    x = torch.cat([x, x.flip(2)], dim=2)[:, :, :w].contiguous()

    if cfg.norm:
        if cfg.in_chans == 3:
            mean = torch.tensor(_RGB_MEAN, dtype=x.dtype, device=x.device)
        else:
            mean = torch.zeros((1,), dtype=x.dtype, device=x.device)
        x = (x - mean) * cfg.img_range

    def features(feat_img):
        b = feat_img.shape[0]
        feat = feat_img.reshape(b, h * w, cfg.embed_dim)
        if 'patch_embed.norm.weight' in p:
            feat = p.layer_norm('patch_embed.norm', feat)
        for li, depth in enumerate(cfg.depths):
            lp = p.sub(f'layers.{li}')
            y = feat
            td = lp['residual_group.td'].to(feat.dtype)[None].expand(b, cfg.num_tokens, cfg.embed_dim)
            for bi in range(depth):
                shift = 0 if bi % 2 == 0 else ws // 2
                y, td = _atd_layer(lp.sub(f'residual_group.layers.{bi}'), y, td, cfg, cfg.num_heads[li], shift,
                                   bi == depth - 1, h, w, masks)
            y_img = _resi_conv(lp, 'conv', y.reshape(b, h, w, cfg.embed_dim), cfg.resi_connection)
            feat = feat + y_img.reshape(b, h * w, cfg.embed_dim)
        return p.layer_norm('norm', feat).reshape(b, h, w, cfg.embed_dim)

    if cfg.upsampler in ('pixelshuffle', 'pixelshuffledirect', 'nearest+conv'):
        x = p.conv('conv_first', x, padding=1)
        x = _resi_conv(p, 'conv_after_body', features(x), cfg.resi_connection) + x
        if cfg.upsampler == 'pixelshuffle':
            x = F.leaky_relu(p.conv('conv_before_upsample.0', x, padding=1), 0.01)
            if cfg.upscale & (cfg.upscale - 1) == 0:
                for i in range(int(math.log2(cfg.upscale))):
                    x = F.pixel_shuffle(p.conv(f'upsample.{2 * i}', x, padding=1), 2)
            elif cfg.upscale == 3:
                x = F.pixel_shuffle(p.conv('upsample.0', x, padding=1), 3)
            x = p.conv('conv_last', x, padding=1)
        elif cfg.upsampler == 'pixelshuffledirect':
            x = F.pixel_shuffle(p.conv('upsample.0', x, padding=1), cfg.upscale)
        else:  # nearest+conv
            x = F.leaky_relu(p.conv('conv_before_upsample.0', x, padding=1), 0.01)
            x = F.leaky_relu(p.conv('conv_up1', F.interpolate_nearest(x, 2), padding=1), 0.2)
            x = F.leaky_relu(p.conv('conv_up2', F.interpolate_nearest(x, 2), padding=1), 0.2)
            x = p.conv('conv_last', F.leaky_relu(p.conv('conv_hr', x, padding=1), 0.2), padding=1)
    else:
        x_first = p.conv('conv_first', x, padding=1)
        res = _resi_conv(p, 'conv_after_body', features(x_first), cfg.resi_connection) + x_first
        x = x + p.conv('conv_last', res, padding=1)

    if cfg.norm:
        x = x / cfg.img_range + mean
    return x[:, : h0 * cfg.upscale, : w0 * cfg.upscale].contiguous()


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/atd.py::_load``."""
    in_chans = sd['conv_first.weight'].shape[1]
    embed_dim = sd['conv_first.weight'].shape[0]
    window_size = math.isqrt(sd['relative_position_index_SA'].shape[0])

    num_layers = get_seq_len(sd, 'layers')
    depths, num_heads = [], []
    for i in range(num_layers):
        depths.append(get_seq_len(sd, f'layers.{i}.residual_group.layers'))
        num_heads.append(sd[f'layers.{i}.residual_group.layers.0.attn_win.relative_position_bias_table'].shape[1])

    num_tokens = sd['layers.0.residual_group.layers.0.attn_atd.scale'].shape[0]
    reducted_dim = sd['layers.0.residual_group.layers.0.attn_atd.wq.weight'].shape[0]
    convffn_kernel_size = sd['layers.0.residual_group.layers.0.convffn.dwconv.depthwise_conv.0.weight'].shape[2]
    mlp_ratio = sd['layers.0.residual_group.layers.0.convffn.fc1.weight'].shape[0] / embed_dim
    qkv_bias = 'layers.0.residual_group.layers.0.wqkv.bias' in sd
    resi_connection = '1conv' if 'layers.0.conv.weight' in sd else '3conv'

    if 'conv_up1.weight' in sd:
        upsampler, upscale = 'nearest+conv', 4
    elif 'conv_before_upsample.0.weight' in sd:
        upsampler = 'pixelshuffle'
        upscale, _ = get_pixelshuffle_params(sd, 'upsample')
    elif 'conv_last.weight' in sd:
        upsampler, upscale = '', 1
    else:
        upsampler = 'pixelshuffledirect'
        upscale = pixelshuffle_scale(sd['upsample.0.weight'].shape[0], in_chans)

    norm = 'no_norm' not in sd
    is_light = upsampler == 'pixelshuffledirect' and embed_dim == 48
    category_size = 128 if is_light else 256

    cfg = ATDConfig(
        in_chans=in_chans, embed_dim=embed_dim, depths=tuple(depths), num_heads=tuple(num_heads),
        window_size=window_size, category_size=category_size, num_tokens=num_tokens,
        reducted_dim=reducted_dim, convffn_kernel_size=convffn_kernel_size, mlp_ratio=mlp_ratio,
        qkv_bias=qkv_bias, upscale=upscale, img_range=1.0, upsampler=upsampler,
        resi_connection=resi_connection, norm=norm,
    )
    params = {k: v for k, v in sd.items() if k != 'no_norm'}
    meta = ModelMetadata(in_channels=in_chans, out_channels=in_chans, upscale=upscale, name='ATD')
    model = SRModel('ATD', cfg, params_from_numpy(params, device), meta, apply, prepare)
    # the JAX package's hints, kept so that tiled outputs match it; their
    # values have not been re-measured on a GPU
    model.tile_batch = {'f32': 1, 'bf16': 2}
    model.serving_tile = 160
    model.serving_halo = {'f32': 16, 'bf16': 8}
    model.size_multiple = window_size
    return model


ARCH = Architecture(
    id='ATD',
    detect_condition=KeyCondition.has_all(
        'relative_position_index_SA',
        'conv_first.weight',
        'conv_first.bias',
        'layers.0.residual_group.td',
        'layers.0.residual_group.layers.0.sigma',
        'layers.0.residual_group.layers.0.norm1.weight',
        'layers.0.residual_group.layers.0.norm1.bias',
        'layers.0.residual_group.layers.0.norm2.weight',
        'layers.0.residual_group.layers.0.norm2.bias',
        'layers.0.residual_group.layers.0.norm3.weight',
        'layers.0.residual_group.layers.0.norm3.bias',
        'layers.0.residual_group.layers.0.wqkv.weight',
        'layers.0.residual_group.layers.0.attn_win.relative_position_bias_table',
        'layers.0.residual_group.layers.0.attn_win.proj.weight',
        'layers.0.residual_group.layers.0.attn_win.proj.bias',
        'layers.0.residual_group.layers.0.attn_atd.scale',
        'layers.0.residual_group.layers.0.attn_atd.wq.weight',
        'layers.0.residual_group.layers.0.attn_atd.wk.weight',
        'layers.0.residual_group.layers.0.attn_atd.wv.weight',
        'layers.0.residual_group.layers.0.attn_aca.logit_scale',
        'layers.0.residual_group.layers.0.attn_aca.proj.weight',
        'layers.0.residual_group.layers.0.convffn.fc1.weight',
        'layers.0.residual_group.layers.0.convffn.fc1.bias',
        'layers.0.residual_group.layers.0.convffn.dwconv.depthwise_conv.0.weight',
        'layers.0.residual_group.layers.0.convffn.dwconv.depthwise_conv.0.bias',
        'layers.0.residual_group.layers.0.convffn.fc2.weight',
        'layers.0.residual_group.layers.0.convffn.fc2.bias',
        'norm.weight',
        'norm.bias',
    ),
    load_fn=_load,
)
