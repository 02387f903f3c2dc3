"""RGT — Recursive Generalization Transformer.

Counterpart of ``resselt_tpu/archs/rgt.py``: the same config inference
(kept verbatim), the same serving hints and the same forward, NHWC: L_SA
(DAT's two rectangular-window branches, taken from the port's ``dat.py`` as
the JAX package takes them from its own, plus a depthwise conv on v)
alternating with RG_SA (a cross-attention from every token to a
recursively downsampled map), each block with its layer-scale residual
``gamma``, DAT's SGFN and a pixelshuffle tail.

On the card every L_SA window attention runs through ``ops.window_mha``
(``csrc/window_attn.cu``): two launches per L_SA block.  RG_SA is plain
PyTorch, with the JAX package's rounding points (the products accumulate in
f32 and are cast to the activations' dtype before the scale).  ``prepare``
is DAT's: the params in the compute dtype and each branch's position bias
built once per dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_pixelshuffle_params, get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from .dat import _MASKS, _dual_window_attention, _resi_conv, _sgfn, _shifted, prepare

_RGB_MEAN = (0.4488, 0.4371, 0.4040)


@dataclass(frozen=True)
class RGTConfig:
    in_chans: int
    embed_dim: int
    depth: tuple[int, ...]
    num_heads: tuple[int, ...]
    mlp_ratio: float
    qkv_bias: bool
    upscale: int
    img_range: float
    resi_connection: str
    split_size: tuple[int, int]
    c_ratio: float


def _l_sa(p: PTree, x, cfg: RGTConfig, heads: int, shifted: bool, masks: dict):
    """L_SA on (B, H, W, C): the two window branches plus a depthwise conv
    on the unpadded v."""
    c = x.shape[-1]
    qkv = p.linear('qkv', x)
    attened = _dual_window_attention(p, qkv, cfg.split_size, heads, shifted, masks)
    lcm = p.conv('get_v', qkv[..., 2 * c:], padding=1, groups=c)
    return p.linear('proj', attened + lcm)


def _rg_sa(p: PTree, x, heads: int, c_ratio: float):
    """RG_SA on (B, H, W, C), the eval-time recursion: the map is reduced by
    4 ``_time`` times (stride-4 depthwise convs), every token attends to the
    reduced tokens, whose v gets a depthwise-conv position encoding."""
    b, h, w, c = x.shape
    n = h * w
    cr = int(c * c_ratio)
    scale = (c // heads * c_ratio) ** -0.5

    _time = max(int(math.log(h // 16, 4)), int(math.log(w // 16, 4)))
    _time = max(_time, 2)
    _scale = 4**_time

    _x = x
    for _ in range(_time):
        _x = p.conv('reduction1', _x, stride=4, groups=c)
    _x = p.conv('dwconv', _x, padding=1, groups=c)
    _x = p.conv('conv', _x)
    hn, wn = _x.shape[1], _x.shape[2]
    _x = F.gelu(p.layer_norm('norm_act.0', _x.reshape(b, hn * wn, cr)))

    q = p.linear('q', x.reshape(b, n, c)).reshape(b, n, heads, cr // heads).transpose(1, 2)
    k = p.linear('k', _x).reshape(b, -1, heads, cr // heads).transpose(1, 2)
    v = p.linear('v', _x).reshape(b, -1, heads, c // heads).transpose(1, 2)

    attn = F.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale)

    # CPE on v: (B, heads, N', C/heads) -> image (B, H/s, W/s, C)
    np_ = v.shape[2]
    v_img = v.transpose(1, 2).reshape(b, h // _scale, w // _scale, c)
    cpe = p.conv('cpe', v_img, padding=1, groups=c)
    v = v + cpe.reshape(b, np_, heads, c // heads).transpose(1, 2)

    out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
    return p.linear('proj', out).reshape(b, h, w, c)


def _block(p: PTree, x, cfg: RGTConfig, heads: int, rs_id: int, idx: int, masks: dict):
    """A block with its layer-scale residual."""
    res = x
    y = p.layer_norm('norm1', x)
    if idx % 2 == 0:
        y = _l_sa(p.sub('attn'), y, cfg, heads, _shifted(rs_id, idx), masks)
    else:
        y = _rg_sa(p.sub('attn'), y, heads, cfg.c_ratio)
    x = x + y
    x = x + _sgfn(p.sub('mlp'), p.layer_norm('norm2', x), int(cfg.embed_dim * cfg.mlp_ratio))
    return x + res * p['gamma'].to(x.dtype)


def apply(cfg: RGTConfig, params, x):
    """Forward on NHWC ``x`` with ``params = prepare(cfg, ..., x.dtype)``."""
    p = PTree(params)
    masks = params[_MASKS]
    if cfg.in_chans == 3:
        mean = torch.tensor(_RGB_MEAN, dtype=x.dtype, device=x.device)
    else:
        mean = torch.zeros((1,), dtype=x.dtype, device=x.device)
    x = (x - mean) * cfg.img_range

    x = p.conv('conv_first', x, padding=1)
    feat = p.layer_norm('before_RG.1', x)
    for gi, depth in enumerate(cfg.depth):
        gp = p.sub(f'layers.{gi}')
        y = feat
        for bi in range(depth):
            y = _block(gp.sub(f'blocks.{bi}'), y, cfg, cfg.num_heads[gi], gi, bi, masks)
        feat = feat + _resi_conv(gp, 'conv', y, cfg.resi_connection)
    feat = p.layer_norm('norm', feat)
    x = _resi_conv(p, 'conv_after_body', feat, cfg.resi_connection) + x

    x = F.leaky_relu(p.conv('conv_before_upsample.0', x, padding=1), 0.01)
    if cfg.upscale & (cfg.upscale - 1) == 0:
        for i in range(int(math.log2(cfg.upscale))):
            x = F.pixel_shuffle(p.conv(f'upsample.{2 * i}', x, padding=1), 2)
    elif cfg.upscale == 3:
        x = F.pixel_shuffle(p.conv('upsample.0', x, padding=1), 3)
    x = p.conv('conv_last', x, padding=1)
    return (x / cfg.img_range + mean).contiguous()


def _get_split_size(sd) -> tuple[int, int]:
    """The split size whose window has as many tokens as the relative
    position index has rows and as many offsets as ``rpe_biases``: square
    first, else (2^i, 2^j) with i < j."""
    a = sd['layers.0.blocks.0.attn.attns.0.relative_position_index'].shape[0]
    b = sd['layers.0.blocks.0.attn.attns.0.rpe_biases'].shape[0]

    def is_solution(ssw, ssh):
        return ssw * ssh == a and (2 * ssw - 1) * (2 * ssh - 1) == b

    square = math.isqrt(a)
    if is_solution(square, square):
        return square, square
    for i in range(1, 10):
        for j in range(i + 1, 10):
            if is_solution(2**i, 2**j):
                return 2**i, 2**j
    raise ValueError(f'No valid split_size found for {a=} and {b=}')


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/rgt.py::_load``."""
    in_chans = sd['conv_first.weight'].shape[1]
    embed_dim = sd['conv_first.weight'].shape[0]

    num_layers = get_seq_len(sd, 'layers')
    depth, num_heads = [], []
    for i in range(num_layers):
        depth.append(get_seq_len(sd, f'layers.{i}.blocks'))
        heads_half = sd[f'layers.{i}.blocks.0.attn.attns.0.pos.pos3.2.weight'].shape[0]
        if embed_dim % (heads_half * 2) == 0:
            num_heads.append(heads_half * 2)
        else:
            num_heads.append(heads_half * 2 + 1)

    qkv_bias = 'layers.0.blocks.0.attn.qkv.bias' in sd
    mlp_ratio = sd['layers.0.blocks.0.mlp.fc1.weight'].shape[0] / sd['layers.0.blocks.0.mlp.fc1.weight'].shape[1]
    resi_connection = '1conv' if 'conv_after_body.weight' in sd else '3conv'

    c_ratio = 0.5
    for i, d in enumerate(depth):
        if d >= 2:
            cw = sd[f'layers.{i}.blocks.1.attn.conv.weight']
            c_ratio = cw.shape[0] / cw.shape[1]
            break

    upscale, _ = get_pixelshuffle_params(sd, 'upsample')
    split_size = _get_split_size(sd)

    cfg = RGTConfig(
        in_chans=in_chans, embed_dim=embed_dim, depth=tuple(depth), num_heads=tuple(num_heads),
        mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, upscale=upscale, img_range=1.0,
        resi_connection=resi_connection, split_size=split_size, c_ratio=c_ratio,
    )
    params = {k: v for k, v in sd.items() if '.attn_mask_' not in k}
    meta = ModelMetadata(in_channels=in_chans, out_channels=in_chans, upscale=upscale, name='RGT')
    model = SRModel('RGT', cfg, params_from_numpy(params, device), meta, apply, prepare)
    # the JAX package's hints, kept so that tiled outputs match it; their
    # values have not been re-measured on a GPU
    model.tile_batch = 2
    model.serving_tile = {'f32': 128, 'bf16': 160}
    model.serving_halo = 8
    model.size_multiple = max(split_size)
    return model


ARCH = Architecture(
    id='RGT',
    detect_condition=KeyCondition.has_all(
        'conv_first.weight',
        'before_RG.1.weight',
        'layers.0.blocks.0.gamma',
        'layers.0.blocks.0.norm1.weight',
        'layers.0.blocks.0.attn.qkv.weight',
        'layers.0.blocks.0.attn.proj.weight',
        'layers.0.blocks.0.attn.attns.0.rpe_biases',
        'layers.0.blocks.0.attn.attns.0.relative_position_index',
        'layers.0.blocks.0.attn.attns.0.pos.pos_proj.weight',
        'layers.0.blocks.0.mlp.fc1.weight',
        'layers.0.blocks.0.mlp.fc2.weight',
        'layers.0.blocks.0.norm2.weight',
        'norm.weight',
        KeyCondition.has_any('conv_after_body.weight', 'conv_after_body.0.weight'),
        'conv_before_upsample.0.weight',
        'conv_last.weight',
    ),
    load_fn=_load,
)
