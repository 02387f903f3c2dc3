"""DAT — Dual Aggregation Transformer.

Counterpart of ``resselt_tpu/archs/dat.py``: the same config inference
(kept verbatim), the same serving hints and the same forward, NHWC:
alternating adaptive spatial attention (two rectangular-window branches,
(sp0, sp1) and (sp1, sp0), on the two channel halves, each with a dynamic
position bias from a small MLP) and adaptive channel attention, each with
its conv branch and AIM interactions, an SGFN feed-forward, and shifts by
the (group, block) parity rule.  The spatial attention pads its q, k and v
with zeros to a multiple of ``max(split_size)``; the model has no outer pad.

On the card every window attention runs through ``ops.window_mha``
(``csrc/window_attn.cu``): two launches per spatial block, q, k and v read
in place from the branch's windowed qkv.  ``prepare`` casts the params to
the compute dtype once and runs each branch's position-bias MLP once in that
dtype, as the JAX package runs it on every forward; the rectangular shift
masks are built once per geometry and device.  The channel attention, the
convs, BatchNorms, layer norms and linears are plain PyTorch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as TF

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len, pixelshuffle_scale
from ..nn import functional as F
from ..nn.params import MEAN, PTree, cast_params, input_mean
from ..nn.window import multi_head_attention, rect_shift_mask, relative_position_bias

_RGB_MEAN = (0.4488, 0.4371, 0.4040)
_MASKS = 'shift_masks'  # prepare's key for the shift-mask cache
_RPE = 'rpe_biases'


@dataclass(frozen=True)
class DATConfig:
    in_chans: int
    embed_dim: int
    depth: tuple[int, ...]
    num_heads: tuple[int, ...]
    split_size: tuple[int, int]
    expansion_factor: float
    qkv_bias: bool
    upscale: int
    img_range: float
    resi_connection: str
    upsampler: str
    img_size: int


def _dyn_pos_bias(p: PTree, biases):
    """DynamicPosBias without its residual: a (entries, heads) table from the
    (entries, 2) relative offsets."""
    pos = p.linear('pos_proj', biases)
    for name in ('pos1', 'pos2', 'pos3'):
        pos = p.linear(f'{name}.2', F.relu(p.layer_norm(f'{name}.0', pos)))
    return pos


def _img2windows(x, hsp: int, wsp: int):
    """(B, H, W, ...) -> (B*nW, hsp*wsp, C), C the product of the trailing
    dims, row-major windows."""
    b, h, w = x.shape[:3]
    rest = x.shape[3:]
    x = x.reshape(b, h // hsp, hsp, w // wsp, wsp, *rest).transpose(2, 3)
    return x.reshape(-1, hsp * wsp, math.prod(rest))


def _windows2img(xw, hsp: int, wsp: int, h: int, w: int):
    c = xw.shape[-1]
    b = xw.shape[0] // ((h // hsp) * (w // wsp))
    return xw.reshape(b, h // hsp, w // wsp, hsp, wsp, c).transpose(2, 3).reshape(b, h, w, c)


def _spatial_branch(p: PTree, qkv, hsp: int, wsp: int, heads: int, shift, masks: dict, h: int, w: int):
    """One Spatial_Attention branch on the zero-padded ``qkv`` image
    (B, Hp, Wp, 3, Cb): rolled by ``-shift`` (a (rows, cols) pair, or None
    for no shift) with its rectangular shift mask, cut into (hsp, wsp)
    windows, attended with the bias ``prepare`` built, put back, rolled back
    and cropped to (B, h, w, Cb)."""
    _, hp, wp, _, cb = qkv.shape
    mask = None
    if shift is not None:
        qkv = torch.roll(qkv, shifts=(-shift[0], -shift[1]), dims=(1, 2))
        mask = rect_shift_mask(masks, hp, wp, hsp, wsp, shift[0], shift[1], qkv.device)
    win = _img2windows(qkv, hsp, wsp)  # (B*nW, n, 3*Cb): q, k, v side by side
    out = multi_head_attention(win[..., :cb], win[..., cb:2 * cb], win[..., 2 * cb:], heads, (cb // heads) ** -0.5,
                               bias=p['relative_position_bias'], mask=mask)
    out = _windows2img(out, hsp, wsp, hp, wp)
    if shift is not None:
        out = torch.roll(out, shifts=shift, dims=(1, 2))
    return out[:, :h, :w]


def _dual_window_attention(p: PTree, qkv, split_size: tuple[int, int], heads: int, shifted: bool, masks: dict):
    """The two window branches on (B, H, W, 3C) ``qkv``: zero-padded to a
    multiple of ``max(split_size)``, the first half of the channels in
    (sp0, sp1) windows, the second in (sp1, sp0), heads // 2 each, each
    shifted by half its window when ``shifted``; (B, H, W, C)."""
    _, h, w, c3 = qkv.shape
    c = c3 // 3
    sp0, sp1 = split_size
    msp = max(sp0, sp1)
    pad_b, pad_r = (msp - h % msp) % msp, (msp - w % msp) % msp
    if pad_b or pad_r:
        qkv = TF.pad(qkv, (0, 0, 0, pad_r, 0, pad_b))
    qkv = qkv.unflatten(-1, (3, c))
    half = c // 2
    s0, s1 = ((sp0 // 2, sp1 // 2), (sp1 // 2, sp0 // 2)) if shifted else (None, None)
    x0 = _spatial_branch(p.sub('attns.0'), qkv[..., :half], sp0, sp1, heads // 2, s0, masks, h, w)
    x1 = _spatial_branch(p.sub('attns.1'), qkv[..., half:], sp1, sp0, heads // 2, s1, masks, h, w)
    return torch.cat([x0, x1], dim=-1)


def _aim(p: PTree, name: str, x):
    """An AIM interaction: conv, BatchNorm, gelu, conv."""
    a, b, c = {'channel_interaction': (1, 2, 4), 'spatial_interaction': (0, 1, 3)}[name]
    x = F.gelu(p.batch_norm(f'{name}.{b}', p.conv(f'{name}.{a}', x)))
    return p.conv(f'{name}.{c}', x)


def _dw_branch(p: PTree, v_img, c: int):
    """The depthwise conv branch on v: conv, BatchNorm, gelu."""
    return F.gelu(p.batch_norm('dwconv.1', p.conv('dwconv.0', v_img, padding=1, groups=c)))


def _adaptive_spatial_attn(p: PTree, x, cfg: DATConfig, heads: int, shifted: bool, masks: dict):
    """Adaptive_Spatial_Attention on (B, H, W, C)."""
    c = x.shape[-1]
    qkv = p.linear('qkv', x)
    v_img = qkv[..., 2 * c:]  # unpadded v for the conv branch

    attened = _dual_window_attention(p, qkv, cfg.split_size, heads, shifted, masks)

    conv_x = _dw_branch(p, v_img, c)
    cm = _aim(p, 'channel_interaction', conv_x.mean(dim=(1, 2), keepdim=True))
    sm = _aim(p, 'spatial_interaction', attened)
    out = attened * F.sigmoid(cm) + F.sigmoid(sm) * conv_x
    return p.linear('proj', out)


def _adaptive_channel_attn(p: PTree, x, heads: int):
    """Adaptive_Channel_Attention on (B, H, W, C): attention across the
    channels of each head, q and k L2-normalised over the tokens; the
    products in x's dtype (f32 accumulate, then cast), then the temperature,
    as the JAX package rounds."""
    b, h, w, c = x.shape
    n = h * w
    qkv = p.linear('qkv', x.reshape(b, n, c))
    hd = c // heads

    def per_head(t):  # (b, n, c) -> (b, heads, hd, n)
        return t.reshape(b, n, heads, hd).permute(0, 2, 3, 1)

    q, k, vt = per_head(qkv[..., :c]), per_head(qkv[..., c:2 * c]), per_head(qkv[..., 2 * c:])
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    k = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12)
    attn = torch.matmul(q, k.transpose(-1, -2)) * p['temperature'].to(x.dtype).reshape(1, heads, 1, 1)
    attened = torch.matmul(F.softmax(attn), vt).permute(0, 3, 1, 2).reshape(b, h, w, c)

    conv_x = _dw_branch(p, qkv[..., 2 * c:].reshape(b, h, w, c), c)
    cm = _aim(p, 'channel_interaction', attened.mean(dim=(1, 2), keepdim=True))
    sm = _aim(p, 'spatial_interaction', conv_x)
    out = attened * F.sigmoid(sm) + conv_x * F.sigmoid(cm)
    return p.linear('proj', out)


def _sgfn(p: PTree, x, hidden: int):
    """SGFN on (B, H, W, C): fc1, gelu, the second half gated through a
    layer norm and a depthwise conv, fc2."""
    x = F.gelu(p.linear('fc1', x))
    x1, x2 = x[..., : hidden // 2], x[..., hidden // 2:]
    x2 = p.conv('sg.conv', p.layer_norm('sg.norm', x2), padding=1, groups=hidden // 2)
    return p.linear('fc2', x1 * x2)


def _shifted(group: int, block: int) -> bool:
    """Whether spatial block ``block`` of group ``group`` is shifted."""
    return (group % 2 == 0 and block > 0 and (block - 2) % 4 == 0) or (group % 2 != 0 and block % 4 == 0)


def _datb(p: PTree, x, cfg: DATConfig, heads: int, rg_idx: int, b_idx: int, masks: dict):
    y = p.layer_norm('norm1', x)
    if b_idx % 2 == 0:
        y = _adaptive_spatial_attn(p.sub('attn'), y, cfg, heads, _shifted(rg_idx, b_idx), masks)
    else:
        y = _adaptive_channel_attn(p.sub('attn'), y, heads)
    x = x + y
    return x + _sgfn(p.sub('ffn'), p.layer_norm('norm2', x), int(cfg.embed_dim * cfg.expansion_factor))


def _resi_conv(p: PTree, key: str, x, resi_connection: str):
    """The residual conv of a group or of the body: one 3x3 conv ('1conv'),
    or 3x3, 1x1, 3x3 with leaky relus between ('3conv')."""
    if resi_connection == '1conv':
        return p.conv(key, x, padding=1)
    q = p.sub(key)
    x = F.leaky_relu(q.conv('0', x, padding=1), 0.2)
    x = F.leaky_relu(q.conv('2', x), 0.2)
    return q.conv('4', x, padding=1)


def prepare(cfg, params, dtype: torch.dtype) -> dict:
    """The params in ``dtype``, plus each window branch's position bias under
    ``....attns.{0,1}.relative_position_bias`` ((heads // 2, N, N): the
    branch's MLP run in ``dtype`` on its ``rpe_biases``, gathered through its
    ``relative_position_index``, rounded to ``dtype``, held in f32 for the
    kernel) and an empty shift-mask cache.  Also DAT's shared ``prepare``
    for RGT."""
    out = cast_params(params, dtype)
    for key in params:
        if key.endswith(f'.{_RPE}'):
            a = PTree(out, key[: -len(_RPE)])
            out[f'{key[: -len(_RPE)]}relative_position_bias'] = relative_position_bias(
                _dyn_pos_bias(a.sub('pos'), a[_RPE]), a['relative_position_index'], dtype)
    out[_MASKS] = {}
    out[MEAN] = input_mean(params, _RGB_MEAN if cfg.in_chans == 3 else (0.0,), dtype)
    return out


def apply(cfg: DATConfig, params, x):
    """Forward on NHWC ``x`` with ``params = prepare(cfg, ..., x.dtype)``."""
    p = PTree(params)
    masks = params[_MASKS]
    mean = params[MEAN]
    x = (x - mean) * cfg.img_range

    x = p.conv('conv_first', x, padding=1)
    feat = p.layer_norm('before_RG.1', x)
    for gi, depth in enumerate(cfg.depth):
        gp = p.sub(f'layers.{gi}')
        y = feat
        for bi in range(depth):
            y = _datb(gp.sub(f'blocks.{bi}'), y, cfg, cfg.num_heads[gi], gi, bi, masks)
        feat = feat + _resi_conv(gp, 'conv', y, cfg.resi_connection)
    feat = p.layer_norm('norm', feat)
    x = _resi_conv(p, 'conv_after_body', feat, cfg.resi_connection) + x

    if cfg.upsampler == 'pixelshuffle':
        x = F.leaky_relu(p.conv('conv_before_upsample.0', x, padding=1), 0.01)
        if cfg.upscale & (cfg.upscale - 1) == 0:
            for i in range(int(math.log2(cfg.upscale))):
                x = F.pixel_shuffle(p.conv(f'upsample.{2 * i}', x, padding=1), 2)
        elif cfg.upscale == 3:
            x = F.pixel_shuffle(p.conv('upsample.0', x, padding=1), 3)
        x = p.conv('conv_last', x, padding=1)
    else:
        x = F.pixel_shuffle(p.conv('upsample.0', x, padding=1), cfg.upscale)

    return (x / cfg.img_range + mean).contiguous()


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/dat.py::_load``."""
    img_size = 64
    split_size = (2, 4)
    in_chans = sd['conv_first.weight'].shape[1]
    embed_dim = sd['conv_first.weight'].shape[0]

    num_layers = get_seq_len(sd, 'layers')
    depth = tuple(get_seq_len(sd, f'layers.{i}.blocks') for i in range(num_layers))
    num_heads = []
    for i in range(num_layers):
        if depth[i] >= 2:
            num_heads.append(sd[f'layers.{i}.blocks.1.attn.temperature'].shape[0])
        else:
            num_heads.append(sd[f'layers.{i}.blocks.0.attn.attns.0.pos.pos3.2.weight'].shape[0] * 2)

    upsampler = 'pixelshuffle' if 'conv_last.weight' in sd else 'pixelshuffledirect'
    resi_connection = '1conv' if 'conv_after_body.weight' in sd else '3conv'

    if upsampler == 'pixelshuffle':
        upscale = 1
        for i in range(0, get_seq_len(sd, 'upsample'), 2):
            num_feat = sd[f'upsample.{i}.weight'].shape[1]
            upscale *= int(math.sqrt(sd[f'upsample.{i}.weight'].shape[0] // num_feat))
    else:
        upscale = pixelshuffle_scale(sd['upsample.0.weight'].shape[0], in_chans)

    qkv_bias = 'layers.0.blocks.0.attn.qkv.bias' in sd
    expansion_factor = float(sd['layers.0.blocks.0.ffn.fc1.weight'].shape[0] / embed_dim)

    if 'layers.0.blocks.2.attn.attn_mask_0' in sd:
        m0x, m0y, _ = sd['layers.0.blocks.2.attn.attn_mask_0'].shape
        img_size = int(math.sqrt(m0x * m0y))
    if 'layers.0.blocks.0.attn.attns.0.rpe_biases' in sd:
        split_sizes = sd['layers.0.blocks.0.attn.attns.0.rpe_biases'][-1] + 1
        split_size = tuple(int(v) for v in split_sizes)

    cfg = DATConfig(
        in_chans=in_chans, embed_dim=embed_dim, depth=depth, num_heads=tuple(num_heads),
        split_size=split_size, expansion_factor=expansion_factor, qkv_bias=qkv_bias,
        upscale=upscale, img_range=1.0, resi_connection=resi_connection,
        upsampler=upsampler, img_size=img_size,
    )
    params = {k: v for k, v in sd.items() if '.attn_mask_' not in k}
    meta = ModelMetadata(in_channels=in_chans, out_channels=in_chans, upscale=upscale, name='DAT')
    model = SRModel('dat', cfg, params_from_numpy(params, device), meta, apply, prepare)
    # the JAX package's hints, kept so that tiled outputs match it; their
    # values have not been re-measured on a GPU
    model.tile_batch = {'f32': 4, 'bf16': 8}
    model.serving_tile = {'f32': 128, 'bf16': 96}
    model.serving_halo = 8
    model.size_multiple = max(split_size)  # per-attention pad granule
    return model


ARCH = Architecture(
    id='dat',
    detect_condition=KeyCondition.has_all(
        'conv_first.weight',
        'before_RG.1.weight',
        'before_RG.1.bias',
        'layers.0.blocks.0.norm1.weight',
        'layers.0.blocks.0.norm2.weight',
        'layers.0.blocks.0.ffn.fc1.weight',
        'layers.0.blocks.0.ffn.sg.norm.weight',
        'layers.0.blocks.0.ffn.sg.conv.weight',
        'layers.0.blocks.0.ffn.fc2.weight',
        'layers.0.blocks.0.attn.qkv.weight',
        'layers.0.blocks.0.attn.proj.weight',
        'layers.0.blocks.0.attn.dwconv.0.weight',
        'layers.0.blocks.0.attn.dwconv.1.running_mean',
        'layers.0.blocks.0.attn.channel_interaction.1.weight',
        'layers.0.blocks.0.attn.channel_interaction.2.running_mean',
        'layers.0.blocks.0.attn.channel_interaction.4.weight',
        'layers.0.blocks.0.attn.spatial_interaction.0.weight',
        'layers.0.blocks.0.attn.spatial_interaction.1.running_mean',
        'layers.0.blocks.0.attn.spatial_interaction.3.weight',
        'layers.0.blocks.0.attn.attns.0.rpe_biases',
        'layers.0.blocks.0.attn.attns.0.relative_position_index',
        'layers.0.blocks.0.attn.attns.0.pos.pos_proj.weight',
        'layers.0.blocks.0.attn.attns.0.pos.pos1.0.weight',
        'layers.0.blocks.0.attn.attns.0.pos.pos3.0.weight',
        'norm.weight',
    ),
    load_fn=_load,
)
