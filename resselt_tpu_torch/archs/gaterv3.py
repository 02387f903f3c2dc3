"""GateRV3: a hybrid gated U-Net with a SPAN SISR branch.

Counterpart of ``resselt_tpu/archs/gaterv3.py``: the same config inference,
metadata and forward.  GateRv2's MetaGated U-Net (``gaterv2.encode`` /
``decode``), an optional restormer-style channel attention in the latent,
a parallel SPAN branch (bias-free Conv3XC SPABs, collapsed at load by
``nn.reparam.collapse_all``) feeding the UniUpsampleV3 tail, and the
input, upsampled nearest and scaled by ``gamma`` (ones when the checkpoint
has none), added back.  Each same-padded 3x3 conv runs through
``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``): ``in_to_dim``, the
stages' ``scale.0``, the SPABs' collapsed convs with the SiLU after c1 and
c2 fused, ``sisr_end_conv``, ``dim_to_in`` at 1x and the tail's 3x3 convs.
The grouped convs (``local.2``, the token mixers, ``qkv_dwconv`` with
groups 3c), the transposed convs, the 1x1 convs and the norms stay plain
torch.  The weights are built once per compute dtype (``prepare``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.reparam import collapse_all, conv3xc_collapse
from ..nn.upsample import SAMPLE_MODS3, uni_upsample_v3
from ..ops.conv_route import conv, prepare_convs
from .gaterv2 import decode, encode, meta_gated_groups
from .mosrv2 import _inception_dwconv


@dataclass(frozen=True)
class GateRV3Config:
    in_ch: int
    dim: int
    enc_blocks: tuple[int, ...]
    dec_blocks: tuple[int, ...]
    num_latent: int
    scale: int
    upsampler: str
    upsample_mid_dim: int
    attention: bool
    span_blocks: int
    end_kernel: int


def _channel_attention(p: PTree, x, heads: int = 16):
    """Latent Attention (gaterv3/arch.py:549-585): XCiT over head_dim
    tokens, the two products accumulated in f32, then in ``x``'s dtype."""
    b, h, w, c = x.shape
    n = h * w
    hd = c // heads
    qkv = conv(p['qkv_dwconv'], conv(p['qkv'], x))

    def split(t):  # torch's view(b, heads, hd, hw) of NCHW
        t = t.reshape(b, n, heads, hd).permute(0, 2, 3, 1)  # (b, heads, hd, n)
        return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-12)

    q, k = split(qkv[..., :c]), split(qkv[..., c : 2 * c])
    v = qkv[..., 2 * c :].reshape(b, n, heads, hd).permute(0, 2, 3, 1)
    temp = p['temperature'].reshape(1, heads, 1, 1)
    attn = F.softmax((q.float() @ k.float().transpose(-1, -2)).to(x.dtype) * temp)
    out = (attn.float() @ v.float()).to(x.dtype)  # (b, heads, hd, n)
    return conv(p['project_out'], out.permute(0, 3, 1, 2).reshape(b, h, w, c))


def _gated_cnn(p: PTree, x, dim: int, att: bool):
    """GatedCNNBlock (gaterv3/arch.py:587-626): no inner residual."""
    x = conv(p['fc1'], F.rms_norm_ref(x, p['norm.scale'], p['norm.offset']))
    hidden = int(1.5 * dim)
    g = x[..., :hidden]
    i = x[..., hidden : 2 * hidden - dim]
    c = x[..., 2 * hidden - dim :]
    if att:
        c = _channel_attention(p.sub('token_mix'), c)
    else:
        c = _inception_dwconv(p.sub('token_mix'), c)
    return conv(p['fc2'], F.mish(g) * torch.cat([i, c], dim=-1), 'mish')


def _spab(p: PTree, x):
    """Bias-free SPAB (gaterv3/arch.py:477-499) with the in-place SiLU: the
    second return value is the activated out1; ``out2`` is read only
    through its SiLU, so c2 fuses it too."""
    out1_act = conv(p['c1_r.eval_conv'], x, 'silu')
    out3 = conv(p['c3_r.eval_conv'], conv(p['c2_r.eval_conv'], out1_act, 'silu'))
    sim_att = F.sigmoid(out3) - 0.5
    return (out3 + x) * sim_att, out1_act


def prepare(cfg: GateRV3Config, params, dtype):
    """The convs for ``dtype``: the MetaGated blocks' grouped convs,
    ``qkv_dwconv`` (groups 3c) and LDA_AQU's offset conv by their widths;
    a ``transpose+conv`` tail's transposed weights are only cast."""
    groups = meta_gated_groups(params)
    for k, v in params.items():
        if k.endswith(('.qkv_dwconv.weight', '.conv_offset.0.weight')):
            groups[k[: -len('.weight')]] = v.shape[0]
    skip = ('dim_to_in.0', 'dim_to_in.2') if cfg.upsampler == 'transpose+conv' and cfg.scale != 1 else ()
    return prepare_convs(params, dtype, groups, skip)


def apply(cfg: GateRV3Config, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    h0, w0 = x.shape[1], x.shape[2]
    inp = F.pad_to_multiple(x, 2 ** len(cfg.enc_blocks), mode='reflect')
    x = conv(p['in_to_dim'], inp)

    # SPAN branch (arch.py:784-790)
    sisr, _ = _spab(p.sub('span_block0'), x)
    sisr_short = sisr
    for i in range(cfg.span_blocks):
        sisr, _ = _spab(p.sub(f'span_n_b.{i}'), sisr)
    sisr, sisr_out = _spab(p.sub('span_end'), sisr)
    sisr = conv(p['sisr_end_conv.eval_conv'], sisr)
    sisr = conv(p['sisr_cat_conv'], torch.cat([x, sisr, sisr_short, sisr_out], dim=-1))

    y, shorts = encode(p, x, cfg.enc_blocks, cfg.dim, 'gater_encode')
    latent_dim = cfg.dim * 2 ** len(cfg.enc_blocks)
    for i in range(cfg.num_latent):
        y = _gated_cnn(p.sub(f'latent.{i}'), y, latent_dim, cfg.attention)
    y = decode(p, y, shorts, cfg.dec_blocks, cfg.dim)

    gamma = p['gamma'].reshape(-1)
    if cfg.scale != 1:
        out = uni_upsample_v3(p.sub('dim_to_in'), y + sisr, cfg.upsampler, cfg.scale, cfg.in_ch,
                              cfg.upsample_mid_dim, dysample_end_kernel=cfg.end_kernel)
        out = out + gamma * F.interpolate_nearest(inp, scale_factor=cfg.scale)
    else:
        out = conv(p['dim_to_in'], y + sisr) + gamma * inp
    return out[:, : h0 * cfg.scale, : w0 * cfg.scale]


# keyed on the Conv3XC-unique '.sk.weight' (never the pa_up upsampler's
# plain 'conv.0.weight')
_MARKERS = {'sk.weight': (conv3xc_collapse, 'eval_conv')}


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/gaterv3.py::_load``."""
    dim, in_ch = sd['in_to_dim.weight'].shape[:2]
    enc_blocks = tuple(get_seq_len(sd, f'gater_encode.{i}.gated') for i in range(get_seq_len(sd, 'gater_encode')))
    latent = get_seq_len(sd, 'latent')
    dec_blocks = tuple(get_seq_len(sd, f'decode.{i}.gated') for i in range(get_seq_len(sd, 'decode')))
    end_kernel = 1
    if 'dim_to_in.MetaUpsample' in sd:
        meta_buf = [int(v) for v in sd['dim_to_in.MetaUpsample'].reshape(-1)]
        _, index, scale, _, out_ch, upsample_dim, _ = meta_buf
        upsampler = SAMPLE_MODS3[index]
        if upsampler == 'dysample' and 'dim_to_in.0.weight' not in sd:
            upsample_dim = dim
            end_kernel = sd['dim_to_in.0.end_conv.weight'].shape[2]
        elif upsampler == 'dysample':
            end_kernel = sd['dim_to_in.2.end_conv.weight'].shape[2]
    else:
        scale, upsample_dim, upsampler = 1, 32, 'conv'
    attention = 'latent.0.token_mix.qkv_dwconv.weight' in sd
    span_blocks = get_seq_len(sd, 'span_n_b')

    cfg = GateRV3Config(
        in_ch=in_ch, dim=dim, enc_blocks=enc_blocks, dec_blocks=dec_blocks,
        num_latent=latent, scale=scale, upsampler=upsampler,
        upsample_mid_dim=upsample_dim, attention=attention,
        span_blocks=span_blocks, end_kernel=end_kernel,
    )
    params = collapse_all(sd, _MARKERS)
    params = {k: v for k, v in params.items() if k != 'dim_to_in.MetaUpsample'}
    if 'gamma' not in params:
        params['gamma'] = np.ones((1, in_ch, 1, 1), np.float32)
    meta = ModelMetadata(in_channels=in_ch, out_channels=in_ch, upscale=scale, name='GateRV3')
    return SRModel('GateRV3', cfg, params_from_numpy(params, device), meta, apply, prepare)


ARCH = Architecture(
    id='GateRV3',
    detect_condition=KeyCondition.has_all(
        'in_to_dim.weight',
        'in_to_dim.bias',
        'gater_encode.0.gated.0.gamma0',
        'gater_encode.0.gated.0.gamma1',
        'gater_encode.0.gated.0.local.0.scale',
        'gater_encode.0.gated.0.local.0.offset',
        'gater_encode.0.gated.0.local.1.weight',
        'gater_encode.0.gated.0.local.1.bias',
        'gater_encode.0.gated.0.local.2.weight',
        'gater_encode.0.gated.0.local.2.bias',
        'gater_encode.0.gated.0.sca.1.weight',
        'gater_encode.0.gated.0.sca.1.bias',
        'gater_encode.0.gated.0.glob.norm.scale',
        'gater_encode.0.gated.0.glob.norm.offset',
        'gater_encode.0.gated.0.glob.fc1.weight',
        'gater_encode.0.gated.0.glob.fc1.bias',
        'gater_encode.0.gated.0.glob.token_mix.dwconv_hw.weight',
        'gater_encode.0.gated.0.glob.token_mix.dwconv_hw.bias',
        'gater_encode.0.gated.0.glob.token_mix.dwconv_w.weight',
        'gater_encode.0.gated.0.glob.token_mix.dwconv_w.bias',
        'gater_encode.0.gated.0.glob.token_mix.dwconv_h.weight',
        'gater_encode.0.gated.0.glob.token_mix.dwconv_h.bias',
        'gater_encode.0.gated.0.glob.fc2.weight',
        'gater_encode.0.gated.0.glob.fc2.bias',
        'gater_encode.0.scale.0.weight',
        'span_block0.c1_r.sk.weight',
        'span_block0.c1_r.conv.0.weight',
        'span_block0.c1_r.conv.1.weight',
        'span_block0.c1_r.conv.2.weight',
        'span_block0.c1_r.eval_conv.weight',
        'span_block0.c2_r.sk.weight',
        'span_block0.c2_r.conv.0.weight',
        'span_block0.c2_r.conv.1.weight',
        'span_block0.c2_r.conv.2.weight',
        'span_block0.c2_r.eval_conv.weight',
        'span_block0.c3_r.sk.weight',
        'span_block0.c3_r.conv.0.weight',
        'span_block0.c3_r.conv.1.weight',
        'span_block0.c3_r.conv.2.weight',
        'span_block0.c3_r.eval_conv.weight',
        'span_n_b.0.c1_r.sk.weight',
        'span_n_b.0.c1_r.conv.0.weight',
        'span_n_b.0.c1_r.conv.1.weight',
        'span_n_b.0.c1_r.conv.2.weight',
        'span_n_b.0.c1_r.eval_conv.weight',
        'span_n_b.0.c2_r.sk.weight',
        'span_n_b.0.c2_r.conv.0.weight',
        'span_n_b.0.c2_r.conv.1.weight',
        'span_n_b.0.c2_r.conv.2.weight',
        'span_n_b.0.c2_r.eval_conv.weight',
        'span_n_b.0.c3_r.sk.weight',
        'span_n_b.0.c3_r.conv.0.weight',
        'span_n_b.0.c3_r.conv.1.weight',
        'span_n_b.0.c3_r.conv.2.weight',
        'span_n_b.0.c3_r.eval_conv.weight',
        'span_end.c1_r.sk.weight',
        'span_end.c1_r.conv.0.weight',
        'span_end.c1_r.conv.1.weight',
        'span_end.c1_r.conv.2.weight',
        'span_end.c1_r.eval_conv.weight',
        'span_end.c2_r.sk.weight',
        'span_end.c2_r.conv.0.weight',
        'span_end.c2_r.conv.1.weight',
        'span_end.c2_r.conv.2.weight',
        'span_end.c2_r.eval_conv.weight',
        'span_end.c3_r.sk.weight',
        'span_end.c3_r.conv.0.weight',
        'span_end.c3_r.conv.1.weight',
        'span_end.c3_r.conv.2.weight',
        'span_end.c3_r.eval_conv.weight',
        'sisr_end_conv.sk.weight',
        'sisr_end_conv.sk.bias',
        'sisr_end_conv.conv.0.weight',
        'sisr_end_conv.conv.0.bias',
        'sisr_end_conv.conv.1.weight',
        'sisr_end_conv.conv.1.bias',
        'sisr_end_conv.conv.2.weight',
        'sisr_end_conv.conv.2.bias',
        'sisr_end_conv.eval_conv.weight',
        'sisr_end_conv.eval_conv.bias',
        'sisr_cat_conv.weight',
        'sisr_cat_conv.bias',
        'decode.0.scale.0.weight',
        'decode.0.gated.0.gamma0',
        'decode.0.gated.0.gamma1',
        'decode.0.gated.0.local.0.scale',
        'decode.0.gated.0.local.0.offset',
        'decode.0.gated.0.local.1.weight',
        'decode.0.gated.0.local.1.bias',
        'decode.0.gated.0.local.2.weight',
        'decode.0.gated.0.local.2.bias',
        'decode.0.gated.0.sca.1.weight',
        'decode.0.gated.0.sca.1.bias',
        'decode.0.gated.0.glob.norm.scale',
        'decode.0.gated.0.glob.norm.offset',
        'decode.0.gated.0.glob.fc1.weight',
        'decode.0.gated.0.glob.fc1.bias',
        'decode.0.gated.0.glob.token_mix.dwconv_hw.weight',
        'decode.0.gated.0.glob.token_mix.dwconv_hw.bias',
        'decode.0.gated.0.glob.token_mix.dwconv_w.weight',
        'decode.0.gated.0.glob.token_mix.dwconv_w.bias',
        'decode.0.gated.0.glob.token_mix.dwconv_h.weight',
        'decode.0.gated.0.glob.token_mix.dwconv_h.bias',
        'decode.0.gated.0.glob.fc2.weight',
        'decode.0.gated.0.glob.fc2.bias',
        'decode.0.shor.weight',
        'decode.0.shor.bias',
    ),
    load_fn=_load,
)
