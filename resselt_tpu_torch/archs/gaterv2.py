"""GateRv2: a NAFNet-style gated U-Net with a linear-attention latent.

Counterpart of ``resselt_tpu/archs/gaterv2.py``: the same config inference,
metadata and forward, with the JAX package's two fixes of reference bugs:
the loader reads the ``upsample.MetaUpsample`` key it probes (the reference
reads ``to_img.MetaUpsample`` and fails on SR checkpoints), and the forward
crops with the real scale (the reference's is fixed at 1).  MetaGated
blocks (a local simple gate and a global gated CNN with the
InceptionDWConv2d mixer), the Taylor linear attention in the latent, and
the UniUpsample tail of the SR variants.  Each same-padded 3x3 conv runs
through ``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``): ``in_to_dim``, the
bias-free ``scale.0`` of every stage, ``dim_to_in`` at 1x, the SR
shortcut's two convs with their Mish fused, and the tail's 3x3 convs.  The
grouped ``local.2`` (groups = the block's width), the token mixer, the 1x1
convs and the norms stay plain torch.  The weights are built once per
compute dtype (``prepare``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.upsample import SAMPLE_MODS, uni_upsample
from ..ops.conv_route import conv, prepare_convs
from .mosrv2 import _inception_dwconv, inception_groups


@dataclass(frozen=True)
class GateRV2Config:
    in_ch: int
    dim: int
    enc_blocks: tuple[int, ...]
    dec_blocks: tuple[int, ...]
    num_latent: int
    scale: int
    upsampler: str
    upsample_mid_dim: int


def _l2_normalize(t):
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-12)


def _taylor_attention(p: PTree, x):
    """Latent linear attention (gaterv2/arch.py:219-261) on NHWC ``x``; the
    two products accumulate in f32, then take ``x``'s dtype."""
    b, h, w, c = x.shape
    n = h * w
    qn = _l2_normalize(conv(p['query_conv'], x).reshape(b, n, -1))  # (B, N, c/s)
    kn = _l2_normalize(conv(p['key_conv'], x).reshape(b, n, -1))
    v = conv(p['value_conv'], x).reshape(b, n, c)
    k_sum = kn.sum(dim=1)  # (B, c/s)
    tailor = 1.0 / (n + (qn @ (k_sum + 1e-6)[..., None])[..., 0])  # (B, N)
    matrix = (kn.float().transpose(1, 2) @ v.float()).to(x.dtype)  # (B, c/s, C)
    matrix_sum = v.sum(dim=1)[:, None, :] + (qn.float() @ matrix.float()).to(x.dtype)
    return (matrix_sum * tailor[:, :, None]).reshape(b, h, w, c)


def _gated_cnn(p: PTree, x, dim: int, att: bool, expansion_ratio: float = 1.5):
    """GatedCNNBlock (gaterv2/arch.py:263-299): no inner residual."""
    x = conv(p['fc1'], F.rms_norm_ref(x, p['norm.scale'], p['norm.offset']))
    hidden = int(expansion_ratio * dim)
    g = x[..., :hidden]
    i = x[..., hidden : 2 * hidden - dim]
    c = x[..., 2 * hidden - dim :]
    if att:
        c = _taylor_attention(p.sub('token_mix'), c)
    else:
        c = _inception_dwconv(p.sub('token_mix'), c)
    return conv(p['fc2'], F.mish(g) * torch.cat([i, c], dim=-1), 'mish')


def _meta_gated(p: PTree, x, dim: int):
    """MetaGated (gaterv2/arch.py:301-340)."""
    y = F.rms_norm_ref(x, p['local.0.scale'], p['local.0.offset'])
    y = conv(p['local.2'], conv(p['local.1'], y))
    half = y.shape[-1] // 2
    y = y[..., :half] * y[..., half:]
    y = y * conv(p['sca.1'], y.mean(dim=(1, 2), keepdim=True))
    x = y * p['gamma0'].reshape(-1) + x
    return _gated_cnn(p.sub('glob'), x, dim, att=False) * p['gamma1'].reshape(-1) + x


def meta_gated_groups(params) -> dict:
    """``prepare_convs``'s groups for the MetaGated blocks: each
    ``local.2`` has groups = the block's width (the input of
    ``local.1``), and the token mixers are depthwise."""
    groups = inception_groups(params)
    for k, v in params.items():
        if k.endswith('.local.2.weight'):
            groups[k[: -len('.weight')]] = params[k.replace('.local.2.', '.local.1.')].shape[1]
    return groups


def encode(p: PTree, x, blocks: tuple[int, ...], dim: int, stage: str):
    """The U-Net's encoder: each stage's MetaGated blocks, then a bias-free
    3x3 conv and a pixel unshuffle; returns x and the skips, deepest first."""
    shorts = []
    for i, nb in enumerate(blocks):
        bp = p.sub(f'{stage}.{i}')
        for j in range(nb):
            x = _meta_gated(bp.sub(f'gated.{j}'), x, dim * 2**i)
        shorts.append(x)
        x = F.pixel_unshuffle(conv(bp['scale.0'], x), 2)
    return x, shorts[::-1]


def decode(p: PTree, x, shorts, blocks: tuple[int, ...], dim: int):
    """The U-Net's decoder: each stage's bias-free 3x3 conv, pixel shuffle,
    the 1x1 ``shor`` over it and the skip, then its MetaGated blocks."""
    for i, nb in enumerate(blocks):
        bp = p.sub(f'decode.{i}')
        x = F.pixel_shuffle(conv(bp['scale.0'], x), 2)
        x = conv(bp['shor'], torch.cat([x, shorts[i]], dim=-1))
        for j in range(nb):
            x = _meta_gated(bp.sub(f'gated.{j}'), x, dim * 2 ** (len(blocks) - i) // 2)
    return x


def prepare(cfg: GateRV2Config, params, dtype):
    return prepare_convs(params, dtype, meta_gated_groups(params))


def apply(cfg: GateRV2Config, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    h0, w0 = x.shape[1], x.shape[2]
    inp = F.pad_to_multiple(x, 2 ** len(cfg.enc_blocks), mode='reflect')
    x, shorts = encode(p, conv(p['in_to_dim'], inp), cfg.enc_blocks, cfg.dim, 'encode')
    latent_dim = cfg.dim * 2 ** len(cfg.enc_blocks)
    for i in range(cfg.num_latent):
        x = _gated_cnn(p.sub(f'latent.{i}'), x, latent_dim, att=True)
    x = decode(p, x, shorts, cfg.dec_blocks, cfg.dim)

    if cfg.scale != 1:
        out1 = conv(p['short_to_dim.block.2'], conv(p['short_to_dim.block.0'], inp, 'mish'), 'mish')
        x = x + (out1 + conv(p['short_to_dim.conv11'], inp))
        x = uni_upsample(p.sub('upsample'), x, cfg.upsampler, cfg.scale, cfg.in_ch, cfg.upsample_mid_dim)
    else:
        x = conv(p['dim_to_in'], x) + inp
    return x[:, : h0 * cfg.scale, : w0 * cfg.scale]


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/gaterv2.py::_load`` (the
    probed ``upsample.MetaUpsample`` key is the one read)."""
    dim, in_ch = sd['in_to_dim.weight'].shape[:2]
    enc_blocks = tuple(get_seq_len(sd, f'encode.{i}.gated') for i in range(get_seq_len(sd, 'encode')))
    latent = get_seq_len(sd, 'latent')
    dec_blocks = tuple(get_seq_len(sd, f'decode.{i}.gated') for i in range(get_seq_len(sd, 'decode')))
    if 'upsample.MetaUpsample' in sd:
        meta_buf = [int(v) for v in sd['upsample.MetaUpsample'].reshape(-1)]
        _, index, scale, _, out_ch, upsample_dim, _ = meta_buf
        upsampler = SAMPLE_MODS[index]
    else:
        scale, upsample_dim, upsampler = 1, 32, 'conv'

    cfg = GateRV2Config(
        in_ch=in_ch, dim=dim, enc_blocks=enc_blocks, dec_blocks=dec_blocks,
        num_latent=latent, scale=scale, upsampler=upsampler, upsample_mid_dim=upsample_dim,
    )
    params = {k: v for k, v in sd.items() if k != 'upsample.MetaUpsample'}
    meta = ModelMetadata(in_channels=in_ch, out_channels=in_ch, upscale=scale, name='GateRv2')
    return SRModel('GateRv2', cfg, params_from_numpy(params, device), meta, apply, prepare)


ARCH = Architecture(
    id='GateRv2',
    detect_condition=KeyCondition.has_all(
        'in_to_dim.weight',
        'in_to_dim.bias',
        'encode.0.gated.0.gamma0',
        'encode.0.gated.0.gamma1',
        'encode.0.gated.0.local.0.scale',
        'encode.0.gated.0.local.0.offset',
        'encode.0.gated.0.local.1.weight',
        'encode.0.gated.0.local.1.bias',
        'encode.0.gated.0.local.2.weight',
        'encode.0.gated.0.local.2.bias',
        'encode.0.gated.0.sca.1.weight',
        'encode.0.gated.0.sca.1.bias',
        'encode.0.gated.0.glob.norm.scale',
        'encode.0.gated.0.glob.norm.offset',
        'encode.0.gated.0.glob.fc1.weight',
        'encode.0.gated.0.glob.fc1.bias',
        'encode.0.gated.0.glob.token_mix.dwconv_hw.weight',
        'encode.0.gated.0.glob.token_mix.dwconv_hw.bias',
        'encode.0.gated.0.glob.token_mix.dwconv_w.weight',
        'encode.0.gated.0.glob.token_mix.dwconv_w.bias',
        'encode.0.gated.0.glob.token_mix.dwconv_h.weight',
        'encode.0.gated.0.glob.token_mix.dwconv_h.bias',
        'encode.0.gated.0.glob.fc2.weight',
        'encode.0.gated.0.glob.fc2.bias',
        'encode.0.scale.0.weight',
        'encode.1.gated.0.gamma0',
        'encode.1.gated.0.gamma1',
        'encode.1.gated.0.local.0.scale',
        'encode.1.gated.0.local.0.offset',
        'encode.1.gated.0.local.1.weight',
        'encode.1.gated.0.local.1.bias',
        'encode.1.gated.0.local.2.weight',
        'encode.1.gated.0.local.2.bias',
        'encode.1.gated.0.sca.1.weight',
        'encode.1.gated.0.sca.1.bias',
        'encode.1.gated.0.glob.norm.scale',
        'encode.1.gated.0.glob.norm.offset',
        'encode.1.gated.0.glob.fc1.weight',
        'encode.1.gated.0.glob.fc1.bias',
        'encode.1.gated.0.glob.token_mix.dwconv_hw.weight',
        'encode.1.gated.0.glob.token_mix.dwconv_hw.bias',
        'encode.1.gated.0.glob.token_mix.dwconv_w.weight',
        'encode.1.gated.0.glob.token_mix.dwconv_w.bias',
        'encode.1.gated.0.glob.token_mix.dwconv_h.weight',
        'encode.1.gated.0.glob.token_mix.dwconv_h.bias',
        'encode.1.gated.0.glob.fc2.weight',
        'encode.1.gated.0.glob.fc2.bias',
        'encode.1.scale.0.weight',
        'latent.0.norm.scale',
        'latent.0.norm.offset',
        'latent.0.fc1.weight',
        'latent.0.fc1.bias',
        'latent.0.token_mix.query_conv.weight',
        'latent.0.token_mix.query_conv.bias',
        'latent.0.token_mix.key_conv.weight',
        'latent.0.token_mix.key_conv.bias',
        'latent.0.token_mix.value_conv.weight',
        'latent.0.token_mix.value_conv.bias',
        'latent.0.fc2.weight',
        'latent.0.fc2.bias',
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
        'decode.1.scale.0.weight',
        'decode.1.gated.0.gamma0',
        'decode.1.gated.0.gamma1',
        'decode.1.gated.0.local.0.scale',
        'decode.1.gated.0.local.0.offset',
        'decode.1.gated.0.local.1.weight',
        'decode.1.gated.0.local.1.bias',
        'decode.1.gated.0.local.2.weight',
        'decode.1.gated.0.local.2.bias',
        'decode.1.gated.0.sca.1.weight',
        'decode.1.gated.0.sca.1.bias',
        'decode.1.gated.0.glob.norm.scale',
        'decode.1.gated.0.glob.norm.offset',
        'decode.1.gated.0.glob.fc1.weight',
        'decode.1.gated.0.glob.fc1.bias',
        'decode.1.gated.0.glob.token_mix.dwconv_hw.weight',
        'decode.1.gated.0.glob.token_mix.dwconv_hw.bias',
        'decode.1.gated.0.glob.token_mix.dwconv_w.weight',
        'decode.1.gated.0.glob.token_mix.dwconv_w.bias',
        'decode.1.gated.0.glob.token_mix.dwconv_h.weight',
        'decode.1.gated.0.glob.token_mix.dwconv_h.bias',
        'decode.1.gated.0.glob.fc2.weight',
        'decode.1.gated.0.glob.fc2.bias',
        'decode.1.shor.weight',
        'decode.1.shor.bias',
    ),
    load_fn=_load,
)
