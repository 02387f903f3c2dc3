"""EIMN — Efficient Information Modulation Network.

Counterpart of ``resselt_tpu/archs/eimn.py``: the same config inference
(including the float ``mlp_ratio``), metadata and detection keys, and the
same forward, NHWC: EIMNBlocks with inference-mode BatchNorm2d, the MOLRCM
dilated depthwise attention, the SADFFM gated FFN with DFFM's dual
attention, a channels-last LayerNorm per stage.  Every MOLRCM that
``molrcm_supported`` takes (dim 64, EIMN_L's width) runs through
``ops.fused_molrcm`` (on the card: ``csrc/molrcm.cu``, one launch per
block: 16 per EIMN_L forward), with its weights packed once per compute
dtype by ``prepare``, where all other params are cast to that dtype once.
Other widths run the plain chain, as JAX's dispatch does outside its gate.
SADFFM, DFFM, the norms and the head and tail convs are plain PyTorch, as
the JAX package leaves them to XLA.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len, pixelshuffle_scale
from ..nn import functional as F
from ..nn.params import PTree
from ..ops import fused_molrcm, molrcm_supported, pack_molrcm_weights


@dataclass(frozen=True)
class EIMNConfig:
    embed_dims: int
    scale: int
    depths: int
    mlp_ratio: float
    num_stages: int


def _molrcm(p: PTree, x, dim: int):
    """MOLRCM (eimn/arch.py:103-147): the fused kernel where ``prepare``
    packed its weights, else the plain chain."""
    packed = p.get('molrcm')
    if packed is not None:
        return fused_molrcm(x, packed)

    c1, c2 = int(3 / 8 * dim), int(1 / 8 * dim)
    value = p.conv('proj_value.0', x)
    query = F.gelu(p.conv('proj_query.0', x))
    query = p.conv('region', query, padding=2, groups=dim)
    q1 = p.conv('spatial_1', query[..., :c1], padding=4, dilation=2, groups=c1)
    q2 = query[..., c1 : c1 + c2]
    q3 = p.conv('spatial_2', query[..., c1 + c2 :], padding=9, dilation=3, groups=dim - c1 - c2)
    out = F.silu(p.conv('fusion', torch.cat([q1, q2, q3], dim=-1)))
    return p.conv('out', out * value)


def _dffm(p: PTree, x):
    """DFFM (eimn/arch.py:65-100)."""
    identity = x
    x = F.layer_norm(x, p['norm.weight'], p['norm.bias'], eps=1e-6)
    xg = F.gelu(p.conv('global_reduce', x.mean(dim=(1, 2), keepdim=True)))
    xl = F.gelu(p.conv('local_reduce', x))
    c_attn = F.sigmoid(p.conv('channel_expand', xg))
    xg_b = xg.expand(x.shape[0], x.shape[1], x.shape[2], xg.shape[-1])
    s_attn = F.sigmoid(p.conv('spatial_expand', torch.cat([xl, xg_b], dim=-1)))
    return identity * (c_attn * s_attn)


def _sadffm(p: PTree, x, dim: int, mlp_ratio: float):
    """SADFFM (eimn/arch.py:38-62)."""
    hidden = int(dim * mlp_ratio)
    x = p.conv('linear_in', x)
    x = p.conv('SAL', x, padding=1, groups=2 * hidden)
    x = F.gelu(x[..., :hidden]) * x[..., hidden:]
    x = p.conv('linear_out', x)
    return _dffm(p.sub('DFFM'), x)


def _block(p: PTree, x, cfg: EIMNConfig):
    """EIMNBlock (eimn/arch.py:149-174)."""
    x = x + p['layer_scale_1'] * _molrcm(p.sub('attn'), p.batch_norm('norm1', x), cfg.embed_dims)
    return x + p['layer_scale_2'] * _sadffm(p.sub('mlp'), p.batch_norm('norm2', x), cfg.embed_dims, cfg.mlp_ratio)


def prepare(cfg: EIMNConfig, params, dtype: torch.dtype) -> dict:
    """The params in ``dtype``, plus each block's MOLRCM weights packed for
    the kernel under ``block{i}.{j}.attn.molrcm`` (rounded to ``dtype``,
    held in f32) where ``molrcm_supported`` takes the width."""
    out = {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}
    if molrcm_supported(cfg.embed_dims, 1, 1):
        p = PTree(params)
        for i in range(1, cfg.num_stages + 1):
            for j in range(cfg.depths):
                out[f'block{i}.{j}.attn.molrcm'] = pack_molrcm_weights(p.sub(f'block{i}.{j}.attn'), dtype)
    return out


def apply(cfg: EIMNConfig, params, x):
    """Forward on NHWC ``x`` with ``params = prepare(cfg, ..., x.dtype)``."""
    p = PTree(params)
    x = p.conv('head.0', x, padding=1)
    identity = x
    for i in range(cfg.num_stages):
        for j in range(cfg.depths):
            x = _block(p.sub(f'block{i + 1}.{j}'), x, cfg)
        x = p.layer_norm(f'norm{i + 1}', x)
    return F.pixel_shuffle(p.conv('tail.0', identity + x, padding=1), cfg.scale)


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/eimn.py::_load``."""
    numbers = [int(m.group(1)) for s in sd.keys() if (m := re.search(r'block(\d+)', s))]
    num_stages = max(numbers)
    depths = get_seq_len(sd, 'block1')
    mr = sd['block1.0.mlp.linear_in.weight'].shape
    mlp_ratio = mr[0] // 2 / mr[1]
    embed_dim = sd['head.0.weight'].shape[0]
    scale = pixelshuffle_scale(sd['tail.0.weight'].shape[0], 3)

    cfg = EIMNConfig(embed_dims=embed_dim, scale=scale, depths=depths, mlp_ratio=mlp_ratio, num_stages=num_stages)
    meta = ModelMetadata(in_channels=3, out_channels=3, upscale=scale, name='EIMN')
    return SRModel('eimn', cfg, params_from_numpy(sd, device), meta, apply, prepare)


ARCH = Architecture(
    id='eimn',
    detect_condition=KeyCondition.has_all(
        'head.0.weight',
        'tail.0.weight',
        'block1.0.layer_scale_1',
        'block1.0.layer_scale_2',
        'block1.0.norm1.running_mean',
        'block1.0.norm1.running_var',
        'block1.0.attn.region.weight',
        'block1.0.attn.spatial_1.weight',
        'block1.0.attn.spatial_2.weight',
        'block1.0.attn.fusion.weight',
        'block1.0.attn.proj_value.0.weight',
        'block1.0.attn.proj_query.0.weight',
        'block1.0.attn.out.weight',
        'block1.0.norm2.running_mean',
        'block1.0.mlp.linear_in.weight',
        'block1.0.mlp.SAL.weight',
        'block1.0.mlp.linear_out.weight',
        'block1.0.mlp.DFFM.norm.weight',
        'block1.0.mlp.DFFM.global_reduce.weight',
        'block1.0.mlp.DFFM.local_reduce.weight',
        'block1.0.mlp.DFFM.channel_expand.weight',
        'block1.0.mlp.DFFM.spatial_expand.weight',
        'norm1.weight',
        'norm1.bias',
    ),
    load_fn=_load,
)
