"""FIGSR: Fourier Inception Gated Super Resolution.

Counterpart of ``resselt_tpu/archs/figsr.py``: the same config inference
(the ``upscale.MetaUpsample`` buffer decoded and dropped), metadata and
forward.  The RMSNorm with its ``eps`` and ``rms`` serialized as buffers,
GFISRV2's FourierUnit with that norm (on the spectrum in f32), full (ungrouped)
inception convs, the built-in reflect halo of 4 with its crop, the learnable
global ``shift`` / ``scale_norm`` affine, the UniUpsampleV3 tail with a 3x3
DySample end conv.  Every same-padded 3x3 conv with groups 1 runs through
``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``): the stem, ``fc1``,
``fc2``, a 3x3 ``convhw``, the second half's tail conv and the
UniUpsampleV3's 3x3 convs.  The depthwise and 1x1 convs, the band convs
and the FFTs (``nn.spectral``) stay plain torch.  The weights are built
once per compute dtype (``prepare``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.upsample import SAMPLE_MODS3, uni_upsample_v3, uni_upsample_v3_convs
from ..ops.conv_route import conv, prepare_convs
from .gfisr import mixer_groups
from .gfisrv2 import fourier_unit_v2


@dataclass(frozen=True)
class FIGSRConfig:
    in_nc: int
    out_nc: int
    dim: int
    expansion_ratio: float
    scale: int
    upsampler: str
    mid_dim: int
    n_blocks: int
    gc: int
    square_kernel_size: int
    band_kernel_size: int


def _rms(p: PTree, name: str, x):
    """FIGSR's RMSNorm (figsr/arch.py:398-409): ``x / (eps + ||x|| * rms)``
    over the channels, scaled and offset, ``eps`` and ``rms`` from the
    checkpoint."""
    t = lambda k: p[f'{name}.{k}'].to(x.dtype)  # noqa: E731
    norm = t('eps').reshape(()) + torch.linalg.vector_norm(x, dim=-1, keepdim=True) * t('rms').reshape(())
    return t('offset') + x / norm * t('scale')


def _gated_block(p: PTree, x, cfg: FIGSRConfig):
    """GatedCNNBlock (figsr/arch.py:593-624)."""
    shortcut = x
    dim, gc = cfg.dim, cfg.gc
    hidden = int(cfg.expansion_ratio * dim) // 8 * 8
    x = conv(p['fc1'], _rms(p, 'norm', x))
    o = 2 * hidden - dim
    c = x[..., o:]
    parts = [x[..., hidden:o], fourier_unit_v2(p.sub('conv.fu'), c[..., : dim - 3 * gc], _rms)]
    for j, name in enumerate(('convhw', 'convw', 'convh')):
        parts.append(conv(p[f'conv.{name}'], c[..., dim - (3 - j) * gc : dim - (2 - j) * gc]))
    return conv(p['fc2'], F.silu(x[..., :hidden]) * torch.cat(parts, dim=-1)) + shortcut


def prepare(cfg: FIGSRConfig, params, dtype):
    groups, skip = uni_upsample_v3_convs(params, 'upscale', cfg.upsampler, cfg.scale)
    return prepare_convs(params, dtype, {**mixer_groups(params, 'gfisr_body_half'), **groups}, skip)


def apply(cfg: FIGSRConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    shift = p['shift'].reshape(-1).to(x.dtype)
    scale_norm = p['scale_norm'].reshape(-1).to(x.dtype)
    x = (x - shift) / scale_norm

    h0, w0 = x.shape[1], x.shape[2]
    extra = 4
    x = F.pad2d(x, (extra, extra + w0 % 2, extra, extra + h0 % 2), mode='reflect')  # the halo, evened out
    x = conv(p['in_to_dim'], x)
    n_half = cfg.n_blocks // 2
    x0 = x
    for i in range(n_half):
        x0 = _gated_block(p.sub(f'gfisr_body_half.{i}'), x0, cfg)
    x1 = x0
    for i in range(cfg.n_blocks - n_half):
        x1 = _gated_block(p.sub(f'gfisr_body_half_2.{i}'), x1, cfg)
    x1 = conv(p[f'gfisr_body_half_2.{cfg.n_blocks - n_half}'], x1)

    x = conv(p['cat_to_dim'], torch.cat([x1, x, x0], dim=-1))
    x = uni_upsample_v3(p.sub('upscale'), x, cfg.upsampler, cfg.scale, cfg.out_nc, cfg.mid_dim,
                        dysample_end_kernel=3)
    ce = extra * cfg.scale
    return x[:, ce : ce + h0 * cfg.scale, ce : ce + w0 * cfg.scale, :] * scale_norm + shift


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/figsr.py::_load``."""
    _, upsampler_idx, scale, _, out_nc, mid_dim, _ = [int(v) for v in sd['upscale.MetaUpsample'].reshape(-1)]
    dim, in_nc = sd['in_to_dim.weight'].shape[:2]
    b = 'gfisr_body_half.0'
    cfg = FIGSRConfig(in_nc=in_nc, out_nc=out_nc, dim=dim, expansion_ratio=sd[f'{b}.fc1.weight'].shape[0] / 2 / dim,
                      scale=scale, upsampler=SAMPLE_MODS3[upsampler_idx], mid_dim=mid_dim,
                      n_blocks=get_seq_len(sd, 'gfisr_body_half') + get_seq_len(sd, 'gfisr_body_half_2') - 1,
                      gc=sd[f'{b}.conv.convh.bias'].shape[0], square_kernel_size=sd[f'{b}.conv.convhw.weight'].shape[2],
                      band_kernel_size=sd[f'{b}.conv.convh.weight'].shape[2])
    params = {k: v for k, v in sd.items() if k != 'upscale.MetaUpsample'}
    meta = ModelMetadata(in_channels=in_nc, out_channels=in_nc, upscale=scale, name='FIGSR')
    return SRModel('FIGSR', cfg, params_from_numpy(params, device), meta, apply, prepare)


def _block_keys(b: str) -> list[str]:
    """The keys of one gated block that detection asks for."""
    keys = [f'{b}.norm.{k}' for k in ('scale', 'offset', 'eps', 'rms')] + [f'{b}.fc1.weight', f'{b}.fc1.bias']
    for n in ('rn', 'post_norm'):
        keys += [f'{b}.conv.fu.{n}.{k}' for k in ('scale', 'offset', 'eps', 'rms')]
    for n in ('fu.fdc', 'fu.fpe', 'convhw', 'convw', 'convh'):
        keys += [f'{b}.conv.{n}.weight', f'{b}.conv.{n}.bias']
    return keys + [f'{b}.fc2.weight', f'{b}.fc2.bias']


ARCH = Architecture(
    id='FIGSR',
    detect_condition=KeyCondition.has_all(
        'in_to_dim.weight',
        'in_to_dim.bias',
        *_block_keys('gfisr_body_half.0'),
        *_block_keys('gfisr_body_half_2.0'),
        'cat_to_dim.weight',
        'cat_to_dim.bias',
        'upscale.MetaUpsample',
    ),
    load_fn=_load,
)
