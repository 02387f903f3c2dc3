"""PLKSR / RealPLKSR: Partial Large Kernel CNNs for Efficient SR.

Counterpart of ``resselt_tpu/archs/plksr.py``: the same config inference,
metadata names and serving hint, and the same forward.  The partial
large-kernel conv works on the first ``pdim`` channels only; every square
one that :func:`lk_conv_supported` takes runs through ``ops.fused_conv_lk``
(on the card: ``csrc/conv_lk.cu``, one launch per block), reading the
channel slice in place.  Its weights are packed for the kernel once per
compute dtype (``prepare``), where all other params are cast to that dtype
once.  The mixer, attention, refine, group-norm and DySample math is plain
PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len, pixelshuffle_scale
from ..nn import functional as F
from ..nn.params import PTree, cast_params
from ..nn.upsample import dysample
from ..ops import fused_conv_lk, lk_conv_supported, pack_conv_lk_weight
from ..ops.fused_conv import fused_lk_enabled


@dataclass(frozen=True)
class PLKSRConfig:
    variant: str  # 'plksr' | 'realplksr'
    dim: int
    n_blocks: int
    upscale: int
    ccm_type: str  # plksr only
    lk_type: str  # plksr only: 'PLK' | 'SparsePLK' | 'RectSparsePLK'
    use_ea: bool
    norm_groups: int = 4  # realplksr only
    dys: bool = False  # realplksr only
    sparse_dilations: tuple[int, ...] = (1, 2, 3, 4)
    n_sparse_convs: int = 0


def _partial(x, pdim, fn):
    return torch.cat([fn(x[..., :pdim]), x[..., pdim:]], dim=-1)


def _plk_conv(p: PTree, x1):
    """The k x k partial large-kernel conv: the lk kernel where ``prepare``
    packed its weights (every square shape the kernel takes) and the kernel
    switch is on (``ops.fused_conv.use_fused_lk``), else a plain
    same-padded conv, as JAX's dispatch outside its gate."""
    packed = p.get('conv.lk_kernel')
    if packed is not None and fused_lk_enabled():
        taps, bias = packed
        return fused_conv_lk(x1, taps, bias, k=p.shape('conv.weight')[-1])
    return p.conv('conv', x1, padding='same')


def _lk(p: PTree, x, cfg: PLKSRConfig):
    if cfg.lk_type == 'PLK':
        pdim = p.shape('conv.weight')[0]
        return _partial(x, pdim, lambda x1: _plk_conv(p, x1))
    if cfg.lk_type == 'RectSparsePLK':
        pdim = p.shape('mn_conv.weight')[0]

        def fn(x1):
            mk, nk = p.shape('mn_conv.weight')[-2:]
            return (
                p.conv('mn_conv', x1, padding=(mk // 2, nk // 2))
                + p.conv('nm_conv', x1, padding=(nk // 2, mk // 2))
                + p.conv('nn_conv', x1, padding=(nk // 2, nk // 2))
            )

        return _partial(x, pdim, fn)
    # SparsePLK: sum of dilated convs (dilations from the default table)
    pdim = p.shape('convs.0.weight')[0]

    def fn(x1):
        out = 0.0
        for i in range(cfg.n_sparse_convs):
            k = p.shape(f'convs.{i}.weight')[-1]
            d = cfg.sparse_dilations[i] if i < len(cfg.sparse_dilations) else 1
            out = out + p.conv(f'convs.{i}', x1, padding=(k // 2) * d, dilation=d)
        return out

    return _partial(x, pdim, fn)


def _plk_block(p: PTree, x, cfg: PLKSRConfig):
    x_skip = x
    if cfg.variant == 'plksr':
        mixer = p.sub('channe_mixer')  # the reference's key spelling
        x = mixer.conv('0', x, padding=mixer.shape('0.weight')[-1] // 2)
        x = F.gelu(x)
        x = mixer.conv('2', x, padding=mixer.shape('2.weight')[-1] // 2)
    else:
        mixer = p.sub('channel_mixer')
        x = mixer.conv('0', x, padding=1)
        x = F.mish(x)
        x = mixer.conv('2', x, padding=1)
    x = _lk(p.sub('lk'), x, cfg)
    if cfg.use_ea:
        x = x * F.sigmoid(p.conv('attn.f.0', x, padding=1))
    x = p.conv('refine', x)
    if cfg.variant == 'realplksr':
        x = F.group_norm(x, cfg.norm_groups, p['norm.weight'], p['norm.bias'])
    return x + x_skip


def prepare(cfg: PLKSRConfig, params, dtype: torch.dtype) -> dict:
    """The params in ``dtype``, plus each PLK conv the lk kernel takes
    packed for it under ``feats.{i}.lk.conv.lk_kernel``: (taps in
    ``dtype``, f32 bias or None)."""
    out = cast_params(params, dtype)
    if cfg.lk_type != 'PLK':
        return out
    for i in range(1, cfg.n_blocks + 1):
        w = params[f'feats.{i}.lk.conv.weight']
        cout, cin, kh, kw = w.shape
        if kh == kw and lk_conv_supported(cin, cout, kh):
            b = params.get(f'feats.{i}.lk.conv.bias')
            out[f'feats.{i}.lk.conv.lk_kernel'] = (pack_conv_lk_weight(w, dtype),
                                                   None if b is None else b.float().contiguous())
    return out


def apply(cfg: PLKSRConfig, params, x):
    """Forward on NHWC ``x`` with ``params = prepare(cfg, ..., x.dtype)``."""
    p = PTree(params)
    s = cfg.upscale
    feat = p.conv('feats.0', x, padding=1)
    for i in range(cfg.n_blocks):
        feat = _plk_block(p.sub(f'feats.{i + 1}'), feat, cfg)
    last = cfg.n_blocks + 1 if cfg.variant == 'plksr' else cfg.n_blocks + 2
    feat = p.conv(f'feats.{last}', feat, padding=1)
    feat = feat + torch.repeat_interleave(x, s * s, dim=-1)
    if cfg.dys:
        groups = x.shape[-1] if s % 2 != 0 else 4
        return dysample(p.sub('to_img'), feat, s, groups=groups, end_convolution=s != 1)
    return F.pixel_shuffle(feat, s)


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/plksr.py::_load``."""
    in_nc = sd['feats.0.weight'].shape[1]
    out_nc = in_nc
    dim = sd['feats.0.weight'].shape[0]
    total_feat_layers = get_seq_len(sd, 'feats')
    use_ea = 'feats.1.attn.f.0.weight' in sd
    scale = pixelshuffle_scale(sd[f'feats.{total_feat_layers - 1}.weight'].shape[0], out_nc)

    if 'feats.1.channe_mixer.0.weight' in sd:
        n_blocks = total_feat_layers - 2
        m0 = sd['feats.1.channe_mixer.0.weight'].shape[2]
        m2 = sd['feats.1.channe_mixer.2.weight'].shape[2]
        ccm_type = {(3, 1): 'CCM', (3, 3): 'DCCM', (1, 3): 'ICCM'}.get((m0, m2))
        if ccm_type is None:
            raise ValueError('Unknown CCM type')
        if 'feats.1.lk.conv.weight' in sd:
            lk_type = 'PLK'
        elif 'feats.1.lk.convs.0.weight' in sd:
            lk_type = 'SparsePLK'
        elif 'feats.1.lk.mn_conv.weight' in sd:
            lk_type = 'RectSparsePLK'
        else:
            raise ValueError('Unknown LK type')
        n_sparse = get_seq_len(sd, 'feats.1.lk.convs') if lk_type == 'SparsePLK' else 0
        cfg = PLKSRConfig(
            variant='plksr', dim=dim, n_blocks=n_blocks, upscale=scale,
            ccm_type=ccm_type, lk_type=lk_type, use_ea=use_ea, n_sparse_convs=n_sparse,
        )
        name = 'PLKSR'
    elif 'feats.1.channel_mixer.0.weight' in sd:
        n_blocks = total_feat_layers - 3
        cfg = PLKSRConfig(
            variant='realplksr', dim=dim, n_blocks=n_blocks, upscale=scale,
            ccm_type='DCCM', lk_type='PLK', use_ea=use_ea,
            norm_groups=4, dys='to_img.init_pos' in sd,
        )
        name = 'RealPLKSR'
    else:
        raise ValueError('Unknown model type')

    meta = ModelMetadata(in_channels=in_nc, out_channels=out_nc, upscale=scale, name=name)
    model = SRModel('PLKSR', cfg, params_from_numpy(sd, device), meta, apply, prepare)
    # the JAX package's hint, kept so that tiled outputs match it; its
    # value has not been re-measured on a GPU
    model.serving_halo = 4
    return model


ARCH = Architecture(
    id='PLKSR',
    detect_condition=KeyCondition.has_all(
        'feats.0.weight',
        KeyCondition.has_any(
            'feats.1.lk.conv.weight',
            'feats.1.lk.convs.0.weight',
            'feats.1.lk.mn_conv.weight',
        ),
        'feats.1.refine.weight',
        KeyCondition.has_any(
            'feats.1.channe_mixer.0.weight',
            'feats.1.channel_mixer.0.weight',
        ),
    ),
    load_fn=_load,
)
