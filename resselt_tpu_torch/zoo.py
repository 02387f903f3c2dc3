"""Synthetic checkpoints: random numpy state dicts with the exact
key and shape layout the detection tables fingerprint, made from a seed.

Counterpart of ``resselt_tpu/zoo.py``, holding ``make_esrgan``,
``make_swinir`` and ``make_plksr`` (the same arrays as the JAX package's),
``make_realplksr`` and ``make_eimn``; ``make_hat`` and ``make_atd`` (the JAX
package's arrays; ``make_atd`` also builds the other upsamplers' tails and
the 3conv residual); ``make_dat``, ``make_rgt``, ``make_drct``, ``make_fdat``
and ``make_omni``, which the JAX package's zoo lacks, written from what its
loaders, detection conditions and forwards read; ``make_compact``,
``make_span``, ``make_spanplus`` and ``make_mosr`` (the JAX package's
arrays at their defaults; the last three also build the reference's other
variants), and ``make_spanpp`` and ``make_rcan``, written from the JAX
loaders and detection keys; ``make_gater`` (the JAX package's arrays; also
an FLPVT2 latent), and ``make_cugan``, ``make_mosrv2``, ``make_moesr``,
``make_gaterv2`` and ``make_gaterv3``, written from the JAX loaders,
detection keys and forwards, with their MetaUpsample buffers; so are
``make_rtmosr``, ``make_smosr``, ``make_rha``, ``make_flexnet``,
``make_gfisr``, ``make_gfisrv2``, ``make_figsr`` and ``make_lawfft`` (with
their scalar config buffers).
"""

from __future__ import annotations

import math

import numpy as np


class _Maker:
    def __init__(self, seed: int = 0, std: float = 0.03):
        self.rng = np.random.default_rng(seed)
        self.std = std
        self.sd: dict[str, np.ndarray] = {}

    def t(self, key: str, *shape: int):
        self.sd[key] = (self.rng.standard_normal(shape) * self.std).astype(np.float32)

    def conv(self, key: str, cout: int, cin: int, k: int = 3):
        self.t(f'{key}.weight', cout, cin, k, k)
        self.t(f'{key}.bias', cout)


def make_esrgan(num_filters: int = 64, num_blocks: int = 23, scale: int = 4, in_nc: int = 3, out_nc: int = 3, gc: int = 32, seed: int = 0):
    """RRDBNet old-arch layout."""
    m = _Maker(seed)
    nf = num_filters
    m.conv('model.0', nf, in_nc, 3)
    for b in range(num_blocks):
        for r in (1, 2, 3):
            base = f'model.1.sub.{b}.RDB{r}'
            for ci in range(1, 6):
                cin = nf + (ci - 1) * gc
                cout = gc if ci < 5 else nf
                m.conv(f'{base}.conv{ci}.0', cout, cin, 3)
    m.conv(f'model.1.sub.{num_blocks}', nf, nf, 3)
    n_up = int(math.log2(scale)) if scale != 3 else 1
    for i in range(1, n_up + 1):
        m.conv(f'model.{3 * i}', nf, nf, 3)
    m.conv(f'model.{3 * n_up + 2}', nf, nf, 3)
    m.conv(f'model.{3 * n_up + 4}', out_nc, nf, 3)
    return m.sd


def make_swinir(
    embed_dim: int = 60,
    depths=(6, 6, 6, 6),
    num_heads=(6, 6, 6, 6),
    window_size: int = 8,
    mlp_ratio: float = 2.0,
    upscale: int = 4,
    upsampler: str = 'pixelshuffle',
    in_nc: int = 3,
    img_size: int = 64,
    seed: int = 0,
):
    """SwinIR layout, including the ``attn_mask`` buffers the reference
    registers on shifted blocks at its training resolution (when
    ``img_size`` tiles evenly into shifted windows).  For 'pixelshuffle',
    'pixelshuffledirect' and '' the same arrays as the JAX package's
    ``make_swinir``; 'nearest+conv' builds the real-world tail
    (``conv_before_upsample.0``, ``conv_up1`` .. ``conv_up{log2 upscale}``,
    ``conv_hr``, ``conv_last``, 64 features)."""
    from .nn.window import relative_position_index, swin_attn_mask

    m = _Maker(seed)
    e = embed_dim
    m.conv('conv_first', e, in_nc, 3)
    m.t('patch_embed.norm.weight', e)
    m.t('patch_embed.norm.bias', e)
    rpi = relative_position_index(window_size, window_size)
    mask = None
    if img_size > window_size and img_size % window_size == 0:
        mask = swin_attn_mask(img_size, img_size, window_size, window_size // 2)
    for li, (depth, heads) in enumerate(zip(depths, num_heads)):
        for bi in range(depth):
            b = f'layers.{li}.residual_group.blocks.{bi}'
            if bi % 2 == 1 and mask is not None:
                m.sd[f'{b}.attn_mask'] = mask
            for nk in ('norm1', 'norm2'):
                m.t(f'{b}.{nk}.weight', e)
                m.t(f'{b}.{nk}.bias', e)
            m.t(f'{b}.attn.relative_position_bias_table', (2 * window_size - 1) ** 2, heads)
            m.sd[f'{b}.attn.relative_position_index'] = rpi
            m.t(f'{b}.attn.qkv.weight', 3 * e, e)
            m.t(f'{b}.attn.qkv.bias', 3 * e)
            m.t(f'{b}.attn.proj.weight', e, e)
            m.t(f'{b}.attn.proj.bias', e)
            hid = int(e * mlp_ratio)
            m.t(f'{b}.mlp.fc1.weight', hid, e)
            m.t(f'{b}.mlp.fc1.bias', hid)
            m.t(f'{b}.mlp.fc2.weight', e, hid)
            m.t(f'{b}.mlp.fc2.bias', e)
        m.conv(f'layers.{li}.conv', e, e, 3)
    m.t('norm.weight', e)
    m.t('norm.bias', e)
    m.conv('conv_after_body', e, e, 3)
    nf = 64
    if upsampler == 'pixelshuffle':
        m.conv('conv_before_upsample.0', nf, e, 3)
        if upscale & (upscale - 1) == 0:
            for i in range(int(math.log2(upscale))):
                m.conv(f'upsample.{2 * i}', 4 * nf, nf, 3)
        elif upscale == 3:
            m.conv('upsample.0', 9 * nf, nf, 3)
        m.conv('conv_last', in_nc, nf, 3)
    elif upsampler == 'pixelshuffledirect':
        m.conv('upsample.0', in_nc * upscale**2, e, 3)
    elif upsampler == 'nearest+conv':
        m.conv('conv_before_upsample.0', nf, e, 3)
        for i in range(1, int(math.log2(upscale)) + 1):
            m.conv(f'conv_up{i}', nf, nf, 3)
        m.conv('conv_hr', nf, nf, 3)
        m.conv('conv_last', in_nc, nf, 3)
    else:
        m.conv('conv_last', in_nc, e, 3)
    return m.sd


def _rpi_oca(ws: int, owin: int) -> np.ndarray:
    """HAT's overlapping cross-attention relative position index,
    (ws*ws, owin*owin) int."""
    co = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing='ij')).reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(owin), np.arange(owin), indexing='ij')).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0).astype(np.int64)
    rel += ws - owin + 1
    rel[:, :, 0] *= ws + owin - 1
    return rel.sum(-1)


def make_hat(
    embed_dim: int = 48,
    depths=(2,),
    num_heads=(4,),
    window_size: int = 8,
    overlap_ratio: float = 0.5,
    compress_ratio: int = 4,
    squeeze_factor: int = 8,
    mlp_ratio: float = 2.0,
    upscale: int = 2,
    num_feat: int = 32,
    in_nc: int = 3,
    seed: int = 0,
):
    """HAT layout: HAB blocks (window attention + CAB), one OCAB per group,
    a pixelshuffle tail, and the two relative-position index buffers.  The
    same arrays as the JAX package's ``make_hat``."""
    from .nn.window import relative_position_index

    m = _Maker(seed)
    e = embed_dim
    ws = window_size
    owin = ws + int(overlap_ratio * ws)
    hid = int(e * mlp_ratio)
    m.conv('conv_first', e, in_nc, 3)
    m.sd['relative_position_index_SA'] = relative_position_index(ws, ws)
    m.sd['relative_position_index_OCA'] = _rpi_oca(ws, owin)

    def mlp(b):
        m.t(f'{b}.mlp.fc1.weight', hid, e)
        m.t(f'{b}.mlp.fc1.bias', hid)
        m.t(f'{b}.mlp.fc2.weight', e, hid)
        m.t(f'{b}.mlp.fc2.bias', e)

    for li, (depth, heads) in enumerate(zip(depths, num_heads)):
        for bi in range(depth):
            b = f'layers.{li}.residual_group.blocks.{bi}'
            for nk in ('norm1', 'norm2'):
                m.t(f'{b}.{nk}.weight', e)
                m.t(f'{b}.{nk}.bias', e)
            m.t(f'{b}.attn.relative_position_bias_table', (2 * ws - 1) ** 2, heads)
            m.t(f'{b}.attn.qkv.weight', 3 * e, e)
            m.t(f'{b}.attn.qkv.bias', 3 * e)
            m.t(f'{b}.attn.proj.weight', e, e)
            m.t(f'{b}.attn.proj.bias', e)
            m.conv(f'{b}.conv_block.cab.0', e // compress_ratio, e, 3)
            m.conv(f'{b}.conv_block.cab.2', e, e // compress_ratio, 3)
            m.conv(f'{b}.conv_block.cab.3.attention.1', e // squeeze_factor, e, 1)
            m.conv(f'{b}.conv_block.cab.3.attention.3', e, e // squeeze_factor, 1)
            mlp(b)
        o = f'layers.{li}.residual_group.overlap_attn'
        for nk in ('norm1', 'norm2'):
            m.t(f'{o}.{nk}.weight', e)
            m.t(f'{o}.{nk}.bias', e)
        m.t(f'{o}.relative_position_bias_table', (ws + owin - 1) ** 2, heads)
        m.t(f'{o}.qkv.weight', 3 * e, e)
        m.t(f'{o}.qkv.bias', 3 * e)
        m.t(f'{o}.proj.weight', e, e)
        m.t(f'{o}.proj.bias', e)
        mlp(o)
        m.conv(f'layers.{li}.conv', e, e, 3)
    m.t('norm.weight', e)
    m.t('norm.bias', e)
    m.conv('conv_after_body', e, e, 3)
    m.conv('conv_before_upsample.0', num_feat, e, 3)
    for i in range(int(math.log2(upscale))):
        m.conv(f'upsample.{2 * i}', 4 * num_feat, num_feat, 3)
    m.conv('conv_last', in_nc, num_feat, 3)
    return m.sd


def make_atd(
    embed_dim: int = 48,
    depths=(2,),
    num_heads=(4,),
    window_size: int = 8,
    num_tokens: int = 16,
    reducted_dim: int = 8,
    convffn_kernel_size: int = 5,
    mlp_ratio: float = 1.0,
    upscale: int = 2,
    in_nc: int = 3,
    seed: int = 0,
    upsampler: str = 'pixelshuffledirect',
    resi_connection: str = '1conv',
):
    """ATD layout: a token dictionary ``td`` per group; per layer the shared
    ``wqkv``, the ``attn_win`` / ``attn_atd`` / ``attn_aca`` parameter sets,
    the ConvFFN, and (on all but a group's last layer) ``sigma`` and
    ``norm3`` for the dictionary refresh.  With the defaults
    ('pixelshuffledirect', '1conv') the same arrays as the JAX package's
    ``make_atd``.  ``upsampler`` 'pixelshuffle' (64 features), 'nearest+conv'
    (4x) and '' (1x) build the other tails; ``resi_connection`` '3conv'
    puts conv(e, e/4, 3), conv(e/4, e/4, 1), conv(e/4, e, 3) in place of each
    group's conv and of ``conv_after_body``."""
    from .nn.window import relative_position_index

    m = _Maker(seed)
    e = embed_dim
    ws = window_size
    hid = int(e * mlp_ratio)

    def resi_conv(key):
        if resi_connection == '1conv':
            m.conv(key, e, e, 3)
        else:
            m.conv(f'{key}.0', e // 4, e, 3)
            m.conv(f'{key}.2', e // 4, e // 4, 1)
            m.conv(f'{key}.4', e, e // 4, 3)

    m.conv('conv_first', e, in_nc, 3)
    m.sd['relative_position_index_SA'] = relative_position_index(ws, ws)
    for li, (depth, heads) in enumerate(zip(depths, num_heads)):
        g = f'layers.{li}.residual_group'
        m.t(f'{g}.td', num_tokens, e)
        for bi in range(depth):
            b = f'{g}.layers.{bi}'
            if bi < depth - 1:  # a group's last layer does not refresh td
                m.t(f'{b}.sigma', num_tokens, 1)
                m.t(f'{b}.norm3.weight', num_tokens)
                m.t(f'{b}.norm3.bias', num_tokens)
            for nk in ('norm1', 'norm2'):
                m.t(f'{b}.{nk}.weight', e)
                m.t(f'{b}.{nk}.bias', e)
            m.t(f'{b}.wqkv.weight', 3 * e, e)
            m.t(f'{b}.wqkv.bias', 3 * e)
            m.t(f'{b}.attn_win.relative_position_bias_table', (2 * ws - 1) ** 2, heads)
            m.t(f'{b}.attn_win.proj.weight', e, e)
            m.t(f'{b}.attn_win.proj.bias', e)
            m.t(f'{b}.attn_atd.scale', num_tokens)
            for wk, od in (('wq', reducted_dim), ('wk', reducted_dim), ('wv', e)):
                m.t(f'{b}.attn_atd.{wk}.weight', od, e)
                m.t(f'{b}.attn_atd.{wk}.bias', od)
            m.t(f'{b}.attn_aca.logit_scale', 1, 1)
            m.t(f'{b}.attn_aca.proj.weight', e, e)
            m.t(f'{b}.attn_aca.proj.bias', e)
            m.t(f'{b}.convffn.fc1.weight', hid, e)
            m.t(f'{b}.convffn.fc1.bias', hid)
            m.conv(f'{b}.convffn.dwconv.depthwise_conv.0', hid, 1, convffn_kernel_size)
            m.t(f'{b}.convffn.fc2.weight', e, hid)
            m.t(f'{b}.convffn.fc2.bias', e)
        resi_conv(f'layers.{li}.conv')
    m.t('norm.weight', e)
    m.t('norm.bias', e)
    resi_conv('conv_after_body')
    nf = 64
    if upsampler == 'pixelshuffledirect':
        m.conv('upsample.0', in_nc * upscale**2, e, 3)
    elif upsampler == 'pixelshuffle':
        m.conv('conv_before_upsample.0', nf, e, 3)
        if upscale & (upscale - 1) == 0:
            for i in range(int(math.log2(upscale))):
                m.conv(f'upsample.{2 * i}', 4 * nf, nf, 3)
        elif upscale == 3:
            m.conv('upsample.0', 9 * nf, nf, 3)
        m.conv('conv_last', in_nc, nf, 3)
    elif upsampler == 'nearest+conv':
        m.conv('conv_before_upsample.0', nf, e, 3)
        for key in ('conv_up1', 'conv_up2', 'conv_hr'):
            m.conv(key, nf, nf, 3)
        m.conv('conv_last', in_nc, nf, 3)
    elif upsampler == '':
        m.conv('conv_last', in_nc, e, 3)
    else:
        raise ValueError(f'unknown ATD upsampler {upsampler!r}')
    return m.sd


def make_plksr(dim: int = 64, n_blocks: int = 4, upscale: int = 4, kernel_size: int = 17, split_ratio: float = 0.25,
               in_nc: int = 3, seed: int = 0):
    """PLKSR layout with DCCM mixer + EA attention: a 17x17 partial
    large-kernel conv per block."""
    m = _Maker(seed)
    d = dim
    pk = int(d * split_ratio)
    m.conv('feats.0', d, in_nc, 3)
    for i in range(1, n_blocks + 1):
        m.conv(f'feats.{i}.channe_mixer.0', 2 * d, d, 3)
        m.conv(f'feats.{i}.channe_mixer.2', d, 2 * d, 3)
        m.conv(f'feats.{i}.lk.conv', pk, pk, kernel_size)
        m.conv(f'feats.{i}.attn.f.0', d, d, 3)
        m.conv(f'feats.{i}.refine', d, d, 1)
    m.conv(f'feats.{n_blocks + 1}', in_nc * upscale**2, d, 3)
    return m.sd


def make_realplksr(dim: int = 64, n_blocks: int = 28, upscale: int = 4, kernel_size: int = 17,
                   split_ratio: float = 0.25, in_nc: int = 3, use_ea: bool = True, dysample: bool = False,
                   seed: int = 0):
    """RealPLKSR layout: DCCM mixer (``channel_mixer``), partial
    large-kernel conv, optional EA, GroupNorm per block; a dropout slot puts
    the last conv at ``feats.{n_blocks + 2}``; with ``dysample`` (and
    upscale > 1) a DySample tail ``to_img`` with the reference's initial
    sample positions."""
    m = _Maker(seed)
    d = dim
    pk = int(d * split_ratio)
    m.conv('feats.0', d, in_nc, 3)
    for i in range(1, n_blocks + 1):
        m.conv(f'feats.{i}.channel_mixer.0', 2 * d, d, 3)
        m.conv(f'feats.{i}.channel_mixer.2', d, 2 * d, 3)
        m.conv(f'feats.{i}.lk.conv', pk, pk, kernel_size)
        if use_ea:
            m.conv(f'feats.{i}.attn.f.0', d, d, 3)
        m.conv(f'feats.{i}.refine', d, d, 1)
        m.t(f'feats.{i}.norm.weight', d)
        m.sd[f'feats.{i}.norm.weight'] += 1.0
        m.t(f'feats.{i}.norm.bias', d)
    c = in_nc * upscale**2
    m.conv(f'feats.{n_blocks + 2}', c, d, 3)
    if dysample and upscale != 1:
        _dysample(m, 'to_img', c, in_nc, upscale, in_nc if upscale % 2 else 4)
    return m.sd


def make_eimn(embed_dims: int = 64, num_stages: int = 16, depths: int = 1, mlp_ratio: float = 2.66, scale: int = 4,
              seed: int = 0):
    """EIMN layout (the reference's ``eimn()`` defaults are EIMN_L: embed
    64, 16 stages of one block, mlp ratio 2.66, 4x): per block the layer
    scales, two BatchNorm2d with running statistics (mean N(0, 0.1), var
    U(0.5, 1.5), as tests/test_rcan_eimn.py randomizes them, and
    ``num_batches_tracked``), the MOLRCM attention (1x1 value, query,
    fusion and out convs, the 5x5 region and the dilated 5x5 / 7x7
    depthwise convs on the 3/8 and 4/8 channel splits) and the SADFFM
    (linear_in to 2 x int(embed x mlp_ratio), the depthwise 3x3 SAL,
    linear_out, DFFM).  The repository does not record the reference's
    DFFM reduce width; this function uses embed // 4 for
    ``global_reduce`` / ``local_reduce`` (``spatial_expand`` takes both
    halves to one channel).  A LayerNorm per stage, and a pixel-shuffle
    tail."""
    m = _Maker(seed)
    d = embed_dims
    c1, c2 = int(3 / 8 * d), int(1 / 8 * d)
    hidden = int(d * mlp_ratio)
    red = d // 4
    m.conv('head.0', d, 3, 3)
    for i in range(1, num_stages + 1):
        for j in range(depths):
            b = f'block{i}.{j}'
            m.t(f'{b}.layer_scale_1', d)
            m.t(f'{b}.layer_scale_2', d)
            for norm in ('norm1', 'norm2'):
                m.t(f'{b}.{norm}.weight', d)
                m.sd[f'{b}.{norm}.weight'] += 1.0
                m.t(f'{b}.{norm}.bias', d)
                m.sd[f'{b}.{norm}.running_mean'] = (m.rng.standard_normal(d) * 0.1).astype(np.float32)
                m.sd[f'{b}.{norm}.running_var'] = (m.rng.random(d) + 0.5).astype(np.float32)
                m.sd[f'{b}.{norm}.num_batches_tracked'] = np.zeros((), np.int64)
            a = f'{b}.attn'
            m.conv(f'{a}.proj_value.0', d, d, 1)
            m.conv(f'{a}.proj_query.0', d, d, 1)
            m.conv(f'{a}.region', d, 1, 5)
            m.conv(f'{a}.spatial_1', c1, 1, 5)
            m.conv(f'{a}.spatial_2', d - c1 - c2, 1, 7)
            m.conv(f'{a}.fusion', d, d, 1)
            m.conv(f'{a}.out', d, d, 1)
            f = f'{b}.mlp'
            m.conv(f'{f}.linear_in', 2 * hidden, d, 1)
            m.conv(f'{f}.SAL', 2 * hidden, 1, 3)
            m.conv(f'{f}.linear_out', d, hidden, 1)
            m.t(f'{f}.DFFM.norm.weight', d)
            m.sd[f'{f}.DFFM.norm.weight'] += 1.0
            m.t(f'{f}.DFFM.norm.bias', d)
            m.conv(f'{f}.DFFM.global_reduce', red, d, 1)
            m.conv(f'{f}.DFFM.local_reduce', red, d, 1)
            m.conv(f'{f}.DFFM.channel_expand', d, red, 1)
            m.conv(f'{f}.DFFM.spatial_expand', 1, 2 * red, 1)
        m.t(f'norm{i}.weight', d)
        m.sd[f'norm{i}.weight'] += 1.0
        m.t(f'norm{i}.bias', d)
    m.conv('tail.0', 3 * scale**2, d, 3)
    return m.sd


def _ln(m: _Maker, key: str, width: int):
    """A LayerNorm's scale near one and its bias."""
    m.t(f'{key}.weight', width)
    m.sd[f'{key}.weight'] += 1.0
    m.t(f'{key}.bias', width)


def _bn(m: _Maker, key: str, width: int):
    """A BatchNorm2d's affine params and running statistics (mean N(0, 0.1),
    var U(0.5, 1.5)) and ``num_batches_tracked``."""
    _ln(m, key, width)
    m.sd[f'{key}.running_mean'] = (m.rng.standard_normal(width) * 0.1).astype(np.float32)
    m.sd[f'{key}.running_var'] = (m.rng.random(width) + 0.5).astype(np.float32)
    m.sd[f'{key}.num_batches_tracked'] = np.zeros((), np.int64)


def _linear(m: _Maker, key: str, cout: int, cin: int, bias: bool = True):
    m.t(f'{key}.weight', cout, cin)
    if bias:
        m.t(f'{key}.bias', cout)


def rpe_biases(sp_h: int, sp_w: int) -> np.ndarray:
    """The ((2 sp_h - 1)(2 sp_w - 1), 2) float grid of relative offsets a
    DAT / RGT window branch holds as ``rpe_biases``: its last row is
    (sp_h - 1, sp_w - 1)."""
    grid = np.stack(np.meshgrid(np.arange(1 - sp_h, sp_h), np.arange(1 - sp_w, sp_w), indexing='ij'))
    return grid.reshape(2, -1).T.astype(np.float32)


def _window_branches(m: _Maker, a: str, c: int, heads: int, split, pos_dim: int):
    """The two Spatial_Attention branches of a DAT / RGT attention ``a``:
    (sp0, sp1) windows on the first half of the channels, (sp1, sp0) on the
    second, heads // 2 each, with the position-bias MLP (``pos_dim`` wide)."""
    from .nn.window import relative_position_index

    for i, (sh, sw) in enumerate((split, split[::-1])):
        b = f'{a}.attns.{i}'
        m.sd[f'{b}.rpe_biases'] = rpe_biases(sh, sw)
        m.sd[f'{b}.relative_position_index'] = relative_position_index(sh, sw)
        _linear(m, f'{b}.pos.pos_proj', pos_dim, 2)
        for name, out in (('pos1', pos_dim), ('pos2', pos_dim), ('pos3', heads // 2)):
            _ln(m, f'{b}.pos.{name}.0', pos_dim)
            _linear(m, f'{b}.pos.{name}.2', out, pos_dim)


def _window_masks(m: _Maker, a: str, img_size: int, split):
    """A shifted DAT / RGT block's ``attn_mask_0`` / ``attn_mask_1`` buffers
    at its training resolution (when ``img_size`` tiles into both window
    shapes)."""
    from .nn.window import rect_attn_mask

    sp0, sp1 = split
    if img_size % max(sp0, sp1) == 0:
        m.sd[f'{a}.attn_mask_0'] = rect_attn_mask(img_size, img_size, sp0, sp1, sp0 // 2, sp1 // 2)
        m.sd[f'{a}.attn_mask_1'] = rect_attn_mask(img_size, img_size, sp1, sp0, sp1 // 2, sp0 // 2)


def _sgfn(m: _Maker, f: str, c: int, hidden: int):
    _linear(m, f'{f}.fc1', hidden, c)
    _ln(m, f'{f}.sg.norm', hidden // 2)
    m.conv(f'{f}.sg.conv', hidden // 2, 1, 3)
    _linear(m, f'{f}.fc2', c, hidden // 2)


def _resi(m: _Maker, key: str, c: int, resi_connection: str):
    if resi_connection == '1conv':
        m.conv(key, c, c, 3)
    else:
        m.conv(f'{key}.0', c // 4, c, 3)
        m.conv(f'{key}.2', c // 4, c // 4, 1)
        m.conv(f'{key}.4', c, c // 4, 3)


def _pixelshuffle_tail(m: _Maker, c: int, upscale: int, in_nc: int, nf: int = 64):
    m.conv('conv_before_upsample.0', nf, c, 3)
    if upscale & (upscale - 1) == 0:
        for i in range(int(math.log2(upscale))):
            m.conv(f'upsample.{2 * i}', 4 * nf, nf, 3)
    elif upscale == 3:
        m.conv('upsample.0', 9 * nf, nf, 3)
    m.conv('conv_last', in_nc, nf, 3)


def _pos_dim(embed_dim: int) -> int:
    """The position-bias MLP's width: the reference's (embed // 2 // 4) // 4
    (5 at embed 180), at least 4.  No loader reads it."""
    return max(embed_dim // 2 // 4 // 4, 4)


def make_dat(embed_dim: int = 180, depth=(6,) * 6, num_heads=(6,) * 6, split_size=(8, 16),
             expansion_factor: float = 2.0, upscale: int = 4, upsampler: str = 'pixelshuffle',
             resi_connection: str = '1conv', qkv_bias: bool = True, in_nc: int = 3, img_size: int = 64,
             seed: int = 0):
    """DAT layout (defaults: DAT-S 4x).  Even blocks hold the adaptive
    spatial attention (qkv, proj, the depthwise conv branch with its
    BatchNorm, the AIM channel (C -> C/8 -> C) and spatial (C -> C/16 -> 1)
    interactions, two window branches), odd blocks the adaptive channel
    attention (the same convs and a per-head ``temperature``); every block
    an SGFN.  Shifted spatial blocks carry the ``attn_mask_0`` /
    ``attn_mask_1`` buffers of an ``img_size`` image, as a trained
    checkpoint does.  The position-bias MLP is ``_pos_dim(embed)`` wide.
    'pixelshuffle' (64 features) or 'pixelshuffledirect' tails; '1conv' or
    '3conv' residuals."""
    from .archs.dat import _shifted

    m = _Maker(seed)
    c = embed_dim
    hidden = int(c * expansion_factor)
    m.conv('conv_first', c, in_nc, 3)
    _ln(m, 'before_RG.1', c)
    for gi, (d, heads) in enumerate(zip(depth, num_heads)):
        for bi in range(d):
            b = f'layers.{gi}.blocks.{bi}'
            a = f'{b}.attn'
            _ln(m, f'{b}.norm1', c)
            _ln(m, f'{b}.norm2', c)
            _linear(m, f'{a}.qkv', 3 * c, c, qkv_bias)
            _linear(m, f'{a}.proj', c, c)
            m.conv(f'{a}.dwconv.0', c, 1, 3)
            _bn(m, f'{a}.dwconv.1', c)
            m.conv(f'{a}.channel_interaction.1', c // 8, c, 1)
            _bn(m, f'{a}.channel_interaction.2', c // 8)
            m.conv(f'{a}.channel_interaction.4', c, c // 8, 1)
            m.conv(f'{a}.spatial_interaction.0', c // 16, c, 1)
            _bn(m, f'{a}.spatial_interaction.1', c // 16)
            m.conv(f'{a}.spatial_interaction.3', 1, c // 16, 1)
            if bi % 2 == 0:
                _window_branches(m, a, c, heads, split_size, _pos_dim(c))
                if _shifted(gi, bi):
                    _window_masks(m, a, img_size, split_size)
            else:
                m.sd[f'{a}.temperature'] = (1 + 0.1 * m.rng.standard_normal((heads, 1, 1))).astype(np.float32)
            _sgfn(m, f'{b}.ffn', c, hidden)
        _resi(m, f'layers.{gi}.conv', c, resi_connection)
    _ln(m, 'norm', c)
    _resi(m, 'conv_after_body', c, resi_connection)
    if upsampler == 'pixelshuffle':
        _pixelshuffle_tail(m, c, upscale, in_nc)
    else:
        m.conv('upsample.0', in_nc * upscale**2, c, 3)
    return m.sd


def make_rgt(embed_dim: int = 180, depth=(6,) * 6, num_heads=(6,) * 6, split_size=(8, 32), mlp_ratio: float = 2.0,
             c_ratio: float = 0.5, upscale: int = 4, resi_connection: str = '1conv', qkv_bias: bool = True,
             in_nc: int = 3, img_size: int = 64, seed: int = 0):
    """RGT layout (defaults: RGT-S 4x).  Even blocks hold L_SA (qkv, proj,
    the depthwise ``get_v``, two window branches as DAT's), odd blocks RG_SA
    (the stride-4 depthwise ``reduction1``, ``dwconv``, the C -> C x c_ratio
    ``conv`` with its layer norm, q / k / v, the depthwise ``cpe``, proj);
    every block a layer-scale ``gamma`` and DAT's SGFN as ``mlp``.  Shifted
    L_SA blocks carry the ``attn_mask_0`` / ``attn_mask_1`` buffers of an
    ``img_size`` image.  The position-bias MLP is ``_pos_dim(embed)`` wide;
    a pixelshuffle tail of 64 features."""
    from .archs.dat import _shifted

    m = _Maker(seed)
    c = embed_dim
    cr = int(c * c_ratio)
    m.conv('conv_first', c, in_nc, 3)
    _ln(m, 'before_RG.1', c)
    for gi, (d, heads) in enumerate(zip(depth, num_heads)):
        for bi in range(d):
            b = f'layers.{gi}.blocks.{bi}'
            a = f'{b}.attn'
            _ln(m, f'{b}.norm1', c)
            _ln(m, f'{b}.norm2', c)
            m.t(f'{b}.gamma', c)
            if bi % 2 == 0:
                _linear(m, f'{a}.qkv', 3 * c, c, qkv_bias)
                m.conv(f'{a}.get_v', c, 1, 3)
                _window_branches(m, a, c, heads, split_size, _pos_dim(c))
                if _shifted(gi, bi):
                    _window_masks(m, a, img_size, split_size)
            else:
                m.conv(f'{a}.reduction1', c, 1, 4)
                m.conv(f'{a}.dwconv', c, 1, 3)
                m.conv(f'{a}.conv', cr, c, 1)
                _ln(m, f'{a}.norm_act.0', cr)
                _linear(m, f'{a}.q', cr, c, qkv_bias)
                _linear(m, f'{a}.k', cr, cr, qkv_bias)
                _linear(m, f'{a}.v', c, cr, qkv_bias)
                m.conv(f'{a}.cpe', c, 1, 3)
            _linear(m, f'{a}.proj', c, c)
            _sgfn(m, f'{b}.mlp', c, int(c * mlp_ratio))
        _resi(m, f'layers.{gi}.conv', c, resi_connection)
    _ln(m, 'norm', c)
    _resi(m, 'conv_after_body', c, resi_connection)
    _pixelshuffle_tail(m, c, upscale, in_nc)
    return m.sd


def make_drct(embed_dim: int = 180, num_layers: int = 6, num_heads: int = 6, window_size: int = 16, gc: int = 32,
              mlp_ratio: float = 2.0, upscale: int = 4, in_nc: int = 3, img_size: int = 64,
              attn_masks: bool = True, seed: int = 0):
    """DRCT layout (defaults: DRCT 4x, six residual dense groups).  Per
    group five Swin blocks ``swin1..5`` on embed + (k - 1) x gc channels
    with ``num_heads`` heads for the first and ``num_heads - width %
    num_heads`` for the others, the 1x1 ``adjust1..5`` convs (to gc, the
    last to embed); the patch-embedding layer norm, a 1conv body residual
    and a pixelshuffle tail of 64 features.  With ``attn_masks`` the
    shifted blocks (swin2, swin4) carry the ``attn_mask`` buffers of an
    ``img_size`` image, as a trained checkpoint does: the loader reads its
    ``img_size`` from them, and without them every shift is off."""
    from .nn.window import relative_position_index, swin_attn_mask

    m = _Maker(seed)
    d, ws = embed_dim, window_size
    rpi = relative_position_index(ws, ws)
    mask = None
    if attn_masks and img_size > ws and img_size % ws == 0:
        mask = swin_attn_mask(img_size, img_size, ws, ws // 2)
    m.conv('conv_first', d, in_nc, 3)
    _ln(m, 'patch_embed.norm', d)
    for li in range(num_layers):
        for k in range(1, 6):
            width = d + (k - 1) * gc
            heads = num_heads if k == 1 else num_heads - width % num_heads
            b = f'layers.{li}.swin{k}'
            _ln(m, f'{b}.norm1', width)
            _ln(m, f'{b}.norm2', width)
            m.t(f'{b}.attn.relative_position_bias_table', (2 * ws - 1) ** 2, heads)
            m.sd[f'{b}.attn.relative_position_index'] = rpi
            _linear(m, f'{b}.attn.qkv', 3 * width, width)
            _linear(m, f'{b}.attn.proj', width, width)
            _linear(m, f'{b}.mlp.fc1', int(width * mlp_ratio), width)
            _linear(m, f'{b}.mlp.fc2', width, int(width * mlp_ratio))
            if k in (2, 4) and mask is not None:
                m.sd[f'{b}.attn_mask'] = mask
            m.conv(f'layers.{li}.adjust{k}', gc if k < 5 else d, width, 1)
    _ln(m, 'norm', d)
    m.conv('conv_after_body', d, d, 3)
    _pixelshuffle_tail(m, d, upscale, in_nc)
    return m.sd


def _dysample(m: _Maker, key: str, c: int, out: int, scale: int, groups: int = 4, end_kernel: int = 1):
    """A DySample module on ``c`` channels: the 1x1 offset and scope convs,
    the reference's initial sample positions and an ``end_kernel`` end conv
    to ``out``."""
    s, g = scale, groups
    m.conv(f'{key}.offset', 2 * g * s * s, c, 1)
    m.t(f'{key}.scope.weight', 2 * g * s * s, c, 1, 1)
    h = (np.arange(s, dtype=np.float32) - (s - 1) / 2) / s
    pos = np.stack(np.meshgrid(h, h, indexing='ij')).transpose(0, 2, 1)  # (2, s, s): [x, y] offsets
    m.sd[f'{key}.init_pos'] = np.tile(pos, (1, g, 1)).reshape(1, -1, 1, 1).astype(np.float32)
    m.conv(f'{key}.end_conv', out, c, end_kernel)


def _lda_aqu(m: _Maker, key: str, c: int, reduction: int = 4, n_groups: int = 2, heads: int = 1, k_u: int = 3,
             k_e: int = 3):
    """An LDA_AQU module on ``c`` channels with the reference's defaults:
    hidden c / 4 in two offset groups, one head, 3 x 3 sample points, a 3x3
    offset conv, the relative-position table."""
    hidden = c // reduction
    gc = hidden // n_groups
    _ln(m, f'{key}.layer_norm', c)
    m.t(f'{key}.proj_q.weight', hidden, c, 1, 1)
    m.t(f'{key}.proj_k.weight', hidden, c, 1, 1)
    m.t(f'{key}.conv_offset.0.weight', gc, 1, 3, 3)
    _ln(m, f'{key}.conv_offset.1', gc)
    m.conv(f'{key}.conv_offset.3', 2 * k_u * k_u, gc, k_e)
    m.t(f'{key}.relative_position_bias_table', 1, heads, 1, k_u * k_u, hidden // heads)


def _uni_upsample_v3(m: _Maker, key: str, mode: str, scale: int, c: int, out: int, mid: int,
                     end_kernel: int = 1):
    """UniUpsampleV3's layers under ``key`` for ``mode`` at ``scale``, from
    ``c`` channels to ``out`` through ``mid`` (also UniUpsample's: its five
    modes are the first five here); a single 3x3 conv at scale 1 whatever
    the mode; ``end_kernel``: DySample's end conv.  ``transpose+conv`` goes c -> mid -> out: 4x4 stride-2
    transposed convs at 2x (one) and 4x (two, a gelu between), a 3x3
    stride-3 one at 3x, then a 3x3 conv (no loader reads the widths)."""
    pow2 = scale & (scale - 1) == 0
    if scale == 1 or mode == 'conv':
        m.conv(f'{key}.0', out, c, 3)
    elif mode == 'pixelshuffledirect':
        m.conv(f'{key}.0', out * scale * scale, c, 3)
    elif mode == 'pixelshuffle':
        m.conv(f'{key}.0', mid, c, 3)
        steps = [(2, 4)] * int(math.log2(scale)) if pow2 else [(2, 9)]
        for i, (_, r2) in enumerate(steps):
            m.conv(f'{key}.{2 + 2 * i}', r2 * mid, mid, 3)
        m.conv(f'{key}.{2 + 2 * len(steps)}', out, mid, 3)
    elif mode == 'nearest+conv':
        if pow2:
            n = int(math.log2(scale))
            for i in range(n):
                m.conv(f'{key}.{3 * i}', mid, c if i == 0 else mid, 3)
            m.conv(f'{key}.{3 * n}', mid, mid, 3)
            m.conv(f'{key}.{3 * n + 2}', out, mid, 3)
        else:
            m.conv(f'{key}.0', mid, c, 3)
            m.conv(f'{key}.3', mid, mid, 3)
            m.conv(f'{key}.5', out, mid, 3)
    elif mode in ('dysample', 'lda'):
        inner = c
        if mid != c:
            m.conv(f'{key}.0', mid, c, 3)
            inner = mid
        at = f'{key}.2' if mid != c else f'{key}.0'
        if mode == 'dysample':
            _dysample(m, at, inner, out, scale, end_kernel=end_kernel)
        else:
            _lda_aqu(m, at, inner)
            m.conv(f'{key}.3' if mid != c else f'{key}.1', out, inner, 3)
    elif mode == 'transpose+conv':
        k = 3 if scale == 3 else 4
        m.t(f'{key}.0.weight', c, mid, k, k)
        m.t(f'{key}.0.bias', mid)
        if scale == 4:
            m.t(f'{key}.2.weight', mid, mid, 4, 4)
            m.t(f'{key}.2.bias', mid)
        m.conv(f'{key}.3' if scale == 4 else f'{key}.1', out, mid, 3)
    elif mode == 'pa_up':
        idx = 0
        for i in range(int(math.log2(scale)) if pow2 else 1):
            m.conv(f'{key}.{idx + 1}', mid, c if i == 0 else mid, 3)
            m.conv(f'{key}.{idx + 2}.conv.0', mid, mid, 1)
            m.conv(f'{key}.{idx + 4}', mid, mid, 3)
            idx += 6
        m.conv(f'{key}.{idx}', out, mid, 3)
    else:
        raise ValueError(f'unknown UniUpsampleV3 mode {mode!r}')


def make_fdat(embed_dim: int = 120, num_groups: int = 4, depth_per_group: int = 3, num_heads: int = 4,
              window_size: int = 8, ffn_expansion_ratio: float = 2.0, aim_reduction_ratio: int = 8,
              mid_dim: int = 64, upsampler: str = 'transpose+conv', scale: int = 4, unshuffle: bool = False,
              qkv_bias: bool = False, in_nc: int = 3, out_nc: int = 3, seed: int = 0):
    """FDAT layout (defaults: the reference class's, FDAT-M 4x).  Each group
    holds ``2 * depth_per_group`` blocks, spatial and channel in turn: layer
    norms ``n1`` / ``n2``, the attention's qkv and proj (spatial: a learned
    (heads, ws², ws²) ``bias``; channel: a per-head ``temp``), the depthwise
    ``conv.0``, SimplifiedAIM's spatial gate ``inter.sg.0`` (C -> 1) and
    channel gate ``inter.cg.1`` / ``.3`` (C -> C / r -> C), the FFN
    (``fc1``, the depthwise ``smix``, ``fc2``, no biases); a 3x3 conv
    closing each group, ``conv_after``, and the UniUpsampleV3 tail with its
    ``MetaUpsample`` buffer (uint8: version 3, the mode's index in
    ``SAMPLE_MODS3``, the upsampler's scale, embed, out channels, mid dim,
    groups 4).  With ``unshuffle`` at scale 1 or 2 the stem is
    ``conv_first.1`` on the pixel-unshuffled input and the tail runs at
    4x."""
    from .nn.upsample import SAMPLE_MODS3

    m = _Maker(seed)
    c = embed_dim
    hidden = int(c * ffn_expansion_ratio)
    n = window_size * window_size
    unshuffle = unshuffle and scale < 3
    if unshuffle:
        m.conv('conv_first.1', c, in_nc * (4 // scale) ** 2, 3)
    else:
        m.conv('conv_first', c, in_nc, 3)
    for gi in range(num_groups):
        for bi in range(2 * depth_per_group):
            b = f'groups.{gi}.blocks.{bi}'
            _ln(m, f'{b}.n1', c)
            _ln(m, f'{b}.n2', c)
            _linear(m, f'{b}.attn.qkv', 3 * c, c, qkv_bias)
            _linear(m, f'{b}.attn.proj', c, c)
            if bi % 2 == 0:
                m.t(f'{b}.attn.bias', num_heads, n, n)
            else:
                m.sd[f'{b}.attn.temp'] = (1 + 0.1 * m.rng.standard_normal((num_heads, 1, 1))).astype(np.float32)
            m.t(f'{b}.conv.0.weight', c, 1, 3, 3)
            m.t(f'{b}.inter.sg.0.weight', 1, c, 1, 1)
            m.t(f'{b}.inter.cg.1.weight', c // aim_reduction_ratio, c, 1, 1)
            m.t(f'{b}.inter.cg.3.weight', c, c // aim_reduction_ratio, 1, 1)
            m.t(f'{b}.ffn.fc1.weight', hidden, c)
            m.t(f'{b}.ffn.smix.weight', hidden, 1, 3, 3)
            m.t(f'{b}.ffn.fc2.weight', c, hidden)
        m.conv(f'groups.{gi}.conv', c, c, 3)
    m.conv('conv_after', c, c, 3)
    up_scale = 4 if unshuffle else scale
    _uni_upsample_v3(m, 'upsampler', upsampler, up_scale, c, out_nc, mid_dim)
    m.sd['upsampler.MetaUpsample'] = np.array([3, SAMPLE_MODS3.index(upsampler), up_scale, c, out_nc, mid_dim, 4],
                                              dtype=np.uint8)
    return m.sd


def make_omni(num_feat: int = 64, block_num: int = 1, pe: bool = True, window_size: int = 8, res_num: int = 5,
              up_scale: int = 4, bias: bool = True, in_nc: int = 3, seed: int = 0):
    """OmniSR layout (defaults: the published OmniSR 4x).  Per residual
    group ``block_num`` OSA blocks (layer.0 MBConv with expansion 1 and its
    squeeze-excitation gate to num_feat / 4; layer.2 / layer.8 the block /
    grid attention under a pre-norm: ``to_qkv``, ``to_out.0`` and with
    ``pe`` the ((2 ws - 1)², heads) ``rel_pos_bias`` table, 4 heads; layer.4,
    6, 10, 12 the gated conv FFNs and layer.5, 11 the channel attentions,
    each under a LayerNorm2d, no biases), a 1x1 conv and the ESA gate (16
    channels); the 3x3 ``input`` / ``output`` convs and the pixel-shuffle
    ``up.0``.  ``bias`` gives the group, ESA and outer convs their biases."""
    m = _Maker(seed)
    f = num_feat
    heads = f // (f // 4)

    def conv(key, cout, cin, k):
        m.t(f'{key}.weight', cout, cin, k, k)
        if bias:
            m.t(f'{key}.bias', cout)

    conv('input', f, in_nc, 3)
    for ri in range(res_num):
        g = f'residual_layer.{ri}'
        for bi in range(block_num):
            o = f'{g}.residual_layer.{bi}.layer'
            m.conv(f'{o}.0.fn.0', f, f, 1)
            m.conv(f'{o}.0.fn.2', f, 1, 3)
            m.t(f'{o}.0.fn.4.gate.1.weight', f // 4, f)
            m.t(f'{o}.0.fn.4.gate.3.weight', f, f // 4)
            m.conv(f'{o}.0.fn.5', f, f, 1)
            for a in ('2', '8'):
                _ln(m, f'{o}.{a}.norm', f)
                m.t(f'{o}.{a}.fn.to_qkv.weight', 3 * f, f)
                m.t(f'{o}.{a}.fn.to_out.0.weight', f, f)
                if pe:
                    m.t(f'{o}.{a}.fn.rel_pos_bias.weight', (2 * window_size - 1) ** 2, heads)
            for a in ('4', '6', '10', '12'):
                _ln(m, f'{o}.{a}.norm', f)
                m.t(f'{o}.{a}.fn.project_in.weight', 2 * f, f, 1, 1)
                m.t(f'{o}.{a}.fn.dwconv.weight', 2 * f, 1, 3, 3)
                m.t(f'{o}.{a}.fn.project_out.weight', f, f, 1, 1)
            for a in ('5', '11'):
                _ln(m, f'{o}.{a}.norm', f)
                m.sd[f'{o}.{a}.fn.temperature'] = (1 + 0.1 * m.rng.standard_normal((4, 1, 1))).astype(np.float32)
                m.t(f'{o}.{a}.fn.qkv.weight', 3 * f, f, 1, 1)
                m.t(f'{o}.{a}.fn.qkv_dwconv.weight', 3 * f, 1, 3, 3)
                m.t(f'{o}.{a}.fn.project_out.weight', f, f, 1, 1)
        conv(f'{g}.residual_layer.{block_num}', f, f, 1)
        for key, cout, cin, k in (('conv1', 16, f, 1), ('conv_f', 16, 16, 1), ('conv2', 16, 16, 3),
                                  ('conv3', 16, 16, 3), ('conv4', f, 16, 1)):
            conv(f'{g}.esa.{key}', cout, cin, k)
    conv('output', f, f, 3)
    conv('up.0', in_nc * up_scale * up_scale, f, 3)
    return m.sd


# -- the 3x3-conv families ------------------------------------------------------


def _conv3xc(m: _Maker, key: str, cin: int, cout: int, gain: int = 2):
    """Conv3XC bundle keys (reference span/arch.py:59-121)."""
    m.conv(f'{key}.sk', cout, cin, 1)
    m.conv(f'{key}.conv.0', cin * gain, cin, 1)
    m.conv(f'{key}.conv.1', cout * gain, cin * gain, 3)
    m.conv(f'{key}.conv.2', cout, cout * gain, 1)
    m.conv(f'{key}.eval_conv', cout, cin, 3)


def make_compact(num_feat: int = 64, num_conv: int = 16, upscale: int = 4, in_nc: int = 3, seed: int = 0):
    """SRVGGNetCompact layout (reference compact/arch.py:37-56)."""
    m = _Maker(seed)
    m.conv('body.0', num_feat, in_nc, 3)
    m.t('body.1.weight', num_feat)
    for i in range(num_conv):
        m.conv(f'body.{2 * i + 2}', num_feat, num_feat, 3)
        m.t(f'body.{2 * i + 3}.weight', num_feat)
    m.conv(f'body.{2 * num_conv + 2}', in_nc * upscale * upscale, num_feat, 3)
    return m.sd


def make_spanplus(feature_channels: int = 48, blocks=(4,), upscale: int = 2, in_nc: int = 3, seed: int = 0,
                  upsampler: str = 'ps'):
    """SpanPlus layout (reference spanplus/arch.py:154-201); 'ps' gives the
    JAX package's arrays, 'dys' a DySample tail (4 groups) to ``in_nc``,
    'conv' a 3x3 conv to ``in_nc`` at 1x."""
    m = _Maker(seed)
    f = feature_channels
    _conv3xc(m, 'feats.0', in_nc, f)
    for bi, n_blocks in enumerate(blocks):
        g = f'feats.{bi + 1}'
        for blk in ['block_1'] + [f'block_n.{i}' for i in range(n_blocks)] + ['block_end']:
            for c in ('c1_r', 'c2_r', 'c3_r'):
                _conv3xc(m, f'{g}.{blk}.{c}', f, f)
        _conv3xc(m, f'{g}.conv_2', f, f)
        m.conv(f'{g}.conv_cat', f, f * 4, 1)
    if upsampler == 'ps':
        m.conv('upsampler.0', in_nc * upscale**2, f, 3)
    elif upsampler == 'dys':
        _dysample(m, 'upsampler', f, in_nc, upscale)
    elif upsampler == 'conv':
        m.conv('upsampler', in_nc, f, 3)
    else:
        raise ValueError(f'unknown SpanPlus upsampler {upsampler!r}')
    return m.sd


def make_span(feature_channels: int = 48, upscale: int = 4, in_nc: int = 3, seed: int = 0, norm: bool = True):
    """SPAN layout (reference span/arch.py:183-234): Conv3XC stem, six SPABs,
    conv_cat/conv_2, pixelshuffle tail; the JAX package's arrays, and
    without ``norm`` the reference's ``no_norm`` buffer."""
    m = _Maker(seed)
    f = feature_channels
    _conv3xc(m, 'conv_1', in_nc, f)
    for b in range(1, 7):
        for c in ('c1_r', 'c2_r', 'c3_r'):
            _conv3xc(m, f'block_{b}.{c}', f, f)
    m.conv('conv_cat', f, 4 * f, 1)
    _conv3xc(m, 'conv_2', f, f)
    m.conv('upsampler.0', in_nc * upscale * upscale, f, 3)
    if not norm:
        m.sd['no_norm'] = np.zeros((1,), np.float32)
    return m.sd


def make_mosr(
    dim: int = 48,
    n_block: int = 4,
    upscale: int = 2,
    in_nc: int = 3,
    expansion_ratio: float = 1.5,
    conv_ratio: float = 1.0,
    kernel_size: int = 7,
    seed: int = 0,
    upsampler: str = 'ps',
):
    """MoSR layout (reference mosr/arch.py:108-156): gblocks Sequential =
    stem conv + GatedCNNBlocks + 5-entry conv tail, ConvBlock shortcut;
    'ps' gives the JAX package's arrays, 'dys' a DySample tail (4 groups)
    to ``in_nc``, 'gps' the geo-ensemble 3x3 ``in_to_k`` conv."""
    m = _Maker(seed)
    hidden = int(expansion_ratio * dim)
    cc = int(conv_ratio * dim)
    m.conv('gblocks.0', dim, in_nc, 3)
    for i in range(1, n_block + 1):
        m.t(f'gblocks.{i}.norm.weight', dim)
        m.t(f'gblocks.{i}.norm.bias', dim)
        m.conv(f'gblocks.{i}.fc1', hidden * 2, dim, 3)
        m.conv(f'gblocks.{i}.conv', cc, 1, kernel_size)  # depthwise
        m.conv(f'gblocks.{i}.fc2', dim, hidden, 3)
    m.conv(f'gblocks.{n_block + 1}', dim * 2, dim, 3)
    m.conv(f'gblocks.{n_block + 3}', dim, dim * 2, 3)
    m.conv(f'gblocks.{n_block + 5}', dim, dim, 1)
    m.conv('shortcut.block.0', dim, in_nc, 3)
    m.conv('shortcut.block.2', dim, dim, 3)
    m.conv('shortcut.conv11', dim, in_nc, 1)
    if upsampler == 'ps':
        m.conv('upsampler.0', in_nc * upscale * upscale, dim, 3)
    elif upsampler == 'dys':
        _dysample(m, 'upsampler', dim, in_nc, upscale)
    elif upsampler == 'gps':
        m.conv('upsampler.in_to_k', 8 * in_nc * upscale * upscale, dim, 3)
    else:
        raise ValueError(f'unknown MoSR upsampler {upsampler!r}')
    return m.sd


def _repconv(m: _Maker, key: str, cin: int, cout: int, mid_mult: int = 2):
    """A RepConv bundle (reference rtmosr/arch.py:167-207), the keys
    ``nn.reparam.repconv_collapse`` and SpanPP's detection read: ``alpha``
    (three branch weights near 1), ``conv1`` a SeqConv3x3 (1x1 ``k0`` /
    ``b0`` to ``mid_mult * cout``, 3x3 ``k1`` / ``b1``), ``conv2`` a 3x3,
    ``conv3`` a Conv3XC, and the collapsed ``conv_3x3_rep``."""
    m.t(f'{key}.alpha', 3)
    m.sd[f'{key}.alpha'] += 1.0
    mid = mid_mult * cout
    m.t(f'{key}.conv1.k0', mid, cin, 1, 1)
    m.t(f'{key}.conv1.b0', mid)
    m.t(f'{key}.conv1.k1', cout, mid, 3, 3)
    m.t(f'{key}.conv1.b1', cout)
    m.conv(f'{key}.conv2', cout, cin, 3)
    _conv3xc(m, f'{key}.conv3', cin, cout)
    m.conv(f'{key}.conv_3x3_rep', cout, cin, 3)


def make_spanpp(feature_channels: int = 48, scale_list=(1, 2, 3, 4), ig_kernel: int = 3, implicit_dim: int = 256,
                latent_layers: int = 4, in_nc: int = 3, seed: int = 0):
    """SpanPP layout (reference spanpp/arch.py), written from what
    ``resselt_tpu/archs/spanpp.py::_load`` and its detection keys read:
    RepConv stem ``conv0``, six SPABs of RepConvs, ``conv_2``, the 1x1
    ``conv_cat``, and the IGConv upsampler: ``freq`` and ``amplitude``
    ((feature_channels * ig_kernel², implicit_dim, 1, 1), unit scale),
    ``phase`` (a 1x1 conv from 1 to implicit_dim / 2 channels) and the
    ``query_kernel`` 1x1 stack (``latent_layers`` of implicit_dim wide,
    He-scaled, then one to 3).  A ``scale_list`` other than (1, 2, 3, 4)
    is written as the ``MetaIGConv`` buffer.  The widths are this builder's
    choice: the reference's ``SpanPP()`` defaults are not in this repo."""
    m = _Maker(seed)
    f, d = feature_channels, implicit_dim
    _repconv(m, 'conv0', in_nc, f)
    for b in range(1, 7):
        for c in ('c1_r', 'c2_r', 'c3_r'):
            _repconv(m, f'block_{b}.{c}', f, f)
    _repconv(m, 'conv_2', f, f)
    m.conv('conv_cat', f, 4 * f, 1)
    n = f * ig_kernel * ig_kernel
    m.sd['upsampler.freq'] = m.rng.standard_normal((n, d, 1, 1)).astype(np.float32)
    m.sd['upsampler.amplitude'] = m.rng.standard_normal((n, d, 1, 1)).astype(np.float32)
    m.conv('upsampler.phase', d // 2, 1, 1)
    for i in range(latent_layers + 1):
        cout = 3 if i == latent_layers else d
        m.sd[f'upsampler.query_kernel.{2 * i}.weight'] = (
            m.rng.standard_normal((cout, d, 1, 1)) * math.sqrt(2.0 / d)).astype(np.float32)
        m.t(f'upsampler.query_kernel.{2 * i}.bias', cout)
    if tuple(scale_list) != (1, 2, 3, 4):
        m.sd['MetaIGConv'] = np.asarray(scale_list, np.int64)
    return m.sd


_RCAN_RGB_MEAN = (0.4488, 0.4371, 0.4040)


def make_rcan(n_feats: int = 64, n_resgroups: int = 10, n_resblocks: int = 20, reduction: int = 16, scale: int = 4,
              norm: bool = True, unshuffle: bool = False, kernel_size: int = 3, n_colors: int = 3, seed: int = 0):
    """RCAN layout (defaults: the published RCAN, 10 groups of 20 RCABs, 64
    features, reduction 16), written from what
    ``resselt_tpu/archs/rcan.py::_load`` and its detection keys read: with
    ``norm`` the MeanShifts (identity 1x1 weights, biases -/+ 255 x the
    DIV2K mean); the head ``head.0``, or with ``unshuffle`` (scale 1 or 2)
    ``head.1`` after a pixel unshuffle to the 4x tail; per RCAB two k x k
    convs and the channel attention's 1x1 ``conv_du`` pair; each group's
    and the body's closing conv; the 3x3 pixel-shuffle ``tail.0`` and the
    k x k ``tail.1``."""
    m = _Maker(seed)
    f, k = n_feats, kernel_size
    if norm:
        for key, sign in (('sub_mean', -1), ('add_mean', 1)):
            m.sd[f'{key}.weight'] = np.eye(n_colors, dtype=np.float32).reshape(n_colors, n_colors, 1, 1)
            m.sd[f'{key}.bias'] = (sign * 255 * np.asarray(_RCAN_RGB_MEAN[:n_colors])).astype(np.float32)
    if unshuffle:
        if scale not in (1, 2):
            raise ValueError(f'the unshuffle head serves scale 1 or 2, got {scale}')
        m.conv('head.1', f, n_colors * (4 // scale) ** 2, k)
    else:
        m.conv('head.0', f, n_colors, k)
    for g in range(n_resgroups):
        for b in range(n_resblocks):
            r = f'body.{g}.body.{b}.body'
            m.conv(f'{r}.0', f, f, k)
            m.conv(f'{r}.2', f, f, k)
            m.conv(f'{r}.3.conv_du.0', f // reduction, f, 1)
            m.conv(f'{r}.3.conv_du.2', f, f // reduction, 1)
        m.conv(f'body.{g}.body.{n_resblocks}', f, f, k)
    m.conv(f'body.{n_resgroups}', f, f, k)
    tail_scale = 4 if unshuffle else scale
    if tail_scale & (tail_scale - 1) == 0:
        for i in range(int(math.log2(tail_scale))):
            m.conv(f'tail.0.{2 * i}', 4 * f, f, 3)
    elif tail_scale == 3:
        m.conv('tail.0.0', 9 * f, f, 3)
    else:
        raise ValueError(f'RCAN scale {scale} has no pixel-shuffle tail')
    m.conv('tail.1', n_colors, f, k)
    return m.sd


# -- the restoration U-nets, CUGAN and the MoSR lineage --------------------------------


def make_cugan(variant: str = '2x', pro: bool = False, in_nc: int = 3, seed: int = 0):
    """Real-CUGAN UpCunet (reference cugan/arch.py:51-441) at its fixed
    widths: ``variant`` '2x', '3x', '4x' or '2x_fast'; ``pro`` adds the
    marker buffer of the pro checkpoints.  UNet1's bottom is a transposed
    4x4 stride-2 conv (5x5 stride 3 at 3x); 4x and 2x_fast run both UNets at
    64 channels and end in ``conv_final`` (64 -> 12) and a pixel shuffle;
    2x_fast takes the 2x unshuffled input (12 channels)."""
    m = _Maker(seed)

    def unet_conv(key, cin, mid, cout, se):
        m.conv(f'{key}.conv.0', mid, cin, 3)
        m.conv(f'{key}.conv.2', cout, mid, 3)
        if se:
            m.conv(f'{key}.seblock.conv1', cout // 8, cout, 1)
            m.conv(f'{key}.seblock.conv2', cout, cout // 8, 1)

    def deconv(key, cin, cout, k):
        m.t(f'{key}.weight', cin, cout, k, k)
        m.t(f'{key}.bias', cout)

    wide = variant in ('4x', '2x_fast')
    c_in = 4 * in_nc if variant == '2x_fast' else in_nc
    mid_out = 64 if wide else in_nc
    u = 'unet1'
    unet_conv(f'{u}.conv1', c_in, 32, 64, False)
    m.conv(f'{u}.conv1_down', 64, 64, 2)
    unet_conv(f'{u}.conv2', 64, 128, 64, True)
    deconv(f'{u}.conv2_up', 64, 64, 2)
    m.conv(f'{u}.conv3', 64, 64, 3)
    deconv(f'{u}.conv_bottom', 64, mid_out, 5 if variant == '3x' else 4)
    u = 'unet2'
    unet_conv(f'{u}.conv1', mid_out, 32, 64, False)
    m.conv(f'{u}.conv1_down', 64, 64, 2)
    unet_conv(f'{u}.conv2', 64, 64, 128, True)
    m.conv(f'{u}.conv2_down', 128, 128, 2)
    unet_conv(f'{u}.conv3', 128, 256, 128, True)
    deconv(f'{u}.conv3_up', 128, 128, 2)
    unet_conv(f'{u}.conv4', 128, 64, 64, True)
    deconv(f'{u}.conv4_up', 64, 64, 2)
    m.conv(f'{u}.conv5', 64, 64, 3)
    m.conv(f'{u}.conv_bottom', mid_out, 64, 3)
    if wide:
        m.conv('conv_final', 4 * in_nc, 64, 3)
    if pro:
        m.sd['pro'] = np.zeros(1, np.float32)
    return m.sd


def make_gater(dim: int = 16, num_blocks=(1, 1, 1, 1, 1, 1, 1), in_nc: int = 3, seed: int = 0,
               latent_att: bool = False):
    """GateR restoration U-net layout, 1x (reference gater/arch.py:162-200):
    enc0/enc1/enc2/latent/dec0/dec1/dec2 stages of GatedCNNBlocks with
    PixelUnshuffle/Shuffle stage transitions; without ``latent_att`` the
    JAX package's arrays.  ``latent_att`` gives the latent blocks FLPVT2
    (q, kv, proj linears, softplus ``scale``, a per-dim ``focusing_factor``
    near 3, a depthwise ``dwc`` over each head's v) in place of the 7x7
    conv; its 8 heads and 5x5 ``dwc`` are the zoo's choice (no loader reads
    them)."""
    m = _Maker(seed)
    d = dim

    def gated(prefix: str, width: int, n: int, att: bool = False):
        h = int(width * 8 / 3)
        for i in range(n):
            b = f'{prefix}.{i}'
            m.t(f'{b}.norm.weight', width)
            m.t(f'{b}.fc1.weight', 2 * h, width)
            m.t(f'{b}.fc1.bias', 2 * h)
            if att:
                a = f'{b}.conv'
                _linear(m, f'{a}.q', width, width)
                _linear(m, f'{a}.kv', 2 * width, width)
                m.t(f'{a}.scale', 1, 1, width)
                m.t(f'{a}.focusing_factor', 1, 1, width)
                m.sd[f'{a}.focusing_factor'] += 3.0
                m.conv(f'{a}.dwc', width // 8, 1, 5)
                _linear(m, f'{a}.proj', width, width)
            else:
                m.conv(f'{b}.conv.conv', width, 1, 7)
            m.t(f'{b}.fc2.weight', width, h)
            m.t(f'{b}.fc2.bias', width)

    m.conv('in_to_dim', d, in_nc, 3)
    gated('enc0.gated', d, num_blocks[0])
    m.conv('enc1.0.body.0', d // 2, d, 3)
    gated('enc1.1.gated', 2 * d, num_blocks[1])
    m.conv('enc2.0.body.0', d, 2 * d, 3)
    gated('enc2.1.gated', 4 * d, num_blocks[2])
    m.conv('latent.0.body.0', 2 * d, 4 * d, 3)
    gated('latent.1.gated', 8 * d, num_blocks[3], latent_att)
    m.conv('latent.2.body.0', 16 * d, 8 * d, 3)
    m.conv('dec0.0', 4 * d, 8 * d, 1)
    gated('dec0.1.gated', 4 * d, num_blocks[4])
    m.conv('dec0.2.body.0', 8 * d, 4 * d, 3)
    m.conv('dec1.0', 2 * d, 4 * d, 1)
    gated('dec1.1.gated', 2 * d, num_blocks[5])
    m.conv('dec1.2.body.0', 4 * d, 2 * d, 3)
    gated('dec2.0.gated', 2 * d, num_blocks[6])
    m.conv('dim_to_ch.0', d, 2 * d, 3)
    m.conv('dim_to_ch.1', in_nc, d, 3)
    return m.sd


_SAMPLE_MODS = ('conv', 'pixelshuffledirect', 'pixelshuffle', 'nearest+conv', 'dysample')
_SAMPLE_MODS3 = _SAMPLE_MODS + ('transpose+conv', 'lda', 'pa_up')


def _meta_upsample(m: _Maker, key: str, modes, mode: str, scale: int, dim: int, out: int, mid: int,
                   group: int = 4):
    """The MetaUpsample uint8 buffer (reference mosrv2/arch.py:157-171):
    version, mode index, scale, in width, out width, mid width, groups."""
    m.sd[key] = np.asarray([1, modes.index(mode), scale, dim, out, mid, group], np.uint8)


def _inception_dwconv(m: _Maker, key: str, c: int, square: int = 3, band: int = 11, branch_ratio: float = 0.125):
    """InceptionDWConv2d (reference mosrv2/arch.py:174-209): three depthwise
    convs on ``int(c * branch_ratio)`` channels each, square and bands."""
    gc = int(c * branch_ratio)
    m.t(f'{key}.dwconv_hw.weight', gc, 1, square, square)
    m.t(f'{key}.dwconv_hw.bias', gc)
    m.t(f'{key}.dwconv_w.weight', gc, 1, 1, band)
    m.t(f'{key}.dwconv_w.bias', gc)
    m.t(f'{key}.dwconv_h.weight', gc, 1, band, 1)
    m.t(f'{key}.dwconv_h.bias', gc)


def _gated_cnn_v2(m: _Maker, key: str, dim: int, expansion: float, k: int, rms: bool, mixer: str = 'conv'):
    """A MoSRv2 / MoESR GatedCNNBlock: RMSNorm ``scale`` / ``offset`` or
    LayerNorm, ``fc1`` (k x k) to 2 x hidden, the Inception mixer on
    ``dim`` channels under ``mixer``, ``fc2`` (k x k) back, the layer scale
    ``gamma`` near 0.1 (with scales near 1 the 54 blocks of MoESR's bench
    model drive its output to +-8, outside the image range that a 16-bit
    run's PSNR is taken against)."""
    hidden = int(expansion * dim)
    if rms:
        m.t(f'{key}.norm.scale', dim)
        m.sd[f'{key}.norm.scale'] += 1.0
        m.t(f'{key}.norm.offset', dim)
    else:
        _ln(m, f'{key}.norm', dim)
    m.conv(f'{key}.fc1', 2 * hidden, dim, k)
    _inception_dwconv(m, f'{key}.{mixer}', dim)
    m.conv(f'{key}.fc2', dim, hidden, k)
    m.t(f'{key}.gamma', 1, dim, 1, 1)
    m.sd[f'{key}.gamma'] += 0.1


def make_mosrv2(dim: int = 64, n_block: int = 24, scale: int = 4, in_nc: int = 3,
                upsampler: str = 'pixelshuffledirect', expansion_ratio: float = 1.5, mid_dim: int = 32,
                group: int = 4, unshuffle_mod: bool = False, rms_norm: bool = True, seed: int = 0):
    """MoSRv2 layout (reference mosrv2/arch.py:281-337): ``gblocks`` =
    stem conv (after a pixel unshuffle by 4 // scale with
    ``unshuffle_mod`` below 3x) + GatedCNNBlocks + the 5-entry conv tail,
    ``to_img`` a UniUpsample and its MetaUpsample buffer.  Its defaults
    (dim 64, 24 blocks, pixelshuffledirect, RMSNorm) are the zoo's choice:
    ``MoSRv2()``'s are not in this repo."""
    m = _Maker(seed)
    unshuffle = unshuffle_mod and scale < 3
    if unshuffle:
        m.conv('gblocks.1', dim, in_nc * (4 // scale) ** 2, 3)
    else:
        m.conv('gblocks.0', dim, in_nc, 3)
    first = 2 if unshuffle else 1
    for i in range(n_block):
        _gated_cnn_v2(m, f'gblocks.{first + i}', dim, expansion_ratio, 3, rms_norm)
    i0 = first + n_block
    m.conv(f'gblocks.{i0}', dim * 2, dim, 3)
    m.conv(f'gblocks.{i0 + 2}', dim, dim * 2, 3)
    m.conv(f'gblocks.{i0 + 4}', dim, dim, 1)
    to_img_scale = 4 if unshuffle else scale
    _uni_upsample_v3(m, 'to_img', upsampler, to_img_scale, dim, in_nc, mid_dim)
    _meta_upsample(m, 'to_img.MetaUpsample', _SAMPLE_MODS, upsampler, scale, dim, in_nc, mid_dim, group)
    return m.sd


def make_moesr(dim: int = 64, n_blocks: int = 6, n_block: int = 6, scale: int = 4, in_nc: int = 3,
               out_nc: int = 3, expansion_factor: float = 2.5, expansion_msg: float = 2.5,
               upsampler: str = 'pixelshuffledirect', upsample_dim: int = 64, seed: int = 0):
    """MoESR layout (reference moesr/arch.py:190-227): ``in_to_dim``,
    ``n_blocks`` Blocks of ``n_block`` LayerNorm GatedCNNBlocks and an MSG
    (``down.0`` dim -> dim / 4, three gated blocks at 1/2 resolution,
    ``up.0`` dim -> 4 dim), ``upscale`` a UniUpsample and its MetaUpsample
    buffer.  Its defaults are the zoo's choice: ``MoESR()``'s are not in
    this repo."""
    m = _Maker(seed)
    m.conv('in_to_dim', dim, in_nc, 3)
    for bi in range(n_blocks):
        for i in range(n_block):
            _gated_cnn_v2(m, f'blocks.{bi}.blocks.{i}', dim, expansion_factor, 3, False)
        msg = f'blocks.{bi}.msg'
        m.conv(f'{msg}.down.0', dim // 4, dim, 3)
        for i in range(3):
            _gated_cnn_v2(m, f'{msg}.gated.{i}', dim, expansion_msg, 3, False)
        m.conv(f'{msg}.up.0', dim * 4, dim, 3)
    _uni_upsample_v3(m, 'upscale', upsampler, scale, dim, out_nc, upsample_dim)
    _meta_upsample(m, 'upscale.MetaUpsample', _SAMPLE_MODS, upsampler, scale, dim, out_nc, upsample_dim)
    return m.sd


def _meta_gated(m: _Maker, key: str, d: int):
    """A GateRv2 / GateRV3 MetaGated block of width ``d``: the local gate
    (RMSNorm, 1x1 to 2d, 3x3 with groups d, simple gate, ``sca.1``), the
    global gated CNN (1x1 ``fc1`` to 3d, the Inception mixer, 1x1 ``fc2``
    from 1.5d) and the two ``gamma``s."""
    m.t(f'{key}.local.0.scale', d)
    m.sd[f'{key}.local.0.scale'] += 1.0
    m.t(f'{key}.local.0.offset', d)
    m.conv(f'{key}.local.1', 2 * d, d, 1)
    m.conv(f'{key}.local.2', 2 * d, 2, 3)
    m.conv(f'{key}.sca.1', d, d, 1)
    for g in ('gamma0', 'gamma1'):
        m.t(f'{key}.{g}', 1, d, 1, 1)
        m.sd[f'{key}.{g}'] += 1.0
    _gated_cnn_v2(m, f'{key}.glob', d, 1.5, 1, True, 'token_mix')
    del m.sd[f'{key}.glob.gamma']


def _gated_unet(m: _Maker, enc: str, dim: int, enc_blocks, dec_blocks):
    """The GateRv2 / GateRV3 U-Net's MetaGated stages: each encoder stage's
    blocks and bias-free 3x3 ``scale.0`` to half width (then unshuffled),
    each decoder stage's ``scale.0`` to twice the width (then shuffled),
    1x1 ``shor`` and blocks."""
    for i, nb in enumerate(enc_blocks):
        d = dim * 2**i
        for j in range(nb):
            _meta_gated(m, f'{enc}.{i}.gated.{j}', d)
        m.t(f'{enc}.{i}.scale.0.weight', d // 2, d, 3, 3)
    for i, nb in enumerate(dec_blocks):
        d = dim * 2 ** (len(dec_blocks) - i)
        m.t(f'decode.{i}.scale.0.weight', 2 * d, d, 3, 3)
        m.conv(f'decode.{i}.shor', d // 2, d, 1)
        for j in range(nb):
            _meta_gated(m, f'decode.{i}.gated.{j}', d // 2)


def _gated_cnn_latent(m: _Maker, key: str, c: int):
    """A latent GatedCNNBlock's RMSNorm, 1x1 ``fc1`` to 3c and 1x1 ``fc2``
    from 1.5c; the token mixer is the caller's."""
    m.t(f'{key}.norm.scale', c)
    m.sd[f'{key}.norm.scale'] += 1.0
    m.t(f'{key}.norm.offset', c)
    m.conv(f'{key}.fc1', 3 * c, c, 1)
    m.conv(f'{key}.fc2', c, 3 * c // 2, 1)


def make_gaterv2(dim: int = 32, enc_blocks=(2, 2, 4), dec_blocks=(4, 2, 2), num_latent: int = 6, scale: int = 1,
                 in_nc: int = 3, upsampler: str = 'pixelshuffledirect', upsample_mid_dim: int = 32,
                 seed: int = 0):
    """GateRv2 layout (reference gaterv2/arch.py:394-470): ``in_to_dim``,
    the MetaGated U-Net (``encode`` / ``decode``), latent GatedCNNBlocks
    with the Taylor linear attention (1x1 query / key convs to c / 8, value
    to c), then at 1x ``dim_to_in``, else the ``short_to_dim`` ConvBlock and
    ``upsample``, a UniUpsample, with its MetaUpsample buffer under the key
    the JAX loader reads.  Its defaults and the c / 8 are the zoo's choice:
    ``GateRV2()``'s are not in this repo."""
    m = _Maker(seed)
    m.conv('in_to_dim', dim, in_nc, 3)
    _gated_unet(m, 'encode', dim, enc_blocks, dec_blocks)
    latent = dim * 2 ** len(enc_blocks)
    for i in range(num_latent):
        key = f'latent.{i}'
        _gated_cnn_latent(m, key, latent)
        m.conv(f'{key}.token_mix.query_conv', latent // 8, latent, 1)
        m.conv(f'{key}.token_mix.key_conv', latent // 8, latent, 1)
        m.conv(f'{key}.token_mix.value_conv', latent, latent, 1)
    if scale == 1:
        m.conv('dim_to_in', in_nc, dim, 3)
    else:
        m.conv('short_to_dim.block.0', dim, in_nc, 3)
        m.conv('short_to_dim.block.2', dim, dim, 3)
        m.conv('short_to_dim.conv11', dim, in_nc, 1)
        _uni_upsample_v3(m, 'upsample', upsampler, scale, dim, in_nc, upsample_mid_dim)
        _meta_upsample(m, 'upsample.MetaUpsample', _SAMPLE_MODS, upsampler, scale, dim, in_nc, upsample_mid_dim)
    return m.sd


def _conv3xc_bias_free(m: _Maker, key: str, c: int, gain: int = 2):
    """A bias-free Conv3XC bundle on ``c`` channels (reference
    gaterv3/arch.py:436-447)."""
    m.t(f'{key}.sk.weight', c, c, 1, 1)
    m.t(f'{key}.conv.0.weight', c * gain, c, 1, 1)
    m.t(f'{key}.conv.1.weight', c * gain, c * gain, 3, 3)
    m.t(f'{key}.conv.2.weight', c, c * gain, 1, 1)
    m.t(f'{key}.eval_conv.weight', c, c, 3, 3)


def make_gaterv3(dim: int = 32, enc_blocks=(2, 2, 4), dec_blocks=(4, 2, 2), num_latent: int = 4, scale: int = 1,
                 in_nc: int = 3, upsampler: str = 'pixelshuffledirect', upsample_mid_dim: int = 32,
                 attention: bool = True, span_blocks: int = 4, end_kernel: int = 1, gamma: bool = True,
                 seed: int = 0):
    """GateRV3 layout (reference gaterv3/arch.py:705-802): ``in_to_dim``,
    the SPAN branch (bias-free SPABs ``span_block0``, ``span_n_b.*``,
    ``span_end``, a biased Conv3XC ``sisr_end_conv``, 1x1 ``sisr_cat_conv``
    from 4 dim), the MetaGated U-Net (``gater_encode`` / ``decode``), latent
    GatedCNNBlocks with the channel attention (16 heads: 1x1 ``qkv``, 3x3
    ``qkv_dwconv`` with groups 3c, ``temperature``, 1x1 ``project_out``) or
    the Inception mixer, ``dim_to_in`` (a 3x3 conv at 1x, else a
    UniUpsampleV3 with its MetaUpsample buffer; ``end_kernel``: DySample's
    end conv) and ``gamma`` (left out with ``gamma=False``, which the loader
    fills with ones).  Its defaults are the zoo's choice: ``GateRV3()``'s
    are not in this repo."""
    m = _Maker(seed)
    m.conv('in_to_dim', dim, in_nc, 3)
    for b in ['span_block0', *(f'span_n_b.{i}' for i in range(span_blocks)), 'span_end']:
        for c in ('c1_r', 'c2_r', 'c3_r'):
            _conv3xc_bias_free(m, f'{b}.{c}', dim)
    _conv3xc(m, 'sisr_end_conv', dim, dim)
    m.conv('sisr_cat_conv', dim, 4 * dim, 1)
    _gated_unet(m, 'gater_encode', dim, enc_blocks, dec_blocks)
    latent = dim * 2 ** len(enc_blocks)
    for i in range(num_latent):
        key = f'latent.{i}'
        _gated_cnn_latent(m, key, latent)
        if attention:
            m.t(f'{key}.token_mix.temperature', 16, 1, 1)
            m.sd[f'{key}.token_mix.temperature'] += 1.0
            m.t(f'{key}.token_mix.qkv.weight', 3 * latent, latent, 1, 1)
            m.conv(f'{key}.token_mix.qkv_dwconv', 3 * latent, 1, 3)
            m.t(f'{key}.token_mix.project_out.weight', latent, latent, 1, 1)
        else:
            _inception_dwconv(m, f'{key}.token_mix', latent)
    if scale == 1:
        m.conv('dim_to_in', in_nc, dim, 3)
    else:
        _uni_upsample_v3(m, 'dim_to_in', upsampler, scale, dim, in_nc, upsample_mid_dim, end_kernel)
        _meta_upsample(m, 'dim_to_in.MetaUpsample', _SAMPLE_MODS3, upsampler, scale, dim, in_nc, upsample_mid_dim)
    if gamma:
        m.t('gamma', 1, in_nc, 1, 1)
        m.sd['gamma'] += 1.0
    return m.sd


# -- the last eight: RTMoSR, SMoSR, RHA, FlexNet and the four spectral families ---------------


def _omnishift(m: _Maker, key: str, c: int, bias: bool = True):
    """An OmniShift on ``c`` channels (reference rtmosr/arch.py:210-282):
    per-channel ``alpha1`` .. ``alpha4`` near 1, depthwise 1x1 / 3x3 / 5x5
    convs and the collapsed ``conv5x5_reparam``; FlexNet's bias-free variant
    (``bias=False``) has one ``alpha`` vector of the four weights instead."""
    if bias:
        for i in range(1, 5):
            m.t(f'{key}.alpha{i}', c)
            m.sd[f'{key}.alpha{i}'] += 1.0
    else:
        m.t(f'{key}.alpha', 4)
        m.sd[f'{key}.alpha'] += 1.0
    for name, k in (('conv1x1', 1), ('conv3x3', 3), ('conv5x5', 5), ('conv5x5_reparam', 5)):
        m.t(f'{key}.{name}.weight', c, 1, k, k)
        if bias:
            m.t(f'{key}.{name}.bias', c)


def make_rtmosr(dim: int = 64, n_blocks: int = 2, scale: int = 2, ffn_expansion: float = 2.0,
                unshuffle_mod: bool = True, dccm: bool = True, se: bool = True, se_reduction: int = 16,
                seed: int = 0):
    """RTMoSR layout (reference rtmosr/arch.py:340-386): the RepConv stem
    ``to_feat`` (``to_feat.1`` after a pixel unshuffle by 4 // scale with
    ``unshuffle_mod`` below 4x), GatedCNNBlocks (RMSNorm ``scale`` /
    ``offset``, RepConv ``fc1`` to 2 x hidden, the pooled RepConv
    ``conv.0.poll.1`` dim -> 4 dim, an OmniShift on 4 dim, a CSE
    ``conv.2`` with ``se``, RepConv ``fc2`` with ``dccm`` or a 1x1), and the
    RepConv ``to_img.0``.  Its defaults (dim 64, ffn 2, 2x with the
    unshuffle stem) and the CSE's reduction 16 are the zoo's choice:
    ``RTMoSR()``'s are not in this repo."""
    m = _Maker(seed)
    hidden = int(ffn_expansion * dim)
    unshuffle = unshuffle_mod and scale < 4
    if unshuffle:
        _repconv(m, 'to_feat.1', 3 * (4 // scale) ** 2, dim)
    else:
        _repconv(m, 'to_feat', 3, dim)
    for i in range(n_blocks):
        b = f'body.{i}'
        m.t(f'{b}.norm.scale', dim)
        m.sd[f'{b}.norm.scale'] += 1.0
        m.t(f'{b}.norm.offset', dim)
        _repconv(m, f'{b}.fc1', dim, 2 * hidden)
        _repconv(m, f'{b}.conv.0.poll.1', dim, 4 * dim)
        _omnishift(m, f'{b}.conv.1', 4 * dim)
        if se:
            m.conv(f'{b}.conv.2.squeezing.0', 4 * dim // se_reduction, 4 * dim, 1)
            m.conv(f'{b}.conv.2.squeezing.2', 4 * dim, 4 * dim // se_reduction, 1)
        if dccm:
            _repconv(m, f'{b}.fc2', hidden, dim)
        else:
            m.conv(f'{b}.fc2', dim, hidden, 1)
    _repconv(m, 'to_img.0', dim, 3 * (4 if unshuffle else scale) ** 2)
    return m.sd


def _doconv(m: _Maker, key: str, cin: int, cout: int, k: int):
    """A DOConv2d (reference smosr/arch.py:211-293): ``W`` (cout, cin,
    k²), for k > 1 the depthwise ``D`` and its identity ``d_diag`` (cin,
    k², k²), the scalar ``mul`` near 1, ``bias`` and the ``eval_conv``
    buffers."""
    m.t(f'{key}.W', cout, cin, k * k)
    if k > 1:
        m.t(f'{key}.D', cin, k * k, k * k)
        m.sd[f'{key}.d_diag'] = np.tile(np.eye(k * k, dtype=np.float32), (cin, 1, 1))
    m.sd[f'{key}.mul'] = np.ones(1, np.float32)
    m.t(f'{key}.bias', cout)
    m.conv(f'{key}.eval_conv', cout, cin, k)


def _smosr_conv(m: _Maker, key: str, cin: int, cout: int, k: int, rep: bool, gain: int = 2):
    """One of SMoSR's convs: a DOConv2d, or with ``rep`` a ConvNXC
    (reference smosr/arch.py:295-377: DOConv 1x1 ``sk``, DOConvs 1x1 ->
    k x k -> 1x1 through ``gain`` times the widths) with its own
    ``eval_conv`` buffers beside the nested ones."""
    if not rep:
        _doconv(m, key, cin, cout, k)
        return
    _doconv(m, f'{key}.sk', cin, cout, 1)
    _doconv(m, f'{key}.conv.0', cin, cin * gain, 1)
    _doconv(m, f'{key}.conv.1', cin * gain, cout * gain, k)
    _doconv(m, f'{key}.conv.2', cout * gain, cout, 1)
    m.conv(f'{key}.eval_conv', cout, cin, k)


_V4_MODS = ('conv', 'pixelshuffledirect', 'pixelshuffle', 'nearest+conv', 'dysample', 'pa_up')


def make_smosr(dim: int = 64, n_mb: int = 2, scale: int = 4, in_ch: int = 3, out_ch: int = 3, rep: bool = False,
               upsampler: str = 'pixelshuffledirect', mid_dim: int = 32, d_kernel: int = 3, group: int = 4,
               seed: int = 0):
    """SMoSR layout (reference smosr/arch.py:419-470): the 1x1 ``short``
    from ``in_ch`` to ``in_ch * scale²`` channels; SMBs ``blocks_1.0``,
    ``blocks_1.1``, ``blocks_2.*`` and ``end_block.0`` (``body.0`` 3x3 to dim,
    ``body.2`` 3x3, ``body.4`` 1x1 to 2 dim, a SiLU after the first two; a
    1x1 ``short``), ``end_block.1`` (3x3), then UniUpsampleV4_light on dim +
    ``in_ch * scale²`` channels and its 8-entry MetaUpsample buffer
    (version, mode, scale, dim, out, mid, groups, rep).  Every conv but the
    two ``short`` kinds and DySample's is a DOConv2d, or a ConvNXC with
    ``rep``.  Its defaults and the block's widths are the zoo's choice:
    ``SMoSR()``'s are not in this repo."""
    m = _Maker(seed)
    short = in_ch * scale * scale
    m.conv('short', short, in_ch, 1)
    blocks = ['blocks_1.0', 'blocks_1.1', *(f'blocks_2.{i}' for i in range(n_mb)), 'end_block.0']
    for i, b in enumerate(blocks):
        cin = in_ch if i == 0 else dim
        _smosr_conv(m, f'{b}.body.0', cin, dim, 3, rep)
        _smosr_conv(m, f'{b}.body.2', dim, dim, 3, rep)
        _smosr_conv(m, f'{b}.body.4', dim, 2 * dim, 1, rep)
        m.conv(f'{b}.short', dim, cin, 1)
    _smosr_conv(m, 'end_block.1', dim, dim, 3, rep)
    c = dim + short
    up = 'upsampler'
    pow2 = scale & (scale - 1) == 0
    if scale == 1 or upsampler == 'conv':
        _smosr_conv(m, f'{up}.0', c, out_ch, 3, rep)
    elif upsampler == 'pixelshuffledirect':
        _smosr_conv(m, f'{up}.0', c, out_ch * scale * scale, 3, rep)
    elif upsampler == 'pixelshuffle':
        _smosr_conv(m, f'{up}.0', c, mid_dim, 3, rep)
        steps = [4] * int(math.log2(scale)) if pow2 else [9]
        for i, r2 in enumerate(steps):
            _smosr_conv(m, f'{up}.{2 + 2 * i}', mid_dim, r2 * mid_dim, 3, rep)
        _smosr_conv(m, f'{up}.{2 + 2 * len(steps)}', mid_dim, out_ch, 3, rep)
    elif upsampler == 'nearest+conv':
        n = int(math.log2(scale)) if pow2 else 1
        idx = [3 * i for i in range(n)] if pow2 else [0]
        for i, j in enumerate(idx):
            _smosr_conv(m, f'{up}.{j}', c if i == 0 else mid_dim, mid_dim, 3, rep)
        last = 3 * n if pow2 else 3
        _smosr_conv(m, f'{up}.{last}', mid_dim, mid_dim, 3, rep)
        _smosr_conv(m, f'{up}.{last + 2}', mid_dim, out_ch, 3, rep)
    elif upsampler == 'dysample':
        if mid_dim != c:
            _smosr_conv(m, f'{up}.0', c, mid_dim, 3, rep)
            _dysample(m, f'{up}.2', mid_dim, out_ch, scale, group, d_kernel)
        else:
            _dysample(m, f'{up}.0', c, out_ch, scale, group, d_kernel)
    elif upsampler == 'pa_up':
        idx = 0
        for i in range(int(math.log2(scale)) if pow2 else 1):
            _smosr_conv(m, f'{up}.{idx + 1}', c if i == 0 else mid_dim, mid_dim, 3, rep)
            _smosr_conv(m, f'{up}.{idx + 2}.conv.0', mid_dim, mid_dim, 1, rep)
            _smosr_conv(m, f'{up}.{idx + 4}', mid_dim, mid_dim, 3, rep)
            idx += 6
        _smosr_conv(m, f'{up}.{idx}', mid_dim, out_ch, 3, rep)
    else:
        raise ValueError(f'unknown SMoSR upsampler {upsampler!r}')
    m.sd[f'{up}.MetaUpsample'] = np.asarray([1, _V4_MODS.index(upsampler), scale, dim, out_ch, mid_dim, group,
                                             int(rep)], np.uint8)
    return m.sd


def make_rha(dim: int = 64, scale: int = 4, in_ch: int = 3, out_ch: int = 3, mid_dim: int = 64,
             down_list=(8, 4, 2, 1), expansion_ratio: float = 1.5, res_blocks: int = 6,
             upsample: str = 'pixelshuffle', unshuffle_mod: bool = False, window_size: int = 8, head_dim: int = 8,
             dwc_kernel: int = 5, seed: int = 0):
    """RHA layout (reference rha/arch.py:454-566): the 3x3 stem
    ``to_feat`` (``to_feat.1`` and the scalar ``unshuffle`` buffer 4 // scale
    with ``unshuffle_mod``), one group per ``down_list`` entry (its scalar
    ``down_sample`` buffer; ``res_blocks`` gated blocks: LayerNorm, 3x3
    ``fc1`` to 2 x hidden, the hybrid attention on dim channels (an
    OmniShift on half of them; on the other half the focused linear window
    attention ``att.2``: ``qkv`` and ``proj`` linears, the
    ``positional_encoding`` (1, window², half), the softplus ``scale``, the
    depthwise ``dwc`` over each head's v), the 1x1 ``aggr.0``), 3x3 ``fc2``;
    then an OmniShift on dim and a 1x1 conv), and the UniUpsample
    ``to_img`` with its MetaUpsample buffer (its scale the internal one: 4
    with ``unshuffle_mod``).  Its defaults (4 groups down 8 / 4 / 2 / 1 of
    six blocks, a pixelshuffle tail), the attention's head dim 8 and its
    5x5 ``dwc`` are the zoo's choice: ``RHA()``'s are not in this repo."""
    m = _Maker(seed)
    hidden = int(expansion_ratio * dim)
    half = dim // 2
    unshuffle = 4 // scale if unshuffle_mod else 1
    if unshuffle_mod:
        m.sd['unshuffle'] = np.asarray([unshuffle], np.int64)
        m.conv('to_feat.1', dim, in_ch * unshuffle**2, 3)
    else:
        m.conv('to_feat', dim, in_ch, 3)
    for gi, down in enumerate(down_list):
        g = f'body.{gi}'
        m.sd[f'{g}.down_sample'] = np.asarray([down], np.int64)
        for bi in range(res_blocks):
            b = f'{g}.body.{bi}'
            _ln(m, f'{b}.norm', dim)
            m.conv(f'{b}.fc1', 2 * hidden, dim, 3)
            _omnishift(m, f'{b}.conv.conv', half)
            a = f'{b}.conv.att.2'
            _linear(m, f'{a}.qkv', 3 * half, half)
            m.t(f'{a}.positional_encoding', 1, window_size**2, half)
            m.t(f'{a}.scale', 1, 1, half)
            m.conv(f'{a}.dwc', head_dim, 1, dwc_kernel)
            _linear(m, f'{a}.proj', half, half)
            m.conv(f'{b}.conv.aggr.0', dim, dim, 1)
            m.conv(f'{b}.fc2', dim, hidden, 3)
        _omnishift(m, f'{g}.body.{res_blocks}', dim)
        m.conv(f'{g}.body.{res_blocks + 1}', dim, dim, 1)
    to_img_scale = 4 if unshuffle_mod else scale
    _uni_upsample_v3(m, 'to_img', upsample, to_img_scale, dim, out_ch, mid_dim)
    _meta_upsample(m, 'to_img.MetaUpsample', _SAMPLE_MODS, upsample, to_img_scale, dim, out_ch, mid_dim)
    return m.sd


def _flex_conv_block(m: _Maker, key: str, cin: int, cout: int):
    """A FlexNet ConvBlock: 3x3 ``block.0`` and ``block.2``, 1x1 ``conv11``."""
    m.conv(f'{key}.block.0', cout, cin, 3)
    m.conv(f'{key}.block.2', cout, cout, 3)
    m.conv(f'{key}.conv11', cout, cin, 1)


def _flex_xblock(m: _Maker, key: str, c: int, n_blocks: int, hidden_rate: int, channel_norm: bool):
    """A FlexNet LBlock / MBlock on ``c`` channels: ``n_blocks``
    TransformerBlocks (RMSNorm ``rn1`` / ``rn2``, layer scales ``gamma1`` /
    ``gamma2`` near 0.1; LMLTVIT ``att``: bias-free OmniShift, ``qkv``, the
    depthwise LePE ``get_v``, ``proj``; ChannelMix ``ffn``: bias-free
    OmniShift, ``key`` to ``hidden_rate`` x c, optional ``key_norm``,
    ``value``, ``receptance``, all without biases) and the ConvBlock
    ``conv`` from 2c."""
    for i in range(n_blocks):
        t = f'{key}.t_blocks.{i}'
        for n in ('rn1', 'rn2'):
            m.sd[f'{t}.{n}.weight'] = np.ones(c, np.float32)
        for g in ('gamma1', 'gamma2'):
            m.t(f'{t}.{g}', c)
            m.sd[f'{t}.{g}'] += 0.1
        _omnishift(m, f'{t}.att.omni_shift', c, bias=False)
        _linear(m, f'{t}.att.qkv', 3 * c, c)
        m.conv(f'{t}.att.get_v', c, 1, 3)
        _linear(m, f'{t}.att.proj', c, c)
        _omnishift(m, f'{t}.ffn.omni_shift', c, bias=False)
        _linear(m, f'{t}.ffn.key', hidden_rate * c, c, bias=False)
        if channel_norm:
            m.sd[f'{t}.ffn.key_norm.weight'] = np.ones(hidden_rate * c, np.float32)
        _linear(m, f'{t}.ffn.value', c, hidden_rate * c, bias=False)
        _linear(m, f'{t}.ffn.receptance', c, c, bias=False)
    _flex_conv_block(m, f'{key}.conv', 2 * c, c)


def make_flexnet(dim: int = 64, num_blocks=(6, 6, 6, 6, 6, 6), scale: int = 4, inp_channels: int = 3,
                 window_size: int = 8, hidden_rate: int = 4, channel_norm: bool = False,
                 pipeline_type: str = 'linear', upsampler: str = 'ps', seed: int = 0):
    """FlexNet layout (reference flexnet/arch.py:342-455): the scalar
    ``window_size`` and ``scale_factor`` buffers, the ConvBlock
    ``short_cut``, the 3x3 ``in_to_feat``, then the ``linear`` pipeline
    (``pipeline.att.{i}``, one block group per entry of ``num_blocks``,
    the first of at least three blocks) or the ``meta`` U-Net
    (``enc0``-``enc3`` at dim, 2, 4 and 8 dim, ``dec0``-``dec2`` back up;
    bias-free 3x3 ``down*.body.0`` to half the width before a pixel
    unshuffle and ``up*.body.0`` before a pixel shuffle), and the tail on
    2 dim: ``ps`` (a 3x3 conv and a pixel shuffle), ``n+c`` (``to_img.0``
    to dim, nearest + conv stages ``to_img.1``) or ``dys`` (DySample with a
    1x1 end conv).  Its defaults (dim 64, six groups of six blocks, hidden
    rate 4, ``ps``) are the zoo's choice: ``FlexNet()``'s are not in this
    repo."""
    m = _Maker(seed)
    m.sd['window_size'] = np.asarray([window_size], np.int64)
    m.sd['scale_factor'] = np.asarray([scale], np.int64)
    _flex_conv_block(m, 'short_cut', inp_channels, dim)
    m.conv('in_to_feat', dim, inp_channels, 3)
    if pipeline_type == 'linear':
        for i, n in enumerate(num_blocks):
            _flex_xblock(m, f'pipeline.att.{i}', dim, n, hidden_rate, channel_norm)
    else:
        nb = num_blocks
        for i in range(4):
            _flex_xblock(m, f'pipeline.enc{i}.0', dim * 2**i, nb[i], hidden_rate, channel_norm)
        for i in range(3):
            c = dim * 2**i
            m.t(f'pipeline.down{i + 1}.body.0.weight', c // 2, c, 3, 3)
            m.t(f'pipeline.up{3 - i}.body.0.weight', 4 * c, 4 * c, 3, 3)
            _flex_xblock(m, f'pipeline.dec{2 - i}.0', c, nb[i], hidden_rate, channel_norm)
    c = 2 * dim
    if upsampler == 'n+c':
        m.conv('to_img.0', dim, c, 3)
        pow2 = scale & (scale - 1) == 0
        n = int(math.log2(scale)) if pow2 else 1
        for i in range(n):
            m.conv(f'to_img.1.{3 * i}', dim, dim, 3)
        last = 3 * n if pow2 else 3
        m.conv(f'to_img.1.{last}', dim, dim, 3)
        m.conv(f'to_img.1.{last + 2}', inp_channels, dim, 3)
    elif upsampler == 'dys':
        _dysample(m, 'to_img', c, inp_channels, scale)
    else:
        m.conv('to_img.0', inp_channels * scale * scale, c, 3)
    return m.sd


def _gfisr_fourier_unit(m: _Maker, key: str, c: int, groups: int):
    """GFISR's FourierUnit on ``c`` channels (reference
    gfisr/arch.py:416-472): LayerNorm ``ln`` over the 2c interleaved
    spectrum channels, the depthwise 3x3 ``fpe``, the 1x1 ``weight.0`` to
    ``groups`` mixing logits and the grouped 1x1 ``fdc`` to 2c x
    ``groups``."""
    _ln(m, f'{key}.ln', 2 * c)
    m.conv(f'{key}.fpe', 2 * c, 1, 3)
    m.conv(f'{key}.weight.0', groups, 2 * c, 1)
    m.conv(f'{key}.fdc', 2 * c * groups, 2 * c // groups, 1)


def _gfisr_stem(m: _Maker, dim: int, in_nc: int, scale: int, pixel_unshuffle: bool):
    """``in_to_dim`` (3x3), or ``in_to_dim.1`` on the pixel-unshuffled
    input below 4x."""
    if pixel_unshuffle and scale in (1, 2):
        m.conv('in_to_dim.1', dim, in_nc * (4 // scale) ** 2, 3)
        return 4
    m.conv('in_to_dim', dim, in_nc, 3)
    return scale


def make_gfisr(dim: int = 64, n_blocks: int = 24, scale: int = 4, in_nc: int = 3, out_nc: int = 3,
               expansion_ratio: float = 1.5, fft_mode: bool = True, upsampler: str = 'pixelshuffledirect',
               mid_dim: int = 32, pixel_unshuffle: bool = False, band: int = 11, fu_groups: int = 4,
               seed: int = 0):
    """GFISR layout (reference gfisr/arch.py:581-650): the stem, ``net.*``
    GatedCNNBlocks (LayerNorm, 3x3 ``fc1`` to 2 x hidden, the rotating
    inception on dim channels, 3x3 ``fc2``, ``gamma`` near 0.1) and the
    UniUpsampleV3 ``dim_to_out`` (a 3x3 DySample end conv) with its
    MetaUpsample buffer.  Block i's inception module at position o holds
    the weights of op (i + o) % 5: none (identity), a depthwise 3x3, a 1 x
    ``band`` and a ``band`` x 1 depthwise band on dim / 8 channels, a
    FourierUnit with ``fft_mode``.  Its defaults (dim 64, 24 blocks,
    pixelshuffledirect) and the FourierUnit's 4 groups are the zoo's
    choice: ``GFISR()``'s are not in this repo."""
    m = _Maker(seed)
    up_scale = _gfisr_stem(m, dim, in_nc, scale, pixel_unshuffle)
    hidden = int(expansion_ratio * dim)
    gc = int(dim * 0.125)
    for i in range(n_blocks):
        b = f'net.{i}'
        _ln(m, f'{b}.norm', dim)
        m.conv(f'{b}.fc1', 2 * hidden, dim, 3)
        for o, name in enumerate(('pconv', 'dwconv_hw', 'dwconv_w', 'dwconv_h', 'fsas')):
            slot = (i + o) % 5
            key = f'{b}.conv.{name}'
            if slot == 1:
                m.conv(key, gc, 1, 3)
            elif slot in (2, 3):
                m.t(f'{key}.weight', gc, 1, *((1, band) if slot == 2 else (band, 1)))
                m.t(f'{key}.bias', gc)
            elif slot == 4 and fft_mode:
                _gfisr_fourier_unit(m, key, gc, fu_groups)
        m.conv(f'{b}.fc2', dim, hidden, 3)
        m.t(f'{b}.gamma', 1, dim, 1, 1)
        m.sd[f'{b}.gamma'] += 0.1
    _uni_upsample_v3(m, 'dim_to_out', upsampler, up_scale, dim, out_nc, mid_dim, end_kernel=3)
    _meta_upsample(m, 'dim_to_out.MetaUpsample', _SAMPLE_MODS3, upsampler, up_scale, dim, out_nc, mid_dim)
    return m.sd


def _rms_ref(m: _Maker, key: str, width: int):
    """An RMSNorm (eps outside the sqrt): ``scale`` near 1 and ``offset``."""
    m.t(f'{key}.scale', width)
    m.sd[f'{key}.scale'] += 1.0
    m.t(f'{key}.offset', width)


def make_gfisrv2(dim: int = 64, n_blocks: int = 22, scale: int = 4, in_nc: int = 3, out_nc: int = 3,
                 expansion_ratio: float = 1.5, upsampler: str = 'pixelshuffledirect', mid_dim: int = 32,
                 pixel_unshuffle: bool = False, band: int = 11, seed: int = 0):
    """GFISRV2 layout (reference gfisrv2/arch.py:631-700): the stem,
    ``gfisr_body.*`` GatedCNNBlocks (RMSNorm, 3x3 ``fc1``, the rotating
    inception on dim channels, 3x3 ``fc2``, ``gamma`` near 0.1), then
    ``gfisr_body.{n}`` and ``.{n + 2}`` (3x3, a SiLU between), and the
    UniUpsampleV3 ``upscale`` (a 3x3 DySample end conv) with its
    MetaUpsample buffer.  Block i's module at position o holds op (i + o) %
    4: a FourierUnit v2 on dim - 3 dim / 8 channels (RMSNorms ``rn`` over
    the 2c spectrum channels and ``post_norm``, depthwise ``fpe``, 1x1
    ``fdc``), a depthwise 3x3, a 1 x ``band`` and a ``band`` x 1 band.  Its
    defaults are the zoo's choice: ``GFISRV2()``'s are not in this repo."""
    m = _Maker(seed)
    up_scale = _gfisr_stem(m, dim, in_nc, scale, pixel_unshuffle)
    hidden = int(expansion_ratio * dim)
    gc = int(dim * 0.125)
    for i in range(n_blocks):
        b = f'gfisr_body.{i}'
        _rms_ref(m, f'{b}.norm', dim)
        m.conv(f'{b}.fc1', 2 * hidden, dim, 3)
        for o, name in enumerate(('pconv', 'dwconv_hw', 'dwconv_w', 'dwconv_h')):
            slot = (i + o) % 4
            key = f'{b}.conv.{name}'
            if slot == 0:
                c = dim - 3 * gc
                _rms_ref(m, f'{key}.rn', 2 * c)
                m.conv(f'{key}.fpe', 2 * c, 1, 3)
                m.conv(f'{key}.fdc', 2 * c, 2 * c, 1)
                _rms_ref(m, f'{key}.post_norm', c)
            elif slot == 1:
                m.conv(key, gc, 1, 3)
            else:
                m.t(f'{key}.weight', gc, 1, *((1, band) if slot == 2 else (band, 1)))
                m.t(f'{key}.bias', gc)
        m.conv(f'{b}.fc2', dim, hidden, 3)
        m.t(f'{b}.gamma', 1, dim, 1, 1)
        m.sd[f'{b}.gamma'] += 0.1
    m.conv(f'gfisr_body.{n_blocks}', dim, dim, 3)
    m.conv(f'gfisr_body.{n_blocks + 2}', dim, dim, 3)
    _uni_upsample_v3(m, 'upscale', upsampler, up_scale, dim, out_nc, mid_dim, end_kernel=3)
    _meta_upsample(m, 'upscale.MetaUpsample', _SAMPLE_MODS3, upsampler, up_scale, dim, out_nc, mid_dim)
    return m.sd


def _figsr_rms(m: _Maker, key: str, width: int):
    """FIGSR's RMSNorm: ``scale`` near 1, ``offset``, and the buffers
    ``eps`` (1e-6) and ``rms`` (width^-1/2)."""
    _rms_ref(m, key, width)
    m.sd[f'{key}.eps'] = np.full(1, 1e-6, np.float32)
    m.sd[f'{key}.rms'] = np.full(1, width**-0.5, np.float32)


def make_figsr(dim: int = 64, n_blocks: int = 18, scale: int = 4, in_nc: int = 3, out_nc: int = 3,
               expansion_ratio: float = 2.0, upsampler: str = 'pixelshuffledirect', mid_dim: int = 32, gc: int = 8,
               square_kernel_size: int = 3, band_kernel_size: int = 11, seed: int = 0):
    """FIGSR layout (reference figsr/arch.py:627-720): the global
    ``shift`` / ``scale_norm`` affine, the 3x3 ``in_to_dim``, the two
    halves ``gfisr_body_half.*`` and ``gfisr_body_half_2.*`` of
    GatedCNNBlocks (FIGSR RMSNorm, 3x3 ``fc1`` to 2 x hidden (hidden a
    multiple of 8), on dim channels a FourierUnit ``conv.fu`` over dim - 3
    ``gc`` of them and full convs ``convhw`` (square), ``convw`` /
    ``convh`` (bands) over ``gc`` each, 3x3 ``fc2``), the second half's
    closing 3x3 conv, the 1x1 ``cat_to_dim`` from 3 dim, and the
    UniUpsampleV3 ``upscale`` (a 3x3 DySample end conv) with its
    MetaUpsample buffer.  Its defaults (dim 64, 18 blocks, expansion 2, gc
    8, a 3x3 square and 11-tap bands, pixelshuffledirect) are the zoo's
    choice: ``FIGSR()``'s are not in this repo."""
    m = _Maker(seed)
    m.t('shift', 1, in_nc, 1, 1)
    m.t('scale_norm', 1, in_nc, 1, 1)
    m.sd['scale_norm'] += 1.0
    m.conv('in_to_dim', dim, in_nc, 3)
    hidden = int(expansion_ratio * dim) // 8 * 8
    c = dim - 3 * gc
    n_half = n_blocks // 2
    for b in [f'gfisr_body_half.{i}' for i in range(n_half)] + [f'gfisr_body_half_2.{i}'
                                                               for i in range(n_blocks - n_half)]:
        _figsr_rms(m, f'{b}.norm', dim)
        m.conv(f'{b}.fc1', 2 * hidden, dim, 3)
        _figsr_rms(m, f'{b}.conv.fu.rn', 2 * c)
        m.conv(f'{b}.conv.fu.fpe', 2 * c, 1, 3)
        m.conv(f'{b}.conv.fu.fdc', 2 * c, 2 * c, 1)
        _figsr_rms(m, f'{b}.conv.fu.post_norm', c)
        m.conv(f'{b}.conv.convhw', gc, gc, square_kernel_size)
        m.t(f'{b}.conv.convw.weight', gc, gc, 1, band_kernel_size)
        m.t(f'{b}.conv.convw.bias', gc)
        m.t(f'{b}.conv.convh.weight', gc, gc, band_kernel_size, 1)
        m.t(f'{b}.conv.convh.bias', gc)
        m.conv(f'{b}.fc2', dim, hidden, 3)
    m.conv(f'gfisr_body_half_2.{n_blocks - n_half}', dim, dim, 3)
    m.conv('cat_to_dim', dim, 3 * dim, 1)
    _uni_upsample_v3(m, 'upscale', upsampler, scale, dim, out_nc, mid_dim, end_kernel=3)
    _meta_upsample(m, 'upscale.MetaUpsample', _SAMPLE_MODS3, upsampler, scale, dim, out_nc, mid_dim)
    return m.sd


def _dynamic_local(m: _Maker, key: str, c: int, k: int):
    """A LAWFFT DynamicLocal on ``c`` channels: 1x1 ``kernel_gen.1`` and
    ``kernel_gen.3`` to c x k² generated kernel taps."""
    m.conv(f'{key}.kernel_gen.1', c, c, 1)
    m.conv(f'{key}.kernel_gen.3', c * k * k, c, 1)


def make_lawfft(dim: int = 64, n_rblock: int = 4, n_mblock: int = 6, scale: int = 4, in_ch: int = 3,
                split: float = 0.25, t_mid_factor: float = 1.0, window_size: int = 8, mlp_factor: float = 2.0,
                unshuffle_mod: bool = False, upsampler: str = 'pixelshuffledirect', mid_dim: int = 32,
                seed: int = 0):
    """LAWFFT layout (reference lawfft/arch.py:360-440): the scalar
    ``window_size`` buffer, the 3x3 stem ``in_to_dim`` (``in_to_dim.1``
    on the pixel-unshuffled input by 4 // scale with ``unshuffle_mod``),
    ``n_rblock`` residual groups ``body.*`` of ``n_mblock`` meta blocks
    (LayerNorm ``token_mix.0``; SFSAS ``token_mix.1``: DynamicLocal 3x3 and
    5x5 ``local.0`` / ``local.1`` on the first ``split`` of the channels,
    FSAS ``att`` on the rest (1x1 ``to_hidden`` to 3 x ``t_mid_factor``
    widths, depthwise 3x3 ``to_hidden_dw``, LayerNorm ``norm``, 1x1
    ``project_out``), 1x1 ``last``; LayerNorm ``channel_mix1.0`` and the
    FFN ``channel_mix1.1``: 1x1 ``project_in`` to 2 x ``mlp_factor`` dim,
    depthwise 3x3 ``dwconv``, 1x1 ``project_out``) and a closing
    DynamicLocal 3x3, and the UniUpsample ``upscale`` with its
    MetaUpsample buffer (its scale the internal one: 4 with
    ``unshuffle_mod``).  Its defaults are the zoo's choice: ``LAWFFT()``'s
    are not in this repo."""
    m = _Maker(seed)
    m.sd['window_size'] = np.asarray([window_size], np.int64)
    if unshuffle_mod:
        m.conv('in_to_dim.1', dim, in_ch * (4 // scale) ** 2, 3)
    else:
        m.conv('in_to_dim', dim, in_ch, 3)
    local = int(split * dim)
    glob = dim - local
    mid = int(3 * t_mid_factor * glob)
    hid = int(mlp_factor * dim)
    for ri in range(n_rblock):
        for mi in range(n_mblock):
            r = f'body.{ri}.residual.{mi}'
            t = f'{r}.token_mix'
            _ln(m, f'{t}.0', dim)
            _dynamic_local(m, f'{t}.1.local.0', local, 3)
            _dynamic_local(m, f'{t}.1.local.1', local, 5)
            m.conv(f'{t}.1.att.to_hidden', mid, glob, 1)
            m.conv(f'{t}.1.att.to_hidden_dw', mid, 1, 3)
            _ln(m, f'{t}.1.att.norm', mid // 3)
            m.conv(f'{t}.1.att.project_out', glob, mid // 3, 1)
            m.conv(f'{t}.1.last', dim, dim, 1)
            _ln(m, f'{r}.channel_mix1.0', dim)
            m.conv(f'{r}.channel_mix1.1.project_in', 2 * hid, dim, 1)
            m.conv(f'{r}.channel_mix1.1.dwconv', 2 * hid, 1, 3)
            m.conv(f'{r}.channel_mix1.1.project_out', dim, hid, 1)
        _dynamic_local(m, f'body.{ri}.residual.{n_mblock}', dim, 3)
    up_scale = 4 if unshuffle_mod else scale
    _uni_upsample_v3(m, 'upscale', upsampler, up_scale, dim, in_ch, mid_dim)
    _meta_upsample(m, 'upscale.MetaUpsample', _SAMPLE_MODS, upsampler, up_scale, dim, in_ch, mid_dim)
    return m.sd
