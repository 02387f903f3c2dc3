"""GateR: a gated-CNN restoration U-Net (1x).

Counterpart of ``resselt_tpu/archs/gater.py``: the same config inference,
metadata and forward.  RMSNorm gated CNN blocks whose token mixer is a
7x7 depthwise conv, or FLPVT2 focused linear attention in the latent
stage; pixel-unshuffle / shuffle stages; reflect padding to a multiple of
8; the input added back.  Each same-padded 3x3 conv (``in_to_dim``, the
stages' ``body.0`` and ``dim_to_ch.*``) runs through
``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``); the 1x1 convs, the
depthwise convs and the linears stay plain torch.  The weights are built
once per compute dtype (``prepare``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..ops.conv_route import conv, prepare_convs

_STAGES = ('enc0', 'enc1.1', 'enc2.1', 'latent.1', 'dec0.1', 'dec1.1', 'dec2.0')


@dataclass(frozen=True)
class GateRConfig:
    dim: int
    in_ch: int
    num_blocks: tuple[int, ...]
    latent_att: bool


def _norm(t):
    return torch.linalg.vector_norm(t, dim=-1, keepdim=True)


def flpvt2(p: PTree, x, h: int, w: int):
    """FLPVT2 global focused linear attention (gater/arch.py:19-90) on
    ``x`` (B, N, C), with the learned per-dim focusing factor.  The linears
    and the depthwise ``dwc`` run in ``x``'s dtype; the focusing, the two
    products and the normaliser in f32 (the JAX package's order and f32
    accumulation), the result taken to ``x``'s dtype: in fp16,
    ``(relu(q) + 1e-6) ** ff`` underflows to 0 and its norm to a division
    by zero."""
    b, n, c = x.shape
    hd = p.shape('dwc.weight')[0]
    nh = c // hd
    q = p.linear('q', x).float()
    kv = p.linear('kv', x)
    k, v = kv[..., :c].float(), kv[..., c:]

    scale = torch.nn.functional.softplus(p['scale'].float())
    ff = p['focusing_factor'].float()
    q = (F.relu(q) + 1e-6) / scale
    k = (F.relu(k) + 1e-6) / scale
    qn, kn = _norm(q), _norm(k)
    q, k = q**ff, k**ff
    q = q / _norm(q) * qn
    k = k / _norm(k) * kn

    q = q.reshape(b, n, nh, hd).transpose(1, 2)
    k = k.reshape(b, n, nh, hd).transpose(1, 2)
    v = v.reshape(b, n, nh, hd).transpose(1, 2)

    z = 1.0 / (q @ k.mean(dim=2, keepdim=True).transpose(-1, -2) + 1e-6)
    kvm = (k * n**-0.5).transpose(-1, -2) @ (v.float() * n**-0.5)
    out = ((q @ kvm) * z).to(x.dtype).transpose(1, 2).reshape(b, n, c)

    v_img = v.reshape(b * nh, h, w, hd)
    dwc = conv(p['dwc'], v_img)
    out = out + dwc.reshape(b, nh, n, hd).transpose(1, 2).reshape(b, n, c)
    return p.linear('proj', out)


def gated_block(p: PTree, x, h: int, w: int, att: bool):
    """GatedCNNBlock (gater/arch.py:90-130) on ``x`` (B, N, C), no inner
    residual."""
    b, n, c = x.shape
    x = F.rms_norm(x, p['norm.weight'], eps=1e-6)
    x = p.linear('fc1', x)
    hidden = x.shape[-1] // 2
    g = x[..., :hidden]
    i = x[..., hidden : 2 * hidden - c]
    cc = x[..., 2 * hidden - c :]
    if att:
        cc = flpvt2(p.sub('conv'), cc, h, w)
    else:
        cc = conv(p['conv.conv'], cc.reshape(b, h, w, c)).reshape(b, n, c)
    return p.linear('fc2', F.mish(g) * torch.cat([i, cc], dim=-1))


def blocks(p: PTree, x_img, n_block: int, att: bool = False):
    """Blocks with a residual each (gater/arch.py:133-142); ``x_img`` NHWC."""
    b, h, w, c = x_img.shape
    x = x_img.reshape(b, h * w, c)
    for i in range(n_block):
        x = gated_block(p.sub(f'gated.{i}'), x, h, w, att) + x
    return x.reshape(b, h, w, c)


def prepare(cfg: GateRConfig, params, dtype):
    """The convs for ``dtype``: the 7x7 token mixers are depthwise (groups
    = their channels), FLPVT2's ``dwc`` grouped by head dim."""
    groups = {k[: -len('.weight')]: v.shape[0] for k, v in params.items()
              if k.endswith(('.conv.conv.weight', '.conv.dwc.weight'))}
    return prepare_convs(params, dtype, groups)


def apply(cfg: GateRConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    nb = cfg.num_blocks
    h0, w0 = x.shape[1], x.shape[2]
    x = F.pad_to_multiple(x, 8, mode='reflect')

    def down(name, t):
        return F.pixel_unshuffle(conv(p[f'{name}.body.0'], t), 2)

    def up(name, t):
        return F.pixel_shuffle(conv(p[f'{name}.body.0'], t), 2)

    enc0 = blocks(p.sub('enc0'), conv(p['in_to_dim'], x), nb[0])
    enc1 = blocks(p.sub('enc1.1'), down('enc1.0', enc0), nb[1])
    enc2 = blocks(p.sub('enc2.1'), down('enc2.0', enc1), nb[2])
    latent = up('latent.2', blocks(p.sub('latent.1'), down('latent.0', enc2), nb[3], cfg.latent_att))

    d = conv(p['dec0.0'], torch.cat([latent, enc2], dim=-1))
    dec0 = up('dec0.2', blocks(p.sub('dec0.1'), d, nb[4]))
    d = conv(p['dec1.0'], torch.cat([dec0, enc1], dim=-1))
    dec1 = up('dec1.2', blocks(p.sub('dec1.1'), d, nb[5]))
    dec2 = blocks(p.sub('dec2.0'), torch.cat([dec1, enc0], dim=-1), nb[6])

    out = conv(p['dim_to_ch.1'], conv(p['dim_to_ch.0'], dec2))
    return (out + x)[:, :h0, :w0, :]


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/gater.py::_load``."""
    dim, in_ch = sd['in_to_dim.weight'].shape[:2]
    num_blocks = tuple(get_seq_len(sd, s + '.gated') for s in _STAGES)
    latent_att = 'latent.1.gated.0.conv.conv.weight' not in sd

    cfg = GateRConfig(dim=dim, in_ch=in_ch, num_blocks=num_blocks, latent_att=latent_att)
    meta = ModelMetadata(in_channels=in_ch, out_channels=in_ch, upscale=1, name='GateR')
    return SRModel('GateR', cfg, params_from_numpy(sd, device), meta, apply, prepare)


ARCH = Architecture(
    id='GateR',
    detect_condition=KeyCondition.has_all(
        'dec0.0.bias',
        'dec0.0.weight',
        'dec0.1.gated.0.conv.conv.bias',
        'dec0.1.gated.0.conv.conv.weight',
        'dec0.1.gated.0.fc1.bias',
        'dec0.1.gated.0.fc1.weight',
        'dec0.1.gated.0.fc2.bias',
        'dec0.1.gated.0.fc2.weight',
        'dec0.1.gated.0.norm.weight',
        'dec0.2.body.0.bias',
        'dec0.2.body.0.weight',
        'dec1.0.bias',
        'dec1.0.weight',
        'dec1.1.gated.0.conv.conv.bias',
        'dec1.1.gated.0.conv.conv.weight',
        'dec1.1.gated.0.fc1.bias',
        'dec1.1.gated.0.fc1.weight',
        'dec1.1.gated.0.fc2.bias',
        'dec1.1.gated.0.fc2.weight',
        'dec1.1.gated.0.norm.weight',
        'dec1.2.body.0.bias',
        'dec1.2.body.0.weight',
        'dec2.0.gated.0.conv.conv.bias',
        'dec2.0.gated.0.conv.conv.weight',
        'dec2.0.gated.0.fc1.bias',
        'dec2.0.gated.0.fc1.weight',
        'dec2.0.gated.0.fc2.bias',
        'dec2.0.gated.0.fc2.weight',
        'dec2.0.gated.0.norm.weight',
        'dim_to_ch.0.bias',
        'dim_to_ch.0.weight',
        'dim_to_ch.1.bias',
        'dim_to_ch.1.weight',
        'enc0.gated.0.conv.conv.bias',
        'enc0.gated.0.conv.conv.weight',
        'enc0.gated.0.fc1.bias',
        'enc0.gated.0.fc1.weight',
        'enc0.gated.0.fc2.bias',
        'enc0.gated.0.fc2.weight',
        'enc0.gated.0.norm.weight',
        'enc1.0.body.0.bias',
        'enc1.0.body.0.weight',
        'enc1.1.gated.0.conv.conv.bias',
        'enc1.1.gated.0.conv.conv.weight',
        'enc1.1.gated.0.fc1.bias',
        'enc1.1.gated.0.fc1.weight',
        'enc1.1.gated.0.fc2.bias',
        'enc1.1.gated.0.fc2.weight',
        'enc1.1.gated.0.norm.weight',
        'enc2.0.body.0.bias',
        'enc2.0.body.0.weight',
        'enc2.1.gated.0.conv.conv.bias',
        'enc2.1.gated.0.conv.conv.weight',
        'enc2.1.gated.0.fc1.bias',
        'enc2.1.gated.0.fc1.weight',
        'enc2.1.gated.0.fc2.bias',
        'enc2.1.gated.0.fc2.weight',
        'enc2.1.gated.0.norm.weight',
        'in_to_dim.bias',
        'in_to_dim.weight',
        'latent.0.body.0.bias',
        'latent.0.body.0.weight',
        'latent.1.gated.0.fc1.bias',
        'latent.1.gated.0.fc1.weight',
        'latent.1.gated.0.fc2.bias',
        'latent.1.gated.0.fc2.weight',
        'latent.1.gated.0.norm.weight',
        'latent.2.body.0.bias',
        'latent.2.body.0.weight',
    ),
    load_fn=_load,
)
