"""Compact (SRVGGNetCompact): a plain conv / PReLU stack with a
pixel-shuffle tail and a nearest-upsampled residual base.

Counterpart of ``resselt_tpu/archs/compact.py``: the same config inference,
metadata and serving hint, and the same forward.  Every conv is a 3x3
through ``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``; 18 launches per
forward of ``compact 4x``, 64 features, 16 convs), act ``linear``: the
PReLU that follows each one has no epilogue in the kernel and runs as
plain torch.  The weights are packed once per compute dtype (``prepare``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len, pixelshuffle_scale
from ..nn import functional as F
from ..ops.conv_route import conv, prepare_convs


@dataclass(frozen=True)
class CompactConfig:
    num_in_ch: int
    num_out_ch: int
    num_feat: int
    num_conv: int
    upscale: int


def prepare(cfg: CompactConfig, params, dtype):
    return prepare_convs(params, dtype)


def apply(cfg: CompactConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    out = x
    # body = [conv, prelu] * (num_conv + 1) + [conv]  (compact/arch.py:37-56)
    n_layers = 2 * (cfg.num_conv + 1) + 1
    for i in range(n_layers):
        if i % 2 == 0:
            out = conv(w[f'body.{i}'], out)
        else:
            out = F.prelu(out, w[f'body.{i}.weight'])
    out = F.pixel_shuffle(out, cfg.upscale)
    base = F.interpolate_nearest(x, scale_factor=cfg.upscale)
    return out + base


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/compact.py::_load``."""
    highest_num = get_seq_len(sd, 'body') - 1
    in_nc = sd['body.0.weight'].shape[1]
    num_feat = sd['body.0.weight'].shape[0]
    num_conv = (highest_num - 2) // 2
    pixelshuffle_shape = sd[f'body.{highest_num}.bias'].shape[0]
    scale = pixelshuffle_scale(pixelshuffle_shape, in_nc)

    cfg = CompactConfig(num_in_ch=in_nc, num_out_ch=in_nc, num_feat=num_feat, num_conv=num_conv, upscale=scale)
    meta = ModelMetadata(in_channels=in_nc, out_channels=in_nc, upscale=scale, name='Compact')
    model = SRModel('Compact', cfg, params_from_numpy(sd, device), meta, apply, prepare)
    # the JAX package's hint, kept so that tiled outputs match it; its
    # value has not been re-measured on a GPU
    model.serving_halo = 4
    return model


ARCH = Architecture(
    id='Compact',
    detect_condition=KeyCondition.has_all('body.0.weight', 'body.1.weight'),
    load_fn=_load,
)
