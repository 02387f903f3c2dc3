"""RRDBNet (ESRGAN), written from Real-ESRGAN's published
``basicsr/archs/rrdbnet_arch.py``, in plain float32 PyTorch on NCHW.

The state dict uses the published key names (``conv_first``,
``body.{i}.rdb{r}.conv{c}``, ``conv_body``, ``conv_up1``, ``conv_up2``,
``conv_hr``, ``conv_last``).  The random weights follow the published
initialisation in form: the dense blocks' convs at a tenth of Kaiming's
scale (``default_init_weights(..., 0.1)``), the others at PyTorch's default
scale, with small random biases so that every bias is exercised.  The
trunk's features grow about 60-fold over the 23 blocks at these scales, so
the last conv is drawn at a fiftieth of the default and its bias centred
on 0.5: the output then lies mostly inside [0, 1] (a standard deviation
of about 0.15) instead of being clamped.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF



def _conv_spec(key: str, cout: int, cin: int, std: float, bias_mean: float = 0.0):
    return [(f'{key}.weight', (cout, cin, 3, 3), 0.0, std), (f'{key}.bias', (cout,), bias_mean, 0.01)]


def state_dict_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], float, float]]:
    """``(key, shape, mean, std)`` of every tensor of the checkpoint."""
    nf, gc, cin, cout = cfg['num_feat'], cfg['num_grow_ch'], cfg['num_in_ch'], cfg['num_out_ch']
    spec = _conv_spec('conv_first', nf, cin, 1 / math.sqrt(9 * cin))
    for i in range(cfg['num_block']):
        for r in (1, 2, 3):
            for c in range(1, 6):
                width = nf + (c - 1) * gc
                spec += _conv_spec(f'body.{i}.rdb{r}.conv{c}', nf if c == 5 else gc, width,
                              0.1 * math.sqrt(2 / (9 * width)))
    for key in ('conv_body', 'conv_up1', 'conv_up2', 'conv_hr'):
        spec += _conv_spec(key, nf, nf, 1 / math.sqrt(9 * nf))
    spec += _conv_spec('conv_last', cout, nf, 0.02 / math.sqrt(9 * nf), bias_mean=0.5)
    return spec


def scale(cfg: dict) -> int:
    return cfg['scale']


def fixed_buffers(cfg: dict) -> dict:
    """Tensors of the checkpoint that are not weights: none."""
    return {}


def _lrelu(x):
    return TF.leaky_relu(x, 0.2)


def _conv(p: dict, key: str, x):
    return TF.conv2d(x, p[f'{key}.weight'], p[f'{key}.bias'], padding=1)


def _rdb(p: dict, key: str, x):
    feats = [x]
    for c in range(1, 5):
        feats.append(_lrelu(_conv(p, f'{key}.conv{c}', torch.cat(feats, 1))))
    return _conv(p, f'{key}.conv5', torch.cat(feats, 1)) * 0.2 + x


def forward(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The x4 forward of an NCHW batch in [0, 1]."""
    if cfg['scale'] != 4:
        raise ValueError('this reference is the x4 RRDBNet')
    feat = _conv(p, 'conv_first', x)
    body = feat
    for i in range(cfg['num_block']):
        out = body
        for r in (1, 2, 3):
            out = _rdb(p, f'body.{i}.rdb{r}', out)
        body = out * 0.2 + body
    feat = feat + _conv(p, 'conv_body', body)
    feat = _lrelu(_conv(p, 'conv_up1', TF.interpolate(feat, scale_factor=2, mode='nearest')))
    feat = _lrelu(_conv(p, 'conv_up2', TF.interpolate(feat, scale_factor=2, mode='nearest')))
    return _conv(p, 'conv_last', _lrelu(_conv(p, 'conv_hr', feat)))
