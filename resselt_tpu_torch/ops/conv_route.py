"""The one static rule that sends a family's conv to the 3x3 kernel.

A conv with a 3x3 kernel, stride 1, dilation 1, groups 1 and padding 1
runs :func:`fused_conv3x3_act` (``csrc/conv3x3.cu``), with the activation
that follows it fused when that is one of the kernel's (linear, lrelu 0.2,
silu, mish).  Every other conv (1x1, grouped or depthwise, k != 3, the
1 x k and k x 1 bands) runs ``F.conv2d`` and then that activation.  A
family's ``prepare`` builds its convs once per compute dtype
(:func:`prepare_convs`: the taps packed for the kernel, or the weight cast
for ``F.conv2d``); its ``apply`` runs them with :func:`conv`, and the shared
upsamplers reach them through ``PTree.conv``.  There is no switch: on a
CUDA tensor a routed conv launches the kernel or raises; on a CPU tensor
the kernel's plain version runs.

Every conv built here is stride 1, dilation 1, with the same padding
(``(kh // 2, kw // 2)``), as every conv of the families that use it.  The
family names its grouped convs (``groups``: a grouped 3x3 weight would
otherwise be packed as a narrow-Cin conv) and the 4-D weights that are no
such conv (``skip``: transposed convs), which are only cast.  An int8
weight of a quantized model (``SRModel.quantize_int8``) with its
``.weight_scale`` becomes an int8 conv, which runs ``F.conv2d_int8``
whatever its kernel size: the 3x3 kernel reads float taps only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Collection, Mapping

import torch

from ..nn import functional as F
from ..nn.params import cast_params, quiet, record_int8_safe
from .fused_conv import fused_conv3x3_act, pack_conv3x3_weight

# the plain path's activations, the kernel's four
_ACTS = {
    'linear': lambda y: y,
    'lrelu': lambda y: F.leaky_relu(y, 0.2),
    'silu': F.silu,
    'mish': F.mish,
}


def routes_to_kernel(w_shape, groups: int = 1) -> bool:
    """Whether a same-padded, stride-1 conv of weight shape ``w_shape``
    (OIHW) runs the 3x3 kernel: a 3x3 kernel (so padding 1) and groups 1."""
    return len(w_shape) == 4 and tuple(w_shape[2:]) == (3, 3) and groups == 1


@dataclass(frozen=True)
class Conv:
    """One conv, ready for :func:`conv`: ``kernel`` True holds the packed
    taps ``(9, Cin, Cout)`` in the compute dtype and an f32 bias; False the
    OIHW weight and bias in the compute dtype, its (ph, pw) padding and
    groups, or, with an f32 ``scale``, the int8 OIHW weight and an f32
    bias.  ``key``: the ``{name}.weight`` it was built from, for int8
    discovery (None for a weight a family built itself)."""

    w: torch.Tensor
    b: torch.Tensor | None
    kernel: bool
    padding: tuple[int, int] = (0, 0)
    groups: int = 1
    scale: torch.Tensor | None = None
    key: str | None = None

    @property
    def shape(self) -> tuple[int, ...]:
        """The OIHW weight's shape."""
        if self.kernel:
            return (self.w.shape[2], self.w.shape[1], 3, 3)
        return tuple(self.w.shape)


def prepare_conv(w: torch.Tensor, b: torch.Tensor | None, dtype: torch.dtype, groups: int = 1,
                 scale: torch.Tensor | None = None, key: str | None = None) -> Conv:
    """A same-padded conv with OIHW weight ``w`` for inputs of ``dtype``;
    an int8 ``w`` needs its per-out-channel ``scale``."""
    padding = (w.shape[-2] // 2, w.shape[-1] // 2)
    if w.dtype == torch.int8:
        if scale is None or groups != 1:
            raise ValueError(f'int8 conv {key}: needs its scale and groups 1, got groups {groups}')
        return Conv(w, None if b is None else b.float(), False, padding, 1, scale.float(), key)
    if routes_to_kernel(w.shape, groups):
        return Conv(pack_conv3x3_weight(w, dtype), None if b is None else b.float().contiguous(), True, (1, 1),
                    key=key)
    return Conv(w.to(dtype), None if b is None else b.to(dtype), False, padding, groups, key=key)


def prepare_named_conv(params: Mapping[str, torch.Tensor], name: str, dtype: torch.dtype, groups: int = 1) -> Conv:
    """:func:`prepare_conv` of the params' ``{name}.weight`` with its bias
    and, for an int8 weight, its ``.weight_scale``; the int8-aware read of
    discovery (``nn.params``), recorded when :func:`conv` runs it."""
    params = quiet(params)
    key = f'{name}.weight'
    return prepare_conv(params[key], params.get(f'{name}.bias'), dtype, groups, params.get(f'{key}_scale'), key)


def prepare_convs(params: Mapping[str, torch.Tensor], dtype: torch.dtype,
                  groups: Mapping[str, int] | None = None, skip: Collection[str] = ()) -> dict:
    """The weights a family's ``apply`` reads: every floating param cast to
    ``dtype`` under its own key (:func:`cast_params`), and every conv (a
    4-D ``{name}.weight`` whose ``name`` is not in ``skip``) as a
    :class:`Conv` under ``name``, with ``groups[name]`` (default 1).  A
    routed conv's OIHW weight is dropped: its taps replace it."""
    groups = groups or {}
    params = quiet(params)
    out = cast_params(params, dtype)
    for key, w in params.items():
        if key.endswith('.weight') and w.ndim == 4 and key[: -len('.weight')] not in skip:
            name = key[: -len('.weight')]
            c = out[name] = prepare_named_conv(params, name, dtype, groups.get(name, 1))
            if c.kernel:
                del out[key]
    return out


def conv(c: Conv, x: torch.Tensor, act: str = 'linear') -> torch.Tensor:
    """Run ``c`` on NHWC ``x``, then ``act``: fused in the kernel for a
    routed conv (which reads a contiguous copy of a channel slice), after
    ``F.conv2d`` or ``F.conv2d_int8`` for the others."""
    if c.key is not None and c.groups == 1:
        record_int8_safe(c.key)
    if c.kernel:
        return fused_conv3x3_act(x.contiguous(), c.w, c.b, act)
    if c.scale is not None:
        return _ACTS[act](F.conv2d_int8(x, c.w, c.scale, c.b, padding=c.padding))
    return _ACTS[act](F.conv2d(x, c.w, c.b, padding=c.padding, groups=c.groups))
