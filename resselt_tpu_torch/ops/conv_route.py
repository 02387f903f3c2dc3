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
such conv (``skip``: transposed convs), which are only cast.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Collection, Mapping

import torch

from ..nn import functional as F
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
    groups."""

    w: torch.Tensor
    b: torch.Tensor | None
    kernel: bool
    padding: tuple[int, int] = (0, 0)
    groups: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        """The OIHW weight's shape."""
        if self.kernel:
            return (self.w.shape[2], self.w.shape[1], 3, 3)
        return tuple(self.w.shape)


def prepare_conv(w: torch.Tensor, b: torch.Tensor | None, dtype: torch.dtype, groups: int = 1) -> Conv:
    """A same-padded conv with OIHW weight ``w`` for inputs of ``dtype``."""
    if routes_to_kernel(w.shape, groups):
        return Conv(pack_conv3x3_weight(w, dtype), None if b is None else b.float().contiguous(), True, (1, 1))
    return Conv(w.to(dtype), None if b is None else b.to(dtype), False, (w.shape[-2] // 2, w.shape[-1] // 2),
                groups)


def prepare_convs(params: Mapping[str, torch.Tensor], dtype: torch.dtype,
                  groups: Mapping[str, int] | None = None, skip: Collection[str] = ()) -> dict:
    """The weights a family's ``apply`` reads: every floating param cast to
    ``dtype`` under its own key, and every conv (a 4-D ``{name}.weight``
    whose ``name`` is not in ``skip``) as a :class:`Conv` under ``name``,
    with ``groups[name]`` (default 1).  A routed conv's OIHW weight is
    dropped: its taps replace it."""
    groups = groups or {}
    out = {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}
    for key, w in params.items():
        if key.endswith('.weight') and w.ndim == 4 and key[: -len('.weight')] not in skip:
            name = key[: -len('.weight')]
            c = prepare_conv(w, params.get(f'{name}.bias'), dtype, groups.get(name, 1))
            out[name] = c
            if c.kernel:
                del out[key]
    return out


def conv(c: Conv, x: torch.Tensor, act: str = 'linear') -> torch.Tensor:
    """Run ``c`` on NHWC ``x``, then ``act``: fused in the kernel for a
    routed conv (which reads a contiguous copy of a channel slice), after
    ``F.conv2d`` for the others."""
    if c.kernel:
        return fused_conv3x3_act(x.contiguous(), c.w, c.b, act)
    return _ACTS[act](F.conv2d(x, c.w, c.b, padding=c.padding, groups=c.groups))
