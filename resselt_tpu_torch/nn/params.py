"""Param-tree access helpers.

Params are flat dicts keyed by checkpoint names.  ``PTree`` is a thin view
that scopes key prefixes so arch code reads like module code::

    p = PTree(params)
    y = p.conv('body.0', x, padding=1)

Counterpart of ``resselt_tpu/nn/params.py``.
"""

from __future__ import annotations

from typing import Mapping

from . import functional as F


class PTree:
    __slots__ = ('_d', '_prefix')

    def __init__(self, d: Mapping, prefix: str = ''):
        self._d = d
        self._prefix = prefix

    def sub(self, name) -> 'PTree':
        return PTree(self._d, f'{self._prefix}{name}.')

    def __getitem__(self, key: str):
        return self._d[self._prefix + str(key)]

    def get(self, key: str, default=None):
        return self._d.get(self._prefix + str(key), default)

    def __contains__(self, key: str) -> bool:
        return (self._prefix + str(key)) in self._d

    def shape(self, key: str):
        """The shape of one tensor; of a conv that ``ops.conv_route``
        prepared, ``{name}.weight`` is its OIHW weight's shape."""
        k = self._prefix + str(key)
        if k not in self._d and k.endswith('.weight'):
            return self._d[k[: -len('.weight')]].shape
        return self._d[k].shape

    def keys(self):
        n = len(self._prefix)
        return [k[n:] for k in self._d.keys() if k.startswith(self._prefix)]

    def wb(self, name: str):
        """(weight, bias-or-None) pair for a submodule."""
        return self[f'{name}.weight'], self.get(f'{name}.bias')

    def conv(self, name: str, x, stride=1, padding=0, dilation=1, groups=1):
        """A conv of these params, or one that ``ops.conv_route`` prepared
        under ``name`` (the 3x3 kernel or ``F.conv2d``; it must be the conv
        asked for: stride and dilation 1, its own padding and groups)."""
        prepared = self.get(name)
        if prepared is None:
            w, b = self.wb(name)
            return F.conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation, groups=groups)
        from ..ops.conv_route import conv

        kh, kw = prepared.shape[-2:]
        want = (kh // 2, kw // 2) if padding == 'same' else F._pair(padding)
        if (stride, dilation) != (1, 1) or want != (kh // 2, kw // 2) or groups != prepared.groups:
            raise ValueError(f'{self._prefix}{name}: prepared as a same-padded conv with groups '
                             f'{prepared.groups}, asked for stride {stride}, padding {padding}, groups {groups}')
        return conv(prepared, x)

    def linear(self, name: str, x):
        w, b = self.wb(name)
        return F.linear(x, w, b)

    def layer_norm(self, name: str, x, eps: float = 1e-5):
        return F.layer_norm(x, self.get(f'{name}.weight'), self.get(f'{name}.bias'), eps=eps)

    def batch_norm(self, name: str, x, eps: float = 1e-5):
        return F.batch_norm_2d(x, self[f'{name}.weight'], self[f'{name}.bias'], self[f'{name}.running_mean'],
                               self[f'{name}.running_var'], eps=eps)
