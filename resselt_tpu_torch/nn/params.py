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

    def keys(self):
        n = len(self._prefix)
        return [k[n:] for k in self._d.keys() if k.startswith(self._prefix)]

    def wb(self, name: str):
        """(weight, bias-or-None) pair for a submodule."""
        return self[f'{name}.weight'], self.get(f'{name}.bias')

    def conv(self, name: str, x, stride=1, padding=0, dilation=1, groups=1):
        w, b = self.wb(name)
        return F.conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation, groups=groups)
