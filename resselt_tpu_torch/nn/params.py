"""Param-tree access helpers.

Params are flat dicts keyed by checkpoint names.  ``PTree`` is a thin view
that scopes key prefixes so arch code reads like module code::

    p = PTree(params)
    y = p.conv('body.0', x, padding=1)

Counterpart of ``resselt_tpu/nn/params.py``.
"""

from __future__ import annotations

from typing import Mapping

import torch

from . import functional as F

#: int8-eligibility discovery (``quant``): while set (to a dict with
#: 'safe'/'raw' key sets), param reads are recorded -- an int8-aware
#: consumer (``PTree.conv``, ``PTree.conv_weight_int8``, a groups-1
#: ``ops.conv_route.conv``) marks its weight int8-SAFE, any other read of a
#: ``.weight`` key taints it.  A key both safe and tainted stays float (it
#: is consumed by a second, non-int8-aware op).  Set only inside
#: ``SRModel.quantize_int8``'s discovery run; None in normal operation.
_INT8_DISCOVERY = None


def record_int8_safe(full_key: str) -> None:
    """Mark a weight key as consumed by an int8-aware op (see PTree.conv);
    for arch code with a bespoke int8 path (e.g. esrgan's RDB)."""
    if _INT8_DISCOVERY is not None:
        _INT8_DISCOVERY['safe'].add(full_key)


def _record_raw(full_key: str) -> None:
    if _INT8_DISCOVERY is not None and full_key.endswith('.weight'):
        _INT8_DISCOVERY['raw'].add(full_key)


class RecordingParams(Mapping):
    """A params (or prepared weights) dict as the discovery run hands it to a
    family's ``prepare`` and ``apply``: a read of a ``.weight`` key by key
    taints it, as ``PTree``'s own reads do, so that a weight a ``prepare``
    repacks, concatenates or slices, or an ``apply`` reads raw, stays
    float.  Iteration (``items()``, ``values()``: casting every param)
    reads no weight; an int8-aware consumer reads through :func:`quiet`."""

    def __init__(self, data: Mapping):
        self.data = data

    def __getitem__(self, key):
        _record_raw(key)
        return self.data[key]

    def __iter__(self):
        return iter(self.data)

    def __len__(self) -> int:
        return len(self.data)

    def __contains__(self, key) -> bool:
        return key in self.data

    def items(self):
        return self.data.items()

    def values(self):
        return self.data.values()


def quiet(d: Mapping) -> Mapping:
    """``d`` without discovery's recording: for the int8-aware consumers."""
    return d.data if isinstance(d, RecordingParams) else d


def cast_params(params: Mapping[str, torch.Tensor], dtype: torch.dtype) -> dict:
    """Every floating param in ``dtype``; int8 weights and their f32
    ``.weight_scale`` stay as they are."""
    return {k: v.to(dtype) if v.is_floating_point() and not k.endswith('.weight_scale') else v
            for k, v in params.items()}


#: the key under which a family's ``prepare`` keeps :func:`input_mean`
MEAN = 'input_mean'


def input_mean(params: Mapping[str, torch.Tensor], values, dtype: torch.dtype) -> torch.Tensor:
    """``values``, the mean a family's forward subtracts from its input, as a
    ``dtype`` tensor on the params' device.  A ``prepare`` builds it: in a
    forward, the host-to-device copy would be refused under CUDA graph
    capture."""
    return torch.tensor(values, dtype=dtype, device=next(iter(params.values())).device)


class PTree:
    __slots__ = ('_d', '_prefix')

    def __init__(self, d: Mapping, prefix: str = ''):
        self._d = d
        self._prefix = prefix

    def sub(self, name) -> 'PTree':
        return PTree(self._d, f'{self._prefix}{name}.')

    def __getitem__(self, key: str):
        k = self._prefix + str(key)
        _record_raw(k)
        return self._d[k]

    def get(self, key: str, default=None):
        k = self._prefix + str(key)
        if k in self._d:
            _record_raw(k)
        return self._d.get(k, default)

    def __contains__(self, key: str) -> bool:
        return (self._prefix + str(key)) in self._d

    def shape(self, key: str):
        """The shape of one tensor; of a conv that ``ops.conv_route``
        prepared, ``{name}.weight`` is its OIHW weight's shape.  A
        shape-only read: it does not count as consumption for int8
        discovery."""
        d = quiet(self._d)
        k = self._prefix + str(key)
        if k not in d and k.endswith('.weight'):
            return d[k[: -len('.weight')]].shape
        return d[k].shape

    def keys(self):
        n = len(self._prefix)
        return [k[n:] for k in self._d.keys() if k.startswith(self._prefix)]

    def wb(self, name: str):
        """(weight, bias-or-None) pair for a submodule."""
        return self[f'{name}.weight'], self.get(f'{name}.bias')

    def conv(self, name: str, x, stride=1, padding=0, dilation=1, groups=1):
        """A conv of these params, or one that ``ops.conv_route`` prepared
        under ``name`` (the 3x3 kernel, ``F.conv2d`` or ``F.conv2d_int8``;
        it must be the conv asked for: stride and dilation 1, its own
        padding and groups).  The int8-aware consumer: an int8 weight runs
        ``F.conv2d_int8`` with its ``.weight_scale``."""
        d = quiet(self._d)
        key = f'{self._prefix}{name}'
        if groups == 1:
            record_int8_safe(f'{key}.weight')
        prepared = d.get(key)
        if prepared is None:
            w, b = d[f'{key}.weight'], d.get(f'{key}.bias')
            if w.dtype == torch.int8:
                if groups != 1:
                    raise ValueError(f'int8 conv {name!r} with groups={groups} (ineligible shape quantized?)')
                return F.conv2d_int8(x, w, d[f'{key}.weight_scale'], b, stride=stride, padding=padding,
                                     dilation=dilation)
            return F.conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation, groups=groups)
        from ..ops.conv_route import conv

        kh, kw = prepared.shape[-2:]
        want = (kh // 2, kw // 2) if padding == 'same' else F._pair(padding)
        if (stride, dilation) != (1, 1) or want != (kh // 2, kw // 2) or groups != prepared.groups:
            raise ValueError(f'{key}: prepared as a same-padded conv with groups '
                             f'{prepared.groups}, asked for stride {stride}, padding {padding}, groups {groups}')
        return conv(prepared, x)

    def conv_weight_int8(self, name: str):
        """(weight, scale-or-None) with int8-SAFE discovery recording, for
        arch code with its own int8 path (esrgan's RDB)."""
        d = quiet(self._d)
        k = f'{self._prefix}{name}.weight'
        record_int8_safe(k)
        w = d[k]
        if w.dtype == torch.int8:
            return w, d[k + '_scale']
        return w, None

    def linear(self, name: str, x):
        w, b = self.wb(name)
        return F.linear(x, w, b)

    def layer_norm(self, name: str, x, eps: float = 1e-5):
        return F.layer_norm(x, self.get(f'{name}.weight'), self.get(f'{name}.bias'), eps=eps)

    def batch_norm(self, name: str, x, eps: float = 1e-5):
        return F.batch_norm_2d(x, self[f'{name}.weight'], self[f'{name}.bias'], self[f'{name}.running_mean'],
                               self[f'{name}.running_var'], eps=eps)
