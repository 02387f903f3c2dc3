"""Architecture registration with an explicit, deterministic order.

Counterpart of ``resselt_tpu/archs/__init__.py``.  The JAX package registers
31 families in this order (strong fingerprints first, the weak single-key
spanplus last): swinir, hat, omni, drct, fdat, dat, rgt, atd, spanpp, span,
esrgan, plksr, mosrv2, moesr, rtmosr, smosr, rha, flexnet, gaterv3,
gaterv2, lawfft, gfisrv2, figsr, gfisr, gater, cugan, rcan, eimn, mosr,
compact, spanplus.  ``_ARCH_MODULES`` lists the families the port has, in
that order; a later slice inserts its family where that order puts it.
"""

from __future__ import annotations

import importlib

from ..core import Registry

_ARCH_MODULES: list[str] = [
    'swinir', 'hat', 'omni', 'drct', 'fdat', 'dat', 'rgt', 'atd', 'spanpp', 'span', 'esrgan', 'plksr', 'mosrv2',
    'moesr', 'gaterv3', 'gaterv2', 'gater', 'cugan', 'rcan', 'eimn', 'mosr', 'compact', 'spanplus',
]

internal_registry = Registry()

for _mod_name in _ARCH_MODULES:
    internal_registry.add(importlib.import_module(f'{__name__}.{_mod_name}').ARCH)
