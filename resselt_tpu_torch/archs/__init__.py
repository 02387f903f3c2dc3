"""Architecture registration with an explicit, deterministic order.

Counterpart of ``resselt_tpu/archs/__init__.py``: the same 31 families in
the same order (strong fingerprints first, the weak single-key spanplus
last), so that a state dict detects as the same family in both packages.
"""

from __future__ import annotations

import importlib

from ..core import Registry

_ARCH_MODULES: list[str] = [
    'swinir', 'hat', 'omni', 'drct', 'fdat', 'dat', 'rgt', 'atd', 'spanpp', 'span', 'esrgan', 'plksr', 'mosrv2',
    'moesr', 'rtmosr', 'smosr', 'rha', 'flexnet', 'gaterv3', 'gaterv2', 'lawfft', 'gfisrv2', 'figsr', 'gfisr',
    'gater', 'cugan', 'rcan', 'eimn', 'mosr', 'compact', 'spanplus',
]

internal_registry = Registry()

for _mod_name in _ARCH_MODULES:
    internal_registry.add(importlib.import_module(f'{__name__}.{_mod_name}').ARCH)
