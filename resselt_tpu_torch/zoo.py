"""Synthetic checkpoints: random numpy state dicts with the exact
key and shape layout the detection tables fingerprint, made from a seed.

Counterpart of ``resselt_tpu/zoo.py``, holding ``make_esrgan``.
"""

from __future__ import annotations

import math

import numpy as np


class _Maker:
    def __init__(self, seed: int = 0, std: float = 0.03):
        self.rng = np.random.default_rng(seed)
        self.std = std
        self.sd: dict[str, np.ndarray] = {}

    def t(self, key: str, *shape: int):
        self.sd[key] = (self.rng.standard_normal(shape) * self.std).astype(np.float32)

    def conv(self, key: str, cout: int, cin: int, k: int = 3):
        self.t(f'{key}.weight', cout, cin, k, k)
        self.t(f'{key}.bias', cout)


def make_esrgan(num_filters: int = 64, num_blocks: int = 23, scale: int = 4, in_nc: int = 3, out_nc: int = 3, gc: int = 32, seed: int = 0):
    """RRDBNet old-arch layout."""
    m = _Maker(seed)
    nf = num_filters
    m.conv('model.0', nf, in_nc, 3)
    for b in range(num_blocks):
        for r in (1, 2, 3):
            base = f'model.1.sub.{b}.RDB{r}'
            for ci in range(1, 6):
                cin = nf + (ci - 1) * gc
                cout = gc if ci < 5 else nf
                m.conv(f'{base}.conv{ci}.0', cout, cin, 3)
    m.conv(f'model.1.sub.{num_blocks}', nf, nf, 3)
    n_up = int(math.log2(scale)) if scale != 3 else 1
    for i in range(1, n_up + 1):
        m.conv(f'model.{3 * i}', nf, nf, 3)
    m.conv(f'model.{3 * n_up + 2}', nf, nf, 3)
    m.conv(f'model.{3 * n_up + 4}', out_nc, nf, 3)
    return m.sd
