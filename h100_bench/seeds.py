"""Seeds of the run's independent streams (weights, pixels, arrivals,
samples), each derived from ``--seed`` and the stream's name.  Any whole
number is a seed, negative or past 64 bits."""

from __future__ import annotations

import hashlib

import numpy as np


def _words(seed: int, stream: str) -> list[int]:
    digest = hashlib.sha256(f'{int(seed)}/{stream}'.encode()).digest()
    return [int.from_bytes(digest[i : i + 4], 'little') for i in range(0, 16, 4)]


def numpy_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(_words(seed, stream))


def torch_seed(seed: int, stream: str) -> int:
    """A seed for ``torch.Generator.manual_seed``, below 2**63."""
    w = _words(seed, stream)
    return (w[0] | w[1] << 32) & (2**63 - 1)
