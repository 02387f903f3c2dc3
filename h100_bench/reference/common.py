"""What the references share: float32 products without TF32 on the card.
Nothing here imports the program under test."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_precision():
    """Float32 convolutions and products without TF32, inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
