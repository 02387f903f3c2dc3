"""resselt_tpu_torch — the PyTorch/CUDA port of resselt_tpu.

Loads super-resolution checkpoints (.pth/.pt/.ckpt/.safetensors) without
running code from them, detects the architecture from the state dict's
keys, and serves the model on an NVIDIA GPU, whole-image or overlap-tiled,
with hand-written CUDA kernels on the hot path.  The public API mirrors
``resselt_tpu``; models live on ``device`` ('cuda' unless the caller asks
for 'cpu', where the kernels' plain versions run).
"""

from typing import Any, Mapping

from .archs import internal_registry
from .core import Architecture, ArchitectureNotFound, KeyCondition, ModelMetadata, Registry, SRModel

__version__ = '0.1.0'


def add(arch: Architecture) -> None:
    """Register a new architecture."""
    internal_registry.add(arch)


def get(uid: str) -> Architecture:
    """Get architecture by ID."""
    return internal_registry.get(uid)


def load_from_file(path: str, device='cuda') -> SRModel:
    """Detect and load a model from a checkpoint file onto ``device``."""
    return internal_registry.load_from_file(path, device=device)


def load_from_state_dict(state_dict: Mapping[str, Any], device='cuda') -> SRModel:
    """Detect and load a model from an in-memory numpy state dict onto ``device``."""
    return internal_registry.load_from_state_dict(state_dict, device=device)


def __getattr__(name):
    # lazy re-exports of the heavier submodules, as resselt_tpu's
    if name in ('upscale_tiled', 'upscale_padded', 'make_mesh'):
        from . import parallel

        return getattr(parallel, name)
    if name in ('save_model', 'load_model'):
        from . import cache

        return getattr(cache, name)
    raise AttributeError(name)


__all__ = [
    'add',
    'get',
    'load_from_file',
    'load_from_state_dict',
    'Architecture',
    'ArchitectureNotFound',
    'KeyCondition',
    'ModelMetadata',
    'Registry',
    'SRModel',
]
