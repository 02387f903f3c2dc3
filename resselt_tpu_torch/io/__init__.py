"""Checkpoint ingestion: torch pickle (zip + legacy), safetensors, TorchScript.

The readers are numpy-only and never run code from a checkpoint; they
produce numpy-valued state dicts.  Counterpart of ``resselt_tpu/io``.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Mapping

from .safetensors_io import read_safetensors, write_safetensors
from .torch_pickle import UnsafeCheckpointError, read_torch_checkpoint, read_torchscript_state_dict

__all__ = [
    'load_state_dict_from_file', 'read_safetensors', 'write_safetensors',
    'read_torch_checkpoint', 'read_torchscript_state_dict', 'UnsafeCheckpointError',
]


def _is_torchscript(path: str) -> bool:
    try:
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
        return any(n.endswith('constants.pkl') for n in names)
    except zipfile.BadZipFile:
        return False


def _read_torchscript_state_dict(path: str) -> Mapping[str, Any]:
    """TorchScript ``.pt``: read the state dict from the archive's data.pkl
    object tree with the pure reader; archives it rejects (opaque
    __getstate__ objects) go through ``torch.jit.load``."""
    try:
        return read_torchscript_state_dict(path)
    except Exception:
        import torch

        module = torch.jit.load(path, map_location='cpu')
        return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def load_state_dict_from_file(path: str) -> Mapping[str, Any]:
    """Read a checkpoint file into a (possibly nested) numpy state dict."""
    extension = os.path.splitext(path)[1].lower()
    if extension == '.pt':
        if _is_torchscript(path):
            return _read_torchscript_state_dict(path)
        return read_torch_checkpoint(path)
    if extension in ('.pth', '.ckpt'):
        return read_torch_checkpoint(path)
    if extension == '.safetensors':
        return read_safetensors(path)
    raise ValueError(f'Unsupported model file extension {extension}. Please try a supported model type.')
