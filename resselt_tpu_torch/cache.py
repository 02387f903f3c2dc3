"""Converted-model cache: save/load an SRModel's transformed params.

Counterpart of ``resselt_tpu/cache.py``, with its ``.npz`` layout: the
param arrays plus a JSON ``__header__`` (format version 1) holding the
arch id, the config dataclass's module, class and fields, the metadata and
the four serving hints.  Loading a cache skips pickle parsing, key remaps
and reparameterization collapses.  A cache that the JAX package wrote
loads here too: its header's module string ``resselt_tpu.archs.<m>`` names
this package's ``resselt_tpu_torch.archs.<m>``, whose config class and
``apply`` / ``prepare`` take the same params (nothing of JAX is imported).
int8 weights and their ``.weight_scale`` round-trip.
"""

from __future__ import annotations

import dataclasses
import importlib
import json

import numpy as np

from .core import ModelMetadata, SRModel, params_from_numpy

_FORMAT_VERSION = 1
_PREFIX = 'resselt_tpu_torch.archs.'
_JAX_PREFIX = 'resselt_tpu.archs.'


def save_model(model: SRModel, path: str) -> None:
    """Serialize a loaded model (transformed params + config) to ``path``."""
    cfg = model.config
    header = {
        'format_version': _FORMAT_VERSION,
        'arch_id': model.arch_id,
        'config_module': type(cfg).__module__,
        'config_class': type(cfg).__name__,
        'config': dataclasses.asdict(cfg),
        'metadata': {
            'in_channels': model.metadata.in_channels,
            'out_channels': model.metadata.out_channels,
            'upscale': model.metadata.upscale,
            'name': model.metadata.name,
        },
        # the loader's serving hints survive the round trip: the cache exists for serving
        'tile_batch': model.tile_batch,
        'serving_tile': model.serving_tile,
        'serving_halo': model.serving_halo,
        'size_multiple': model.size_multiple,
    }
    arrays = {k: v.detach().cpu().numpy() for k, v in model.params.items()}
    np.savez(path, __header__=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8), **arrays)


def _restore_tuples(cls, values: dict):
    """dataclasses.asdict turns tuples into lists; restore per-field types."""
    out = {}
    hints = {f.name: f.type for f in dataclasses.fields(cls)}
    for k, v in values.items():
        if isinstance(v, list) and 'tuple' in str(hints.get(k, '')):
            out[k] = tuple(v)
        else:
            out[k] = v
    return out


def load_model(path: str, device='cuda') -> SRModel:
    """Load a model saved with :func:`save_model` (or with the JAX package's)
    onto ``device``."""
    with np.load(path) as data:
        header = json.loads(bytes(data['__header__']).decode())
        params = {k: data[k] for k in data.files if k != '__header__'}
    if header['format_version'] != _FORMAT_VERSION:
        raise ValueError(f'Unsupported cache format version {header["format_version"]}')

    # A hostile cache file must not be able to import arbitrary modules
    # (import alone executes code): only this package's arch modules qualify.
    mod_name = header['config_module']
    if isinstance(mod_name, str) and mod_name.startswith(_JAX_PREFIX):
        mod_name = _PREFIX + mod_name[len(_JAX_PREFIX):]
    if not isinstance(mod_name, str) or not mod_name.startswith(_PREFIX):
        raise ValueError(f'Cache header names a non-architecture module: {header["config_module"]!r}')
    module = importlib.import_module(mod_name)
    cfg_cls = getattr(module, header['config_class'])
    if not (dataclasses.is_dataclass(cfg_cls) and callable(getattr(module, 'apply', None))):
        raise ValueError(f'{mod_name}.{header["config_class"]} is not an architecture config')
    cfg = cfg_cls(**_restore_tuples(cfg_cls, header['config']))

    meta = ModelMetadata(**header['metadata'])
    model = SRModel(header['arch_id'], cfg, params_from_numpy(params, device), meta, module.apply,
                    getattr(module, 'prepare', None))
    model.tile_batch = header.get('tile_batch')
    model.serving_tile = header.get('serving_tile')
    model.serving_halo = header.get('serving_halo')
    model.size_multiple = header.get('size_multiple')
    return model
