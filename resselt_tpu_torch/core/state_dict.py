"""State-dict canonicalization and shape-inference helpers, on
numpy-valued dicts.  Counterpart of ``resselt_tpu/core/state_dict.py``."""

from __future__ import annotations

from typing import Any, Mapping


def remove_common_prefix(state_dict: Mapping[str, Any], prefixes: list[str]) -> Mapping[str, Any]:
    if len(state_dict) > 0:
        for prefix in prefixes:
            if all(k.startswith(prefix) for k in state_dict.keys()):
                state_dict = {k[len(prefix) :]: v for k, v in state_dict.items()}
    return state_dict


def canonicalize_state_dict(state_dict: Mapping[str, Any]) -> Mapping[str, Any]:
    """Unwrap nested containers and strip DataParallel-style prefixes."""
    unwrap_keys = ['state_dict', 'params_ema', 'params-ema', 'params', 'model', 'net']
    for unwrap_key in unwrap_keys:
        if unwrap_key in state_dict and isinstance(state_dict[unwrap_key], dict):
            state_dict = state_dict[unwrap_key]
            break

    return remove_common_prefix(state_dict, ['module.', 'netG.'])


def get_seq_len(state_dict: Mapping[str, Any], seq_key: str) -> int:
    """Max index + 1 over ``{seq_key}.{i}.*`` keys."""
    prefix = seq_key + '.'
    indices: set[int] = set()
    for k in state_dict.keys():
        if k.startswith(prefix):
            index = k[len(prefix) :].split('.', maxsplit=1)[0]
            try:
                indices.add(int(index))
            except ValueError:
                continue
    if not indices:
        return 0
    return max(indices) + 1
