"""Architecture registry with an explicit, deterministic order.
Counterpart of ``resselt_tpu/core/registry.py``; loading takes the device
the model's weights go to."""

from __future__ import annotations

import logging
from typing import Any, Iterator, Mapping

from .. import tracing
from ..io import load_state_dict_from_file
from .factory import Architecture, SRModel
from .state_dict import canonicalize_state_dict


logger = logging.getLogger('resselt_tpu_torch.registry')


class ArchitectureNotFound(Exception):
    pass


class Registry:
    def __init__(self):
        self.store: dict[str, Architecture] = {}

    def __contains__(self, uid: str) -> bool:
        return uid in self.store

    def __iter__(self) -> Iterator[Architecture]:
        return iter(list(self.store.values()))

    def __len__(self) -> int:
        return len(self.store)

    def add(self, arch: Architecture) -> None:
        self.store[arch.id] = arch

    def get(self, uid: str) -> Architecture:
        try:
            return self.store[uid]
        except KeyError:
            raise ArchitectureNotFound(uid) from None

    def load_from_file(self, path: str, device='cuda') -> SRModel:
        state_dict = load_state_dict_from_file(path)
        return self.load_from_state_dict(state_dict, device=device)

    def load_from_state_dict(self, state_dict: Mapping[str, Any], device='cuda') -> SRModel:
        """Canonicalize the keys and detect the architecture (the span
        ``load.detect``), then build the model with its params on
        ``device`` (``load.build``), inside the span ``load``."""
        with tracing.span('load') as span:
            with tracing.span('load.detect'):
                state_dict = canonicalize_state_dict(state_dict)
                architecture = next((a for a in self.store.values() if a.detect(state_dict)), None)
            if architecture is None:
                raise ArchitectureNotFound(
                    'No registered architecture matches the checkpoint key fingerprint '
                    f'({len(state_dict)} keys).'
                )
            span.set(arch=architecture.id, tensors=len(state_dict))
            with tracing.span('load.build'):
                model = architecture.load(state_dict, device)
        logger.info(
            'detected %s (%s): upscale=%s in=%d out=%d, %d params on %s',
            architecture.id, model.metadata.name, model.metadata.upscale,
            model.metadata.in_channels, model.metadata.out_channels, len(model.params),
            model.device,
        )
        return model
