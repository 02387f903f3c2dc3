"""A configuration's checkpoint made from the seed: every weight drawn on
the device in one call, scaled per tensor, and copied to the host once,
under the published key names that the reference module lists."""

from __future__ import annotations

import numpy as np
import torch

from .seeds import torch_seed


def make_state_dict(reference, cfg: dict, seed: int, device) -> dict[str, np.ndarray]:
    """``{key: float32 or int64 array}``: the weights of
    ``reference.state_dict_spec(cfg)`` drawn from ``seed``, and the
    buffers of ``reference.fixed_buffers(cfg)``."""
    spec = reference.state_dict_spec(cfg)
    counts = torch.tensor([int(np.prod(shape)) for _, shape, _, _ in spec], device=device)
    means = torch.tensor([m for _, _, m, _ in spec], dtype=torch.float32, device=device)
    stds = torch.tensor([s for _, _, _, s in spec], dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 'weights'))
    flat = torch.randn(int(counts.sum()), generator=gen, device=device)
    flat = flat * torch.repeat_interleave(stds, counts) + torch.repeat_interleave(means, counts)
    host = flat.cpu().numpy()
    out, offset = {}, 0
    for key, shape, _, _ in spec:
        n = int(np.prod(shape))
        out[key] = host[offset : offset + n].reshape(shape)
        offset += n
    out.update(reference.fixed_buffers(cfg))
    return out
