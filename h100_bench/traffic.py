"""The one traffic generator.  A mix is a JSON file under ``traffic/``,
named as the mix; this module reads its parameters:

``sizes``
    The images' sizes: ``{"kind": <kind>, ...}``, read by
    ``sizes/<kind>.py`` (``fixed``: every image one size; ``listed``: a
    published collection, each image once, in its own order).  Every seed
    gets the same sizes, so the work of a window does not swing with the
    seed; the seed draws the pixels.
``distinct``
    How many distinct images are made, before the window.  The requests
    take them in turn, over again when they run out.
``path``
    How a request is served, read by ``paths/<path>.py`` (``tiled``:
    ``upscale_tiled`` at the model's hints, on the CUDA graph of the size;
    ``cli``: the CLI's rule on a folder of the distinct images).
``check_share``
    The share of requests whose pixels are kept for the correctness check,
    drawn from the seed; the largest image served is always kept.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from .lookup import module
from .seeds import numpy_rng, torch_seed

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
    with open(os.path.join(HERE, 'traffic', f'{name}.json')) as fh:
        return json.load(fh)


def arrivals(mix: dict, seed: int) -> list[tuple[int, int]]:
    """The (height, width) of the mix's distinct images in arrival order."""
    kind = module('sizes', mix['sizes']['kind'])
    return kind.arrivals(mix['sizes'], mix['distinct'], numpy_rng(seed, 'order'))


@dataclass
class Traffic:
    images: list[np.ndarray]  # (H, W, 3) uint8, in arrival order
    path: str
    check_share: float
    seed: int

    def requests(self):
        """Endless (index, image, kept-for-check) in arrival order."""
        rng = numpy_rng(self.seed, 'check')
        i = 0
        while True:
            yield i, self.images[i % len(self.images)], bool(rng.random() < self.check_share)
            i += 1

    def first_of_each_size(self) -> list[np.ndarray]:
        """One image of each distinct size: what warms every shape the
        window will serve."""
        seen, out = set(), []
        for img in self.images:
            if img.shape not in seen:
                seen.add(img.shape)
                out.append(img)
        return out


def generate(mix: dict, seed: int, device, channels: int = 3) -> Traffic:
    """The mix's images for ``seed``: pixels drawn on ``device`` in one call
    and copied to the host once."""
    shapes = [(h, w, channels) for h, w in arrivals(mix, seed)]
    counts = [h * w * c for h, w, c in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 'pixels'))
    flat = torch.randint(0, 256, (sum(counts),), generator=gen, device=device, dtype=torch.uint8).cpu().numpy()
    offsets = np.cumsum([0] + counts)
    images = [flat[offsets[k] : offsets[k + 1]].reshape(s) for k, s in enumerate(shapes)]
    return Traffic(images, mix['path'], mix['check_share'], seed)
