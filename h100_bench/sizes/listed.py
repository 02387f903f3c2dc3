"""A published collection of images, one request an image:
``{"kind": "listed", "images": [{"name": ..., "width": W, "height": H}, ...]}``.
The mix's ``distinct`` is the collection's length.  The images arrive in
the collection's order for every seed: on an H100, an order drawn from the seed moved a
window's throughput by 2% from seed to seed, ten times what it moved
between two runs of one seed."""


def arrivals(spec: dict, distinct: int, rng) -> list[tuple[int, int]]:
    images = spec['images']
    if distinct != len(images):
        raise ValueError(f'a listed mix makes each of its {len(images)} images once, not {distinct}')
    return [(i['height'], i['width']) for i in images]
