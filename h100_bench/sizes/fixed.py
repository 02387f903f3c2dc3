"""Every image one size: ``{"kind": "fixed", "height": H, "width": W}``."""


def arrivals(spec: dict, distinct: int, rng) -> list[tuple[int, int]]:
    return [(spec['height'], spec['width'])] * distinct
