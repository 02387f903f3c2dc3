"""What the roofline readers share."""

from ..trace import kernel_base_name


def roofline_pct(r, counter: str, source: str, bound_of) -> float | None:
    """100 x the bound of every launch of ``counter`` in the traced window
    (``bound_of(shape key)`` seconds) over the device seconds of the
    kernels of ``csrc/<source>``; None where none ran."""
    if r.trace is None:
        return None
    names = r.csrc.get(source, set())
    seconds = r.trace.kernel_seconds(lambda name: kernel_base_name(name) in names)
    launches = r.launches.get(counter)
    if not seconds or not launches:
        return None
    return 100.0 * sum(n * bound_of(key) for key, n in launches.items()) / seconds
