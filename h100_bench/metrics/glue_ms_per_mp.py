"""Device ms of every kernel that is not one of the program's own
(``csrc/*.cu``) per output megapixel, in the traced window."""

from ..trace import kernel_base_name


def read(r):
    if r.trace is None:
        return None
    own = set().union(*r.csrc.values())
    mp = sum(q.out_px for q in r.trace_records) / 1e6
    return 1e3 * r.trace.kernel_seconds(lambda name: kernel_base_name(name) not in own) / mp
