"""Host ms a window on the host loop (``upscale_tiled(on_device=False)``)
in the traced window: the ``tile.batch`` spans (the program's: stack,
forward, paste) of the requests that took the host loop, over the windows
they computed, padding included."""

from ._spans import host_loop_ms_per_window, window_spans


def read(r):
    spans = window_spans(r)
    return None if spans is None else host_loop_ms_per_window(spans)
