"""Seconds of the loader: detection and config inference
(``load_from_state_dict``) and the first ``weights(dtype)`` (prepare)."""


def read(r):
    return r.load_s
