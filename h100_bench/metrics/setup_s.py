"""Seconds from the process's start to the window's start."""


def read(r):
    return r.setup_s
