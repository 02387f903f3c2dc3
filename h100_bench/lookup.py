"""What a cell is made of, found by name: ``<folder>/<name>.py`` under
``h100_bench/`` (``metrics``, ``paths``, ``sizes``)."""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def module(folder: str, name: str):
    """``h100_bench/<folder>/<name>.py``, loaded by its path: a name may
    hold dots (``out_mp_per_s.photos``)."""
    qualified = f'h100_bench.{folder}.{name.replace(".", "__")}'
    if qualified not in sys.modules:
        path = os.path.join(HERE, folder, f'{name}.py')
        if not os.path.isfile(path):
            raise ValueError(f'no h100_bench/{folder}/{name}.py for {name!r}')
        spec = importlib.util.spec_from_file_location(qualified, path)
        sys.modules[qualified] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[qualified])
    return sys.modules[qualified]
