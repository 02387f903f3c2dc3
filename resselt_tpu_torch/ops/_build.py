"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``_build/<name>-<hash>.so``, at
first use, and loaded with ``ctypes``.  The hash covers the sources under
``csrc/`` and the compiler flags, so a changed source is rebuilt.  A build
failure raises with the compiler's output.  ``nvcc -Xptxas -v``'s report
(registers, shared memory, spills) is kept beside the library as
``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith('.cu'))


def _nvcc() -> str:
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.isfile(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA kernels cannot be built')
    return found


def _library_path(name: str) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f.endswith(('.cu', '.cuh', '.h')):
            with open(os.path.join(CSRC, f), 'rb') as fh:
                h.update(f.encode() + b'\0' + fh.read())
    return os.path.join(BUILD_DIR, f'{name}-{h.hexdigest()[:16]}.so')


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds each
    build took (0.0 for one already built); raises if any build fails."""
    names = sources() if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    took = {}
    for name in names:
        out = _library_path(name)
        if os.path.exists(out):
            took[name] = 0.0
            continue
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC, f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        with open(out[:-3] + '.log', 'w') as fh:
            fh.write(log)
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
    return took


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``."""
    path = _library_path(name)[:-3] + '.log'
    if not os.path.exists(path):
        return ''
    with open(path) as fh:
        return fh.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(_library_path(name))
        return lib
