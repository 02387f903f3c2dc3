"""Training data pipeline: native (C++) batch sampler + prefetching.

Counterpart of ``resselt_tpu/data.py``, with the same behaviour.  The hot
host-side work (random HR crops, flips, and exact box-downsampled LR pairs)
runs in a multi-threaded C++ sampler (``native/sampler.cpp``, the JAX
package's, built at first use with the system ``g++`` into ``_build/`` and
driven via ctypes), overlapped with the GPU step by a one-deep background
prefetch thread.  A pure-numpy sampler with identical semantics is the
fallback of ``backend='auto'`` and the exactness oracle; ``backend=
'native'`` raises instead of falling back.  The batches are numpy arrays;
the caller moves them to the card (``train_sr.py``: from pinned memory).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import queue
import subprocess
import threading

import numpy as np

logger = logging.getLogger('resselt_tpu_torch.data')

_PKG = os.path.dirname(os.path.abspath(__file__))
NATIVE_SOURCE = os.path.join(_PKG, 'native', 'sampler.cpp')
BUILD_DIR = os.path.join(_PKG, '_build')
GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')


def _build_native() -> 'ctypes.CDLL | None':
    if not os.path.exists(NATIVE_SOURCE):
        return None
    with open(NATIVE_SOURCE, 'rb') as fh:
        digest = hashlib.sha256(' '.join(GXX_FLAGS).encode() + b'\0' + fh.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f'libsampler-{digest}.so')
    if not os.path.exists(so):
        # per-process temp name: concurrent first-use builds must not race on
        # a shared .tmp path (os.replace of a partially written .so)
        tmp = f'{so}.{os.getpid()}.tmp'
        cmd = ['g++', *GXX_FLAGS, '-o', tmp, NATIVE_SOURCE, '-lpthread']
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except Exception as e:  # g++ missing or failed: numpy fallback
            logger.debug('native sampler build failed (%s); using numpy fallback', e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.sampler_create.restype = ctypes.c_void_p
    lib.sampler_create.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
    ]
    lib.sampler_next.restype = None
    lib.sampler_next.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                                 ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.sampler_destroy.restype = None
    lib.sampler_destroy.argtypes = [ctypes.c_void_p]
    return lib


_lib = None
_lib_tried = False
_lib_lock = threading.Lock()


def _native_lib():
    global _lib, _lib_tried
    with _lib_lock:
        if not _lib_tried:
            _lib_tried = True
            _lib = _build_native()
    return _lib


class CropSampler:
    """Random (LR, HR) training pairs from a list of HWC uint8 images.

    HR = random ``crop`` x ``crop`` window with random x/y flips, as
    f32/255; LR = exact ``scale`` x ``scale`` box mean of that HR crop.
    Uses the native sampler when available, numpy otherwise (``backend``
    forces one; ``backend`` says which runs)."""

    def __init__(self, images, crop: int, scale: int, seed: int = 0,
                 backend: str = 'auto', n_threads: int | None = None):
        if crop % scale != 0:
            raise ValueError('crop must be a multiple of scale')
        self.images = [np.ascontiguousarray(im, dtype=np.uint8) for im in images
                       if im.shape[0] >= crop and im.shape[1] >= crop and im.shape[2] == 3]
        if not self.images:
            raise ValueError(f'no images >= {crop}px')
        self.crop, self.scale = crop, scale
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        self._rng = np.random.default_rng(seed)
        self._handle = None
        lib = _native_lib() if backend in ('auto', 'native') else None
        if backend == 'native' and lib is None:
            raise RuntimeError('native sampler unavailable (g++ build failed)')
        if lib is not None:
            ptrs = (ctypes.c_void_p * len(self.images))(
                *[im.ctypes.data_as(ctypes.c_void_p) for im in self.images]
            )
            hs = (ctypes.c_int * len(self.images))(*[im.shape[0] for im in self.images])
            ws = (ctypes.c_int * len(self.images))(*[im.shape[1] for im in self.images])
            self._handle = lib.sampler_create(ptrs, hs, ws, len(self.images), crop, scale, seed)
            self._lib = lib
        self.backend = 'native' if self._handle else 'numpy'

    def next_batch(self, batch: int):
        """-> (lr, hr) float32 NHWC arrays."""
        crop, scale = self.crop, self.scale
        lsz = crop // scale
        hr = np.empty((batch, crop, crop, 3), np.float32)
        lr = np.empty((batch, lsz, lsz, 3), np.float32)
        if self._handle:
            self._lib.sampler_next(
                self._handle, batch,
                hr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                lr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.n_threads,
            )
            return lr, hr
        rng = self._rng
        for i in range(batch):
            im = self.images[rng.integers(len(self.images))]
            y = rng.integers(im.shape[0] - crop + 1)
            x = rng.integers(im.shape[1] - crop + 1)
            patch = im[y : y + crop, x : x + crop].astype(np.float32) / 255.0
            if rng.random() < 0.5:
                patch = patch[:, ::-1]
            if rng.random() < 0.5:
                patch = patch[::-1]
            hr[i] = patch
            lr[i] = patch.reshape(lsz, scale, lsz, scale, 3).mean(axis=(1, 3))
        return lr, hr

    def __del__(self):
        handle = getattr(self, '_handle', None)
        if handle:
            self._lib.sampler_destroy(handle)
            self._handle = None


class Prefetcher:
    """One-deep background producer: the next batch is sampled on a host
    thread while the device executes the current step."""

    def __init__(self, sampler: CropSampler, batch: int):
        self.sampler = sampler
        self.batch = batch
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                item = self.sampler.next_batch(self.batch)
            except BaseException as e:  # propagate to the consumer, never hang
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, BaseException):
                return

    def next(self):
        item = self._q.get()
        if isinstance(item, BaseException):
            # producer died: surface the real error instead of blocking
            # forever on an empty queue
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
