"""Calibrated forward-throughput measurement on the model's device.

Counterpart of ``resselt_tpu/benchmark.py``, with its method: ``n``
dependency-chained forwards (each input moved by ``1e-6 x`` the previous
output, so no forward can start before the one it depends on ends), timed
on the host clock up to a scalar readback, which waits for the device; two
runs of different lengths, so that the fixed launch and sync cost cancels
out of their difference (:func:`calibrated_per_iter`).  JAX runs the chain
as one on-device ``fori_loop``; here the host issues it forward by forward
under ``torch.inference_mode``, and the kernels queue on the stream ahead of
the host.  Every function runs on the model's device: the card for a model
loaded there, the CPU only for a model the caller loaded there.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# NVIDIA H100 SXM dense bf16 peak (data sheet, at its 700 W limit), for MFU columns
PEAK_TFLOPS = 989.4


def calibrated_per_iter(run, iters: int, min_seconds: float = 2.0,
                        deadline: float | None = None, progress=None) -> float:
    """Genuine seconds/iteration from a latency-cancelling two-run delta.

    ``run(n)`` executes ``n`` dependency-chained iterations on device and
    returns wall seconds INCLUDING the fixed dispatch+readback latency.
    The first (short) run's latency inflates its per-iteration estimate,
    which would UNDERSHOOT the second run's length (a 10 ms/iter config
    behind 0.3 s of latency would get ~0.2 s of genuine work instead of
    ``min_seconds``) — so the second run grows, re-estimating from the
    genuine delta, until it contains at least ``min_seconds`` of real
    device work beyond the first run.

    ``deadline`` (absolute ``time.perf_counter`` value) is a hard
    wall-clock budget: once a next run's *predicted* finish would pass it,
    the best estimate so far is returned instead of issuing the run — a
    stall degrades the calibration, it no longer hangs the tool.
    ``progress(stage, per_iter_est)`` is called after every completed run
    so callers can emit best-so-far numbers even if later killed.
    """
    note = progress or (lambda stage, est: None)
    dt1 = run(iters)
    note('run1', dt1 / iters)
    if dt1 >= 4 * min_seconds:  # slow config: dispatch latency negligible
        return dt1 / iters
    n2 = iters + max(iters, int(iters * min_seconds / max(dt1, 1e-3)) + 1)
    best = dt1 / iters  # latency-inflated upper bound; refined below
    while True:
        if deadline is not None:
            # predicted wall for the next run from the current estimate,
            # plus the fixed latency already present in dt1
            predicted = best * n2 + 1.0
            if time.perf_counter() + predicted > deadline:
                return best
        dt2 = run(n2)
        genuine = dt2 - dt1
        best = max(genuine, 1e-6) / (n2 - iters)
        note('run2', best)
        if genuine >= min_seconds or n2 - iters >= 1_000_000:
            return best
        n2 = iters + max(2 * (n2 - iters), int(min_seconds / best) + 1)


def _input(model, shape, dtype) -> torch.Tensor:
    """The seeded input of JAX's measurements: uniform [0, 1) from numpy's
    ``default_rng(0)``, in ``dtype`` (default f32) on the model's device."""
    x = torch.from_numpy(np.random.default_rng(0).random(shape, dtype=np.float32)).to(model.device)
    return x if dtype is None else x.to(dtype)


def _chained(step, x0: torch.Tensor, mode=torch.inference_mode):
    """``run(n)``: ``n`` calls of ``step(carry) -> carry`` from ``x0``, under
    ``mode()``, ended by a scalar readback of the last carry; wall
    seconds."""

    def run(n: int) -> float:
        t0 = time.perf_counter()
        with mode():
            carry = x0
            for _ in range(n):
                carry = step(carry)
            float(carry.float().sum())
        return time.perf_counter() - t0

    return run


def measure_forward(model, tile: int, batch: int, dtype=None, iters: int = 3,
                    min_seconds: float = 2.0, halo: int = 0):
    """Measure one model forward; returns ``(useful_mps, sec_per_forward, scale)``.

    With ``halo > 0`` the forward runs at the window size the tiled driver
    actually runs — ``(tile + 2*halo)``-square inputs — but only the
    ``tile * scale`` core output pixels the driver keeps are credited, so
    the number ranks configs for ``upscale_tiled(tile=..., halo=...)``
    honestly (per-tile rates at the bare tile size do not: the halo is
    ~27% extra area at tile 128).  ``halo=0`` measures the bare forward.
    ``dtype``: the compute dtype (``model(x)``'s), default f32.
    """
    win = tile + 2 * halo
    in_ch = model.metadata.in_channels
    x = _input(model, (batch, win, win, in_ch), dtype)
    scale = model(x).shape[1] // win  # outside inference mode: the model keeps the weights it prepares here

    def step(carry):
        y = model(carry)
        return carry + 1e-6 * y[:, :win, :win, :in_ch]

    run = _chained(step, x)
    run(iters)  # warm: weights prepared for the dtype, kernels built and loaded
    per_iter = calibrated_per_iter(run, iters, min_seconds)
    mps = (tile * scale) ** 2 * batch / 1e6 / per_iter
    return mps, per_iter, scale


def _tiled(model, hw, tile, halo, batch_size, dtype):
    """The program ``upscale_tiled`` serves for an ``hw`` image, its scale
    and the seeded image; ValueError when the image fits one window."""
    from .parallel.tiling import tiled_program

    h, w = hw
    fn, scale = tiled_program(model, h, w, tile=tile, halo=halo, batch_size=batch_size, dtype=dtype)
    if fn is None:
        raise ValueError(f'({h}, {w}) fits in one tile window; use measure_forward')
    return fn, scale, _input(model, (h, w, model.metadata.in_channels), dtype)


def measure_tiled(model, hw, tile: int | None = None, halo: int | None = None,
                  batch_size: int | None = None, dtype=None, iters: int = 2,
                  min_seconds: float = 2.0):
    """End-to-end tiled-driver throughput, dependency-chained and calibrated.

    Times the SAME one-dispatch program ``upscale_tiled`` serves
    (``parallel.tiling.tiled_program``: a CUDA graph of extract -> tile
    batches -> stitch on the card, with its batch resolution), chained
    frame to frame, so the fixed launch and sync cost cancels out of the
    number.  The image is in the compute dtype on the model's device.
    Returns ``(mps, sec_per_frame)``; ValueError when the image fits one
    tile window.
    """
    h, w = hw
    fn, scale, img = _tiled(model, hw, tile, halo, batch_size, dtype)
    in_ch = img.shape[-1]

    def step(carry):
        y = fn(carry)
        return carry + 1e-6 * y[:h, :w, :in_ch].to(carry.dtype)

    run = _chained(step, img, torch.no_grad)  # the model keeps the program's buffers: no inference tensors
    run(1)  # warm: the graph's warm-up run, capture and first replay
    per_frame = calibrated_per_iter(run, iters, min_seconds)
    mps = h * w * scale * scale / 1e6 / per_frame
    return mps, per_frame


def measure_tiled_direct(model, hw, tile: int | None = None,
                         halo: int | None = None,
                         batch_size: int | None = None, dtype=None,
                         iters: int = 2, min_seconds: float = 2.0):
    """``measure_tiled`` without the chain: each frame is the program on the
    same image followed by a scalar readback (a strided sum of the output),
    for a program whose frames should not queue behind one another.  The
    two-run delta still cancels the fixed setup.  Returns ``(mps,
    sec_per_frame)``; ValueError when the image fits one tile window."""
    h, w = hw
    fn, scale, img = _tiled(model, hw, tile, halo, batch_size, dtype)
    stride = max(1, (h * scale) // 64)

    def one_frame():
        with torch.no_grad():
            return float(fn(img)[::stride].float().sum())  # per-frame readback

    one_frame()  # warm

    def run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            one_frame()
        return time.perf_counter() - t0

    per_frame = calibrated_per_iter(run, iters, min_seconds)
    mps = h * w * scale * scale / 1e6 / per_frame
    return mps, per_frame
