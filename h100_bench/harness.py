"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the correctness check, and the result.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names
the cell's configuration (a JSON file of sizes, with the reference module
``reference/<config>.py`` beside it), its traffic mix (``traffic/<mix>.json``,
read by ``traffic.py``, whose size kind is ``sizes/<kind>.py`` and serving
path ``paths/<path>.py``), its metrics (``metrics/<metric>.py``, each with a
``read(readings)``) and its limits (``limits/<cell>.json``).
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import subprocess
import sys
import time
import traceback
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from . import launches as launches_mod
from . import trace as trace_mod
from .lookup import module
from .reference import tiling
from .reference.common import full_precision
from .traffic import generate
from .weights import make_state_dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TRACE_SECONDS = 10  # the traced window's length at most: a longer trace costs minutes to read


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Record:
    start: float
    end: float
    lr_px: int
    out_px: int
    shape_ok: bool


@dataclass
class Readings:
    """What the metric readers read."""

    dtype: str
    flops_per_lr_px: float
    setup_s: float
    load_s: float
    window_start: float
    records: list[Record]
    trace: trace_mod.Trace | None = None
    trace_records: list[Record] = field(default_factory=list)
    launches: dict[str, Counter] = field(default_factory=dict)  # counter -> shapes launched in the traced window
    csrc: dict[str, set] = field(default_factory=dict)  # .cu file -> its kernels' names


@dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    limits: dict
    reference: object
    metrics: dict  # 'end_to_end' / 'per_layer' -> [(entry, module)]


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    bench = bench or read_json(os.path.join(ROOT, 'BENCHMARK.json'))
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'no workload {workload!r} in BENCHMARK.json')
    w = cells[workload]
    conf = {c['name']: c for c in bench['configs']}[w['config']]
    metrics = {}
    for kind in ('end_to_end', 'per_layer'):
        metrics[kind] = [(m, module('metrics', m['name'])) for m in bench[kind] if workload in m.get('workloads', [workload])]
    return Cell(workload, read_json(os.path.join(ROOT, conf['file'])),
                read_json(os.path.join(HERE, 'traffic', f'{w["traffic"]}.json')),
                read_json(os.path.join(HERE, 'limits', f'{workload}.json')),
                importlib.import_module(f'h100_bench.reference.{w["config"]}'), metrics)


def _counter(path: str) -> Counter:
    module, name = path.split(':')
    return getattr(importlib.import_module(module), name).by_shape


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def quantize(out: torch.Tensor) -> np.ndarray:
    """The CLI's output step: round to 8 bits on the device, copy to the host."""
    return torch.clamp(out.float() * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8).cpu().numpy()


def reference_server(cell: Cell, params: dict, device, tile: int, halo: int):
    """The reference, tiled by the benchmark's own rule."""
    scale = cell.reference.scale(cell.cfg)

    def serve(img):
        x = torch.as_tensor(img).to(device).permute(2, 0, 1).float() / 255.0
        with torch.no_grad(), full_precision():
            y = tiling.upscale(lambda t: cell.reference.forward(cell.cfg, params, t), x, scale, tile, halo)
        return y.permute(1, 2, 0)

    return serve


def run_window(serve, requests, seconds: float, scale: int, keep: dict | None):
    """The closed loop: one request in flight, the next sent when the last
    one's pixels are on the host, until ``seconds`` have passed.  ``keep``
    gathers the outputs the check reads: under 'sampled' those the traffic
    marks (request index -> (image, pixels)), under 'largest' the largest
    image served of the rest."""
    records, failed = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i, img, check = next(requests)
        start = time.perf_counter()
        try:
            host = quantize(serve(img))
        except Exception:  # noqa: BLE001 - a failed request is counted and the run goes on
            failed += 1
            if failed <= 3:
                log(f'request {i} failed:\n{traceback.format_exc()}')
            continue
        end = time.perf_counter()
        h, w = img.shape[:2]
        out_px = host.shape[0] * host.shape[1]
        records.append(Record(start, end, h * w, out_px, host.shape == (h * scale, w * scale, img.shape[2])))
        if keep is not None:
            if check:
                keep['sampled'][i] = (img, host)
            elif out_px > keep['largest'][0]:
                keep['largest'] = (out_px, i, img, host)
    return t0, records, failed


def build_kernels(device) -> tuple[float, list[str]]:
    """The program's CUDA kernels built where they are not yet (a
    checkout's first run): the seconds it took and the sources built."""
    if torch.device(device).type != 'cuda':
        return 0.0, []
    from resselt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    took = _build.build()
    return time.perf_counter() - t0, sorted(name for name, s in took.items() if s > 0)


def latency_line(records: list[Record]) -> str:
    lat = sorted((r.end - r.start) * 1e3 for r in records)
    if not lat:
        return 'latency_ms none'
    q = {p: lat[min(len(lat) - 1, int(p / 100 * len(lat)))] for p in (50, 90, 99)}
    return f'latency_ms p50={q[50]:.2f} p90={q[90]:.2f} p99={q[99]:.2f} max={lat[-1]:.2f}'


def card_info(device) -> dict:
    if torch.device(device).type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device), 'count': 1}


def nvidia_smi() -> str:
    try:
        return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu',
                               '--format=csv,noheader'], capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f'nvidia-smi failed: {err}'


def run(workload: str, seed: int, seconds: float, traced: bool, t_process: float, *, device='cuda',
        cell: Cell | None = None, control: str | None = None) -> tuple[dict, list[str]]:
    """One run; returns the result object and the check lines.  ``control``
    'program_int8' (the correctness calibration only) serves the program's
    int8 path, the control of the check."""
    import resselt_tpu_torch as rt
    from resselt_tpu_torch.parallel.tiling import _resolve_halo_hint, _resolve_tile_hint

    cell = cell or load_cell(workload)
    cfg, mix = cell.cfg, cell.mix
    dtype = getattr(torch, cfg['dtype'])
    sources = {mod.COUNTER: mod.SOURCE for kind in cell.metrics.values() for _, mod in kind if hasattr(mod, 'COUNTER')}
    t_import = time.perf_counter()

    build_s, built = build_kernels(device)
    t_build = time.perf_counter()
    sd = make_state_dict(cell.reference, cfg, seed, device)
    t_weights = time.perf_counter()
    model = rt.load_from_state_dict(sd, device=device)
    model.weights(dtype)
    _sync(device)
    t_load = time.perf_counter()
    if control == 'program_int8':
        model = model.quantize_int8()
    traffic = generate(mix, seed, device)
    t_traffic = time.perf_counter()
    scale = int(model.metadata.upscale)
    tile = _resolve_tile_hint(model, dtype)
    halo = _resolve_halo_hint(model, tile, dtype)

    path = module('paths', traffic.path)
    serve = path.server(model, dtype, tile, traffic.images)
    first_calls = []  # (a graph program, what its first call counted), one per size served on a graph
    sizes, program = traffic.first_of_each_size(), None
    for img in sizes:
        before = {c: Counter(_counter(c)) for c in sources}
        quantize(serve(img))
        program = path.program(model, img, dtype, tile, traffic.images)
        if program is not None and program.graph is not None:
            first_calls.append((program, {c: _counter(c) - before[c] for c in sources}))
    _sync(device)
    t_ready = time.perf_counter()
    setup_s = t_ready - t_process
    log(f'setup import_s={t_import - t_process:.3f} build_s={build_s:.3f} built={",".join(built) or "none"} '
        f'weights_s={t_weights - t_build:.3f} load_s={t_load - t_weights:.3f} traffic_s={t_traffic - t_load:.3f} '
        f'warmup_s={t_ready - t_traffic:.3f} setup_s={setup_s:.3f} tile={tile} halo={halo} scale={scale} '
        f'path={traffic.path} graphs={len(first_calls)} sizes={len(sizes)}')

    keep: dict = {'sampled': {}, 'largest': (-1, None, None, None)}
    requests = traffic.requests()
    t0, records, failed = run_window(serve, requests, seconds, scale, keep)
    readings = Readings(cfg['dtype'], cfg['flops_per_lr_px'], setup_s, t_load - t_weights, t0, records)

    t_window = time.perf_counter()
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        eager0 = {c: Counter(_counter(c)) for c in sources}
        replays0 = [p.replays for p, _ in first_calls]
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == 'cuda' else [])
        with profile(activities=activities) as prof:
            with record_function(trace_mod.WINDOW):
                _, readings.trace_records, failed_traced = run_window(
                    serve, requests, min(seconds, TRACE_SECONDS), scale, None)
                _sync(device)
        failed += failed_traced
        replays = [p.replays - r0 for (p, _), r0 in zip(first_calls, replays0)]
        csrc = os.path.join(os.path.dirname(rt.__file__), 'csrc')
        readings.csrc = {f: trace_mod.kernels_in(os.path.join(csrc, f)) for f in os.listdir(csrc) if f.endswith('.cu')}
        readings.trace = trace_mod.read(prof)
        del prof
        for c, source in sources.items():
            eager = _counter(c) - eager0[c]
            names = readings.csrc.get(source, set())
            traced_n = readings.trace.kernel_launches(lambda name: trace_mod.kernel_base_name(name) in names)
            got, k = launches_mod.in_window(eager, [(counts[c], r) for (_, counts), r in zip(first_calls, replays)],
                                            traced_n)
            log(f'launches {c} eager={sum(eager.values())} graph_replays={sum(replays)} in_trace={traced_n} '
                f'passes_a_first_call={k} ' + (f'counted={sum(got.values())} shapes={len(got)}' if got is not None
                                               else 'DISAGREE: the counts and the trace differ; no roofline'))
            if got is not None:
                readings.launches[c] = got

    device_info = card_info(device)
    if device_info['platform'] == 'gpu':
        device_info['memory_peak_bytes'] = torch.cuda.max_memory_allocated(device)
    if traced:
        device_info['busy_s'] = readings.trace.busy_s
        device_info['window_s'] = readings.trace.window_s
    log(f'card {nvidia_smi()}' if device_info['platform'] == 'gpu' else 'card none (cpu)')
    log(f'window requests={len(records)} failed={failed} samples={len(records)} {latency_line(records)}')

    kind = 'per_layer' if traced else 'end_to_end'
    metrics = {}
    for entry, mod in cell.metrics[kind] if records else ():  # no request completed: no metric, not correct
        value = mod.read(readings)
        if value is not None:
            metrics[entry['name']] = {'value': value, 'unit': entry['unit']}

    # the check: the program's state freed first, so that the reference sets no peak
    del serve, model, first_calls, program, path
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    t_checked = time.perf_counter()
    numbers = check(cell, sd, keep, records, device, tile, halo)
    log(f'timing window_s={t_window - t0:.3f} traced_window_and_read_s={t_checked - t_window:.3f} '
        f'check_s={time.perf_counter() - t_checked:.3f}')
    correct = failed == 0 and bool(records) and all(r.shape_ok for r in records) and all(
        v <= lim for v, lim in numbers.values())
    lines = [f'check {name} {v!r} limit {lim!r}' for name, (v, lim) in numbers.items()]
    result = {'correct': correct, 'attempted': len(records) + failed, 'failed': failed, 'metrics': metrics,
              'device': device_info}
    if traced:
        result['breakdown'] = trace_mod.breakdown(readings.trace)
    result['setup'] = {'build_s': build_s, 'built': built}
    result['check'] = {name: {'value': v, 'limit': lim} for name, (v, lim) in numbers.items()}
    return result, lines


def check(cell: Cell, sd: dict, keep: dict, records: list[Record], device, tile: int,
          halo: int) -> dict[str, tuple[float, float]]:
    """The kept outputs against the float32 reference over the same
    windows, each number beside its limit.  ``mse_levels2``: the worst
    image's mean squared error in 8-bit levels, of the served pixels
    against the reference's output clamped to [0, 255] (PSNR's quantity;
    a perfect 8-bit rounding reads 1/12)."""
    compared = dict(keep['sampled'])
    _, i, img, host = keep['largest']
    if img is not None:
        compared[i] = (img, host)
    params = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in sd.items()}
    ref = reference_server(cell, params, device, tile, halo)
    mse, by_image = 0.0, {}
    for i, (img, host) in sorted(compared.items()):
        key = id(img)
        if key not in by_image:
            by_image[key] = ref(img).clamp(0, 1) * 255.0
        mse = max(mse, float((torch.as_tensor(host).to(device).float() - by_image[key]).square().mean()))
    log(f'check compared={len(compared)} distinct_inputs={len(by_image)} of served={len(records)}')
    return {'mse_levels2': (mse, cell.limits['mse_levels2'])}
