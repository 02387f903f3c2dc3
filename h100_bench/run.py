"""Run one cell of the benchmark on the card and print its result.

    python3 h100_bench/run.py --workload esrgan_x4.frames720 --seed 7 --seconds 30 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, ``setup`` (the seconds of the kernels' nvcc build and the
sources built: none on a warm run), and last ``check``: each number the
correctness check compared, beside its limit.  The same numbers end standard error.  Without
a CUDA card the run fails and prints no result, as it does if the process
has loaded JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (the
    interpreter's own start-up included, to the kernel's clock tick)."""
    now = time.perf_counter()
    try:
        with open('/proc/self/stat') as fh:
            start_ticks = int(fh.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as fh:
            uptime = float(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - start_ticks / os.sysconf('SC_CLK_TCK'))


T_PROCESS = _process_start()

import argparse  # noqa: E402 - the clock above is read first
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'resselt_tpu')  # top-level module names, compared whole


def loaded_forbidden() -> list[str]:
    return sorted({name for name in list(sys.modules) if name.split('.', 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from h100_bench import harness

    bench = harness.read_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))
    chips = {w['name']: w['chips'] for w in bench['workloads']}.get(args.workload)
    if chips is None:
        print(f'no workload {args.workload!r} in BENCHMARK.json', file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{args.workload} needs {chips} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}', file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, bench)
    result, lines = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS, cell=cell)
    found = loaded_forbidden()
    if found:
        print(f'the run loaded {", ".join(found)}: the benchmark measures the port alone', file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
