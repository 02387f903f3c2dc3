"""The readings that a cell's correctness limit is set from, in one
process: the program's check numbers on each of ``--seeds`` and the
control's (the program's int8 path, the precision below the configuration's
bfloat16) on each of ``--control-seeds``, each over a short window at the
cell's own load with every served image compared.

    python3 h100_bench/calibrate.py --workload esrgan_x4.frames720 --seconds 6 \\
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --control-seeds 21,22,23

One JSON line a run: the seed, the side, the numbers, attempted and failed.
The lower reading is the largest the program gives, the upper the smallest
the control gives; ``PERF.md`` records both and the limit set between them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--control-seeds', required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from h100_bench import harness

    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    runs = [(int(s), None) for s in args.seeds.split(',')] + [
        (int(s), 'program_int8') for s in args.control_seeds.split(',')]
    for seed, control in runs:
        cell = harness.load_cell(args.workload)
        cell.mix['check_share'] = 1.0
        result, _ = harness.run(args.workload, seed, args.seconds, False, time.perf_counter(), cell=cell,
                                control=control)
        print(json.dumps({'seed': seed, 'side': control or 'program', 'check': result['check'],
                          'attempted': result['attempted'], 'failed': result['failed'],
                          'metrics': result['metrics']}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
