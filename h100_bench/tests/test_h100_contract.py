"""BENCHMARK.json against the benchmark's contract, and every file a cell
is made of found by its name."""

import importlib
import json
import os
import re

import pytest

from conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'h100_bench/run.py'] and BENCH['paths'] == ['h100_bench']
    assert 1 <= BENCH['run_seconds'] <= 51 and isinstance(BENCH['run_seconds'], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    # 2 + 14 runs a cell, each run_seconds + 60 s, 180 s of compile a cell, 1200 s spare, 24 cells
    assert (2 + 14 * 24) * (BENCH['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('h100_bench/') and os.path.isfile(os.path.join(ROOT, c['file']))
        names.append(c['name'])
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'} and w['chips'] == 1
        assert 1 <= len(w['why']) <= 200 and '\n' not in w['why']
        names += [w['name'], w['config'], w['traffic']]
    for kind in ('end_to_end', 'per_layer'):
        for m in BENCH[kind]:
            assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
            names.append(m['name'])
            if kind == 'end_to_end':
                assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
                assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
            else:
                assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
    assert all(NAME.match(n) for n in names)
    assert len({w['name'] for w in BENCH['workloads']}) == len(BENCH['workloads'])
    assert {m['name'] for m in BENCH['end_to_end']} >= {'setup_s'}


@pytest.mark.parametrize('cell', CELLS)
def test_cell_files_found_by_name(cell):
    from h100_bench import harness
    from h100_bench.lookup import module

    c = harness.load_cell(cell, BENCH)
    assert c.cfg['dtype'] == 'bfloat16'
    assert callable(module('paths', c.mix['path']).server) and callable(module('sizes', c.mix['sizes']['kind']).arrivals)
    assert c.limits['mse_levels2'] > 1 / 12  # exact rounding alone reads 1/12
    for kind in ('end_to_end', 'per_layer'):
        assert c.metrics[kind], kind
        for entry, mod in c.metrics[kind]:
            assert callable(mod.read)
            if hasattr(mod, 'COUNTER'):
                name, fn = mod.COUNTER.split(':')
                assert hasattr(getattr(importlib.import_module(name), fn), 'by_shape')
                assert os.path.isfile(os.path.join(ROOT, 'resselt_tpu_torch', 'csrc', mod.SOURCE))
    # every cell reports setup_s, another end-to-end metric, and a per-layer metric that moves one of them
    e2e = {entry['name'] for entry, _ in c.metrics['end_to_end']}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert all(entry['moves'] in e2e for entry, _ in c.metrics['per_layer'])
