"""The correctness check: a run with the timed path broken underneath
comes out not correct, and so does the control (the program's int8 path);
a sound run comes out correct.  These drive the harness on the CPU, past
its look for a card, at sizes a test run holds, under the cells' own
limits.  Also: the import guard, and one run of each cell on a card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT
from h100_bench import harness

FRAME = {'sizes': {'kind': 'fixed', 'height': 72, 'width': 100}, 'distinct': 2, 'path': 'tiled', 'check_share': 1.0}


@pytest.fixture
def small_tiles(monkeypatch):
    """Tiles of 32 (windows of 40 at ESRGAN's halo of 4): the 72 x 100
    frame runs as 6 windows in one batch, at the published widths."""
    from resselt_tpu_torch.parallel import tiling

    monkeypatch.setattr(tiling, '_resolve_tile_hint', lambda model, dtype: 32)


def _run(cell_name: str, mix, seconds=0.1, control=None):
    cell = harness.load_cell(cell_name)
    cell.mix = mix
    result, lines = harness.run(cell_name, 2**32 + 17, seconds, False, time.perf_counter(), device='cpu', cell=cell,
                                control=control)
    assert lines and all(line.startswith('check ') for line in lines)
    assert list(result)[-1] == 'check'
    return result


def test_sound_run_is_correct(small_tiles):
    result = _run('esrgan_x4.frames720', mix=FRAME)
    assert result['correct'] and result['failed'] == 0 and result['attempted'] >= 1
    assert set(result['metrics']) == {'out_mp_per_s', 'setup_s'}
    assert result['attempted'] >= 1 and result['check']['mse_levels2']['value'] < 1


def _patched_call(monkeypatch, fault):
    from resselt_tpu_torch.core.factory import SRModel

    call = SRModel.__call__

    def broken(self, x, *args, **kwargs):
        return fault(call, self, x, *args, **kwargs)

    monkeypatch.setattr(SRModel, '__call__', broken)


def _half_batch(call, model, x, *args, **kwargs):
    """Half of the batch left out: its windows come back as copies of the rest."""
    x = torch.as_tensor(x)
    if x.ndim == 4 and x.shape[0] > 1:
        out = call(model, x[: x.shape[0] // 2], *args, **kwargs)
        return torch.cat([out, out[: x.shape[0] - out.shape[0]]])
    return call(model, x, *args, **kwargs)


def _altered(call, model, x, *args, **kwargs):
    """An answer altered where it is produced: a patch of one window's output."""
    out = call(model, x, *args, **kwargs).clone()
    out[..., :8, :8, :] += 0.5
    return out


@pytest.mark.parametrize('fault', [_half_batch, _altered], ids=['half_batch_left_out', 'answer_altered'])
def test_broken_timed_path_is_not_correct(monkeypatch, small_tiles, fault):
    _patched_call(monkeypatch, fault)
    result = _run('esrgan_x4.frames720', mix=FRAME)
    assert result['failed'] == 0 and not result['correct']
    assert result['check']['mse_levels2']['value'] > result['check']['mse_levels2']['limit']


@pytest.mark.parametrize('cell', ['esrgan_x4.frames720', 'swinir_m_x4.frames720'])
def test_control_is_not_correct(cell):
    """The control at the published widths on a small frame: the program's
    int8 path fails the cell's limit, which its bf16 path keeps."""
    mix = {'sizes': {'kind': 'fixed', 'height': 40, 'width': 48}, 'distinct': 1, 'path': 'tiled', 'check_share': 1.0}
    sound = _run(cell, mix)
    control = _run(cell, mix, control='program_int8')
    assert sound['correct'] and not control['correct']


def test_import_guard_compares_whole_top_level_names():
    code = ('import sys, types\n'
            "for name in ('jaxlib.xla_client', 'resselt_tpu.core', 'resselt_tpu_torch', 'jaxtyping', 'flax'):\n"
            '    sys.modules[name] = types.ModuleType(name)\n'
            'from h100_bench.run import loaded_forbidden\n'
            'print(loaded_forbidden())\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True, check=True).stdout
    assert out.strip() == str(['flax', 'jaxlib.xla_client', 'resselt_tpu.core'])


def test_a_whole_run_loads_no_jax():
    """Everything a run loads, driven once on the CPU in a fresh process:
    neither JAX nor the JAX package."""
    code = ('import sys, time\n'
            'from h100_bench import harness\n'
            'from h100_bench.run import loaded_forbidden\n'
            "cell = harness.load_cell('swinir_m_x4.photos')\n"
            "cell.mix = {'sizes': {'kind': 'listed', 'images': [{'name': 'a', 'width': 40, 'height': 40}, "
            "{'name': 'b', 'width': 40, 'height': 40}, {'name': 'c', 'width': 36, 'height': 20}, "
            "{'name': 'd', 'width': 12, 'height': 10}]}, 'distinct': 4, 'path': 'cli', 'check_share': 1.0}\n"
            "cell.cfg.update(depths=[1], num_heads=[2], embed_dim=8)\n"
            "result, _ = harness.run(cell.name, 3, 0.05, True, time.perf_counter(), device='cpu', cell=cell)\n"
            "assert result['attempted'] >= 1 and result['setup'] == {'build_s': 0.0, 'built': []}\n"
            'print(loaded_forbidden())\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == '[]'


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['esrgan_x4.frames720', 'swinir_m_x4.frames720', 'esrgan_x4.photos',
                                  'swinir_m_x4.photos'])
def test_cell_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    proc = subprocess.run([sys.executable, 'h100_bench/run.py', '--workload', cell, '--seed', '4242',
                           '--seconds', '3', '--trace', '0'], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['correct'] and result['device']['platform'] == 'gpu'
    assert os.path.isdir(os.path.join(ROOT, 'resselt_tpu_torch', '_build'))


@pytest.mark.cuda
@pytest.mark.parametrize('cell, roofline', [('esrgan_x4.frames720', 'conv3x3_roofline'),
                                            ('swinir_m_x4.photos', 'window_attn_roofline.swinir_photos')])
def test_traced_launches_agree_with_the_trace_on_card(cell, roofline):
    """The wrappers' launch counts, graph replays included, agree with the
    kernels the trace holds, so the roofline is read and within 100%."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    proc = subprocess.run([sys.executable, 'h100_bench/run.py', '--workload', cell, '--seed', '4243',
                           '--seconds', '2', '--trace', '1'], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'DISAGREE' not in proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert 0 < result['metrics'][roofline]['value'] <= 100
