"""The port stands alone: resselt_tpu_torch and chip_smoke.py import neither
jax nor resselt_tpu, entry points do not drop to the CPU on their own, and
chip_smoke.py refuses to run without a card or without the package."""

import ast
import os
import subprocess
import sys

import pytest
import torch


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'resselt_tpu_torch')


def _forbidden(name: str) -> bool:
    return name in ('jax', 'resselt_tpu') or name.startswith(('jax.', 'resselt_tpu.'))


def _port_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, 'chip_smoke.py')


def test_no_jax_or_reference_imports_in_source():
    bad = []
    for path in _port_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            bad += [f'{os.path.relpath(path, ROOT)}: {n}' for n in names if _forbidden(n)]
    assert not bad, bad


def test_loading_and_serving_import_no_jax():
    code = (
        'import sys, numpy as np\n'
        'import resselt_tpu_torch, resselt_tpu_torch.upscale, resselt_tpu_torch.parallel\n'
        'from resselt_tpu_torch.zoo import make_esrgan\n'
        "m = resselt_tpu_torch.load_from_state_dict(make_esrgan(8, 1, 2, gc=4), device='cpu')\n"
        'y = resselt_tpu_torch.upscale_tiled(m, np.zeros((40, 40, 3), np.float32), tile=16, halo=2)\n'
        'assert tuple(y.shape) == (80, 80, 3)\n'
        "bad = [k for k in sys.modules if k in ('jax', 'resselt_tpu') or k.startswith(('jax.', 'resselt_tpu.'))]\n"
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n'
    )
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is usable')
    import resselt_tpu_torch
    from resselt_tpu_torch.core import params_from_numpy
    from resselt_tpu_torch.zoo import make_esrgan

    sd = make_esrgan(8, 1, 2, gc=4)
    with pytest.raises(RuntimeError, match='CUDA'):
        resselt_tpu_torch.load_from_state_dict(sd)
    with pytest.raises(RuntimeError, match='CUDA'):
        params_from_numpy(sd, 'cuda')


@pytest.mark.parametrize('alone', [False, True], ids=['in_repo', 'alone'])
def test_chip_smoke_refuses_without_card_or_package(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip('a CUDA device is present: chip_smoke.py would run for real')
    script = os.path.join(ROOT, 'chip_smoke.py')
    cwd = ROOT
    if alone:
        with open(script) as fh:
            (tmp_path / 'chip_smoke.py').write_text(fh.read())
        script, cwd = str(tmp_path / 'chip_smoke.py'), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
