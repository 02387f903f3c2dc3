"""The port stands alone: resselt_tpu_torch and chip_smoke.py import neither
jax nor resselt_tpu, entry points do not drop to the CPU on their own, an
installed copy carries every file its kernels include, and chip_smoke.py
refuses to run without a card or without the package."""

import ast
import fnmatch
import os
import re
import subprocess
import sys
import tomllib

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
        'import resselt_tpu_torch.cache, resselt_tpu_torch.convert, resselt_tpu_torch.inspect\n'
        'import resselt_tpu_torch.metrics, resselt_tpu_torch.quant\n'
        'from resselt_tpu_torch import load_model, save_model\n'
        'from resselt_tpu_torch.parallel import tiled_program\n'
        'from resselt_tpu_torch.zoo import make_atd, make_dat, make_drct, make_eimn, make_esrgan, make_hat, make_plksr\n'
        'from resselt_tpu_torch.zoo import make_fdat, make_omni, make_rgt, make_swinir\n'
        'from resselt_tpu_torch.zoo import make_compact, make_mosr, make_rcan, make_span, make_spanplus, make_spanpp\n'
        "m = resselt_tpu_torch.load_from_state_dict(make_esrgan(8, 1, 2, gc=4), device='cpu')\n"
        'y = resselt_tpu_torch.upscale_tiled(m, np.zeros((40, 40, 3), np.float32), tile=16, halo=2)\n'
        'assert tuple(y.shape) == (80, 80, 3)\n'
        "m = resselt_tpu_torch.load_from_state_dict(make_plksr(32, 1, 2, kernel_size=9), device='cpu')\n"
        "assert m.arch_id == 'PLKSR'\n"
        'y = resselt_tpu_torch.upscale_tiled(m, np.zeros((40, 40, 3), np.float32), tile=16)\n'
        'assert tuple(y.shape) == (80, 80, 3)\n'
        "m = resselt_tpu_torch.load_from_state_dict(make_swinir(16, (2,), (2,), 8, upscale=2), device='cpu')\n"
        "assert m.arch_id == 'SwinIR'\n"
        'y = resselt_tpu_torch.upscale_tiled(m, np.zeros((40, 40, 3), np.float32), tile=16)\n'
        'assert tuple(y.shape) == (80, 80, 3)\n'
        "m = resselt_tpu_torch.load_from_state_dict(make_eimn(64, 1, 1, 2.66, 2), device='cpu')\n"
        "assert m.arch_id == 'eimn'\n"
        'y = resselt_tpu_torch.upscale_tiled(m, np.zeros((40, 40, 3), np.float32), tile=16)\n'
        'assert tuple(y.shape) == (80, 80, 3)\n'
        "m = resselt_tpu_torch.load_from_state_dict(make_hat(24, (2,), (3,), 8, upscale=2), device='cpu')\n"
        "assert m.arch_id == 'HAT'\n"
        'y = resselt_tpu_torch.upscale_tiled(m, np.zeros((40, 40, 3), np.float32), tile=16)\n'
        'assert tuple(y.shape) == (80, 80, 3)\n'
        "m = resselt_tpu_torch.load_from_state_dict(make_atd(24, (2,), (3,), 8, upscale=2), device='cpu')\n"
        "assert m.arch_id == 'ATD'\n"
        'y = resselt_tpu_torch.upscale_tiled(m, np.zeros((40, 40, 3), np.float32), tile=16)\n'
        'assert tuple(y.shape) == (80, 80, 3)\n'
        "for sd, arch in ((make_dat(24, (2,), (2,), (2, 4), 2.0, 2), 'dat'), (make_drct(24, 1, 3, 8, 8, 2.0, 2), 'DRCT'),\n"
        "                 (make_rgt(24, (2,), (2,), (4, 4), 2.0, 0.5, 2), 'RGT'),\n"
        "                 (make_fdat(32, 1, 1, 4, 8, 1.5, 8, 32, 'lda', 2), 'FDAT'),\n"
        "                 (make_omni(16, 1, True, 8, 1, 2), 'OmniSR'), (make_compact(16, 2, 2), 'Compact'),\n"
        "                 (make_span(16, 2), 'SPAN'), (make_spanplus(16, (1,), 2), 'spanplus'),\n"
        "                 (make_mosr(16, 1, 2), 'MoSR'), (make_rcan(16, 1, 1, 4, 2), 'RCAN')):\n"
        "    m = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')\n"
        '    assert m.arch_id == arch\n'
        '    y = resselt_tpu_torch.upscale_tiled(m, np.zeros((40, 40, 3), np.float32), tile=16)\n'
        '    assert tuple(y.shape) == (80, 80, 3)\n'
        'from resselt_tpu_torch.zoo import make_cugan, make_gater, make_gaterv2, make_gaterv3, make_moesr, make_mosrv2\n'
        "for sd, arch, s in ((make_cugan('2x'), 'CuGAN', 2), (make_gater(16, latent_att=True), 'GateR', 1),\n"
        "                    (make_mosrv2(16, 1, 2), 'MoSRv2', 2), (make_moesr(16, 1, 1, 2, upsample_dim=16), 'MoESR', 2),\n"
        "                    (make_gaterv2(16, (1, 1), (1, 1), 1, 2), 'GateRv2', 2),\n"
        "                    (make_gaterv3(16, (1,), (1,), 1, span_blocks=1), 'GateRV3', 1)):\n"
        "    m = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')\n"
        '    assert m.arch_id == arch\n'
        '    y = resselt_tpu_torch.upscale_tiled(m, np.zeros((40, 40, 3), np.float32), tile=16)\n'
        '    assert tuple(y.shape) == (40 * s, 40 * s, 3)\n'
        "m = resselt_tpu_torch.load_from_state_dict(make_spanpp(16, implicit_dim=32, latent_layers=2), device='cpu')\n"
        "assert m.arch_id == 'SpanPP'\n"
        'y = resselt_tpu_torch.upscale_tiled(m.with_config(eval_scale=2), np.zeros((40, 40, 3), np.float32), tile=16)\n'
        'assert tuple(y.shape) == (80, 80, 3)\n'
        "m = resselt_tpu_torch.load_from_state_dict(make_compact(32, 2, 2), device='cpu').quantize_int8()\n"
        'assert m.cost(16, 16)["flops"] > 0\n'
        'import tempfile, os.path\n'
        "save_model(m, os.path.join(tempfile.mkdtemp(), 'm.npz'))\n"
        'resselt_tpu_torch.metrics.psnr(np.zeros((16, 16, 3)), np.ones((16, 16, 3)))\n'
        "bad = [k for k in sys.modules if k in ('jax', 'resselt_tpu') or k.startswith(('jax.', 'resselt_tpu.'))]\n"
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n'
    )
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_package_data_covers_every_kernel_include():
    """Every ``#include "..."`` of ``csrc/`` names a file of the package data
    (pyproject.toml), so an installed copy can build its kernels."""
    with open(os.path.join(ROOT, 'pyproject.toml'), 'rb') as fh:
        globs = tomllib.load(fh)['tool']['setuptools']['package-data']['resselt_tpu_torch']
    csrc = os.path.join(PKG, 'csrc')
    sources = sorted(os.listdir(csrc))
    needed = set(sources)
    for f in sources:
        with open(os.path.join(csrc, f)) as fh:
            needed |= set(re.findall(r'^\s*#include\s+"([^"]+)"', fh.read(), re.M))
    missing = [n for n in sorted(needed) if not any(fnmatch.fnmatch(f'csrc/{n}', g) for g in globs)]
    assert not missing, missing


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
