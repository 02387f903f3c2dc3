"""Two public calls that resselt_tpu accepts, held against it on the CPU
(``zoo.make_compact`` with weights of order one, test_conv_archs.py's TOL
5e-4): every ``precision`` name of ``jax.default_matmul_precision`` that
has a counterpart here, through ``SRModel.__call__``, ``upscale_tiled``,
``upscale_padded`` and the CLI's ``--precision``, and an unknown name
raising in both packages; ``upscale_tiled(..., on_device=False)``, the
host loop, equal to the JAX package's, and the one-dispatch path and
unroll equal to JAX's one-dispatch program; a mesh that is not a
``DeviceMesh`` refused, and a one-rank gloo mesh equal to the meshless
run."""

import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel.tiling as jt
import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu_torch.zoo import make_compact
from tests.test_torch_conv_route import cli_both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 5e-4
# JAX's CPU dot runs 'bfloat16' as one bf16 pass where torch's CPU conv stays f32: the two agree to
# bf16 rounding, and each stays within it of f32
BF16_TOL = 1e-2
_F32_NAMES = ['default', 'high', 'highest', 'float32', 'tensorfloat32', 'F32_F32_F32']
_BF16_NAMES = ['bfloat16', 'BF16_BF16_F32']


@pytest.fixture(scope='module')
def models():
    sd = strong(make_compact(16, 2, 2, seed=1), 1)
    return resselt_tpu.load_from_state_dict(sd), resselt_tpu_torch.load_from_state_dict(sd, device='cpu'), sd


def _x(h=16, w=20, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('precision', _F32_NAMES + _BF16_NAMES)
def test_every_precision_name_matches_jax(models, precision):
    jm, tm, _ = models
    want = np.asarray(jm(_x(), precision=precision))
    got = tm(_x(), precision=precision).numpy()
    tol = BF16_TOL if precision in _BF16_NAMES else TOL
    assert float(np.abs(got - want).max()) < tol
    assert float(np.abs(got - tm(_x()).numpy()).max()) < tol


def test_tensorfloat32_preset_is_tensorfloat32(models):
    """'TF32_TF32_F32' (which JAX's CPU dot does not take) is the
    'tensorfloat32' setting."""
    _, tm, _ = models
    assert torch.equal(tm(_x(), precision='TF32_TF32_F32'), tm(_x(), precision='tensorfloat32'))


@pytest.mark.parametrize('precision', ['fastest', 'bfloat16_3x', 'float8', 'HIGHEST'])
def test_unknown_precision_raises_in_both(models, precision):
    jm, tm, _ = models
    with pytest.raises(ValueError):
        jm(_x(), precision=precision)
    with pytest.raises(ValueError, match='precision'):
        tm(_x(), precision=precision)


@pytest.mark.parametrize('precision', ['F16_F16_F32', 'BF16_BF16_F32_X3', 'TF32_TF32_F32_X3', 'F64_F64_F64',
                                       'ANY_F8_ANY_F8_F32'])
def test_presets_without_a_counterpart_raise(models, precision):
    """JAX's other dot-algorithm presets have no torch setting here: the
    port refuses them rather than run another precision."""
    with pytest.raises(ValueError, match='precision'):
        models[1](_x(), precision=precision)


@pytest.mark.parametrize('precision', ['default', 'high', 'float32'])
def test_tiled_and_padded_take_the_names(models, precision):
    jm, tm, _ = models
    img = np.random.default_rng(1).random((40, 46, 3), dtype=np.float32)
    want = np.asarray(jt.upscale_tiled(jm, img, tile=16, precision=precision, on_device=False))
    got = tt.upscale_tiled(tm, img, tile=16, precision=precision).numpy()
    assert float(np.abs(got - want).max()) < TOL
    want = np.asarray(jt.upscale_padded(jm, img, multiple=32, precision=precision))
    got = tt.upscale_padded(tm, img, multiple=32, precision=precision).numpy()
    assert float(np.abs(got - want).max()) < TOL


@pytest.mark.parametrize('bucket', [False, True])
def test_host_loop_equals_jax(models, bucket):
    """``on_device=False`` is the port's host loop, as it is the JAX
    package's (0.0 max difference on this model in f32)."""
    jm, tm, _ = models
    img = np.random.default_rng(2).random((40, 46, 3), dtype=np.float32)
    want = np.asarray(jt.upscale_tiled(jm, img, tile=16, on_device=False, bucket=bucket))
    got = tt.upscale_tiled(tm, img, tile=16, on_device=False, bucket=bucket)
    assert got.shape == want.shape and float(np.abs(got.numpy() - want).max()) < 1e-6
    assert torch.equal(got, tt.upscale_tiled(tm, img, tile=16, bucket=bucket))  # None: the same function on the CPU


@pytest.mark.parametrize('kwargs', [{'on_device': True}, {'unroll': 2}, {'mesh': object()}])
def test_one_dispatch_unroll_and_mesh_still_raise(models, kwargs):
    """``on_device=True`` and ``unroll`` run the one-dispatch path, equal to
    JAX's one-dispatch program; a ``mesh`` that is not a ``DeviceMesh``
    raises TypeError, and a one-rank gloo mesh gives the meshless output,
    JAX's one-dispatch program's."""
    jm, tm, _ = models
    img = np.random.default_rng(2).random((40, 46, 3), dtype=np.float32)
    if 'mesh' in kwargs:
        want = np.asarray(jt.upscale_tiled(jm, img, tile=16, on_device=True))
        import torch_mesh_ranks as ranks
        from resselt_tpu_torch.parallel import make_mesh

        with pytest.raises(TypeError):
            tt.upscale_tiled(tm, img, tile=16, **kwargs)
        with ranks.one_rank():
            got = tt.upscale_tiled(tm, img, tile=16, mesh=make_mesh(device='cpu'))
        assert torch.equal(got, tt.upscale_tiled(tm, img, tile=16))
        assert got.shape == want.shape and float(np.abs(got.numpy() - want).max()) < 1e-6
        return
    want = np.asarray(jt.upscale_tiled(jm, img, tile=16, **{'on_device': True, **kwargs}))
    got = tt.upscale_tiled(tm, img, tile=16, **kwargs)
    assert got.shape == want.shape and float(np.abs(got.numpy() - want).max()) < 1e-6


@pytest.mark.parametrize('precision', ['highest', 'tensorfloat32', 'bfloat16'])
def test_cli_precision_matches_jax(tmp_path, models, precision):
    assert cli_both(tmp_path, models[2], ['--precision', precision]) == (60, 76, 3)


def test_cli_refuses_other_precisions(tmp_path, models):
    from resselt_tpu_torch.upscale import main

    with pytest.raises(SystemExit):
        main([str(tmp_path / 'm.safetensors'), 'in.png', 'out.png', '--precision', 'default'])
