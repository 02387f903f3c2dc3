"""The port's training gradients against the JAX package's, family by
family, on the CPU in f32: the tiny state dicts of
tests/test_torch_detection_matrix.py::_MATRIX, loaded in both packages,
one batch; ``jax.value_and_grad`` of resselt_tpu.train's charbonnier loss
over the trainable params (``resselt_tpu.train.split_trainable``) against
``torch.autograd.grad`` of the port's through ``SRModel.apply``, whose
kernel Functions run here with their plain forwards and their own
backwards (the conv's ``dx`` on the plain version of the kernel).  The loss agrees
within rel 1e-5, every gradient tensor within the family test's TOL x its
max|g_jax| + 1e-7 (a param the forward does not read: JAX's zeros).  The
matrix is split over six files, every sixth entry from entry 0 here, so
that each stays well within a minute on one worker."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu_torch
from resselt_tpu.train import LOSSES as JAX_LOSSES, split_trainable as jax_split
from resselt_tpu_torch.train import LOSSES, split_trainable
from tests.test_torch_detection_matrix import _MATRIX


torch.set_num_threads(2)

# the family tests' TOL (tests/test_torch_<family>.py), by arch id
FAMILY_TOL = {
    'SwinIR': 2e-3, 'HAT': 2e-3, 'OmniSR': 1e-3, 'DRCT': 2e-3, 'FDAT': 1e-3, 'dat': 2e-3, 'RGT': 2e-3,
    'ATD': 2e-3, 'SpanPP': 5e-4, 'SPAN': 5e-4, 'ESRGAN': 5e-4, 'PLKSR': 5e-4, 'MoSRv2': 5e-4, 'MoESR': 5e-4,
    'RTMoSR': 5e-4, 'SMoSR': 1e-3, 'RHA': 1e-3, 'FlexNet': 1e-3, 'GateRV3': 1e-3, 'GateRv2': 1e-3,
    'LAWFFT': 1e-3, 'GFISRV2': 1e-3, 'FIGSR': 1e-3, 'GFISR': 1e-3, 'GateR': 1e-3, 'CuGAN': 5e-4, 'RCAN': 5e-4,
    'eimn': 5e-4, 'MoSR': 5e-4, 'Compact': 5e-4, 'spanplus': 2e-4,
}


def matrix_part(part: int, parts: int = 6) -> list:
    """Every ``parts``-th entry of the matrix from ``part``, as pytest params."""
    return [pytest.param(*m, id=m[0]) for m in _MATRIX[part::parts]]


def check_family_gradients(make, arch: str, hw=(24, 32), seed=0):
    """One batch through both packages: loss and every trainable gradient."""
    sd = make()
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert jm.arch_id == tm.arch_id == arch
    rng = np.random.default_rng(seed)
    x = rng.random((1, *hw, 3), dtype=np.float32)
    y = np.asarray(jm.apply(jm.params, jnp.asarray(x)))
    hr = rng.random(y.shape, dtype=np.float32)

    jtrain, jstatic = jax_split(jm.params)

    def jloss(tp):
        return JAX_LOSSES['charbonnier'](jm._apply_fn(jm.config, {**tp, **jstatic}, jnp.asarray(x)), jnp.asarray(hr))

    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(jtrain)
    ttrain, tstatic = split_trainable(tm.params)
    assert set(ttrain) == set(jtrain)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in ttrain.items()}
    with torch.enable_grad():  # another module of the worker may have turned it off (tests/torch_ref.py)
        loss = LOSSES['charbonnier'](tm.apply({**leaves, **tstatic}, torch.from_numpy(x)), torch.from_numpy(hr))
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    tol = FAMILY_TOL[arch]
    bad = []
    for (k, leaf), g in zip(leaves.items(), grads):
        want = np.asarray(jgrads[k])
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        err = float(np.abs(got - want).max())
        if not err <= tol * float(np.abs(want).max()) + 1e-7:
            bad.append((k, err, float(np.abs(want).max())))
    assert not bad, bad


@pytest.mark.parametrize('label,make,arch,name', matrix_part(0))
def test_family_gradients_match_jax(label, make, arch, name):
    check_family_gradients(make, arch)
