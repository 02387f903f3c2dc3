"""resselt_tpu_torch.ops.fused_molrcm against resselt_tpu.

On the CPU the port's wrapper computes its plain version; it is held
against the JAX Pallas kernel run in interpret mode and against JAX's
``archs/eimn.py::_molrcm`` (the plain XLA chain), in f32, at
test_pallas_ops.py's shapes and with its tolerance (1.5e-3 x max|want|).
The shape gate is held equal to JAX's, the weight packing to the torch
layout, and the CPU path launches nothing.  The CUDA kernel itself is held
against the plain version in test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resselt_tpu.archs.eimn import _molrcm as jax_molrcm
from resselt_tpu.nn.params import PTree as JPTree
from resselt_tpu.ops.molrcm import fused_molrcm as jax_fused_molrcm, molrcm_supported as jax_supported
from resselt_tpu_torch.archs.eimn import _molrcm as port_molrcm
from resselt_tpu_torch.nn.params import PTree
from resselt_tpu_torch.ops import molrcm as mo


torch.set_num_threads(2)

TOL = 1.5e-3  # x max|want|: tests/test_pallas_ops.py::test_fused_molrcm


def _params(d, seed=0, bias=True):
    """test_pallas_ops.py's construction: weights and biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    c1, c2 = int(3 / 8 * d), int(1 / 8 * d)
    params = {}
    for name, (o, i, k) in {'proj_value.0': (d, d, 1), 'proj_query.0': (d, d, 1), 'region': (d, 1, 5),
                            'spatial_1': (c1, 1, 5), 'spatial_2': (d - c1 - c2, 1, 7), 'fusion': (d, d, 1),
                            'out': (d, d, 1)}.items():
        params[f'{name}.weight'] = rng.standard_normal((o, i, k, k), np.float32) * 0.1
        if bias:
            params[f'{name}.bias'] = rng.standard_normal((o,), np.float32) * 0.1
    return params


def _port(params):
    return PTree({k: torch.from_numpy(v) for k, v in params.items()})


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize('shape,th', [((2, 37, 45, 64), 16), ((1, 16, 128, 64), 8)])
def test_plain_matches_pallas_and_chain(shape, th):
    d = shape[-1]
    params = _params(d)
    x = np.random.default_rng(1).standard_normal(shape, np.float32) * 0.3
    jp = JPTree({k: jnp.asarray(v) for k, v in params.items()})
    chain = np.asarray(jax_molrcm(jp, jnp.asarray(x), d))
    pallas = np.asarray(jax_fused_molrcm(jp, jnp.asarray(x), d, th=th, interpret=True))

    packed = mo.pack_molrcm_weights(_port(params))
    before, shapes = mo.fused_molrcm.launches, dict(mo.fused_molrcm.by_shape)
    got = mo.fused_molrcm(torch.from_numpy(x), packed)
    assert mo.fused_molrcm.launches == before and dict(mo.fused_molrcm.by_shape) == shapes
    assert got.shape == shape and got.dtype == torch.float32 and got.is_contiguous()
    _close(got.numpy(), chain)
    _close(got.numpy(), pallas)
    assert torch.equal(got, mo.fused_molrcm_ref(torch.from_numpy(x), packed))


@pytest.mark.parametrize('shape,bias', [((1, 1, 1, 64), True), ((3, 15, 17, 64), True), ((1, 16, 16, 64), True),
                                        ((3, 17, 15, 64), True), ((1, 300, 16, 64), True),
                                        ((3, 16, 300, 64), False)])
def test_plain_matches_chain_at_strip_edges(shape, bias):
    """The edges of the 16-bit kernel's 16-column strips and runs of rows
    (h and w of 1, 15, 16, 17 and 300; n of 1 and 3; without biases): the
    plain version against JAX's plain chain."""
    params = _params(64, seed=7, bias=bias)
    x = np.random.default_rng(8).standard_normal(shape, np.float32) * 0.3
    want = np.asarray(jax_molrcm(JPTree({k: jnp.asarray(v) for k, v in params.items()}), jnp.asarray(x), 64))
    got = mo.fused_molrcm(torch.from_numpy(x), mo.pack_molrcm_weights(_port(params)))
    assert got.shape == shape
    _close(got.numpy(), want)


@pytest.mark.parametrize('shape', [(3, 15, 17, 64), (1, 17, 15, 64)])
def test_plain_matches_pallas_at_strip_edges(shape):
    params = _params(64, seed=9)
    x = np.random.default_rng(10).standard_normal(shape, np.float32) * 0.3
    jp = JPTree({k: jnp.asarray(v) for k, v in params.items()})
    pallas = np.asarray(jax_fused_molrcm(jp, jnp.asarray(x), 64, th=8, interpret=True))
    _close(mo.fused_molrcm(torch.from_numpy(x), mo.pack_molrcm_weights(_port(params))).numpy(), pallas)


@pytest.mark.parametrize('bias', [True, False], ids=['bias', 'no_bias'])
def test_port_chain_and_kernel_path_agree(bias):
    """The port's ``_molrcm``: with packed weights (the kernel's path) and
    without (the plain chain outside the gate), and JAX's chain, on an
    image smaller than the dilated conv's reach; biases optional, as JAX's
    ``_wb`` allows."""
    params = _params(64, seed=2, bias=bias)
    x = np.random.default_rng(3).standard_normal((1, 7, 11, 64), np.float32) * 0.3
    chain = port_molrcm(_port(params), torch.from_numpy(x), 64).numpy()
    with_packed = dict(_port(params)._d, molrcm=mo.pack_molrcm_weights(_port(params)))
    fused = port_molrcm(PTree(with_packed), torch.from_numpy(x), 64).numpy()
    want = np.asarray(jax_molrcm(JPTree({k: jnp.asarray(v) for k, v in params.items()}), jnp.asarray(x), 64))
    _close(chain, want)
    _close(fused, want)


def test_bf16_input_is_computed_in_f32():
    params = _params(64, seed=4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 9, 20, 64), np.float32)).to(torch.bfloat16)
    packed = mo.pack_molrcm_weights(_port(params), torch.bfloat16)
    got = mo.fused_molrcm(x, packed)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mo.fused_molrcm_ref(x.float(), packed).to(torch.bfloat16))


def test_pack_layout():
    """1x1 weights as torch's [c_out][k], taps as [dy * K + dx][c], each
    with its bias, rounded to the dtype and held in f32; absent biases are
    zeros."""
    params = _params(64, seed=6)
    del params['region.bias']
    p = _port(params)
    packed = mo.pack_molrcm_weights(p, torch.bfloat16)
    assert packed.dtype == torch.float32 and packed.shape == (mo.packed_size(64),) and packed.numel() == 20528
    u = mo._unpack(packed, 64)
    wq = p['proj_query.0.weight'].to(torch.bfloat16).float()
    assert torch.equal(u['wq'], wq.reshape(64, 64))
    w2 = p['spatial_2.weight'].to(torch.bfloat16).float()
    assert u['w2'].shape == (49, 32) and torch.equal(u['w2'][3 * 7 + 2, 9], w2[9, 0, 3, 2])
    assert torch.equal(u['br'], torch.zeros(64))
    assert torch.equal(u['bo'], p['out.bias'].to(torch.bfloat16).float())


@pytest.mark.parametrize('h,w', [(1, 1), (37, 45), (0, 5), (4, 0)])
def test_supported_matches_jax(h, w):
    assert [mo.molrcm_supported(d, h, w) for d in range(8, 129)] == [jax_supported(d, h, w) for d in range(8, 129)]
    assert mo.molrcm_supported(64, h, w) == (h >= 1 and w >= 1)


def test_wrapper_refuses_what_it_does_not_take():
    packed = mo.pack_molrcm_weights(_port(_params(64)))
    with pytest.raises(ValueError):  # outside the gate
        mo.fused_molrcm(torch.zeros((1, 8, 8, 48)), packed)
    with pytest.raises(ValueError):  # not NHWC
        mo.fused_molrcm(torch.zeros((8, 8, 64)), packed)
    with pytest.raises(ValueError):  # packed for another width
        mo.fused_molrcm(torch.zeros((1, 8, 8, 64)), packed[:-1])
