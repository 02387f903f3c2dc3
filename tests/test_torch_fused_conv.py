"""resselt_tpu_torch.ops.fused_conv against resselt_tpu's fused 3x3 conv.

On the CPU the port's wrappers compute their plain version; it is held
against the JAX Pallas kernels run in interpret mode, on the shapes and
activations of test_pallas_ops.py, with that file's tolerance (rtol 1e-4,
atol 1e-5).  The ESRGAN widths the JAX kernel cannot take (cout > 128) are
held against JAX's F.conv2d + activation.  The CUDA kernel itself is held
against the plain version in test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from resselt_tpu.nn import functional as JF
from resselt_tpu.ops.fused_conv import fused_conv3x3_act as jax_act, fused_conv3x3_pack2 as jax_pack2
from resselt_tpu_torch.ops import fused_conv as fc


torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
_JACT = {'linear': lambda t: t, 'lrelu': lambda t: JF.leaky_relu(t, 0.2), 'silu': JF.silu, 'mish': JF.mish}


def _inputs(shape, seed, batch=None):
    h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(((batch,) if batch else ()) + (h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((cout, cin, 3, 3)) * 0.05).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, wt, b


@pytest.mark.parametrize('act', ['linear', 'lrelu', 'silu', 'mish'])
@pytest.mark.parametrize('shape', [(32, 128, 64, 64), (48, 160, 48, 64), (16, 128, 3, 64)])
def test_fused_conv3x3_matches_pallas(act, shape):
    x, wt, b = _inputs(shape, 0)
    want = np.asarray(jax_act(x, wt, b, act=act, interpret=True))
    got = fc.fused_conv3x3_act(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b), act=act)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fused_conv3x3_batched_no_bias():
    x, wt, _ = _inputs((24, 128, 32, 32), 1, batch=2)
    want = np.asarray(jax_act(x, wt, None, interpret=True))
    got = fc.fused_conv3x3_act(torch.from_numpy(x), torch.from_numpy(wt))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('act', ['linear', 'lrelu', 'mish'])
@pytest.mark.parametrize('shape', [(32, 128, 64, 64), (24, 130, 48, 32), (17, 128, 3, 64), (8, 256, 64, 16)])
def test_fused_conv3x3_pack2_matches_pallas(act, shape):
    x, wt, b = _inputs(shape, 2)
    want = np.asarray(jax_pack2(x, wt, b, act=act, interpret=True))
    got = fc.fused_conv3x3_pack2(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b), act=act)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('x_shape,w_shape', [((8, 128, 96), (96, 96, 3, 3)), ((8, 127, 32), (32, 32, 3, 3))],
                         ids=['wide_channels', 'odd_width'])
def test_pack2_rejects_what_jax_rejects(x_shape, w_shape):
    x, wt = np.zeros(x_shape, np.float32), np.zeros(w_shape, np.float32)
    with pytest.raises(ValueError):
        jax_pack2(x, wt, interpret=True)
    with pytest.raises(ValueError):
        fc.fused_conv3x3_pack2(torch.from_numpy(x), torch.from_numpy(wt))
    with pytest.raises(ValueError):  # the packed-weight form is checked alike
        fc.fused_conv3x3_pack2(torch.from_numpy(x), fc.pack_conv3x3_weight(torch.from_numpy(wt)))


@pytest.mark.parametrize('cin,cout,act', [(64, 192, 'linear'), (32, 160, 'linear'), (32, 128, 'linear'),
                                          (32, 96, 'linear'), (12, 64, 'linear'), (64, 3, 'lrelu')])
def test_esrgan_widths_match_jax_conv(cin, cout, act):
    x, wt, b = _inputs((13, 21, cin, cout), 3, batch=2)
    want = np.asarray(_JACT[act](JF.conv2d(x, wt, b, padding=1)))
    got = fc.fused_conv3x3_act(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b), act=act)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_packed_weights_equal_oihw():
    x, wt, b = _inputs((9, 11, 32, 96), 4, batch=1)
    xt, wtt, bt = map(torch.from_numpy, (x, wt, b))
    taps = fc.pack_conv3x3_weight(wtt)
    assert taps.shape == (9, 32, 96) and taps.is_contiguous()
    # [dy*3+dx][ci][co] is OIHW's (co, ci, dy, dx)
    assert torch.equal(taps[1 * 3 + 2, 5, 7], wtt[7, 5, 1, 2])
    assert torch.equal(fc.fused_conv3x3_act(xt, taps, bt, 'silu'), fc.fused_conv3x3_act(xt, wtt, bt, 'silu'))


def test_bf16_on_cpu_rounds_the_f32_result():
    x, wt, b = _inputs((10, 12, 32, 64), 5, batch=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = fc.pack_conv3x3_weight(torch.from_numpy(wt), torch.bfloat16)
    got = fc.fused_conv3x3_act(xb, wb, torch.from_numpy(b), act='lrelu')
    assert got.dtype == torch.bfloat16
    want = fc.fused_conv3x3_act_ref(xb.float(), wb.float(), torch.from_numpy(b), act='lrelu')
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=0.0)


def test_cpu_calls_do_not_count_launches():
    entries = (fc.fused_conv3x3_act, fc.fused_conv3x3_pack2)
    before = [(e.launches, sum(e.by_shape.values())) for e in entries]
    x = torch.zeros((1, 4, 4, 8))
    fc.fused_conv3x3_act(x, torch.zeros((8, 8, 3, 3)))
    fc.fused_conv3x3_pack2(x, torch.zeros((8, 8, 3, 3)))
    assert [(e.launches, sum(e.by_shape.values())) for e in entries] == before
