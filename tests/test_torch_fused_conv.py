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


# -- ESRGAN's producer step ---------------------------------------------------

# (cin, cout, addend, split, residuals) of the RDB's five producers at nf 64, gc 32: stage 0 takes x and
# splits, stages 1-3 add the carry and split, stage 4 adds the carry and the RDB's (and the RRDB's) input
STEP_STAGES = {'stage0': (64, 192, False, 32, 0), 'stage1': (32, 160, True, 32, 0), 'stage2': (32, 128, True, 32, 0),
               'stage3': (32, 96, True, 32, 0), 'stage4': (32, 64, True, None, 1), 'stage4_rrdb': (32, 64, True, None, 2)}


def _step_operands(stage, dtype, seed=0, n=2, h=11, w=13):
    cin, cout, has_addend, split, n_res = STEP_STAGES[stage]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=g).to(dtype)
    taps = fc.pack_conv3x3_weight(torch.randn((cout, cin, 3, 3), generator=g) / (3 * cin ** 0.5), dtype)
    b = torch.randn((cout,), generator=g) * 0.1
    # the carry as the chain leaves it: a strided slice of the wider producer output before it
    carry = torch.randn((n, h, w, cout + 32), generator=g).to(dtype)[..., 32:] if has_addend else None
    residuals = tuple(torch.randn((n, h, w, cout), generator=g).to(dtype) for _ in range(n_res))
    return x, taps, b, carry, split, residuals


def _chain(x, taps, b, carry, split, residuals):
    """The unfused chain of ESRGAN's ``_rdb`` / ``_rrdb`` around one producer."""
    a = fc.fused_conv3x3_act(x, taps, b)
    if carry is not None:
        a = carry + a
    if split is not None:
        return torch.nn.functional.leaky_relu(a[..., :split], 0.2), a[..., split:]
    for r in residuals:
        a = a * 0.2 + r
    return a


def _kernel_arithmetic(x, taps, b, carry, split, residuals):
    """csrc/conv3x3.cu's step epilogue written out: f32 arithmetic, rounded
    to the dtype after the bias, the addend, the lrelu, each 0.2 scale and
    each residual."""
    dt = x.dtype
    z = fc.fused_conv3x3_act_ref(x.float(), taps.float(), b).to(dt)
    if carry is not None:
        z = (z.float() + carry.float()).to(dt)
    if split is not None:
        f = z[..., :split].float()
        return torch.where(f >= 0, f, f * 0.2).to(dt), z[..., split:]
    for r in residuals:
        z = ((z.float() * 0.2).to(dt).float() + r.float()).to(dt)
    return z


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('stage', list(STEP_STAGES))
def test_step_equals_the_chain(stage, dtype):
    """The plain step is the chain bit for bit, and so is the kernel's
    arithmetic (so the card's step can be held to equality too)."""
    x, taps, b, carry, split, residuals = _step_operands(stage, dtype)
    got = fc.fused_conv3x3_step(x, taps, b, addend=carry, split=split, residuals=residuals)
    want = _chain(x, taps, b, carry, split, residuals)
    arith = _kernel_arithmetic(x, taps, b, carry, split, residuals)
    got, want, arith = [t if isinstance(t, tuple) else (t,) for t in (got, want, arith)]
    assert len(got) == len(want) == (1 if split is None else 2)
    for g_, w_, a_ in zip(got, want, arith):
        assert g_.dtype == dtype and torch.equal(g_, w_) and torch.equal(g_, a_)


_R = torch.zeros((2, 11, 13, 192))
_BAD_STEPS = {'split_and_residual': {'split': 32, 'residuals': (_R,)}, 'neither': {},
              'three_residuals': {'residuals': (_R,) * 3}, 'split_0': {'split': 0}, 'split_cout': {'split': 192},
              'narrow_addend': {'split': 32, 'addend': _R[..., :64]}, 'fp16_residual': {'residuals': (_R.half(),)}}


@pytest.mark.parametrize('bad', list(_BAD_STEPS))
def test_step_rejects(bad):
    x, taps, b, *_ = _step_operands('stage0', torch.float32)
    with pytest.raises(ValueError):
        fc.fused_conv3x3_step(x, taps, b, **_BAD_STEPS[bad])


def test_step_carries_no_gradient():
    x, taps, b, *_ = _step_operands('stage0', torch.float32)
    taps.requires_grad_()
    with torch.enable_grad(), pytest.raises(ValueError, match='no gradient'):
        fc.fused_conv3x3_step(x, taps, b, split=32)
    with torch.no_grad():
        feat, carry = fc.fused_conv3x3_step(x, taps, b, split=32)
    assert feat.shape == (2, 11, 13, 32) and carry.shape == (2, 11, 13, 160)
