"""The port's int8 serving (resselt_tpu_torch.quant, ``F.conv2d_int8``,
``SRModel.quantize_int8``) against resselt_tpu's on the CPU:
``tests/test_quant.py``'s cases with the port's zoo builders in place of
the torch oracle.

``conv2d_int8`` equals JAX's on the same inputs (identical codes, an exact
int32 sum; f32 within 1e-5 relative), ``quantize_params`` gives JAX's arrays
bit for bit, and discovery quantizes exactly the weights JAX's does.  A
quantized model is held to JAX's quantized model within 1e-4 x max|y|:
Compact and SPAN through JAX's jitted forward; ESRGAN through JAX's
op-by-op ``apply``, since the dynamic activation quant amplifies a last-bit
difference anywhere upstream of an int8 conv (a code flips at a rounding
tie): XLA's whole-program jit contracts ESRGAN's residual ``a * 0.2 + x``
and the rescale into FMAs, and perturbing the input by 1e-7 relative moves
the 3-block model's output by about 2% of max|y|, as much as int8 moves it
from float.  Against the float model: rel < 0.2 and not allclose, as JAX's
test."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import resselt_tpu
import resselt_tpu_torch
from resselt_tpu import quant as jquant
from resselt_tpu.nn import functional as JF
from resselt_tpu_torch import quant
from resselt_tpu_torch.nn import functional as F
from resselt_tpu_torch.zoo import make_compact, make_cugan, make_esrgan, make_gater, make_omni, make_span


torch.set_num_threads(2)

INT8_TOL = 1e-4  # x max|y|


@pytest.mark.parametrize('shape,kw', [
    ((2, 9, 10, 40), {'padding': 1}),
    ((1, 11, 7, 32), {'padding': 'same', 'dilation': 2}),
    ((2, 12, 13, 48), {'stride': 2, 'padding': 1}),
    ((1, 3, 4, 64), {}),  # 1x1 below: fewer than 17 rows
    ((1, 6, 5, 33), {'padding': (2, 1)}),
], ids=['3x3', 'same_dilated', 'strided', 'few_rows', 'odd_channels'])
def test_conv2d_int8_matches_jax(shape, kw):
    rng = np.random.default_rng(0)
    k = 1 if shape[-1] == 64 else 3
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((36, shape[-1], k, k)) * 0.1).astype(np.float32)
    b = rng.standard_normal(36).astype(np.float32)
    q, s = jquant.quantize_weight(w)
    want = np.asarray(JF.conv2d_int8(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(b), **kw))
    got = F.conv2d_int8(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(b), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())
    # the manual math of the scheme in f64 numpy (JAX's test)
    s_a = max(np.abs(x).max(), 1e-12) / 127.0
    xq = np.clip(np.round(x / np.float32(s_a)), -127, 127).astype(np.float32)
    acc = F.conv2d(torch.from_numpy(xq).double(), torch.from_numpy(q.astype(np.float64)), **kw).numpy()
    manual = acc * (s[None, None, None, :].astype(np.float64) * s_a) + b
    np.testing.assert_allclose(got.numpy(), manual, rtol=1e-4, atol=1e-4)
    # bf16 in, bf16 out, from the same f32 math
    gb = F.conv2d_int8(torch.from_numpy(x).bfloat16(), torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(b), **kw)
    assert gb.dtype == torch.bfloat16


def test_quantize_params_equals_jax():
    sd = make_esrgan(64, 1, 2, gc=32, seed=3)
    a, na = quant.quantize_params(sd)
    b, nb = jquant.quantize_params(sd)
    assert na == nb > 0 and list(a) == list(b)
    assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    allowed = {k for k in sd if k.endswith('conv1.0.weight')}
    a, na = quant.quantize_params(sd, allowed=allowed)
    b, nb = jquant.quantize_params(sd, allowed=allowed)
    assert na == nb == 3 and all(np.array_equal(a[k], b[k]) for k in a)
    assert quant.MIN_CH == jquant.MIN_CH == 32


def test_eligibility_bounds():
    for shape, key in [((64, 64, 3, 3), 'a.weight'), ((64, 1, 3, 3), 'a.weight'), ((64, 2, 3, 3), 'a.weight'),
                       ((64, 3, 3, 3), 'a.weight'), ((3, 64, 3, 3), 'a.weight'), ((64, 64, 3, 3), 'a.bias'),
                       ((64, 64), 'a.weight'), ((32, 32, 1, 1), 'b.weight'), ((31, 64, 3, 3), 'c.weight')]:
        arr = np.zeros(shape, np.float32)
        assert quant.eligible(key, arr) == jquant.eligible(key, arr)
    assert quant.eligible('a.weight', np.zeros((64, 64, 3, 3), np.float32))
    assert not quant.eligible('a.weight', np.zeros((64, 1, 3, 3), np.float32))  # depthwise
    assert not quant.eligible('a.weight', np.zeros((3, 64, 3, 3), np.float32))  # tail conv


def _int8_keys(params):
    return {k for k, v in params.items() if str(v.dtype) in ('int8', 'torch.int8')}


def _both_quantized(sd):
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    jm = resselt_tpu.load_from_state_dict(sd)
    tq, jq = tm.quantize_int8(), jm.quantize_int8()
    assert _int8_keys(tq.params) == _int8_keys(jq.params) != set()
    for k in _int8_keys(tq.params):
        assert np.array_equal(tq.params[k].numpy(), np.asarray(jq.params[k]))
        assert np.array_equal(tq.params[k + '_scale'].numpy(), np.asarray(jq.params[k + '_scale']))
    return tm, tq, jq


@pytest.mark.parametrize('family', ['compact', 'esrgan', 'span'])
def test_quantized_model_matches_jax(family):
    sd = {'compact': make_compact, 'span': make_span, 'esrgan': lambda: make_esrgan(num_blocks=3)}[family]()
    tm, tq, jq = _both_quantized(sd)
    x = np.random.default_rng(1).random((1, 20, 22, 3), dtype=np.float32)
    got = tq(x).numpy()
    want = np.asarray(jq.apply(jq.params, jnp.asarray(x)) if family == 'esrgan' else jq(x))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= INT8_TOL * float(np.abs(want).max())
    fp = tm(x).numpy()
    rel = np.abs(got - fp).max() / max(np.abs(fp).max(), 1e-6)
    assert rel < 0.2, rel
    assert not np.allclose(got, fp)  # it really took the int8 path
    assert (tq.serving_halo, tq.tile_batch, tq.device) == (tm.serving_halo, tm.tile_batch, tm.device)


def _quantize_and_check(model, size, rel_bound=0.2):
    """quantize_int8's contract: ValueError (nothing eligible) or a model
    whose forward runs and stays close to float."""
    try:
        qm = model.quantize_int8()
    except ValueError:
        return None
    x = np.random.default_rng(3).random(size, dtype=np.float32)
    fp, q = model(x).numpy(), qm(x).numpy()
    assert q.shape == fp.shape
    assert np.abs(q - fp).max() / max(np.abs(fp).max(), 1e-6) < rel_bound
    return qm


def test_discovery_keeps_cugan_transposed_convs_float():
    """CUGAN's UNets read eligible-shaped weights through F.conv_transpose2d,
    which has no int8 path: they stay float, as JAX's discovery leaves them."""
    tm, tq, _ = _both_quantized(make_cugan('2x', seed=7))
    assert _quantize_and_check(tm, (1, 21, 27, 3)) is not None
    for k in _int8_keys(tq.params):
        assert '.conv_bottom.' not in k and 'up' not in k.split('.')[-2], k


def test_discovery_keeps_omni_raw_conv2d_weights_float():
    """OmniSR reads its qkv weights raw (``F.linear`` / ``F.conv2d``): they
    stay float, and the quantized model runs."""
    tm, tq, _ = _both_quantized(make_omni(64, 1, True, 8, 1, 4, seed=9))
    assert not any('to_qkv' in k for k in _int8_keys(tq.params))
    _quantize_and_check(tm, (1, 24, 24, 3))


def test_quantized_mixed_rdb_dequantizes():
    """gc 16: only conv5 of each RDB is shape-eligible; the producer regroup
    needs one dtype, so the int8 member is dequantized (exact math)."""
    sd = make_esrgan(num_blocks=2, gc=16)
    tm, tq, jq = _both_quantized(sd)
    assert all(k.endswith('conv5.0.weight') for k in _int8_keys(tq.params) if '.RDB' in k)
    assert any(k.endswith('conv5.0.weight') for k in _int8_keys(tq.params))
    x = np.random.default_rng(3).random((1, 20, 22, 3), dtype=np.float32)
    want = np.asarray(jq.apply(jq.params, jnp.asarray(x)))
    assert float(np.abs(tq(x).numpy() - want).max()) <= INT8_TOL * float(np.abs(want).max())
    assert _quantize_and_check(tm, (1, 20, 22, 3)) is not None


def test_float_convs_reject_int8_weights():
    x = torch.zeros((1, 8, 8, 64))
    with pytest.raises(TypeError):
        F.conv_transpose2d(x, torch.zeros((64, 64, 2, 2), dtype=torch.int8), stride=2)
    with pytest.raises(TypeError):
        F.conv2d(x, torch.zeros((64, 64, 3, 3), dtype=torch.int8), padding=1)
    with pytest.raises(TypeError):
        F.conv2d_int8(x, torch.zeros((64, 64, 3, 3)), torch.ones(64))


def test_quantize_rejects_ineligible_model():
    tm = resselt_tpu_torch.load_from_state_dict(make_compact(16, 2, 2), device='cpu')  # 16 channels
    with pytest.raises(ValueError, match='no int8-eligible'):
        tm.quantize_int8()
    sd = make_gater()  # depthwise / grouped U-net: JAX's test accepts either outcome; the port's matches JAX's
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    jm = resselt_tpu.load_from_state_dict(sd)
    try:
        want = _int8_keys(jm.quantize_int8().params)
    except ValueError:
        with pytest.raises(ValueError):
            tm.quantize_int8()
        return
    qm = tm.quantize_int8()
    assert _int8_keys(qm.params) == want
    qm(np.random.default_rng(2).random((1, 24, 24, 3), dtype=np.float32))
