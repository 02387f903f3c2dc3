"""resselt_tpu_torch.ops.fused_conv_lk against resselt_tpu's fused_conv_lk.

On the CPU the port's wrapper computes its plain version; it is held
against the JAX Pallas kernel run in interpret mode, on the shapes of
test_pallas_ops.py's test_fused_conv_lk, with that test's tolerance (rtol
= atol = 1e-4), with and without bias, linear and lrelu.  The port's shape
predicate takes every shape JAX's takes (k up to 31), and the wrapper
refuses what JAX's refuses.  The CUDA kernel itself is held against the
plain version in test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from resselt_tpu.ops.fused_conv import fused_conv_lk as jax_lk, lk_conv_supported as jax_supported
from resselt_tpu_torch.ops import fused_conv as fc


torch.set_num_threads(2)

TOL = 1e-4


def _inputs(h, w, cin, cout, k, seed, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((cout, cin, k, k)) * 0.05).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, wt, b


@pytest.mark.parametrize('h,w,cin,cout,k', [
    (40, 256, 16, 16, 17),  # PLKSR-S partial conv shape class
    (32, 128, 32, 32, 13),
    (24, 128, 16, 8, 5),
    (19, 200, 16, 16, 17),  # unaligned h/w
])
def test_fused_conv_lk_matches_pallas(h, w, cin, cout, k):
    x, wt, b = _inputs(h, w, cin, cout, k, 0)
    want = np.asarray(jax_lk(x, wt, b, k=k, interpret=True))
    got = fc.fused_conv_lk(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b), k=k)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize('h,w,cin,cout,k,act', [
    (15, 17, 8, 8, 3, 'lrelu'),     # mma path
    (17, 33, 16, 16, 17, 'lrelu'),  # stacked path, ragged
    (1, 40, 16, 5, 13, 'linear'),   # stacked path, Cout below a tile, one row
    (12, 14, 32, 24, 13, 'lrelu'),  # tiles path
    (9, 11, 64, 40, 31, 'linear'),  # k 31 at Cin 64: mma path
    (8, 20, 64, 64, 3, 'linear'),   # tiles path, k 3
])
def test_fused_conv_lk_matches_pallas_at_path_edges(h, w, cin, cout, k, act):
    """The shape classes of the card's three 16-bit paths, the plain version
    against the Pallas kernel."""
    x, wt, b = _inputs(h, w, cin, cout, k, 4, batch=1)
    want = np.asarray(jax_lk(x, wt, b, k=k, act=act, interpret=True))
    got = fc.fused_conv_lk(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b), k=k, act=act)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize('act', ['linear', 'lrelu'])
@pytest.mark.parametrize('bias', [True, False], ids=['bias', 'no_bias'])
def test_fused_conv_lk_bias_and_act(act, bias):
    x, wt, b = _inputs(16, 128, 8, 8, 9, 1, batch=1)
    b = b if bias else None
    want = np.asarray(jax_lk(x, wt, b, k=9, act=act, interpret=True))
    got = fc.fused_conv_lk(torch.from_numpy(x), torch.from_numpy(wt), None if b is None else torch.from_numpy(b),
                           k=9, act=act)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_hwc_and_packed_weights():
    x, wt, b = _inputs(9, 11, 16, 12, 7, 2, batch=1)
    xt, wtt, bt = map(torch.from_numpy, (x, wt, b))
    taps = fc.pack_conv_lk_weight(wtt)
    assert taps.shape == (49, 16, 12) and taps.is_contiguous()
    # [dy*k+dx][ci][co] is OIHW's (co, ci, dy, dx)
    assert torch.equal(taps[2 * 7 + 5, 3, 9], wtt[9, 3, 2, 5])
    y = fc.fused_conv_lk(xt, wtt, bt, k=7, act='lrelu')
    assert torch.equal(fc.fused_conv_lk(xt, taps, bt, k=7, act='lrelu'), y)
    assert torch.equal(fc.fused_conv_lk(xt[0], taps, bt, k=7, act='lrelu'), y[0])


def test_channel_slice_equals_contiguous():
    """PLKSR hands the conv x[..., :pdim] of a wider tensor."""
    x, wt, b = _inputs(10, 13, 64, 16, 5, 3)
    wide = torch.from_numpy(x)
    part = fc.fused_conv_lk(wide[..., :16], torch.from_numpy(wt[:, :16]).contiguous(), torch.from_numpy(b), k=5)
    full = fc.fused_conv_lk(wide[..., :16].contiguous(), torch.from_numpy(wt[:, :16]).contiguous(),
                            torch.from_numpy(b), k=5)
    assert torch.equal(part, full)


def test_supported_takes_every_shape_jax_takes():
    for cin in range(1, 70):
        for cout in range(0, 70):
            for k in range(0, 33):
                port, jax = fc.lk_conv_supported(cin, cout, k), jax_supported(cin, cout, k)
                if k <= 31:
                    assert port == jax, (cin, cout, k)
                else:
                    assert not port


@pytest.mark.parametrize('case', ['24_channels', 'silu', 'even_k', 'cout_gt_cin'])
def test_rejects_what_jax_rejects(case):
    cin, cout, k, act = {'24_channels': (24, 24, 17, 'linear'), 'silu': (16, 16, 17, 'silu'),
                         'even_k': (16, 16, 4, 'linear'), 'cout_gt_cin': (8, 16, 5, 'linear')}[case]
    x = np.zeros((2, 32, 128, cin), np.float32)
    wt = np.zeros((cout, cin, k, k), np.float32)
    with pytest.raises(ValueError):
        jax_lk(x, wt, k=k, act=act, interpret=True)
    with pytest.raises(ValueError):
        fc.fused_conv_lk(torch.from_numpy(x), torch.from_numpy(wt), k=k, act=act)


def test_bf16_on_cpu_rounds_the_f32_result():
    x, wt, b = _inputs(10, 12, 16, 16, 17, 5, batch=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = fc.pack_conv_lk_weight(torch.from_numpy(wt), torch.bfloat16)
    got = fc.fused_conv_lk(xb, wb, torch.from_numpy(b), k=17, act='lrelu')
    assert got.dtype == torch.bfloat16
    want = fc.fused_conv_lk_ref(xb.float(), wb.float(), torch.from_numpy(b), k=17, act='lrelu')
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=0.0)


def test_cpu_calls_do_not_count_launches():
    before = (fc.fused_conv_lk.launches, sum(fc.fused_conv_lk.by_shape.values()))
    fc.fused_conv_lk(torch.zeros((1, 4, 4, 8)), torch.zeros((8, 8, 5, 5)), k=5)
    fc.fused_conv_lk(torch.zeros((0, 4, 4, 8)), torch.zeros((8, 8, 5, 5)), k=5)
    assert (fc.fused_conv_lk.launches, sum(fc.fused_conv_lk.by_shape.values())) == before
