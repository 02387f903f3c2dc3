"""The window-attention and large-kernel conv ports take their TPU kernels'
whole domain.

``resselt_tpu_torch.ops.window_mha`` takes every window length n and every
head_dim, and ``fused_conv_lk`` every odd k, as the JAX kernels do.  On the
CPU each wrapper computes its plain version; here it is held against the
JAX Pallas kernel run in interpret mode (and, for the attention, JAX's XLA
path) at the shapes past the limits the card's kernels once had (n 256,
head_dim 64, k 31), with the tolerances of test_torch_window_attention.py
(2e-4) and test_torch_fused_conv_lk.py (1e-4).  Inputs come from a numpy
seed.  The JAX keywords ``head_pad=`` / ``assume_padded=`` of the attention
are held to JAX's results and errors.  DRCT's and FlexNet's published bench
configurations are checked by shape alone: every window attention they
issue is one the kernel takes.  The CUDA kernels at these shapes are held
against the plain versions in test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from resselt_tpu.nn import window as jw
from resselt_tpu.ops.fused_conv import fused_conv_lk as jax_lk, lk_conv_supported as jax_lk_supported
from resselt_tpu.ops.window_attention import window_mha_pallas
from resselt_tpu_torch.nn import window as tw
from resselt_tpu_torch.ops import fused_conv as fc
from resselt_tpu_torch.ops import window_attention as wa
from resselt_tpu_torch.zoo import make_drct, make_flexnet


torch.set_num_threads(2)

WATTN_TOL = 2e-4  # test_torch_window_attention.py's (test_pallas_ops.py's)
LK_TOL = 1e-4     # test_torch_fused_conv_lk.py's


def _mask(kind, nw, n, rng):
    """A Swin shift mask of 2 x 2 windows of 8 x 8 (n 64), DAT's rectangular
    one for 16 x 20 windows (n 320), else random 0 / -100 entries."""
    if kind is None:
        return None
    if n == 64:
        return tw.swin_attn_mask(16, 16, 8, 4)
    if n == 320:
        return tw.rect_attn_mask(32, 40, 16, 20, 8, 10)
    return np.where(rng.random((nw, n, n)) < 0.2, -100.0, 0.0).astype(np.float32)


def _attn_inputs(n, heads, hd, masked, seed, windows=4):
    rng = np.random.default_rng(seed)
    c = heads * hd
    q, k, v = (rng.standard_normal((windows, n, c), np.float32) for _ in range(3))
    bias = (rng.standard_normal((heads, n, n)) * 0.1).astype(np.float32)
    mask = _mask(masked, 4, n, rng)
    if mask is not None:
        assert mask.shape == (4, n, n)
    return q, k, v, bias, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize('masked', [None, 'shift'], ids=['unmasked', 'masked'])
@pytest.mark.parametrize('n,heads,hd', [
    (64, 2, 65),    # head_dim just past the old limit
    (64, 4, 77),    # DRCT's swin5: 4 heads of 77
    (64, 1, 96),    # a FlexNet-style single wide head
    (64, 2, 122),   # DRCT's swin3: 2 heads of 122
    (64, 1, 128),   # FlexNet's meta level at 2 x 64
    (64, 1, 160),   # past one 128-column slice
    (257, 2, 16),   # n just past the old limit
    (320, 2, 32),   # 16 x 20 windows
], ids=lambda v: str(v))
def test_window_mha_takes_every_n_and_head_dim(n, heads, hd, masked):
    q, k, v, bias, mask = _attn_inputs(n, heads, hd, masked, seed=n + hd)
    scale = hd ** -0.5
    assert wa.window_mha_supported(n, heads * hd, heads)
    pallas = np.asarray(window_mha_pallas(q, k, v, bias, mask, num_heads=heads, scale=scale, interpret=True))
    xla = np.asarray(jw.multi_head_attention(q, k, v, heads, scale, bias=bias, mask=mask))
    got = wa.window_mha(*map(_t, (q, k, v, bias, mask)), num_heads=heads, scale=scale)
    assert got.shape == pallas.shape and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), pallas, rtol=WATTN_TOL, atol=WATTN_TOL)
    np.testing.assert_allclose(got.numpy(), xla, rtol=WATTN_TOL, atol=WATTN_TOL)
    # the model's dispatch sends it to the kernel's wrapper, not to the plain path
    via = tw.multi_head_attention(*map(_t, (q, k, v)), heads, scale, bias=_t(bias), mask=_t(mask))
    assert torch.equal(via, got)


@pytest.mark.parametrize('kw', [
    {'head_pad': 32},                          # pad 2 heads of 24 to 32
    {'head_pad': 24},                          # head_pad == head_dim: nothing to pad
    {'head_pad': 32, 'assume_padded': True},   # heads already 32 wide
])
def test_window_mha_head_pad_keywords_match_jax(kw):
    heads, hd = 2, 32 if kw.get('assume_padded') else 24
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((4, 64, heads * hd), np.float32) for _ in range(3))
    if kw.get('assume_padded'):  # the zero columns above a head_dim of 24
        for t in (q, k, v):
            t.reshape(4, 64, heads, hd)[..., 24:] = 0.0
    bias = (rng.standard_normal((heads, 64, 64)) * 0.1).astype(np.float32)
    mask = tw.swin_attn_mask(16, 16, 8, 4)
    want = np.asarray(window_mha_pallas(q, k, v, bias, mask, num_heads=heads, scale=24 ** -0.5, interpret=True,
                                        **kw))
    got = wa.window_mha(*map(_t, (q, k, v, bias, mask)), num_heads=heads, scale=24 ** -0.5, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=WATTN_TOL, atol=WATTN_TOL)


@pytest.mark.parametrize('kw', [
    {'head_pad': 20},                          # below head_dim 24
    {'head_pad': 48},                          # does not divide 128
    {'assume_padded': True},                   # no head_pad
    {'head_pad': 16, 'assume_padded': True},   # C is not heads x head_pad
])
def test_window_mha_head_pad_keywords_raise_as_jax(kw):
    q = np.zeros((2, 16, 48), np.float32)
    bias = np.zeros((2, 16, 16), np.float32)
    with pytest.raises(ValueError):
        window_mha_pallas(q, q, q, bias, num_heads=2, scale=1.0, interpret=True, **kw)
    with pytest.raises(ValueError):
        wa.window_mha(_t(q), _t(q), _t(q), _t(bias), num_heads=2, scale=1.0, **kw)


def test_window_mha_gradient_at_a_wide_head():
    """The Function's backward (plain f32 from P recomputed, in runs of
    windows) against autograd through the plain version at head_dim 122."""
    q, k, v, bias, mask = _attn_inputs(64, 2, 122, 'shift', seed=11, windows=8)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    refs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    do = torch.from_numpy(np.random.default_rng(12).standard_normal(q.shape, np.float32))
    with torch.enable_grad():  # other test files of a worker may turn it off for the process
        wa.window_mha(*ts, _t(mask), num_heads=2, scale=122 ** -0.5).backward(do)
        wa.window_mha_ref(*refs, _t(mask), num_heads=2, scale=122 ** -0.5).backward(do)
    for got, want in zip(ts, refs):
        torch.testing.assert_close(got.grad, want.grad, rtol=1e-4, atol=1e-4 * want.grad.abs().max().item())


def test_window_mha_backward_runs_bound_the_score_tensors(monkeypatch):
    """Past the run size the backward takes windows a few mask periods at a
    time; its gradients equal one run's."""
    q, k, v, bias, mask = _attn_inputs(64, 2, 65, 'shift', seed=13, windows=16)
    do = np.random.default_rng(14).standard_normal(q.shape, np.float32)
    args = [*map(_t, (q, k, v, bias, mask)), _t(do)]
    whole = wa.window_mha_backward(*args, num_heads=2, scale=0.1)
    monkeypatch.setattr(wa, 'BACKWARD_CHUNK_BYTES', 4 * 2 * 64 * 64 * 4)  # one mask period of 4 windows a run
    runs = wa.window_mha_backward(*args, num_heads=2, scale=0.1)
    for a, b in zip(whole, runs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('b,nw,limit,want', [
    (10, 2, 100, [(0, 10, 0, 2)]),
    (10, 2, 4, [(0, 4, 0, 2), (4, 4, 0, 2), (8, 2, 0, 2)]),
    (10, 5, 3, [(0, 3, 0, 3), (3, 2, 3, 2), (5, 3, 0, 3), (8, 2, 3, 2)]),
    (6, 1, 4, [(0, 4, 0, 1), (4, 2, 0, 1)]),
])
def test_window_launches_split_at_the_grid_limit(b, nw, limit, want):
    """Where one launch's grid cannot hold every window, the wrapper covers
    them with several: whole mask periods where one fits, else runs inside
    a period, each with its own part of the mask."""
    got = wa._launch_ranges(b, nw, limit)
    assert got == want
    covered = [w for w0, count, _, _ in got for w in range(w0, w0 + count)]
    assert covered == list(range(b))
    for w0, count, m0, mnw in got:  # every window meets its own mask window
        assert all((m0 + (w - w0) % mnw) == w % nw for w in range(w0, w0 + count)) and count % mnw == 0


_LK_CASES = [(k, cin, cout) for k in (33, 35, 51) for cin in (8, 16) for cout in (cin // 2, cin)]
_LK_EPILOGUES = [('linear', True), ('lrelu', False), ('lrelu', True), ('linear', False)]


@pytest.mark.parametrize('i', range(len(_LK_CASES)),
                         ids=[f'k{k}-{cin}to{cout}' for k, cin, cout in _LK_CASES])
def test_fused_conv_lk_takes_every_odd_k(i):
    k, cin, cout = _LK_CASES[i]
    act, with_bias = _LK_EPILOGUES[i % len(_LK_EPILOGUES)]
    rng = np.random.default_rng(100 + i)
    x = rng.standard_normal((1, 13, 18, cin)).astype(np.float32)
    wt = (rng.standard_normal((cout, cin, k, k)) * 0.02).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if with_bias else None
    assert fc.lk_conv_supported(cin, cout, k) and jax_lk_supported(cin, cout, k)
    want = np.asarray(jax_lk(x, wt, b, k=k, act=act, interpret=True))
    got = fc.fused_conv_lk(torch.from_numpy(x), torch.from_numpy(wt), None if b is None else torch.from_numpy(b),
                           k=k, act=act)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=LK_TOL, atol=LK_TOL)


def _attentions(sd: dict, window_size: int, heads_of) -> list[tuple[str, int, int, int]]:
    """(block, n, C, heads) of every window attention of a checkpoint: C from
    its qkv projection, heads from ``heads_of(block prefix)``."""
    out = []
    for key, w in sd.items():
        if key.endswith('.qkv.weight'):
            prefix = key[: -len('.qkv.weight')]
            out.append((prefix, window_size ** 2, w.shape[1], heads_of(prefix)))
    return out


def test_drct_bench_attentions_all_take_the_kernel():
    """DRCT at its published bench width (the row of tools/bench_families.py
    labelled 'drct-l 4x', which is DRCT's six groups, not DRCT-L's twelve:
    embed 180, six groups of 6 heads, window 16, gc 32): the 30 window
    attentions a forward, heads of 30, 53, 122, 46 and 77, all on the
    kernel (the heads of 122 and 77 took the plain path before)."""
    sd = make_drct(180, 6, 6, 16, 32, 2.0, 4, img_size=64, seed=0)
    attns = _attentions(sd, 16, lambda p: sd[p + '.relative_position_bias_table'].shape[1])
    assert len(attns) == 30
    assert {c // h for _, _, c, h in attns} == {30, 53, 122, 46, 77}
    for block, n, c, heads in attns:
        assert wa.window_mha_supported(n, c, heads), block


@pytest.mark.parametrize('pipeline', ['linear', 'meta'])
def test_flexnet_bench_attentions_all_take_the_kernel(pipeline):
    """FlexNet at its published bench width (dim 64, window 8, one head over
    the full width): the linear pipeline's six groups at 64, and the meta
    U-Net's levels at 64, 128, 256 and 512 (the wider ones took the plain
    path before)."""
    blocks = (6,) * 6 if pipeline == 'linear' else (2, 2, 2, 2)
    sd = make_flexnet(64, blocks, 4, window_size=8, pipeline_type=pipeline, seed=0)
    attns = _attentions(sd, 8, lambda p: 1)
    assert len(attns) == (36 if pipeline == 'linear' else 14)
    assert {c for _, _, c, _ in attns} == ({64} if pipeline == 'linear' else {64, 128, 256, 512})
    for block, n, c, heads in attns:
        assert wa.window_mha_supported(n, c, heads), block
