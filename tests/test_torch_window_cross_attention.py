"""resselt_tpu_torch.ops.window_cross_mha (HAT's overlapping cross-attention)
and the route that sends ``nn.window.multi_head_attention`` to it, on the
CPU.

The wrapper's plain version ``window_cross_mha_ref`` is held to the plain
path ``nn.window._mha_plain`` (which computes what the JAX package's
``_mha_xla`` does) in f32 at OCAB's shapes, with test_torch_window_attention.py's
tolerance; the route's rule (``takes_cross_kernel``) is held case by case;
the kernel's name is a ``__global__`` of the source that ``h100_bench``
reads.  The CUDA kernel itself is held against the plain version in
test_torch_kernels_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

from resselt_tpu_torch.nn import window as tw
from resselt_tpu_torch.ops import window_cross_attention as wca


torch.set_num_threads(2)

TOL = 2e-4


def _inputs(b, n, m, c, heads, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, n, c), np.float32))
    kv = torch.from_numpy(rng.standard_normal((b, m, 2 * c), np.float32))
    bias = torch.from_numpy((rng.standard_normal((heads, n, m)) * 0.5).astype(np.float32))
    return q, kv[..., :c], kv[..., c:], bias


@pytest.mark.parametrize('b,n,m,c,heads', [
    (2, 64, 144, 24, 3),   # window 8, overlap 12 (the CPU tests' HAT)
    (2, 16, 36, 12, 2),    # window 4, overlap 6
    (1, 256, 576, 36, 6),  # window 16, overlap 24 (HAT-L's geometry at a small width)
    (3, 64, 100, 48, 4),   # window 8, overlap 10
])
def test_ref_matches_plain_path(b, n, m, c, heads):
    q, k, v, bias = _inputs(b, n, m, c, heads, seed=m)
    scale = (c // heads) ** -0.5
    want = tw._mha_plain(q, k, v, heads, scale, bias, None)
    got = wca.window_cross_mha_ref(q, k, v, bias, num_heads=heads, scale=scale)
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    # the wrapper on the CPU is its plain version, and counts no launch
    before = wca.window_cross_mha.launches
    torch.testing.assert_close(wca.window_cross_mha(q, k, v, bias, num_heads=heads, scale=scale), got, rtol=0, atol=0)
    assert wca.window_cross_mha.launches == before


def test_ref_keeps_f32_scores_in_bf16():
    """In bf16 the plain version rounds only its inputs and its output: it
    equals the f32 version on the rounded inputs, rounded once."""
    q, k, v, bias = _inputs(2, 64, 144, 24, 3, seed=1)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = wca.window_cross_mha_ref(qb, kb, vb, bias, num_heads=3, scale=0.3)
    want = wca.window_cross_mha_ref(qb.float(), kb.float(), vb.float(), bias, num_heads=3, scale=0.3)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_multi_head_attention_keeps_the_plain_path_on_the_cpu():
    q, k, v, bias = _inputs(2, 64, 144, 24, 3, seed=2)
    before = wca.window_cross_mha.launches
    got = tw.multi_head_attention(q, k, v, 3, 0.3, bias=bias)
    assert wca.window_cross_mha.launches == before
    torch.testing.assert_close(got, tw._mha_plain(q, k, v, 3, 0.3, bias, None), rtol=0, atol=0)


_TAKEN = dict(dtype=torch.bfloat16, on_cuda=True, needs_grad=False, has_bias=True, has_mask=False, scale=0.18)


@pytest.mark.parametrize('change,taken', [
    ({}, True),                                  # HAT-L's served OCAB
    ({'dtype': torch.float16}, True),
    ({'dtype': torch.float32}, False),           # f32: the plain path, as in the JAX package
    ({'on_cuda': False}, False),                 # the CPU
    ({'needs_grad': True}, False),               # training
    ({'has_bias': False}, False),
    ({'has_mask': True}, False),
    ({'scale': 0.0}, False),
    ({'m': 256}, False),                         # as many keys as queries: window_mha's
    ({'m': 577}, False),                         # more keys than the kernel's stage holds
    ({'c': 192}, True),                          # heads of 32, the widest the kernel takes
    ({'c': 204}, False),                         # heads of 34
    ({'c': 144}, True),                          # HAT-S: heads of 24
    ({'c': 186}, False),                         # heads of 31: odd
])
def test_route_rule(change, taken):
    case = dict(n=256, m=576, c=180, num_heads=6, **_TAKEN)
    case.update(change)
    n, m, c, heads = (case.pop(key) for key in ('n', 'm', 'c', 'num_heads'))
    assert tw.takes_cross_kernel(n, m, c, heads, **case) == taken


def test_route_rule_follows_the_switch(monkeypatch):
    assert tw.takes_cross_kernel(256, 576, 180, 6, **_TAKEN)
    monkeypatch.setattr(tw, '_FUSED_ATTENTION', False)
    assert not tw.takes_cross_kernel(256, 576, 180, 6, **_TAKEN)


@pytest.mark.parametrize('n,m,c,heads,supported', [
    (256, 576, 180, 6, True), (64, 144, 24, 3, True), (1, 1, 2, 1, True), (256, 577, 180, 6, False),
    (256, 576, 180, 5, False), (256, 576, 68, 2, False), (256, 576, 30, 6, False), (0, 576, 180, 6, False),
    (256, 576, 180, 0, False),
])
def test_supported_rule(n, m, c, heads, supported):
    assert wca.window_cross_mha_supported(n, m, c, heads) == supported


@pytest.mark.parametrize('shapes', [
    ((2, 64, 24), (2, 144, 24), (2, 144, 24), (3, 64, 100)),  # bias of the wrong shape
    ((2, 64, 24), (2, 144, 24), (2, 140, 24), (3, 64, 144)),  # k and v of different shapes
    ((2, 64, 24), (3, 144, 24), (3, 144, 24), (3, 64, 144)),  # windows differ
    ((2, 64, 24), (2, 144, 20), (2, 144, 20), (3, 64, 144)),  # channels differ
])
def test_rejects_what_it_does_not_take(shapes):
    q, k, v, bias = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        wca.window_cross_mha(q, k, v, bias, num_heads=3, scale=0.3)


def test_kernel_is_a_kernel_of_the_source():
    """The ``__global__`` the trace's device time is read by, found in the
    source the way ``h100_bench.trace.kernels_in`` finds it."""
    import re

    import resselt_tpu_torch

    src = os.path.join(os.path.dirname(resselt_tpu_torch.__file__), 'csrc', 'window_cross_attn.cu')
    with open(src) as fh:
        text = fh.read()
    names = set(re.findall(r'__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)', text))
    assert names == {'wcross_wgmma_kernel'}
    chunk = int(re.search(r'constexpr int CK = (\d+);', text).group(1))
    chunks = int(re.search(r'constexpr int MAX_KEYS = (\d+) \* CK;', text).group(1))
    assert chunk * chunks == wca.MAX_KEYS  # the wrapper's rule holds the source's limits
    assert f'constexpr int MAX_HD = {wca.MAX_HEAD_DIM};' in text
