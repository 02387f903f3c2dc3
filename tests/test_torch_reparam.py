"""The port's ``nn/reparam.py`` against ``resselt_tpu/nn/reparam.py``,
function for function, on the same random numpy state dicts: exactly equal
outputs (the same numpy arithmetic), covering ``conv3xc_collapse`` with and
without biases, ``seqconv3x3_collapse``, ``repconv_collapse``,
``omnishift_collapse``, ``doconv_collapse`` with and without its ``D``
factor, ``convnxc_collapse``, the kernel composition and padding helpers,
and ``collapse_all`` with SpanPP's RepConv marker and with two markers."""

import numpy as np
import pytest

from resselt_tpu.nn import reparam as jr
from resselt_tpu_torch.nn import reparam as tr


def _rng(seed):
    return np.random.default_rng(seed)


def _t(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _conv3xc(rng, sd, p, cin, cout, bias=True, gain=2):
    sd[f'{p}.sk.weight'] = _t(rng, cout, cin, 1, 1)
    sd[f'{p}.conv.0.weight'] = _t(rng, cin * gain, cin, 1, 1)
    sd[f'{p}.conv.1.weight'] = _t(rng, cout * gain, cin * gain, 3, 3)
    sd[f'{p}.conv.2.weight'] = _t(rng, cout, cout * gain, 1, 1)
    if bias:
        for k, n in (('sk', cout), ('conv.0', cin * gain), ('conv.1', cout * gain), ('conv.2', cout)):
            sd[f'{p}.{k}.bias'] = _t(rng, n)
    sd[f'{p}.eval_conv.weight'] = _t(rng, cout, cin, 3, 3)


def _repconv(rng, sd, p, cin, cout):
    sd[f'{p}.alpha'] = _t(rng, 3)
    sd[f'{p}.conv1.k0'] = _t(rng, 2 * cout, cin, 1, 1)
    sd[f'{p}.conv1.b0'] = _t(rng, 2 * cout)
    sd[f'{p}.conv1.k1'] = _t(rng, cout, 2 * cout, 3, 3)
    sd[f'{p}.conv1.b1'] = _t(rng, cout)
    sd[f'{p}.conv2.weight'] = _t(rng, cout, cin, 3, 3)
    sd[f'{p}.conv2.bias'] = _t(rng, cout)
    _conv3xc(rng, sd, f'{p}.conv3', cin, cout)
    sd[f'{p}.conv_3x3_rep.weight'] = _t(rng, cout, cin, 3, 3)


def _doconv(rng, sd, p, cin, cout, k, with_d):
    sd[f'{p}.W'] = _t(rng, cout, cin, k * k if with_d else 1)
    sd[f'{p}.mul'] = np.asarray([0.7], np.float32)
    sd[f'{p}.bias'] = _t(rng, cout)
    if with_d:
        sd[f'{p}.D'] = _t(rng, cin, k * k, k * k)
        sd[f'{p}.d_diag'] = np.tile(np.eye(k * k, dtype=np.float32)[None], (cin, 1, 1))
    sd[f'{p}.eval_conv.weight'] = _t(rng, cout, cin, k, k)


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('k', [3, 5])
def test_compositions_and_padding(k):
    rng = _rng(k)
    w1, b1 = _t(rng, 6, 4, 1, 1).astype(np.float64), _t(rng, 6).astype(np.float64)
    w2, b2 = _t(rng, 5, 6, k, k).astype(np.float64), _t(rng, 5).astype(np.float64)
    _equal(tr.compose_1x1_kxk(w1, b1, w2, b2), jr.compose_1x1_kxk(w1, b1, w2, b2))
    w3, b3 = _t(rng, 7, 5, 1, 1).astype(np.float64), _t(rng, 7).astype(np.float64)
    _equal(tr.compose_kxk_1x1(w2, b2, w3, b3), jr.compose_kxk_1x1(w2, b2, w3, b3))
    _equal(tr.pad_kernel_to(w1, k), jr.pad_kernel_to(w1, k))
    _equal(tr.pad_kernel_to_rect(w1, k, 3), jr.pad_kernel_to_rect(w1, k, 3))
    w4 = _t(rng, 2, 2, 1, 3)
    _equal(tr.pad_kernel_to_rect(w4, 5, 7), jr.pad_kernel_to_rect(w4, 5, 7))


@pytest.mark.parametrize('bias', [True, False], ids=['biases', 'bias_free'])
@pytest.mark.parametrize('cin,cout', [(3, 8), (8, 8), (16, 4)])
def test_conv3xc_collapse(bias, cin, cout):
    sd = {}
    _conv3xc(_rng(cin + cout), sd, 'blk', cin, cout, bias)
    got, want = tr.conv3xc_collapse(sd, 'blk'), jr.conv3xc_collapse(sd, 'blk')
    _equal(got, want)
    assert (got[1] is None) is (not bias)


def test_seqconv_and_repconv_collapse():
    sd = {}
    _repconv(_rng(1), sd, 'c', 4, 6)
    _equal(tr.seqconv3x3_collapse(sd, 'c.conv1'), jr.seqconv3x3_collapse(sd, 'c.conv1'))
    _equal(tr.repconv_collapse(sd, 'c'), jr.repconv_collapse(sd, 'c'))


def test_omnishift_collapse():
    rng, sd, c = _rng(2), {}, 6
    for i in (1, 2, 3, 4):
        sd[f'o.alpha{i}'] = _t(rng, c)
    for k, name in ((1, 'conv1x1'), (3, 'conv3x3'), (5, 'conv5x5')):
        sd[f'o.{name}.weight'] = _t(rng, c, 1, k, k)
        sd[f'o.{name}.bias'] = _t(rng, c)
    _equal(tr.omnishift_collapse(sd, 'o'), jr.omnishift_collapse(sd, 'o'))


@pytest.mark.parametrize('with_d', [True, False], ids=['with_D', 'without_D'])
def test_doconv_collapse(with_d):
    sd = {}
    _doconv(_rng(3), sd, 'd', 4, 5, 3, with_d)
    _equal(tr.doconv_collapse(sd, 'd'), jr.doconv_collapse(sd, 'd'))


def test_convnxc_collapse():
    rng, sd = _rng(4), {}
    _doconv(rng, sd, 'n.conv.0', 4, 8, 1, False)
    _doconv(rng, sd, 'n.conv.1', 8, 10, 3, True)
    _doconv(rng, sd, 'n.conv.2', 10, 5, 1, False)
    _doconv(rng, sd, 'n.sk', 4, 5, 1, False)
    _equal(tr.convnxc_collapse(sd, 'n'), jr.convnxc_collapse(sd, 'n'))


def _same_dicts(a, b):
    assert list(a) == list(b)
    for k in a:
        _equal(a[k], b[k])


def test_collapse_all_with_spanpp_marker():
    rng, sd = _rng(5), {}
    _repconv(rng, sd, 'conv0', 3, 8)
    _repconv(rng, sd, 'block_1.c1_r', 8, 8)
    sd['conv_cat.weight'] = _t(rng, 8, 32, 1, 1)
    sd['upsampler.freq'] = _t(rng, 72, 16, 1, 1)
    got = tr.collapse_all(sd, {'alpha': (tr.repconv_collapse, 'conv_3x3_rep')})
    _same_dicts(got, jr.collapse_all(sd, {'alpha': (jr.repconv_collapse, 'conv_3x3_rep')}))
    assert set(got) == {'conv0.conv_3x3_rep.weight', 'conv0.conv_3x3_rep.bias', 'block_1.c1_r.conv_3x3_rep.weight',
                        'block_1.c1_r.conv_3x3_rep.bias', 'conv_cat.weight', 'upsampler.freq'}


def test_collapse_all_with_two_markers_and_a_bias_free_bundle():
    rng, sd = _rng(6), {}
    _repconv(rng, sd, 'a', 4, 4)
    _conv3xc(rng, sd, 'b', 4, 4, bias=False)
    sd['keep.weight'] = _t(rng, 4)
    markers_t = {'alpha': (tr.repconv_collapse, 'rep'), 'sk.weight': (tr.conv3xc_collapse, 'eval_conv')}
    markers_j = {'alpha': (jr.repconv_collapse, 'rep'), 'sk.weight': (jr.conv3xc_collapse, 'eval_conv')}
    got = tr.collapse_all(sd, markers_t)
    _same_dicts(got, jr.collapse_all(sd, markers_j))
    assert 'b.eval_conv.weight' in got and 'b.eval_conv.bias' not in got


def test_the_port_has_every_function():
    names = sorted(n for n in vars(jr) if callable(getattr(jr, n)) and not n.startswith('_')
                   and getattr(getattr(jr, n), '__module__', '') == jr.__name__)
    assert names == sorted(n for n in vars(tr) if callable(getattr(tr, n)) and not n.startswith('_')
                           and getattr(getattr(tr, n), '__module__', '') == tr.__name__)
    assert len(names) == 11
