"""The port's ESRGAN (resselt_tpu_torch) against resselt_tpu on the same
state dicts, on the CPU in f32, with test_conv_archs.py's TOL (5e-4):
scales 1/2/4, the plus variant, pixel-unshuffle checkpoints, both new-arch
key spellings and a params_ema wrapper; plus params_from_numpy carrying a
JAX model's params across.  The served 16-bit forward's producer steps
(``fused_conv3x3_step``) against the chain of ops they replace: bit for
bit, and which forwards take them."""

import re
from collections import Counter

import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu_torch
from resselt_tpu.zoo import make_esrgan as jax_make_esrgan
from resselt_tpu_torch.archs import esrgan as E
from resselt_tpu_torch.core import ModelMetadata, params_from_numpy
from resselt_tpu_torch.ops import conv_route as cr
from resselt_tpu_torch.zoo import make_esrgan


torch.set_num_threads(2)

TOL = 5e-4


def _both(sd, x):
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert tm.arch_id == jm.arch_id == 'ESRGAN'
    assert tm.metadata == ModelMetadata(**vars(jm.metadata))
    assert tm.config.__dict__ == jm.config.__dict__
    assert tm.serving_halo == jm.serving_halo
    want = np.asarray(jm(x))
    got = tm(x).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err < TOL, f'max err {err}'
    return tm, jm


def _x(h, w, c=3, seed=0):
    return np.random.default_rng(seed).random((1, h, w, c), dtype=np.float32)


def test_zoo_make_esrgan_is_the_jax_one():
    a, b = make_esrgan(16, 2, 4, gc=8, seed=3), jax_make_esrgan(16, 2, 4, gc=8, seed=3)
    assert list(a) == list(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize('scale,num_blocks', [(1, 2), (2, 1), (4, 2)])
def test_esrgan_scales(scale, num_blocks):
    sd = make_esrgan(16, num_blocks, scale, gc=8, seed=scale)
    tm, _ = _both(sd, _x(12, 14))
    assert tm.metadata.upscale == scale and tm.config.num_blocks == num_blocks


def test_esrgan_plus():
    sd = make_esrgan(16, 2, 4, gc=8, seed=5)
    rng = np.random.default_rng(6)
    for b in range(2):
        for r in (1, 2, 3):
            sd[f'model.1.sub.{b}.RDB{r}.conv1x1.weight'] = (rng.standard_normal((8, 16, 1, 1)) * 0.03).astype(np.float32)
    tm, _ = _both(sd, _x(12, 14))
    assert tm.config.plus is True


@pytest.mark.parametrize('in_nc,factor', [(12, 2), (48, 4)])
def test_esrgan_pixel_unshuffle(in_nc, factor):
    sd = make_esrgan(16, 1, 4, in_nc=in_nc, gc=8, seed=7)
    # odd sizes exercise the reflect pad and the output crop
    tm, _ = _both(sd, _x(13, 15))
    assert tm.config.shuffle_factor == factor
    assert tm.metadata == ModelMetadata(3, 3, 4 // factor, 'ESRGAN')


def _new_arch(sd, spelling):
    out = {}
    for k, v in sd.items():
        m = re.match(r'model\.1\.sub\.(\d+)\.RDB(\d)\.conv(\d+)\.0\.(weight|bias)', k)
        if m:
            if spelling == 'bsrgan':
                out[f'RRDB_trunk.{m.group(1)}.RDB{m.group(2)}.conv{m.group(3)}.{m.group(4)}'] = v
            else:
                out[f'body.{m.group(1)}.rdb{m.group(2)}.conv{m.group(3)}.{m.group(4)}'] = v
            continue
        names = {'model.0.': 'conv_first.', 'model.1.sub.2.': ('trunk_conv.' if spelling == 'bsrgan' else 'conv_body.'),
                 'model.3.': ('upconv1.' if spelling == 'bsrgan' else 'conv_up1.'),
                 'model.6.': ('upconv2.' if spelling == 'bsrgan' else 'conv_up2.'),
                 'model.8.': ('HRconv.' if spelling == 'bsrgan' else 'conv_hr.'), 'model.10.': 'conv_last.'}
        for old, new in names.items():
            if k.startswith(old):
                out[new + k[len(old):]] = v
                break
        else:
            raise AssertionError(k)
    return out


@pytest.mark.parametrize('spelling', ['bsrgan', 'realesrgan'])
def test_esrgan_new_arch_keys(spelling):
    old = make_esrgan(16, 2, 4, gc=8, seed=8)
    new = _new_arch(old, spelling)
    assert 'conv_first.weight' in new and 'model.0.weight' not in new
    tm, _ = _both(new, _x(8, 9))
    ref = resselt_tpu_torch.load_from_state_dict(old, device='cpu')
    assert torch.equal(tm(_x(8, 9)), ref(_x(8, 9)))


def test_esrgan_params_ema_wrapper():
    sd = make_esrgan(16, 1, 2, gc=8, seed=9)
    _both({'params_ema': sd}, _x(10, 11))


def test_params_from_numpy_carries_jax_params():
    sd = make_esrgan(16, 1, 4, gc=8, seed=10)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, 'cpu')
    assert set(carried) == set(tm.params)
    assert all(carried[k].dtype == torch.float32 for k in carried)
    x = _x(9, 12)
    want = np.asarray(jm(x))
    got = tm.apply(carried, torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) < TOL


def test_params_from_numpy_widens_and_casts():
    import ml_dtypes

    p = {'h': np.ones(3, np.float16), 'b': np.ones(2, ml_dtypes.bfloat16), 'i': np.arange(3)}
    out = params_from_numpy(p, 'cpu')
    assert out['h'].dtype == out['b'].dtype == torch.float32 and out['i'].dtype == torch.int64
    out = params_from_numpy(p, 'cpu', dtype='bfloat16')
    assert out['h'].dtype == torch.bfloat16 and out['i'].dtype == torch.int64


def test_call_semantics_match_jax():
    """uint8 -> /255, HWC in -> HWC out, dtype cast; bf16 close to f32."""
    sd = make_esrgan(16, 1, 2, gc=8, seed=11)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = (np.random.default_rng(12).random((10, 13, 3)) * 255).astype(np.uint8)
    want = np.asarray(jm(img))
    got = tm(img)
    assert got.shape == want.shape == (20, 26, 3)
    assert float(np.abs(got.numpy() - want).max()) < TOL
    bf = tm(img, dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    mse = float(((bf.float() - got) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 35
    assert tm(img, dtype='bfloat16').dtype == torch.bfloat16


def test_prepared_weights_are_built_once_per_dtype():
    tm = resselt_tpu_torch.load_from_state_dict(make_esrgan(16, 1, 2, gc=8, seed=13), device='cpu')
    w32 = tm.weights(torch.float32)
    assert tm.weights(torch.float32) is w32
    wb = tm.weights(torch.bfloat16)
    assert wb is not w32 and wb['rdb'][0][0]['producers'][0].w.dtype == torch.bfloat16
    # stage-0 producer: all five convs' slices that read x, 4gc+nf outputs, as the 3x3 kernel's taps
    assert wb['rdb'][0][0]['producers'][0].w.shape == (9, 16, 4 * 8 + 16)
    assert [p.w.shape[2] for p in wb['rdb'][0][0]['producers']] == [48, 40, 32, 24, 16]


def test_with_config_and_registry():
    tm = resselt_tpu_torch.load_from_state_dict(make_esrgan(16, 1, 2, gc=8, seed=14), device='cpu')
    clone = tm.with_config(plus=False)
    assert clone.params is not None and clone.serving_halo == tm.serving_halo
    assert resselt_tpu_torch.get('ESRGAN').id == 'ESRGAN'
    with pytest.raises(resselt_tpu_torch.ArchitectureNotFound):
        resselt_tpu_torch.get('nope')
    with pytest.raises(resselt_tpu_torch.ArchitectureNotFound):
        resselt_tpu_torch.load_from_state_dict({'foo.weight': np.zeros(3, np.float32)}, device='cpu')


# -- the served forward's producer steps ----------------------------------------


class _Launches:
    """The conv3x3 kernel's launches a forward would make on the card, read
    on the CPU (where nothing counts them): every routed conv and producer
    step, under ``fused_conv3x3_act.by_shape``'s key, and the steps by
    epilogue kind, as ``by_epilogue`` counts them."""

    def __init__(self, m):
        self.by_shape, self.by_epilogue = Counter(), Counter()
        conv, step = cr.fused_conv3x3_act, E.fused_conv3x3_step

        def record_conv(x, w, b=None, act='linear'):
            self.by_shape[(*x.shape, w.shape[-1], act)] += 1
            return conv(x, w, b, act)

        def record_step(x, w, b=None, *, addend=None, split=None, residuals=()):
            self.by_shape[(*x.shape, w.shape[-1], 'linear')] += 1
            kind = 'split' if split is not None else f'residual{len(residuals)}'
            self.by_epilogue[('carry_' if addend is not None else '') + kind] += 1
            return step(x, w, b, addend=addend, split=split, residuals=residuals)

        m.setattr(cr, 'fused_conv3x3_act', record_conv)
        m.setattr(E, 'fused_conv3x3_step', record_step)


def _forward(monkeypatch, model, x, dtype, chain=False):
    """``model(x)`` (with ``chain``: every RRDB on the chain of ops, as the
    parent ran it) and the :class:`_Launches` it made."""
    with monkeypatch.context() as m:
        if chain:
            m.setattr(E, '_fuses', lambda *a: False)
        launches = _Launches(m)
        return model(x, dtype=dtype), launches


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('nf,gc,num_blocks', [(16, 8, 2), (64, 32, 1)])
def test_served_steps_equal_the_chain(monkeypatch, dtype, nf, gc, num_blocks):
    tm = resselt_tpu_torch.load_from_state_dict(make_esrgan(nf, num_blocks, 4, gc=gc, seed=15), device='cpu')
    x = _x(12, 14, seed=16)
    want, chain = _forward(monkeypatch, tm, x, dtype, chain=True)
    got, steps = _forward(monkeypatch, tm, x, dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    nb = num_blocks
    assert steps.by_epilogue == {'split': 3 * nb, 'carry_split': 9 * nb, 'carry_residual1': 2 * nb,
                                 'carry_residual2': nb}
    assert sum(steps.by_epilogue.values()) == 5 * 3 * nb and not chain.by_epilogue
    assert steps.by_shape == chain.by_shape  # the same 3x3 launches at the same keys


def _plus(sd):
    rng = np.random.default_rng(17)
    for key in [k for k in sd if k.endswith('RDB1.conv1.0.weight')]:
        for r in (1, 2, 3):
            nf = sd[key].shape[1]
            sd[key.replace('RDB1.conv1.0', f'RDB{r}.conv1x1')] = (rng.standard_normal((sd[key].shape[0], nf, 1, 1))
                                                                  * 0.03).astype(np.float32)
    return sd


@pytest.mark.parametrize('case', ['f32', 'grad', 'int8', 'plus'])
def test_the_chain_runs_where_steps_do_not_apply(monkeypatch, case):
    """f32, a forward under grad (training), the int8 model (the benchmark's
    control) and ESRGAN+ take no producer step."""
    sd = make_esrgan(32, 1, 2, gc=32, seed=18)
    tm = resselt_tpu_torch.load_from_state_dict(_plus(sd) if case == 'plus' else sd, device='cpu')
    x = _x(10, 11, seed=19)
    with monkeypatch.context() as m:
        launches = _Launches(m)
        if case == 'grad':
            params = {k: v.clone().requires_grad_() for k, v in tm.params.items()}
            with torch.enable_grad():
                assert tm.apply(params, torch.from_numpy(x).to(torch.bfloat16)).requires_grad
        else:
            model = tm.quantize_int8() if case == 'int8' else tm
            model(x, dtype=torch.float32 if case == 'f32' else torch.bfloat16)
    assert sum(launches.by_shape.values()) > 0 and not launches.by_epilogue
