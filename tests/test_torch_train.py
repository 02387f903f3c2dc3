"""The port's training side (resselt_tpu_torch.train) against
resselt_tpu.train on the CPU: the schedules, the optimizer (clip, Adam,
AdamW, the learning rate at optax's count) and the EMA on identical
gradients, params and EMA within rtol 1e-6; Compact's whole step
(tests/test_train.py::_model) 5 steps within atol 2 lr steps; remat
against the plain step; the Adam state carried across from a JAX state;
save / load resume; export to .safetensors and back through
``load_from_file``; ``SRModel.apply`` under autograd; and each kernel
wrapper's autograd Function on the CPU (its forward the plain version)
against autograd through the plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.train as jt
import resselt_tpu_torch
import resselt_tpu_torch.train as tt
from resselt_tpu.zoo import make_compact as jax_make_compact
from resselt_tpu_torch.ops import fused_conv as fc, molrcm as mo, window_attention as wa
from resselt_tpu_torch.ops.row_gather import row_gather, row_gather_ref
from resselt_tpu_torch.zoo import make_compact


torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on: another module of the worker may have turned it off
    (tests/torch_ref.py does, for the torch oracle)."""
    with torch.enable_grad():
        yield


def _compact_sd():
    return jax_make_compact(num_feat=16, num_conv=2, upscale=2)


def _batch(seed=0):
    hr = np.random.default_rng(seed).random((2, 16, 16, 3), dtype=np.float32)
    return hr[:, ::2, ::2, :].copy(), hr


# -- SRModel.apply under autograd -----------------------------------------------------


def test_apply_gives_gradients_to_every_float_param():
    """``SRModel.apply`` runs under the caller's grad mode, as the JAX
    ``apply`` is differentiable: a loss of its output reaches every float
    param (``__call__`` stays without a graph)."""
    tm = resselt_tpu_torch.load_from_state_dict(make_compact(16, 2, 2), device='cpu')
    params = {k: v.clone().requires_grad_(v.is_floating_point()) for k, v in tm.params.items()}
    x = torch.rand(1, 12, 14, 3, generator=torch.Generator().manual_seed(0))
    y = tm.apply(params, x)
    leaves = [v for v in params.values() if v.requires_grad]
    grads = torch.autograd.grad(y.square().mean(), leaves)
    assert len(leaves) == len(tm.params) and all(g.abs().sum() > 0 for g in grads)
    assert tm(x).grad_fn is None
    assert torch.equal(tm.raw_apply_fn(tm.config, tm.params, x), tm(x))


# -- schedules, optimizer and EMA on identical gradients --------------------------------


@pytest.mark.parametrize('kind,kw', [
    ('constant', {}), ('constant', {'warmup_steps': 4}), ('cosine', {'total_steps': 30}),
    ('cosine', {'total_steps': 30, 'warmup_steps': 5}), ('multistep', {'milestones': (10, 20), 'gamma': 0.5}),
    ('multistep', {'milestones': (3, 20), 'gamma': 0.1, 'warmup_steps': 6}),
])
def test_schedules_equal_optax(kind, kw):
    a, b = jt.make_lr_schedule(1e-3, kind, **kw), tt.make_lr_schedule(1e-3, kind, **kw)
    for step in range(0, 40):
        assert b(step) == pytest.approx(float(a(step)), rel=1e-6, abs=1e-9), step  # 1e-6 x the base lr


def test_schedule_errors_as_jax():
    for call in (lambda m: m.make_lr_schedule(1e-3, 'nope'), lambda m: m.make_lr_schedule(1e-3, 'cosine')):
        for mod in (jt, tt):
            with pytest.raises(ValueError):
                call(mod)


def _grad_model(seed=0):
    """Params and a fixed gradient direction G: ``apply(params, x) =
    sum(p * G * x)`` has the gradient ``G * x`` in both packages, so the
    optimizers see identical gradients."""
    rng = np.random.default_rng(seed)
    shapes = {'conv.weight': (8, 4, 3, 3), 'conv.bias': (8,), 'norm.weight': (8,), 'proj.weight': (5, 8)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    params['bn.running_mean'] = rng.standard_normal(8).astype(np.float32)
    params['bn.num_batches_tracked'] = np.array(3, np.int64)
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    return params, g


def _jax_fake(g):
    def apply(config, params, x):
        return sum(jnp.sum(params[k] * g[k] * x) for k in sorted(g))
    return apply


def _torch_fake(g):
    gt = {k: torch.from_numpy(v) for k, v in g.items()}

    def apply(config, params, x):
        return sum(torch.sum(params[k] * gt[k] * x) for k in sorted(gt))
    return apply


@pytest.mark.parametrize('kind,kw,weight_decay,scale', [
    ('constant', {'warmup_steps': 2}, 0.0, 1.0),
    ('cosine', {'total_steps': 5, 'warmup_steps': 2}, 0.0, 1.0),
    ('multistep', {'milestones': (3,), 'gamma': 0.3, 'warmup_steps': 1}, 0.0, 1.0),
    ('constant', {'warmup_steps': 2}, 1e-2, 1.0),
    ('cosine', {'total_steps': 5, 'warmup_steps': 2}, 1e-2, 0.05),
])
def test_optimizer_and_ema_equal_optax(kind, kw, weight_decay, scale):
    """Five steps on identical gradients (global norm about 12 x ``scale``:
    the clip at 1.0 triggers at scale 1, not at 0.05): params and EMA
    within rtol 1e-6, the metrics equal."""
    params, g = _grad_model()
    g = {k: v * np.float32(scale) for k, v in g.items()}
    lr = 1e-2
    jsched, tsched = jt.make_lr_schedule(lr, kind, **kw), tt.make_lr_schedule(lr, kind, **kw)
    jopt = jt.make_optimizer(lr=jsched, weight_decay=weight_decay, clip=1.0)
    topt = tt.make_optimizer(lr=tsched, weight_decay=weight_decay, clip=1.0)
    jstep = jax.jit(jt.make_train_step(_jax_fake(g), None, jopt, loss=lambda p, t: p, ema_decay=0.9))
    tstep = tt.make_train_step(_torch_fake(g), None, topt, loss=lambda p, t: p, ema_decay=0.9)
    js = jt.init_train_state({k: jnp.asarray(v) for k, v in params.items()}, jopt, ema=True)
    ts = tt.init_train_state({k: torch.from_numpy(v) for k, v in params.items()}, topt, ema=True)
    for i in range(5):
        x = np.float32(1.0 + 0.25 * i)
        js, jm = jstep(js, jnp.asarray(x), None)
        ts, tm = tstep(ts, torch.tensor(x), None)
        assert float(tm['grad_norm']) == pytest.approx(float(jm['grad_norm']), rel=1e-6)
        assert float(tm['loss']) == pytest.approx(float(jm['loss']), rel=1e-6)
    assert ts.step == int(js.step) == 5 and ts.opt_state.count == 5
    for k in params:
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    for k in g:
        np.testing.assert_allclose(ts.ema[k].numpy(), np.asarray(js.ema[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    assert torch.equal(ts.params['bn.running_mean'], torch.from_numpy(params['bn.running_mean']))
    assert set(ts.opt_state.mu) == set(g)


def test_split_trainable_excludes_bn_buffers_and_int8():
    params = {'conv.weight': torch.ones(4, 3, 3, 3), 'bn.running_mean': torch.ones(4),
              'bn.running_var': torch.ones(4), 'bn.num_batches_tracked': torch.ones((), dtype=torch.int64),
              'bn.weight': torch.ones(4), 'q.weight': torch.ones(4, 4, 3, 3, dtype=torch.int8),
              'q.weight_scale': torch.ones(4)}
    trainable, static = tt.split_trainable(params)
    assert set(trainable) == {'conv.weight', 'bn.weight', 'q.weight_scale'}
    assert set(static) == {'bn.running_mean', 'bn.running_var', 'bn.num_batches_tracked', 'q.weight'}


def test_losses_and_psnr_equal_jax():
    rng = np.random.default_rng(4)
    a, b = rng.random((2, 8, 8, 3), dtype=np.float32), rng.random((2, 8, 8, 3), dtype=np.float32)
    for name in ('charbonnier', 'l1', 'l2'):
        want = float(jt.LOSSES[name](jnp.asarray(a), jnp.asarray(b)))
        assert float(tt.LOSSES[name](torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(want, rel=1e-6)
    assert float(tt.psnr(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(
        float(jt.psnr(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)


# -- the whole step on Compact -----------------------------------------------------------


def _both(lr=1e-3, ema=0.0, remat=False):
    sd = _compact_sd()
    jm, tm = resselt_tpu.load_from_state_dict(sd), resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    jopt, topt = jt.make_optimizer(lr=lr), tt.make_optimizer(lr=lr)
    jstep = jax.jit(jt.make_train_step(jm._apply_fn, jm.config, jopt, ema_decay=ema))
    tstep = tt.make_train_step(tm.raw_apply_fn, tm.config, topt, ema_decay=ema, remat=remat)
    return (jm, jopt, jstep), (tm, topt, tstep)


def test_compact_five_steps_match_jax():
    lr, steps = 1e-3, 5
    (jm, jopt, jstep), (tm, topt, tstep) = _both(lr, ema=0.9)
    js, ts = jt.init_train_state(jm.params, jopt, ema=True), tt.init_train_state(tm.params, topt, ema=True)
    lr_b, hr_b = _batch(0)
    for _ in range(steps):
        js, jmet = jstep(js, jnp.asarray(lr_b), jnp.asarray(hr_b))
        ts, tmet = tstep(ts, torch.from_numpy(lr_b), torch.from_numpy(hr_b))
        assert float(tmet['loss']) == pytest.approx(float(jmet['loss']), rel=1e-4)
    for k in js.params:
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]), rtol=0, atol=2 * lr * steps,
                                   err_msg=k)
        np.testing.assert_allclose(ts.ema[k].numpy(), np.asarray(js.ema[k]), rtol=0, atol=2 * lr * steps,
                                   err_msg=k)
    # the state is a copy: the model's own params are untouched
    assert all(torch.equal(tm.params[k], torch.from_numpy(np.array(jm.params[k]))) for k in tm.params)


def test_remat_matches_plain():
    """remat=True recomputes the activations in the backward pass: the
    updated state matches the plain step (tests/test_train.py's bounds)."""
    (_, _, _), (tm, topt, plain) = _both(1e-2)
    remat = tt.make_train_step(tm.raw_apply_fn, tm.config, topt, remat=True)
    lr_b, hr_b = (torch.from_numpy(a) for a in _batch(3))
    outs = {}
    for name, step in (('plain', plain), ('remat', remat)):
        state = tt.init_train_state(tm.params, topt)
        for _ in range(2):
            state, metrics = step(state, lr_b, hr_b)
        outs[name] = (state, float(metrics['loss']))
    for k in outs['plain'][0].params:
        np.testing.assert_allclose(outs['remat'][0].params[k].numpy(), outs['plain'][0].params[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert outs['remat'][1] == pytest.approx(outs['plain'][1], rel=1e-5)


def test_state_carried_across_from_jax():
    """Three JAX steps, the state carried across as numpy arrays
    (``train_state_from_numpy``), then one step in each package."""
    lr = 1e-3
    (jm, jopt, jstep), (tm, topt, tstep) = _both(lr, ema=0.9)
    js = jt.init_train_state(jm.params, jopt, ema=True)
    lr_b, hr_b = _batch(1)
    for _ in range(3):
        js, _ = jstep(js, jnp.asarray(lr_b), jnp.asarray(hr_b))
    adam = js.opt_state[1][0]
    ts = tt.train_state_from_numpy({k: np.asarray(v) for k, v in js.params.items()},
                                   {k: np.asarray(v) for k, v in adam.mu.items()},
                                   {k: np.asarray(v) for k, v in adam.nu.items()}, int(adam.count),
                                   int(js.step), {k: np.asarray(v) for k, v in js.ema.items()}, device='cpu')
    assert ts.step == ts.opt_state.count == 3
    js, _ = jstep(js, jnp.asarray(lr_b), jnp.asarray(hr_b))
    ts, _ = tstep(ts, torch.from_numpy(lr_b), torch.from_numpy(hr_b))
    for k in js.params:
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]), rtol=0, atol=2 * lr, err_msg=k)
        np.testing.assert_allclose(ts.ema[k].numpy(), np.asarray(js.ema[k]), rtol=0, atol=2 * lr, err_msg=k)
    np.testing.assert_allclose(ts.opt_state.nu['body.0.weight'].numpy(),
                               np.asarray(js.opt_state[1][0].nu['body.0.weight']), rtol=1e-3, atol=1e-12)


def test_checkpoint_resume(tmp_path):
    """Exact resume: save mid-training, restore, and the next step matches
    to the bit."""
    (_, _, _), (tm, topt, tstep) = _both(1e-3, ema=0.9)
    lr_b, hr_b = (torch.from_numpy(a) for a in _batch(3))
    state = tt.init_train_state(tm.params, topt, ema=True)
    for _ in range(3):
        state, _ = tstep(state, lr_b, hr_b)
    path = str(tmp_path / 'state.pt')
    tt.save_train_state(state, path)
    restored = tt.load_train_state(path, tt.init_train_state(tm.params, topt, ema=True))
    assert restored.step == 3 and restored.opt_state.count == 3
    assert torch.equal(restored.ema['body.0.weight'], state.ema['body.0.weight'])
    s1, m1 = tstep(state, lr_b, hr_b)
    s2, m2 = tstep(restored, lr_b, hr_b)
    assert float(m1['loss']) == float(m2['loss'])
    assert all(torch.equal(s1.params[k], s2.params[k]) for k in s1.params)
    with pytest.raises(ValueError, match='do not match'):
        tt.load_train_state(path, tt.init_train_state(tm.params, topt, ema=False))


def test_ema_tracks_params_and_disabled_by_default():
    (_, _, _), (tm, topt, _) = _both()
    opt = tt.make_optimizer(lr=1e-2)
    step = tt.make_train_step(tm.raw_apply_fn, tm.config, opt, ema_decay=0.9)
    state = tt.init_train_state(tm.params, opt, ema=True)
    lr_b, hr_b = (torch.from_numpy(a) for a in _batch(0))
    w0 = state.params['body.0.weight'].clone()
    for _ in range(5):
        state, _ = step(state, lr_b, hr_b)
    w, e = state.params['body.0.weight'], state.ema['body.0.weight']
    assert not torch.allclose(e, w) and not torch.allclose(e, w0)
    assert (e - w0).abs().max() < (w - w0).abs().max()
    ep = tt.ema_params(state)
    assert set(ep) == set(state.params) and tm.apply(ep, lr_b).shape == hr_b.shape
    plain = tt.init_train_state(tm.params, opt)
    assert plain.ema is None and tt.ema_params(plain) is plain.params


def test_export_round_trip(tmp_path):
    """Train a few steps, export to .safetensors, reload through
    ``load_from_file`` and the convert CLI: the same forward, and the same
    family (test_train.py's oracle round trip without the oracle)."""
    from resselt_tpu_torch.cache import load_model
    from resselt_tpu_torch.convert import main as convert_main
    from resselt_tpu_torch.io import write_safetensors

    (_, _, _), (tm, topt, tstep) = _both(1e-3)
    state = tt.init_train_state(tm.params, topt)
    lr_b, hr_b = (torch.from_numpy(a) for a in _batch(0))
    for _ in range(3):
        state, _ = tstep(state, lr_b, hr_b)
    path = str(tmp_path / 'trained.safetensors')
    write_safetensors({k: v.numpy() for k, v in state.params.items()}, path, metadata={'arch': tm.arch_id})
    back = resselt_tpu_torch.load_from_file(path, device='cpu')
    assert back.arch_id == 'Compact'
    x = np.random.default_rng(5).random((1, 20, 24, 3), dtype=np.float32)
    want = tm.apply(state.params, torch.from_numpy(x))
    assert float((back(x) - want).abs().max()) < 1e-6
    assert convert_main([path, str(tmp_path / 'rt.npz'), '--device', 'cpu']) == 0
    assert torch.equal(load_model(str(tmp_path / 'rt.npz'), device='cpu')(x), back(x))


# -- the kernel Functions on the CPU against autograd through the plain versions ------------


def _grads(fn, inputs, seed=0):
    out = fn(*inputs)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    need = [t for t in inputs if isinstance(t, torch.Tensor) and t.requires_grad]
    return torch.autograd.grad((out.float() * w).sum(), need)


def _close(got, want, rtol=1e-5):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= rtol * float(w.abs().max()) + 1e-7


def _leaf(*shape, seed=0, scale=1.0):
    return (scale * torch.randn(*shape, generator=torch.Generator().manual_seed(seed))).requires_grad_(True)


@pytest.mark.parametrize('act', ['linear', 'lrelu', 'silu', 'mish'])
@pytest.mark.parametrize('packed,bias', [(False, True), (True, True), (False, False)])
def test_conv3x3_function_matches_plain_autograd(act, packed, bias):
    x = _leaf(2, 9, 11, 6, seed=1)
    w = _leaf(5, 6, 3, 3, seed=2, scale=0.3)
    b = _leaf(5, seed=3, scale=0.1) if bias else None

    def ours(x, w, *b):
        return fc.fused_conv3x3_act(x, fc.pack_conv3x3_weight(w) if packed else w, b[0] if b else None, act)

    def plain(x, w, *b):
        return fc.fused_conv3x3_act_ref(x, w, b[0] if b else None, act)

    inputs = (x, w) + ((b,) if bias else ())
    _close(_grads(ours, inputs), _grads(plain, inputs))


def test_conv3x3_function_leaky_slope_at_zero_is_jaxs():
    """lrelu's slope where the pre-activation is exactly 0 is 1, as
    ``jax.nn.leaky_relu``'s gradient."""
    x = torch.zeros(1, 4, 4, 2, requires_grad=True)
    w = torch.ones(3, 2, 3, 3, requires_grad=True)
    (dx,) = torch.autograd.grad(fc.fused_conv3x3_act(x, w, None, 'lrelu').sum(), [x])
    jx = jax.grad(lambda t: jax.nn.leaky_relu(jax.lax.conv_general_dilated(
        t, jnp.ones((3, 3, 2, 3)), (1, 1), 'SAME', dimension_numbers=('NHWC', 'HWIO', 'NHWC')), 0.2).sum())(
        jnp.zeros((1, 4, 4, 2)))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jx), rtol=1e-6)


def test_pack2_and_image_input_without_grad():
    """pack2 runs the same Function; an input that needs no grad (the image)
    gets none, and its weight still does."""
    x = torch.randn(1, 6, 8, 4, generator=torch.Generator().manual_seed(0))
    w = _leaf(8, 4, 3, 3, seed=4)
    (dw,) = _grads(lambda x, w: fc.fused_conv3x3_pack2(x, w, None, 'silu'), (x, w))
    (want,) = _grads(lambda x, w: fc.fused_conv3x3_pack2_ref(x, w, None, 'silu'), (x, w))
    _close((dw,), (want,))


def test_conv_lk_function_through_a_channel_slice():
    """PLKSR's partial conv: the kernel reads a 16-channel slice of a wider
    tensor; the gradient goes back into that slice only."""
    feat = _leaf(2, 12, 13, 24, seed=5)
    w = _leaf(16, 16, 9, 9, seed=6, scale=0.05)
    b = _leaf(16, seed=7, scale=0.1)
    ours = _grads(lambda f, w, b: fc.fused_conv_lk(f[..., :16], w, b, k=9, act='lrelu'), (feat, w, b))
    plain = _grads(lambda f, w, b: fc.fused_conv_lk_ref(f[..., :16], w, b, k=9, act='lrelu'), (feat, w, b))
    _close(ours, plain)
    assert float(ours[0][..., 16:].abs().max()) == 0.0


@pytest.mark.parametrize('masked', [False, True])
def test_window_mha_function_matches_plain_autograd(masked):
    """q, k, v as slices of one qkv projection, a bias (heads, N, N) that
    gets its gradient, and a shift mask that gets none."""
    nw, b_img, n, c, heads = 4, 2, 16, 24, 3
    qkv = _leaf(nw * b_img, n, 3 * c, seed=8)
    bias = _leaf(heads, n, n, seed=9)
    mask = (torch.randn(nw, n, n, generator=torch.Generator().manual_seed(10)) > 0.5).float() * -100 if masked \
        else None

    def run(fn):
        return lambda qkv, bias: fn(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias, mask,
                                    num_heads=heads, scale=c ** -0.5)

    _close(_grads(run(wa.window_mha), (qkv, bias)), _grads(run(wa.window_mha_ref), (qkv, bias)))


def test_row_gather_function_with_repeated_indices():
    src = _leaf(40, 8, seed=11)
    wide = _leaf(40, 20, seed=12)
    idx = torch.tensor([3, 3, 0, 39, 7, 3, 12, 12], dtype=torch.int64)
    _close(_grads(row_gather, (src, idx)), _grads(row_gather_ref, (src, idx)))
    ours = _grads(lambda t: row_gather(t[:, 4:12], idx.int()), (wide,))
    _close(ours, _grads(lambda t: row_gather_ref(t[:, 4:12], idx.int()), (wide,)))
    assert float(ours[0][:, :4].abs().max()) == 0.0


def test_molrcm_function_matches_plain_autograd():
    x = _leaf(1, 7, 9, 64, seed=13)
    packed = _leaf(mo.packed_size(64), seed=14, scale=0.1)
    _close(_grads(mo.fused_molrcm, (x, packed)), _grads(mo.fused_molrcm_ref, (x, packed)))


def test_conv3x3_gate_for_transposed_shapes():
    """The backward's static rule: ESRGAN's transposed producer shapes at
    training batches run the kernel; a grid past 65535 blocks does not."""
    for cin, cout in ((64, 192), (32, 160), (32, 128), (32, 96), (32, 64), (3, 64), (64, 3)):
        assert fc.conv3x3_kernel_takes(8, 192, 192, cin, cout)
    assert not fc.conv3x3_kernel_takes(40000, 16, 16, 64, 128)
    assert not fc.conv3x3_kernel_takes(1, 16 * 65536, 16, 64, 64)


def test_train_sr_runs_resumes_and_saves(tmp_path):
    """``python -m resselt_tpu_torch.train_sr`` on the CPU: trains, writes
    its state and the model, and a second run resumes from the state."""
    from PIL import Image

    from resselt_tpu_torch.cache import load_model
    from resselt_tpu_torch.io import write_safetensors
    from resselt_tpu_torch.train_sr import main

    rng = np.random.default_rng(0)
    (tmp_path / 'imgs').mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)).save(tmp_path / 'imgs' / f'{i}.png')
    write_safetensors(make_compact(16, 2, 2), str(tmp_path / 'm.safetensors'))
    state, out = str(tmp_path / 'state.pt'), str(tmp_path / 'tuned.npz')
    args = [str(tmp_path / 'm.safetensors'), str(tmp_path / 'imgs'), '--batch', '2', '--crop', '16', '--device', 'cpu',
            '--ema', '0.9', '--checkpoint', state, '--save', out, '--loader', 'native']
    assert main(args + ['--steps', '2']) == 0
    assert torch.load(state, weights_only=True)['step'] == 2
    assert main(args + ['--steps', '3']) == 0
    assert torch.load(state, weights_only=True)['step'] == 3
    tuned = load_model(out, device='cpu')
    assert tuned.arch_id == 'Compact'
    assert torch.equal(tuned.params['body.0.weight'], torch.load(state, weights_only=True)['ema']['body.0.weight'])

