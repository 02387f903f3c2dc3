"""The port's data-parallel training (``train.make_train_step(mesh=...)``,
``train_sr`` under several ranks) and the multi-device dry run against
resselt_tpu on the CPU: the JAX side on this process's virtual devices,
the port in gloo ranks (tests/torch_mesh_ranks.py), every rank checked.
Compact's 3 steps over dp = 2 and over a 2 x 2 mesh with its convs sharded
over tp equal JAX's jitted step on the same mesh shape at
tests/test_torch_train.py's tolerance (loss within 1e-4 relative, params and
EMA within 2 lr a step), with the gradient norm of every step within 1e-5
relative (Adam with global-norm clipping moves the params alike whatever
the gradients' scale, so the norm is what shows a gradient summed over dp
where it should be averaged) and the params' and EMA's move since the start
within 1e-3 of JAX's in norm (a step that moved nothing is off by 1); one step of a small SwinIR over 2 x 2 gives a finite
loss and a nonzero gradient norm; a sharded state saves whole and loads
back sharded; ``train_sr`` under 2 ranks saves the
params one process saves on the same global batch; ``dryrun_multichip(4,
device='cpu')`` completes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import resselt_tpu
import resselt_tpu.train as jt
from resselt_tpu.parallel.mesh import make_mesh as jax_make_mesh, param_sharding as jax_param_sharding
from resselt_tpu.zoo import make_compact, make_swinir

import torch_mesh_ranks as ranks


LR, STEPS, EMA = ranks.TRAIN_LR, ranks.TRAIN_STEPS, ranks.TRAIN_EMA
MOVE_RTOL = 1e-3  # of a param's move since the start; rounding alone gives about 1e-5


def _batch():
    hr = np.random.default_rng(0).random((4, 16, 16, 3), dtype=np.float32)
    return hr[:, ::2, ::2, :].copy(), hr


def _inputs():
    lr, hr = _batch()
    out = {'lr': lr, 'hr': hr}
    out.update({f'compact/{k}': v for k, v in make_compact(num_feat=16, num_conv=2, upscale=2).items()})
    return out


def _jax_steps(mesh, min_size):
    """JAX's step jitted over ``mesh``: params placed by param_sharding, the
    batch sharded over dp, as tools/train_sr.py lays them out."""
    jm = resselt_tpu.load_from_state_dict(make_compact(num_feat=16, num_conv=2, upscale=2))
    opt = jt.make_optimizer(lr=LR)
    state = jt.init_train_state(jm.params, opt, ema=True)
    spec = jax_param_sharding(mesh, state.params, min_size=min_size)
    state = state._replace(params={k: jax.device_put(v, spec[k]) for k, v in state.params.items()})
    data = NamedSharding(mesh, P('dp'))
    step = jax.jit(jt.make_train_step(jm._apply_fn, jm.config, opt, ema_decay=EMA))
    lr, hr = _batch()
    p0 = {k: np.asarray(v) for k, v in jm.params.items()}
    losses, norms = [], []
    with mesh:
        for _ in range(STEPS):
            state, metrics = step(state, jax.device_put(jnp.asarray(lr), data), jax.device_put(jnp.asarray(hr), data))
            losses.append(float(metrics['loss']))
            norms.append(float(metrics['grad_norm']))
    return losses, norms, p0, state


def _check_steps(results, mesh, min_size):
    losses, norms, p0, state = _jax_steps(mesh, min_size)
    for r in results:
        np.testing.assert_allclose(r['losses'], losses, rtol=1e-4)
        np.testing.assert_allclose(r['grad_norms'], norms, rtol=1e-5)
        for k in state.params:
            for name, got, want in (('p', r[f'p/{k}'], state.params[k]), ('e', r[f'e/{k}'], state.ema[k])):
                want = np.asarray(want)
                np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR * STEPS, err_msg=k)
                moved = np.linalg.norm(want - p0[k])
                assert np.linalg.norm(got - want) <= MOVE_RTOL * moved, (name, k)


def _train_sr_args(tmp, out):
    return [str(tmp / 'm.safetensors'), str(tmp / 'imgs'), '--batch', '4', '--crop', '16', '--device', 'cpu',
            '--ema', '0.9', '--steps', '2', '--log-every', '1', '--loader', 'native', '--save', str(tmp / f'{out}.npz'),
            '--checkpoint', str(tmp / f'{out}.pt')]


@pytest.fixture(scope='module')
def dp2(tmp_path_factory):
    from PIL import Image

    from resselt_tpu_torch.io import write_safetensors

    tmp = tmp_path_factory.mktemp('train_dp2')
    rng = np.random.default_rng(0)
    (tmp / 'imgs').mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)).save(tmp / 'imgs' / f'{i}.png')
    write_safetensors(make_compact(num_feat=16, num_conv=2, upscale=2), str(tmp / 'm.safetensors'))
    inputs = {**_inputs(), 'train_sr_args': np.array(_train_sr_args(tmp, 'two'))}
    return tmp, ranks.spawn(ranks.train_dp2_cases, 2, str(tmp / 'ranks'), inputs)


@pytest.fixture(scope='module')
def dp4(tmp_path_factory):
    inputs = _inputs()
    inputs.update({f'swinir/{k}': v for k, v in make_swinir(embed_dim=16, depths=(1, 1), num_heads=(2, 2),
                                                            window_size=8, upscale=2).items()})
    return ranks.spawn(ranks.train_dp4_cases, 4, str(tmp_path_factory.mktemp('train_dp4')), inputs)


def test_compact_steps_over_dp2_match_jax(dp2):
    _check_steps(dp2[1], jax_make_mesh(n_devices=2, dp=2, tp=1), 1 << 16)


def test_compact_steps_over_2x2_with_sharded_params_match_jax(dp4):
    _check_steps(dp4, jax_make_mesh(n_devices=4, tp=2), 1024)
    assert all(int(r['n_sharded']) == 3 for r in dp4)  # the three 16-wide convs, dim 0 split over tp


def test_sharded_state_saves_whole_and_loads_back_sharded(dp4):
    """``save_train_state`` gathers a tp-sharded state (rank 0 writes the
    whole tensors); ``load_train_state`` into a sharded template gives each
    rank its shards back, equal, with the template's placements."""
    assert all(bool(r['state_round_trip']) and bool(r['ema_params_sharded']) for r in dp4)


def test_swinir_step_over_2x2(dp4):
    for r in dp4:
        assert np.isfinite(float(r['swinir_loss'])) and float(r['swinir_grad_norm']) > 0
        assert float(r['swinir_loss']) == float(dp4[0]['swinir_loss'])


def test_train_sr_over_two_ranks_saves_what_one_process_saves(dp2):
    """The same global batch from the same seeded sampler: two ranks average
    their slices' gradients where one process takes the whole batch's, so
    the gradients differ in rounding.  The loss and the gradient norm that
    rank 0 logs at each step equal the one process's within 1e-5 relative
    (the norm shows the dp averaging, which Adam's update hides).  Adam moves
    a param with a near-zero gradient by up to lr whatever its size, so the
    saved params are held to test_torch_train.py's 2 lr a step (train_sr's
    lr 2e-4, 2 steps)."""
    import logging

    from resselt_tpu_torch.cache import load_model
    from resselt_tpu_torch.train_sr import main

    tmp, results = dp2
    assert all(int(r['train_sr_rc']) == 0 for r in results)
    log, logger = ranks.StepLog(), logging.getLogger('resselt_tpu_torch.train')
    level = logger.level
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    try:
        assert main(_train_sr_args(tmp, 'one')) == 0
    finally:
        logger.removeHandler(log)
        logger.setLevel(level)
    assert sorted(log.steps) == [1, 2]
    np.testing.assert_allclose(results[0]['train_sr_steps'], [log.steps[1], log.steps[2]], rtol=1e-5)
    assert results[1]['train_sr_steps'].size == 0  # only rank 0 logs
    one, two = load_model(str(tmp / 'one.npz'), device='cpu'), load_model(str(tmp / 'two.npz'), device='cpu')
    assert set(one.params) == set(two.params)
    for k in one.params:
        np.testing.assert_allclose(two.params[k].numpy(), one.params[k].numpy(), rtol=0, atol=2 * 2e-4 * 2, err_msg=k)
    import torch

    a, b = torch.load(tmp / 'one.pt', weights_only=True), torch.load(tmp / 'two.pt', weights_only=True)
    assert a['step'] == b['step'] == 2


def test_dryrun_multichip_on_cpu():
    from resselt_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(4, device='cpu')
    assert line.startswith('dryrun_multichip OK') and 'dp=2 tp=2' in line and 'err 0.0e+00' in line
