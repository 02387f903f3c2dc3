"""The port's pipeline and expert-parallel executors
(resselt_tpu_torch.parallel.pipeline / moe, esrgan.apply_pipelined)
against resselt_tpu's on the CPU: the JAX side runs on this process's
virtual devices, the port in 4 gloo ranks spawned once for the file
(tests/torch_mesh_ranks.py), every rank's output checked.  The tolerance is
tests/test_pipeline_moe.py's, rtol = atol = 2e-5: the conv-stage pipelines
at (stages, microbatches) (4, 4), (4, 8) and (2, 2), ESRGAN with 6 blocks
on 4 stages (masked padding) and with 4 blocks on 2 stages at m = 4, the
MoE over 'ep' with JAX's params carried across; indivisible experts raise.
One stage in a world of one runs in this process.

The same spawn takes the gradients of ``sum(y ** 2)`` on every rank and
holds each rank's to ``jax.grad`` of the same loss (rtol = TOL, atol = TOL
x max|JAX gradient|, the largest element of the case's whole gradient,
params and ``x``: the deep blocks' gradients are 1e4 times smaller than
the head's, and carry f32 rounding of that size, about 1e-4 of their own
largest element): the pipelines' ``x`` and stacked params, whole
(the whole gradient on every rank) and sharded (the rank's stage's), the
pipelined ESRGANs' ``x`` and raw params, and the MoE's ``x`` and params at
ep 4 and 2, whole and sharded (the rank's experts')."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import resselt_tpu
import resselt_tpu.parallel as jp
from resselt_tpu.archs.esrgan import apply_pipelined as jax_apply_pipelined
from resselt_tpu.nn import functional as JF
from resselt_tpu.zoo import make_esrgan

import resselt_tpu_torch.parallel as tp
import torch_mesh_ranks as ranks


TOL = 2e-5


def _jax_stage(params, x):
    y = JF.conv2d(x, params['w'], params['b'], padding=1)
    return jnp.where(y >= 0, y, params['alpha'] * y)


def _make_stage(rng, feat):
    return {
        'w': rng.standard_normal((feat, feat, 3, 3), np.float32) * 0.1,
        'b': rng.standard_normal((feat,), np.float32) * 0.1,
        'alpha': np.float32(0.25),
    }


def _pipe_case(n_stages, m):
    """tests/test_pipeline_moe.py::test_pipeline_matches_sequential's inputs."""
    rng = np.random.default_rng(0)
    stages = [_make_stage(rng, 8) for _ in range(n_stages)]
    return stages, rng.standard_normal((m * 2, 12, 12, 8), np.float32)


def _mesh(n, name):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n), (name,))


def _esrgan_cases():
    return {'esrgan6': (make_esrgan(num_filters=16, num_blocks=6, scale=2),
                        np.random.default_rng(3).random((4, 24, 24, 3), dtype=np.float32), 4, None),
            'esrgan4': (make_esrgan(num_filters=16, num_blocks=4, scale=2),
                        np.random.default_rng(4).random((8, 16, 16, 3), dtype=np.float32), 2, 4)}


def _moe_params(n_experts, d=16, d_hidden=32):
    p = jp.init_moe_params(jax.random.PRNGKey(0), d=d, d_hidden=d_hidden, n_experts=n_experts)
    return {k: np.array(v) for k, v in p.items()}


def _grad_atol(*trees) -> float:
    """TOL x the largest element of a case's whole JAX gradient."""
    return TOL * max(float(jnp.abs(leaf).max()) for leaf in jax.tree.leaves(trees))


def _assert_grad(got, want, atol: float):
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=atol)


@functools.cache
def _jax_pipe_grads(n_stages, m):
    """``jax.grad`` of ``sum(y ** 2)`` in the stacked params and ``x``,
    jitted (eager, the shard_map'd grads take seconds each to trace)."""
    stages, x = _pipe_case(n_stages, m)
    stacked = jp.stack_stages([{k: jnp.asarray(v) for k, v in s.items()} for s in stages])
    mesh = _mesh(n_stages, 'pp')

    def loss(st, xx):
        return jnp.sum(jp.pipeline_apply(_jax_stage, st, xx, mesh, axis='pp', num_microbatches=m) ** 2)

    return jax.jit(jax.grad(loss, argnums=(0, 1)))(stacked, jnp.asarray(x))


@functools.cache
def _jax_moe_grads(ep):
    params = {k: jnp.asarray(v) for k, v in _moe_params(8).items()}
    x = jnp.asarray(np.random.default_rng(2).standard_normal((64, 16), np.float32))
    mesh = _mesh(ep, 'ep')
    grads = jax.jit(jax.grad(lambda p, xx: jnp.sum(jp.moe_apply_ep(p, xx, mesh, 'ep') ** 2), argnums=(0, 1)))
    dense = jax.jit(jax.grad(lambda xx: jnp.sum(jp.moe_apply_dense(params, xx) ** 2)))
    return grads(params, x), dense(x)


@pytest.fixture(scope='module')
def ported(tmp_path_factory):
    inputs = {}
    for n_stages, m in ranks.PIPELINE_CASES:
        stages, x = _pipe_case(n_stages, m)
        inputs[f'pipe{n_stages}_{m}/x'] = x
        for i, s in enumerate(stages):
            inputs.update({f'pipe{n_stages}_{m}/s{i}/{k}': np.asarray(v) for k, v in s.items()})
    for name, (sd, x, _, _) in _esrgan_cases().items():
        inputs[f'{name}/x'] = x
        inputs.update({f'{name}/sd/{k}': v for k, v in sd.items()})
    inputs.update({f'moe/{k}': v for k, v in _moe_params(8).items()})
    inputs['moe/x'] = np.random.default_rng(2).standard_normal((64, 16), np.float32)
    inputs.update({f'moe_odd/{k}': v for k, v in _moe_params(5, 8, 8).items()})
    return ranks.spawn(ranks.pipeline_moe_cases, 4, str(tmp_path_factory.mktemp('pipeline_moe')), inputs)


@pytest.mark.parametrize('n_stages,m', ranks.PIPELINE_CASES)
def test_pipeline_matches_jax(ported, n_stages, m):
    stages, x = _pipe_case(n_stages, m)
    mesh = _mesh(n_stages, 'pp')
    stacked = jp.shard_stacked_params(jp.stack_stages([{k: jnp.asarray(v) for k, v in s.items()} for s in stages]),
                                      mesh, 'pp')
    want = np.asarray(jp.pipeline_apply(_jax_stage, stacked, jnp.asarray(x), mesh, axis='pp', num_microbatches=m))
    for r in ported:
        np.testing.assert_allclose(r[f'pipe{n_stages}_{m}'], want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize('name', ['esrgan6', 'esrgan4'])
def test_pipelined_esrgan_matches_jax(ported, name):
    """6 blocks on 4 stages: two slots of the last stage are masked padding;
    4 blocks on 2 stages (the 'pp' axis of a (2, 2) mesh) at m = 4."""
    sd, x, n, m = _esrgan_cases()[name]
    jm = resselt_tpu.load_from_state_dict(sd)
    want = np.asarray(jax_apply_pipelined(jm.config, jm.params, jnp.asarray(x), _mesh(n, 'pp'), axis='pp',
                                          num_microbatches=m))
    np.testing.assert_allclose(want, np.asarray(jm(x)), rtol=TOL, atol=TOL)
    for r in ported:
        np.testing.assert_allclose(r[name], want, rtol=TOL, atol=TOL)


def test_moe_ep_matches_jax(ported):
    """JAX's init_moe_params(PRNGKey(0), 16, 32, 8) carried across, experts
    split over 'ep' = 4."""
    params = _moe_params(8)
    x = np.random.default_rng(2).standard_normal((64, 16), np.float32)
    mesh = _mesh(4, 'ep')
    jparams = jp.shard_moe_params({k: jnp.asarray(v) for k, v in params.items()}, mesh, 'ep')
    want = np.asarray(jp.moe_apply_ep(jparams, jnp.asarray(x), mesh, 'ep'))
    for r in ported:
        np.testing.assert_allclose(r['moe'], want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize('placement', ['whole', 'sharded'])
@pytest.mark.parametrize('n_stages,m', ranks.PIPELINE_CASES)
def test_pipeline_grads_match_jax(ported, n_stages, m, placement):
    """Whole stacked params: every rank holds the whole stacked gradient;
    sharded: each rank its own stage's row."""
    gp, gx = _jax_pipe_grads(n_stages, m)
    mesh, atol = 'pp4' if n_stages == 4 else 'pp2', _grad_atol(gp, gx)
    for r in ported:
        got = ranks.sub(r, f'grad/pipe{n_stages}_{m}_{placement}')
        _assert_grad(got['x'], gx, atol)
        for k, want in gp.items():
            want = np.asarray(want)
            _assert_grad(got[k], want if placement == 'whole' else want[int(r[f'coord/{mesh}'])][None], atol)


@pytest.mark.parametrize('name', ['esrgan6', 'esrgan4'])
def test_pipelined_esrgan_grads_match_jax(ported, name):
    """Every rank holds the whole gradient of the raw params (the head's
    through ``x``'s, the tail's, each stage's blocks' summed over the
    axis) and of ``x``."""
    sd, x, n, m = _esrgan_cases()[name]
    jm = resselt_tpu.load_from_state_dict(sd)

    def loss(params, xx):
        return jnp.sum(jax_apply_pipelined(jm.config, params, xx, _mesh(n, 'pp'), axis='pp', num_microbatches=m) ** 2)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jm.params, jnp.asarray(x))
    atol = _grad_atol(gp, gx)
    for r in ported:
        got = ranks.sub(r, f'grad/{name}')
        _assert_grad(got['x'], gx, atol)
        assert {k[2:] for k in got if k.startswith('p/')} == set(gp)
        for k, want in gp.items():
            _assert_grad(got[f'p/{k}'], want, atol)


@pytest.mark.parametrize('placement', ['whole', 'sharded'])
@pytest.mark.parametrize('ep', ranks.MOE_GRAD_CASES)
def test_moe_ep_grads_match_jax(ported, ep, placement):
    """ep 4 on a mesh of 4, ep 2 on the 'ep' axis of a (2, 2) mesh: ``x``
    and the gate get their whole gradient on every rank, the expert stacks
    too when whole, their shard's when sharded."""
    (gp, gx), dense_gx = _jax_moe_grads(ep)
    atol = _grad_atol(gp, gx)
    _assert_grad(gx, dense_gx, atol)
    local = 8 // ep
    for r in ported:
        got = ranks.sub(r, f'grad/moe{ep}_{placement}')
        _assert_grad(got['x'], gx, atol)
        _assert_grad(got['gate'], gp['gate'], atol)
        c = int(r[f'coord/ep{ep}'])
        for k in ('w1', 'w2'):
            want = np.asarray(gp[k])
            _assert_grad(got[k], want if placement == 'whole' else want[c * local:(c + 1) * local], atol)


def test_moe_ep_rejects_indivisible(ported):
    assert all(bool(r['odd_raised']) for r in ported)


def test_moe_dense_matches_jax():
    params = _moe_params(6)
    x = np.random.default_rng(7).standard_normal((20, 16), np.float32)
    want = np.asarray(jp.moe_apply_dense({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    got = tp.moe_apply_dense({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_init_moe_params_shapes_and_scale():
    p = tp.init_moe_params(torch.Generator().manual_seed(0), 16, 32, 8, device='cpu')
    assert {k: tuple(v.shape) for k, v in p.items()} == {'gate': (16, 8), 'w1': (8, 16, 32), 'w2': (8, 32, 16)}
    assert abs(float(p['w1'].std()) - (2 / 16) ** 0.5) < 0.05
    assert torch.equal(p['w2'], tp.init_moe_params(torch.Generator().manual_seed(0), 16, 32, 8, device='cpu')['w2'])


def test_chunk_blocks_matches_jax():
    rng = np.random.default_rng(9)
    blocks = [{'a': rng.standard_normal((2, 3), np.float32), 'b': {'c': rng.standard_normal(4, np.float32)}}
              for _ in range(7)]
    want = jp.chunk_blocks([jax.tree.map(jnp.asarray, b) for b in blocks], 3)
    got = tp.chunk_blocks([{'a': torch.from_numpy(b['a']), 'b': {'c': torch.from_numpy(b['b']['c'])}}
                           for b in blocks], 3)
    assert np.array_equal(got['mask'].numpy(), np.asarray(want['mask']))
    assert np.array_equal(got['blocks']['a'].numpy(), np.asarray(want['blocks']['a']))
    assert np.array_equal(got['blocks']['b']['c'].numpy(), np.asarray(want['blocks']['b']['c']))


def test_masked_stage_fn_matches_jax():
    """Seven blocks in 3 stages of 3: each stage's ``chunk_blocks`` row
    through ``masked_stage_fn`` equals JAX's, the last stage's two padding
    blocks passing the activation through."""
    rng = np.random.default_rng(10)
    blocks = [{'w': rng.standard_normal((4, 4), np.float32) * 0.5, 'b': rng.standard_normal(4, np.float32)}
              for _ in range(7)]
    x = rng.standard_normal((2, 4), np.float32)
    jstacked = jp.chunk_blocks([jax.tree.map(jnp.asarray, b) for b in blocks], 3)
    tstacked = tp.chunk_blocks([{k: torch.from_numpy(v) for k, v in b.items()} for b in blocks], 3)
    jstage = jp.masked_stage_fn(lambda p, h: jnp.tanh(h @ p['w'] + p['b']))
    tstage = tp.masked_stage_fn(lambda p, h: torch.tanh(h @ p['w'] + p['b']))
    assert tstacked['mask'][2].tolist() == [True, False, False]
    for s in range(3):
        want = np.asarray(jstage(jax.tree.map(lambda a: a[s], jstacked), jnp.asarray(x)))
        got = tstage({'blocks': {k: v[s] for k, v in tstacked['blocks'].items()}, 'mask': tstacked['mask'][s]},
                     torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_one_stage_in_a_world_of_one():
    """One stage: no hop (torch refuses a send to oneself); every tick runs
    the stage; equal to JAX's one-device pipeline and to the stage itself."""
    stages, x = _pipe_case(1, 4)
    mesh = _mesh(1, 'pp')
    want = np.asarray(jp.pipeline_apply(_jax_stage, jp.stack_stages([jax.tree.map(jnp.asarray, stages[0])]),
                                        jnp.asarray(x), mesh, axis='pp', num_microbatches=4))
    from torch.distributed.device_mesh import init_device_mesh

    with ranks.one_rank():
        tmesh = init_device_mesh('cpu', (1,), mesh_dim_names=('pp',))
        params = {k: torch.tensor(np.asarray(v)) for k, v in stages[0].items()}
        got = tp.pipeline_apply(ranks.conv_stage, tp.stack_stages([params]), torch.from_numpy(x), tmesh, 'pp', 4)
        with pytest.raises(ValueError):
            tp.pipeline_apply(ranks.conv_stage, tp.stack_stages([params]), torch.from_numpy(x), tmesh, 'pp', 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), ranks.conv_stage(params, torch.from_numpy(x)).numpy(), rtol=TOL, atol=TOL)
