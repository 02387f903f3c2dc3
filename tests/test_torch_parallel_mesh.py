"""The port's mesh (resselt_tpu_torch.parallel.mesh) and tiled serving over
it (``upscale_tiled(mesh=...)``, ``tiled_program(mesh=...)``) against
resselt_tpu's on the CPU: the JAX side on this process's virtual devices,
the port in 4 gloo ranks spawned once for the file
(tests/torch_mesh_ranks.py), every rank's output checked.  Which keys
``param_sharding`` shards at tp = 2 equals JAX's; Compact over dp = 4 and
ESRGAN with tp-sharded params over 2 x 2, on the host loop and the
one-dispatch path, and ``bucket=True`` with a mesh, equal JAX's within
tests/test_parallel.py's 1e-4 and the port's meshless run within 1e-6.
``make_mesh`` from the package root, and a 'cuda' mesh without a card,
run in this process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel as jp
import resselt_tpu.parallel.tiling as jt
from resselt_tpu.parallel.mesh import make_mesh as jax_make_mesh, param_sharding as jax_param_sharding
from resselt_tpu.parallel.mesh import shard_params as jax_shard_params
from resselt_tpu.zoo import make_compact, make_esrgan

import resselt_tpu_torch
import resselt_tpu_torch.parallel as tp
import torch_mesh_ranks as ranks


JAX_TOL = 1e-4  # tests/test_parallel.py's mesh-against-whole bound
HOST_TOL = 1e-6


def _inputs():
    return {
        'compact': make_compact(num_feat=16, num_conv=2, upscale=2),
        'esrgan': make_esrgan(num_filters=16, num_blocks=2, scale=2),
        'img_compact': np.random.default_rng(4).random((64, 96, 3), dtype=np.float32),
        'img_esrgan': np.random.default_rng(7).random((48, 64, 3), dtype=np.float32),
        'img_bucket': np.random.default_rng(5).random((70, 90, 3), dtype=np.float32),
    }


@pytest.fixture(scope='module')
def ported(tmp_path_factory):
    inp = _inputs()
    flat = {k: v for k, v in inp.items() if k.startswith('img')}
    for name in ('compact', 'esrgan'):
        flat.update({f'{name}/{k}': v for k, v in inp[name].items()})
    return ranks.spawn(ranks.mesh_cases, 4, str(tmp_path_factory.mktemp('mesh')), flat)


@pytest.mark.parametrize('min_size', [1, 1024])
def test_param_sharding_shards_the_keys_jax_does(ported, min_size):
    jm = resselt_tpu.load_from_state_dict(_inputs()['esrgan'])
    spec = jax_param_sharding(jax_make_mesh(n_devices=4, tp=2), jm.params, min_size=min_size)
    want = sorted(k for k, s in spec.items() if s.spec == jax.sharding.PartitionSpec('tp'))
    assert want
    for r in ported:
        assert list(r[f'sharded_keys_{min_size}']) == want


@pytest.mark.parametrize('on_device', [False, True])
def test_tiled_over_dp4_matches_jax(ported, on_device):
    inp = _inputs()
    jm = resselt_tpu.load_from_state_dict(inp['compact'])
    mesh = jax_make_mesh(n_devices=4, dp=None, tp=1, axis_names=('dp', 'tp'))
    want = np.asarray(jp.upscale_tiled(jm, inp['img_compact'], tile=16, halo=8, mesh=mesh, on_device=on_device))
    assert np.abs(want - np.asarray(jm(inp['img_compact']))).max() < JAX_TOL
    for r in ported:
        got = r[f'compact_mesh_{on_device}']
        assert got.shape == want.shape and np.abs(got - want).max() < JAX_TOL
        assert np.abs(got - r[f'compact_solo_{on_device}']).max() < HOST_TOL


@pytest.mark.parametrize('on_device', [False, True])
def test_tiled_tp_sharded_over_2x2_matches_jax(ported, on_device):
    """ESRGAN's params sharded over tp (min_size 1), tiles over dp: JAX's
    test_tiled_tp_sharded_matches, both paths."""
    import copy

    inp = _inputs()
    jm = resselt_tpu.load_from_state_dict(inp['esrgan'])
    mesh = jax_make_mesh(n_devices=4, tp=2, axis_names=('dp', 'tp'))
    sharded = copy.copy(jm)
    sharded.__dict__.pop('_tiled_fn_cache', None)
    sharded.params = jax_shard_params(mesh, jm.params, min_size=1)
    want = np.asarray(jp.upscale_tiled(sharded, inp['img_esrgan'], tile=16, halo=8, mesh=mesh, on_device=on_device))
    total = sum(v.numel() for v in resselt_tpu_torch.load_from_state_dict(inp['esrgan'], device='cpu').params.values())
    for r in ported:
        got = r[f'esrgan_mesh_{on_device}']
        assert got.shape == want.shape and np.abs(got - want).max() < JAX_TOL
        assert np.abs(got - r[f'esrgan_solo_{on_device}']).max() < HOST_TOL
        assert int(r['esrgan_local_numel']) < total  # each rank holds a shard of the sharded params


def test_bucket_forwards_the_mesh(ported):
    inp = _inputs()
    jm = resselt_tpu.load_from_state_dict(inp['compact'])
    mesh = jax_make_mesh(n_devices=4, dp=None, tp=1, axis_names=('dp', 'tp'))
    want = np.asarray(jp.upscale_tiled(jm, inp['img_bucket'], tile=32, halo=8, mesh=mesh, bucket=True))
    for r in ported:
        got = r['compact_bucket_mesh']
        assert got.shape == want.shape == (140, 180, 3) and np.abs(got - want).max() < JAX_TOL
        assert np.abs(got - r['compact_bucket_solo']).max() < HOST_TOL


def test_tiled_program_with_a_mesh(ported):
    """``tiled_program(mesh=)``: the batch rounded to the mesh's first axis as
    JAX's planner rounds it, and the program's output upscale_tiled's."""
    inp = _inputs()
    jm = resselt_tpu.load_from_state_dict(inp['compact'])
    mesh = jax_make_mesh(n_devices=4, dp=None, tp=1, axis_names=('dp', 'tp'))
    _, want_batch = jt._plan_tiled(jm, 64, 96, 16, 8, None, jnp.float32, mesh)
    for r in ported:
        assert int(r['program_batch']) == want_batch == 8
        assert np.array_equal(r['compact_program'], r['compact_mesh_True'])


def test_make_mesh_from_the_package_root():
    with ranks.one_rank():
        mesh = resselt_tpu_torch.make_mesh(device='cpu')
        assert resselt_tpu_torch.make_mesh is tp.make_mesh
        assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ('dp', 'tp')
        assert [str(p) for p in tp.replicated(mesh)] == ['R', 'R']
        assert [str(p) for p in tp.batch_sharding(mesh)] == ['S(0)', 'R']
        with pytest.raises(ValueError):
            tp.make_mesh(dp=2, device='cpu')  # a world of one holds no (2, 1) mesh


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError):
        tp.make_mesh(device='cuda')
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_parallel_exports_every_jax_name():
    assert set(jp.__all__) <= set(tp.__all__)
    assert all(callable(getattr(tp, name)) for name in jp.__all__)
