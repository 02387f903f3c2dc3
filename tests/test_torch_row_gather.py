"""resselt_tpu_torch.ops.row_gather against the JAX package's row gathers.

On the CPU the port's wrapper computes its plain version; it is held, bit
for bit, against ``tools/probe_acmsa_gather.py``'s Pallas kernel
``tile_gather`` run in interpret mode (one (8, 128) f32 tile per row, so a
row of 1024 values) and against ``jnp.take`` on flattened rows at AC_MSA's
widths (ATD-light: 3C = 144 and C = 48; ATD: 630 and 210), in f32 and
bf16, with int32 and int64 indices, a repeated index and more or fewer
output rows than source rows.  The CUDA kernel itself is held against the
plain version in test_torch_kernels_cuda.py.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resselt_tpu_torch.ops import row_gather, row_gather_ref


torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def probe():
    """tools/probe_acmsa_gather.py with Pallas bound, as its main() binds it."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    spec = importlib.util.spec_from_file_location('probe_acmsa_gather',
                                                  os.path.join(ROOT, 'tools', 'probe_acmsa_gather.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl, mod.pltpu = pl, pltpu
    return mod


@pytest.mark.parametrize('rows,blk', [(256, 64), (64, 8)])
def test_row_gather_equals_tile_gather_interpret(probe, rows, blk):
    rng = np.random.default_rng(rows)
    perm = rng.permutation(rows).astype(np.int32)
    src = rng.random((rows * 8, 128), dtype=np.float32)
    want = np.asarray(probe.tile_gather(jnp.asarray(src), jnp.asarray(perm), blk, interpret=True))
    before = row_gather.launches
    got = row_gather(torch.from_numpy(src).reshape(rows, 8 * 128), torch.from_numpy(perm))
    assert row_gather.launches == before  # the CPU path launches nothing
    assert got.shape == (rows, 1024) and got.is_contiguous()
    assert np.array_equal(got.numpy().reshape(rows * 8, 128), want)


@pytest.mark.parametrize('idx_dtype', [np.int32, np.int64])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('rows_src,rows_out,width', [
    (2 * 576, 2 * 576, 144), (2 * 576, 2 * 576, 48),   # ATD-light's gather and unsort
    (2 * 768, 2 * 576, 48),                            # the unsort skipping a pad tail
    (576, 768, 630), (300, 300, 210),                  # ATD's widths; the gather adding a pad tail
    (1, 5, 7), (9, 1, 1),
])
def test_row_gather_equals_jnp_take(rows_src, rows_out, width, dtype, idx_dtype):
    rng = np.random.default_rng(rows_src + width)
    src = rng.standard_normal((rows_src, width), np.float32)
    idx = rng.integers(0, rows_src, rows_out).astype(idx_dtype)
    idx[-1] = idx[0]  # a repeated index
    jsrc = jnp.asarray(src).astype(dtype)
    tsrc = torch.from_numpy(src).to(getattr(torch, dtype))
    want = np.asarray(jnp.take(jsrc, jnp.asarray(idx.astype(np.int32)), axis=0).astype(jnp.float32))
    got = row_gather(tsrc, torch.from_numpy(idx))
    assert got.dtype == tsrc.dtype and got.shape == (rows_out, width)
    assert np.array_equal(got.float().numpy(), want)
    assert torch.equal(got, row_gather_ref(tsrc, torch.from_numpy(idx)))


def test_row_gather_reads_slices_of_a_wider_matrix():
    wide = torch.arange(12 * 10, dtype=torch.float32).reshape(12, 10)
    idx = torch.tensor([3, 0, 3, 5])
    assert torch.equal(row_gather(wide[:, 2:7], idx), wide[:, 2:7][idx])
    assert torch.equal(row_gather(wide[4:], idx), wide[4:][idx])


def test_row_gather_refuses_what_it_does_not_take():
    src = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        row_gather(torch.zeros((2, 4, 3)), torch.tensor([0]))
    with pytest.raises(ValueError):
        row_gather(src, torch.tensor([[0]]))
    with pytest.raises(TypeError):
        row_gather(src, torch.tensor([0.0]))
    with pytest.raises(TypeError):
        row_gather(src, torch.tensor([0], dtype=torch.int16))
    with pytest.raises(IndexError):
        row_gather(src, torch.tensor([4]))
    assert row_gather(src, torch.zeros((0,), dtype=torch.int64)).shape == (0, 3)
