"""Pipeline-parallel executor (GPipe) over a mesh axis.

Counterpart of ``resselt_tpu/parallel/pipeline.py``, with its contract:

* every stage keeps one activation shape (true of SR conv trunks);
* stage params are stacked on a leading stage axis, and each rank runs the
  slice of its coordinate on the pipeline axis (a ``DTensor`` sharded over
  that axis by :func:`shard_stacked_params`: its local shard);
* the batch is split into ``num_microbatches`` equal microbatches, which
  stream through ``m + n_stages - 1`` ticks: stage 0 takes microbatch t,
  stage s works on microbatch ``t - s``, and the last stage completes
  microbatch ``t - (n_stages - 1)``.

Where JAX moves each tick's activations one stage to the right with
``ppermute``, every rank here posts the same ``batch_isend_irecv`` pairs
(a send to ``s + 1``, a receive from ``s - 1``) on the axis's group, and only
where a microbatch crosses that hop: bubble ticks run no stage and send
nothing, and one stage sends nothing at all (torch refuses a send to
oneself).  JAX's masked ``psum`` that hands the outputs to every device is a
``broadcast`` from the last stage.  The executor is a forward: no gradient
crosses a stage.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .mesh import axis_size, is_sharded


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested dicts / lists / tuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_stages(per_stage_params: list) -> dict:
    """Stack a list of per-stage param trees on a new leading axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def chunk_blocks(per_block_params: list, n_stages: int) -> dict:
    """Chunk a uniform block stack (e.g. ESRGAN's 23 RRDBs) into
    ``n_stages`` equal pipeline stages.

    Each stage runs ``ceil(n_blocks / n_stages)`` blocks; when the count
    does not divide, the last stages are padded with copies of block 0 that
    are masked out.  Returns ``{'blocks': leaves (n_stages, k, ...), 'mask':
    (n_stages, k) bool}`` for :func:`pipeline_apply` with a
    :func:`masked_stage_fn` stage."""
    nb = len(per_block_params)
    k = -(-nb // n_stages)
    slots = [[s * k + j for j in range(k)] for s in range(n_stages)]
    rows = [stack_stages([per_block_params[i if i < nb else 0] for i in row]) for row in slots]
    mask = torch.tensor([[i < nb for i in row] for row in slots])
    return {'blocks': stack_stages(rows), 'mask': mask}


def masked_stage_fn(block_fn: Callable) -> Callable:
    """A :func:`pipeline_apply` stage from a per-block ``block_fn(params, x)
    -> x`` over the stage's :func:`chunk_blocks` slice: ``{'blocks': leaves
    (k, ...), 'mask': (k,)}``.  A padding block passes the activation
    through: it is skipped, where JAX computes it and discards the result."""

    def stage(sparams, x):
        for j, enabled in enumerate(sparams['mask'].tolist()):
            if enabled:
                x = block_fn(_tree_map(lambda a: a[j], sparams['blocks']), x)
        return x

    return stage


def local_stage(stacked_params, mesh, axis: str = 'pp'):
    """This rank's stage of stacked params: its local shard of a ``DTensor``
    sharded over ``axis``, else its row of the stacked tensor."""
    idx = mesh.get_local_rank(axis)

    def take(a):
        return a.to_local()[0] if is_sharded(a) else a[idx]

    return _tree_map(take, stacked_params)


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor, mesh, axis: str = 'pp',
                   num_microbatches: int | None = None) -> torch.Tensor:
    """Run ``x`` through the ``mesh`` axis' ``n_stages`` pipelined stages.

    ``stage_fn(params, x) -> y`` keeps the activation shape; it gets this
    rank's stage of ``stacked_params`` (:func:`local_stage`).  ``x``:
    (batch, ...), the same on every rank; the batch splits into
    ``num_microbatches`` (default: the axis size), which must divide it.
    Returns the (batch, ...) output of all the stages, on every rank, equal
    to running the stages one after another."""
    sparams = local_stage(stacked_params, mesh, axis)
    return pipeline_run(lambda h: stage_fn(sparams, h), x, mesh, axis, num_microbatches)


def pipeline_run(stage: Callable, x: torch.Tensor, mesh, axis: str = 'pp',
                 num_microbatches: int | None = None) -> torch.Tensor:
    """:func:`pipeline_apply`'s schedule with this rank's stage given as a
    function of the activation alone, ``stage(x) -> y``: for a caller that
    builds only its own stage's params (``esrgan.apply_pipelined``)."""
    n_stages = axis_size(mesh, axis)
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    batch = x.shape[0]
    m = num_microbatches or n_stages
    if batch % m != 0:
        raise ValueError(f'batch {batch} not divisible by {m} microbatches')
    x_mb = x.contiguous().reshape(m, batch // m, *x.shape[1:])
    outs = torch.empty_like(x_mb)
    prev_rank = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    next_rank = dist.get_global_rank(group, idx + 1) if idx < n_stages - 1 else None
    if n_stages > 1:
        dist.barrier(group=group)  # the group's first op involves every rank: NCCL makes its communicator here
    state = None
    for t in range(m + n_stages - 1):
        # the hop into stage s at tick t carries microbatch t - s, produced by stage s - 1 last tick
        ops, inbox = [], None
        if next_rank is not None and 0 <= t - (idx + 1) < m:
            ops.append(dist.P2POp(dist.isend, state, next_rank, group))
        if prev_rank is not None and 0 <= t - idx < m:
            inbox = torch.empty_like(x_mb[0])
            ops.append(dist.P2POp(dist.irecv, inbox, prev_rank, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if not 0 <= t - idx < m:
            continue  # a bubble tick for this stage
        state = stage(x_mb[t] if idx == 0 else inbox).contiguous()
        if idx == n_stages - 1:
            outs[t - idx] = state
    dist.broadcast(outs, dist.get_global_rank(group, n_stages - 1), group=group)
    return outs.reshape(batch, *x.shape[1:])


def shard_stacked_params(stacked_params, mesh, axis: str = 'pp'):
    """Place stacked stage params so each rank holds only its stage: each
    leaf a ``DTensor`` sharded along dim 0 over ``axis``."""
    from torch.distributed.tensor import distribute_tensor

    from .mesh import batch_sharding

    placements = batch_sharding(mesh, axis)
    return _tree_map(lambda a: distribute_tensor(a, mesh, placements), stacked_params)
