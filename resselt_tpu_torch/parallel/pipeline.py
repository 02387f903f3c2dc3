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
``broadcast`` from the last stage.  Gradients follow the transposes of
JAX's ``ppermute`` and ``psum``: under grad the schedule is one
``autograd.Function`` whose backward runs it in reverse (see
:func:`pipeline_run`).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.distributed as dist

from .mesh import axis_size, is_sharded, replicated_grad


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
    to running the stages one after another.  Under grad, with the same
    loss on every rank: whole stacked params get their whole gradient on
    every rank (summed over the axis), ``DTensor`` ones their shard's."""
    leaves, rebuild = _flatten(stacked_params)
    whole = [i for i, a in enumerate(leaves) if not is_sharded(a)]
    # one all_reduce in the backward: x's gradient (from stage 0) and the whole params' (each rank's row)
    x, *summed = replicated_grad([x] + [leaves[i] for i in whole], mesh.get_group(axis))
    for i, a in zip(whole, summed):
        leaves[i] = a
    sparams = local_stage(rebuild(leaves), mesh, axis)
    return pipeline_run(lambda p: functools.partial(stage_fn, p), sparams, x, mesh, axis, num_microbatches)


def pipeline_run(make_stage: Callable, stage_params, x: torch.Tensor, mesh, axis: str = 'pp',
                 num_microbatches: int | None = None) -> torch.Tensor:
    """:func:`pipeline_apply`'s schedule with this rank's stage given as
    ``make_stage(stage_params) -> stage``, ``stage(h) -> h``: called once a
    call, for a caller that prepares its stage's weights from its own params
    (``esrgan.apply_pipelined``).  ``stage_params``: nested dicts / lists of
    this rank's tensors.

    Under grad (grad mode on, and ``x`` or a param requiring grad) the
    schedule is one ``autograd.Function`` of ``x`` and the params: it keeps
    each microbatch's graph of the stage, and its backward runs the GPipe
    schedule in reverse, each hop carrying the gradient of a microbatch one
    stage to the left.  The loss is the same on every rank: the output's
    gradient enters only on the last stage, and ``x``'s comes from stage 0,
    zeros on the others.  A caller whose ranks all hold ``x`` whole sums
    that over the axis (``mesh.replicated_grad``, which must then reach
    every rank's backward), as JAX transposes a replicated input."""
    sched = _Schedule(mesh, axis, x, num_microbatches)
    leaves, rebuild = _flatten(stage_params)
    if not torch.is_grad_enabled() or not (x.requires_grad or any(t.requires_grad for t in leaves)):
        return sched.forward(make_stage(stage_params), x)
    return _Pipeline.apply(sched, make_stage, rebuild, x, *leaves)


def _flatten(tree):
    """The tensor leaves of nested dicts / lists / tuples, and a function
    that builds the tree again from a list of leaves."""
    leaves = []
    _tree_map(leaves.append, tree)

    def rebuild(new):
        it = iter(new)
        return _tree_map(lambda _: next(it), tree)

    return leaves, rebuild


class _Schedule:
    """One call's GPipe schedule on this rank: the axis' group and
    neighbours, the microbatches; :meth:`forward` and :meth:`backward`."""

    def __init__(self, mesh, axis: str, x: torch.Tensor, num_microbatches: int | None):
        self.n = axis_size(mesh, axis)
        self.idx = mesh.get_local_rank(axis)
        self.group = mesh.get_group(axis)
        self.batch = x.shape[0]
        self.m = num_microbatches or self.n
        if self.batch % self.m != 0:
            raise ValueError(f'batch {self.batch} not divisible by {self.m} microbatches')
        self.prev = dist.get_global_rank(self.group, self.idx - 1) if self.idx > 0 else None
        self.next = dist.get_global_rank(self.group, self.idx + 1) if self.idx < self.n - 1 else None

    def microbatches(self, x: torch.Tensor) -> torch.Tensor:
        return x.contiguous().reshape(self.m, self.batch // self.m, *x.shape[1:])

    def _hop(self, send, to, recv_like, frm):
        """Post this tick's send (to ``to``) and receive (from ``frm``, a
        tensor like ``recv_like``), either one None, and wait for both."""
        ops, inbox = [], None
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send, to, self.group))
        if recv_like is not None:
            inbox = torch.empty_like(recv_like)
            ops.append(dist.P2POp(dist.irecv, inbox, frm, self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return inbox

    def forward(self, stage: Callable, x: torch.Tensor, kept: list | None = None) -> torch.Tensor:
        """The schedule's forward: stage s runs microbatch t - s at tick t,
        the hop into stage s at tick t carrying what stage s - 1 made at
        tick t - 1.  With ``kept`` (a list), each microbatch's stage input,
        made a leaf that requires grad, and its output are appended, in
        the order run, for :meth:`backward`."""
        n, idx, m = self.n, self.idx, self.m
        x_mb = self.microbatches(x)
        outs = torch.empty_like(x_mb)
        if n > 1:
            dist.barrier(group=self.group)  # the group's first op involves every rank: NCCL makes its communicator here
        state = None
        for t in range(m + n - 1):
            inbox = self._hop(state if self.next is not None and 0 <= t - (idx + 1) < m else None, self.next,
                              x_mb[0] if self.prev is not None and 0 <= t - idx < m else None, self.prev)
            if not 0 <= t - idx < m:
                continue  # a bubble tick for this stage
            h = x_mb[t] if idx == 0 else inbox
            if kept is not None:
                h = h.detach().requires_grad_()
            state = stage(h).contiguous()
            if kept is not None:
                kept.append((h, state))
                state = state.detach()
            if idx == n - 1:
                outs[t - idx] = state
        dist.broadcast(outs, dist.get_global_rank(self.group, n - 1), group=self.group)
        return outs.reshape(self.batch, *x.shape[1:])

    def backward(self, kept: list, params: list, d_out: torch.Tensor) -> torch.Tensor:
        """The reverse schedule: at tick t (from the last down) stage s
        takes the gradient of microbatch t - s's output (the last stage from
        ``d_out``, the others from stage s + 1), runs the backward of its
        kept graph into the stage input and ``params`` (their ``.grad``),
        and at tick t - 1 sends the input's gradient to stage s - 1.
        Returns the gradient of the microbatched input on stage 0, zeros on
        the others (their input is no function of ``x``)."""
        n, idx, m = self.n, self.idx, self.m
        d_mb = self.microbatches(d_out)
        dx = torch.zeros_like(d_mb)
        wanted = [p for p in params if p.requires_grad]
        d_in = None
        for t in reversed(range(m + n - 1)):
            j = t - idx
            dstate = self._hop(d_in if self.prev is not None and 0 <= t + 1 - idx < m else None, self.prev,
                               d_mb[0] if self.next is not None and 0 <= j < m else None, self.next)
            if not 0 <= j < m:
                continue
            h, out = kept[j]
            g = d_mb[j] if idx == n - 1 else dstate
            # the last microbatch's backward frees what the stage shares between them (prepared weights)
            torch.autograd.backward(out, g, retain_graph=j > 0, inputs=[h] + wanted)
            d_in = h.grad
            if idx == 0:
                dx[j] = d_in
        return dx.reshape(d_out.shape)


class _Pipeline(torch.autograd.Function):
    """:func:`pipeline_run` under grad: the schedule as one function of
    ``x`` and this rank's stage params."""

    @staticmethod
    def forward(ctx, sched: _Schedule, make_stage: Callable, rebuild: Callable, x, *leaves):
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        kept = []
        with torch.enable_grad():
            out = sched.forward(make_stage(rebuild(params)), x.detach(), kept)
        ctx.sched, ctx.kept, ctx.params = sched, kept, params
        return out

    @staticmethod
    def backward(ctx, d_out):
        kept, params = ctx.kept, ctx.params
        ctx.kept = ctx.params = None
        dx = ctx.sched.backward(kept, params, d_out.contiguous())
        return (None, None, None, dx, *(p.grad for p in params))


def shard_stacked_params(stacked_params, mesh, axis: str = 'pp'):
    """Place stacked stage params so each rank holds only its stage: each
    leaf a ``DTensor`` sharded along dim 0 over ``axis``."""
    from torch.distributed.tensor import distribute_tensor

    from .mesh import batch_sharding

    placements = batch_sharding(mesh, axis)
    return _tree_map(lambda a: distribute_tensor(a, mesh, placements), stacked_params)
