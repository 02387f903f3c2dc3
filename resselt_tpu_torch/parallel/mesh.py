"""Device meshes on torch.distributed: data-parallel and tensor-parallel
placements.

Counterpart of ``resselt_tpu/parallel/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, laid out row-major as JAX's ``devices.reshape(dp, tp)``; JAX's
``NamedSharding(mesh, PartitionSpec(...))`` becomes a list of
``torch.distributed.tensor`` placements, one per mesh dimension
(``Shard(0)`` on the named axis, ``Replicate()`` on the others), and a
sharded param a ``DTensor``.  The style is SPMD: every rank makes the same
calls, and a function that returns a replicated array in JAX returns the
whole tensor on every rank here.

The group runs NCCL when the device is ``cuda`` (the default) and gloo only
when the caller asks for ``cpu``.  Under ``torchrun`` (``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` in the environment) each process is one
rank and one card; one process started without it is a world of one.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _backend(device_type: str) -> str:
    if device_type == 'cuda':
        return 'nccl'
    if device_type == 'cpu':
        return 'gloo'
    raise ValueError(f"mesh device must be 'cuda' or 'cpu', got {device_type!r}")


def init_distributed(device='cuda', init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Start the default process group unless one is up, and return this
    rank's device: ``cuda:LOCAL_RANK`` (made the current card) or ``cpu``.

    The rank and world size come from the arguments, else from torchrun's
    ``RANK`` / ``WORLD_SIZE`` (with its ``env://`` rendezvous unless
    ``init_method`` is given, e.g. ``file:///tmp/rdzv``); a process with
    neither is a world of one, over an in-process store.  The backend is
    NCCL for ``cuda`` and gloo for ``cpu``.  Asking for ``cuda`` without a
    card raises: nothing falls back to the CPU.  An existing group must use
    the backend that ``device`` needs."""
    device_type = torch.device(device).type
    backend = _backend(device_type)
    if device_type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh was requested but no CUDA device is available; pass device='cpu'")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f'the process group runs {dist.get_backend()}, a {device_type} mesh needs {backend}')
    else:
        env = os.environ
        if rank is None and 'RANK' in env:
            rank = int(env['RANK'])
        if world_size is None and 'WORLD_SIZE' in env:
            world_size = int(env['WORLD_SIZE'])
        if init_method is None and rank is None and world_size is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method=init_method or 'env://', rank=rank or 0,
                                    world_size=world_size or 1)
    if device_type == 'cuda':
        local = int(os.environ.get('LOCAL_RANK', dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        return torch.device('cuda', local)
    return torch.device('cpu')


def make_mesh(n_devices: int | None = None, dp: int | None = None, tp: int = 1, axis_names=('dp', 'tp'),
              device='cuda'):
    """A ``(dp, tp)`` DeviceMesh over the first ``n_devices`` ranks (default:
    the world), row-major as JAX's ``devices.reshape(dp, tp)``; ``dp``
    defaults to ``n_devices // tp``.  Starts the process group when none is
    up (:func:`init_distributed`).  Every rank of the world calls it; a
    rank outside the mesh gets no coordinate in it."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = init_distributed(device).type
    n = n_devices if n_devices is not None else dist.get_world_size()
    if n > dist.get_world_size():
        raise ValueError(f'{n} devices requested, the world has {dist.get_world_size()}')
    if dp is None:
        dp = n // tp
    if dp < 1 or dp * tp > n:
        raise ValueError(f'a ({dp}, {tp}) mesh does not fit {n} devices')
    return DeviceMesh(device_type, torch.arange(dp * tp).reshape(dp, tp), mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    """The mesh's size along the named axis (JAX's ``mesh.shape[axis]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _placements(mesh, axis: str | None) -> list:
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def replicated(mesh) -> list:
    """Placements of a tensor held whole on every rank (JAX's ``P()``)."""
    return _placements(mesh, None)


def batch_sharding(mesh, axis: str = 'dp') -> list:
    """Placements of a batch split along dim 0 over ``axis`` (``P(axis)``)."""
    return _placements(mesh, axis)


def param_sharding(mesh, params: dict, tp_axis: str = 'tp', min_size: int = 1 << 16) -> dict:
    """Tensor-parallel placements for a state dict, by JAX's rule: dim 0 (the
    output channels) of a tensor with at least ``min_size`` elements is
    sharded over ``tp_axis`` when the axis size divides it; everything else
    is replicated.  Returns ``{key: placements}``."""
    tp = axis_size(mesh, tp_axis)
    out = {}
    for k, v in params.items():
        shard = tp > 1 and v.ndim >= 1 and v.numel() >= min_size and v.shape[0] % tp == 0
        out[k] = _placements(mesh, tp_axis if shard else None)
    return out


def shard_params(mesh, params: dict, **kw) -> dict:
    """The params as ``DTensor``s placed by :func:`param_sharding`; a
    model's forward gathers them whole once per compute dtype
    (``SRModel.weights``)."""
    from torch.distributed.tensor import distribute_tensor

    placements = param_sharding(mesh, params, **kw)
    return {k: distribute_tensor(v, mesh, placements[k]) for k, v in params.items()}


def is_sharded(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``DTensor``: a tensor placed over a mesh."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor`` (an alias: writes reach the
    DTensor), or the tensor itself."""
    return t.to_local() if is_sharded(t) else t


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gathered whole (a collective: every rank of its mesh
    calls it), or the tensor itself."""
    return t.full_tensor() if is_sharded(t) else t


# -- gradients across a mesh axis ----------------------------------------------------------
#
# SPMD code computes one loss on every rank from a replicated result.  JAX's
# transposes give the convention: the cotangent of a ``psum`` onto a
# replicated result is the result's own cotangent (no sum: every rank holds
# it already), and a replicated input's cotangent is the sum over the axis of
# every rank's contribution.  The two Functions below are that pair.
# (``torch.distributed.nn.functional.all_reduce`` sums in both directions,
# which multiplies each rank's gradient by the axis size under this
# convention.)


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        out = list(gs)
        by_dtype = {}
        for i, g in enumerate(gs):
            by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():  # one all_reduce a dtype
            flat = torch.cat([gs[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=ctx.group)
            for i, part in zip(idx, flat.split([gs[i].numel() for i in idx])):
                out[i] = part.view_as(gs[i])
        return (None, *out)


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group`` (an ``all_reduce``, on a
    copy), with an identity backward: the result is replicated and each
    rank's loss is the same, so its gradient passes to ``t`` as it is."""
    return _SumForward.apply(t, group)


def replicated_grad(tensors, group) -> list:
    """``tensors`` as they are, whose gradients are summed over ``group`` in
    the backward (one ``all_reduce`` a dtype): for an input every rank holds
    whole but uses only part of, or uses to compute only its share of a
    result.  Those that do not require grad, and all of them without grad
    mode, are returned untouched."""
    tensors = list(tensors)
    idx = [i for i, t in enumerate(tensors) if t.requires_grad] if torch.is_grad_enabled() else []
    if idx:
        for i, t in zip(idx, _SumBackward.apply(group, *(tensors[i] for i in idx))):
            tensors[i] = t
    return tensors
