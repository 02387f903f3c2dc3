"""Expert-parallel mixture-of-experts layer over a mesh axis.

Counterpart of ``resselt_tpu/parallel/moe.py``: a framework capability,
not an arch port (no family uses a sparse MoE).  Expert weights are stacked
on a leading expert axis and sharded over the ``ep`` axis; every rank
computes its local experts' share of the softmax-gated sum (soft, dense
dispatch: static shapes, no gather), and one ``all_reduce`` over the axis
adds the shares.  Plain torch: there is no kernel here, in either package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import axis_size, is_sharded, local_tensor


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate='tanh')  # jax.nn.gelu's default


def init_moe_params(generator: torch.Generator, d: int, d_hidden: int, n_experts: int, device='cpu') -> dict:
    """Gate and stacked two-layer FFN experts, He-scaled normals drawn from
    ``generator`` (the values differ from ``jax.random``'s; carry a JAX
    model's params across as numpy to compare)."""
    s1 = (2.0 / d) ** 0.5

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32).to(device)

    return {
        'gate': normal(d, n_experts) * s1,
        'w1': normal(n_experts, d, d_hidden) * s1,
        'w2': normal(n_experts, d_hidden, d) * (2.0 / d_hidden) ** 0.5,
    }


def _experts(probs, x, w1, w2):
    h = _gelu(torch.einsum('td,edf->tef', x, w1))
    y = torch.einsum('tef,efd->ted', h, w2)
    return torch.einsum('te,ted->td', probs, y)


def moe_apply_dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Sequential reference: the softmax-gated sum over all experts of
    ``x`` (tokens, d)."""
    probs = torch.softmax(x @ params['gate'], dim=-1)
    return _experts(probs, x, params['w1'], params['w2'])


def moe_apply_ep(params: dict, x: torch.Tensor, mesh, axis: str = 'ep') -> torch.Tensor:
    """:func:`moe_apply_dense` with the experts split over ``axis``: each
    rank takes the full softmax, keeps its experts' columns, runs its
    experts, and one ``all_reduce`` adds the ranks' shares.  ``params`` as
    :func:`shard_moe_params` places them, or whole on every rank.  Raises
    ValueError when the axis size does not divide the experts."""
    ep = axis_size(mesh, axis)
    n_exp = params['w1'].shape[0]
    if n_exp % ep != 0:
        raise ValueError(f'{n_exp} experts not divisible by ep={ep}')
    local = n_exp // ep
    start = mesh.get_local_rank(axis) * local

    def mine(w):
        return w.to_local() if is_sharded(w) else w[start:start + local]

    probs = torch.softmax(x @ local_tensor(params['gate']), dim=-1)
    part = _experts(probs[:, start:start + local], x, mine(params['w1']), mine(params['w2'])).contiguous()
    dist.all_reduce(part, group=mesh.get_group(axis))
    return part


def shard_moe_params(params: dict, mesh, axis: str = 'ep') -> dict:
    """Place the expert stacks so each rank holds only its experts (a
    ``DTensor`` sharded along the expert axis), the gate replicated."""
    from torch.distributed.tensor import distribute_tensor

    from .mesh import batch_sharding, replicated

    return {
        'gate': distribute_tensor(params['gate'], mesh, replicated(mesh)),
        'w1': distribute_tensor(params['w1'], mesh, batch_sharding(mesh, axis)),
        'w2': distribute_tensor(params['w2'], mesh, batch_sharding(mesh, axis)),
    }
