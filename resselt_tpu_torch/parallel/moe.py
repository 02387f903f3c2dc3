"""Expert-parallel mixture-of-experts layer over a mesh axis.

Counterpart of ``resselt_tpu/parallel/moe.py``: a framework capability,
not an arch port (no family uses a sparse MoE).  Expert weights are stacked
on a leading expert axis and sharded over the ``ep`` axis; every rank
computes its local experts' share of the softmax-gated sum (soft, dense
dispatch: static shapes, no gather), and one ``all_reduce`` over the axis
adds the shares.  Gradients follow JAX's transposes of that ``psum``
(``mesh.sum_over``, ``mesh.replicated_grad``): every rank's loss on the
replicated output gives each rank the whole gradient of the input and the
gate, and of whole expert stacks, and of a sharded stack its own shard's.
Plain torch: there is no kernel here, in either package.
"""

from __future__ import annotations

import torch

from .mesh import axis_size, is_sharded, local_tensor, replicated_grad, sum_over


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate='tanh')  # jax.nn.gelu's default


def init_moe_params(generator: torch.Generator, d: int, d_hidden: int, n_experts: int, device='cuda') -> dict:
    """Gate and stacked two-layer FFN experts, He-scaled normals drawn from
    ``generator`` (the values differ from ``jax.random``'s; carry a JAX
    model's params across as numpy to compare), on ``device``: the card
    unless the caller asks for the CPU; without a card ``cuda`` raises."""
    from ..core.factory import resolve_device

    device = resolve_device(device)
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
    :func:`shard_moe_params` places them, or whole on every rank.  Every
    rank passes the same ``x`` and computes the same loss of the result:
    ``x``, the gate and whole expert stacks then get their whole gradient on
    every rank (summed over the axis), a sharded stack its shard's.  Raises
    ValueError when the axis size does not divide the experts."""
    ep = axis_size(mesh, axis)
    n_exp = params['w1'].shape[0]
    if n_exp % ep != 0:
        raise ValueError(f'{n_exp} experts not divisible by ep={ep}')
    local = n_exp // ep
    start = mesh.get_local_rank(axis) * local
    group = mesh.get_group(axis)
    # replicated inputs: their gradients are summed over the axis
    names = ['gate'] + [k for k in ('w1', 'w2') if not is_sharded(params[k])]
    x, *vals = replicated_grad([x] + [local_tensor(params[k]) for k in names], group)
    p = {**params, **dict(zip(names, vals))}

    def mine(w):
        return w.to_local() if is_sharded(w) else w[start:start + local]

    probs = torch.softmax(x @ p['gate'], dim=-1)
    return sum_over(_experts(probs[:, start:start + local], x, mine(p['w1']), mine(p['w2'])), group)


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
