"""Training utilities: losses, learning-rate schedules, the optimizer, the
train step, EMA and checkpoints.

Counterpart of ``resselt_tpu/train.py``, with its names and signatures.
The step differentiates a forward over the raw state-dict params with
autograd, through every hand-written kernel (each wrapper in ``ops/`` is an
``autograd.Function``), and updates the params, the Adam moments and the
EMA in place: JAX's buffer donation (``jit(donate_argnums=0)``) has no
counterpart here and needs none.  The optimizer is this module's own code
with optax's arithmetic (:func:`make_optimizer`); the schedules are plain
functions of the step, equal to optax's.  Checkpoints are ``torch.save``
files, not orbax directories.

Over a mesh (``make_train_step(mesh=...)``, the counterpart of the
shardings a JAX caller lays out before ``jit``), every rank runs the step
on the same global batch and takes its slice along ``dp``; the gradients
are averaged over ``dp`` with one ``all_reduce``.  Params that
``parallel.shard_params`` made ``DTensor``s keep their layout: the forward
reads them gathered whole, and the optimizer and the EMA, which are
elementwise, update each rank's local shards.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from . import tracing
from .parallel.mesh import axis_size, full_tensor, is_sharded, local_tensor


FORWARD_RANGE = 'train_step.forward'  # the spans (``tracing``) of a step (the backward lies outside both)
OPTIMIZER_RANGE = 'train_step.optimizer'


class TrainState(NamedTuple):
    params: dict
    opt_state: Any
    step: int
    ema: Any = None  # EMA of the float params, or None when disabled


def charbonnier_loss(pred, target, eps: float = 1e-6):
    return torch.mean(torch.sqrt(torch.square(pred - target) + eps * eps))


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean(torch.square(pred - target))


LOSSES: dict[str, Callable] = {'charbonnier': charbonnier_loss, 'l1': l1_loss, 'l2': l2_loss}


def _constant(value: float) -> Callable[[int], float]:
    return lambda step: value


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule (a polynomial schedule of power 1)."""
    if steps <= 0:
        return _constant(init)
    return lambda step: (init - end) * (1 - min(max(step, 0), steps) / steps) + end


def _cosine(init: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with alpha 0 and exponent 1, in f32 as
    optax computes it."""
    f32 = np.float32
    return lambda step: float(f32(init) * (f32(0.5) * (f32(1) + np.cos(f32(math.pi) * f32(min(step, decay_steps))
                                                                        / f32(decay_steps)))))


def _piecewise(init: float, boundaries_and_scales: Mapping[int, float]) -> Callable[[int], float]:
    """optax.piecewise_constant_schedule: ``init`` times every scale whose
    boundary the step has reached."""
    def schedule(step: int) -> float:
        v = init
        for boundary, scale in sorted(boundaries_and_scales.items()):
            if step >= boundary:
                v = scale * v
        return v
    return schedule


def make_lr_schedule(
    base_lr: float = 2e-4,
    kind: str = 'constant',
    total_steps: int = 0,
    warmup_steps: int = 0,
    milestones: tuple[int, ...] = (),
    gamma: float = 0.5,
) -> Callable[[int], float]:
    """Standard SR learning-rate schedules (constant / cosine / multistep),
    each with optional linear warmup: a function of the step (optax's
    count) to the learning rate, as a Python float."""
    if kind == 'constant':
        sched = _constant(base_lr)
    elif kind == 'cosine':
        if total_steps <= warmup_steps:
            raise ValueError('cosine schedule needs total_steps > warmup_steps')
        sched = _cosine(base_lr, total_steps - warmup_steps)
    elif kind == 'multistep':
        # milestones are GLOBAL steps; the joined schedule sees (step - warmup_steps)
        sched = _piecewise(base_lr, {int(m) - warmup_steps: gamma for m in milestones})
    else:
        raise ValueError(f'unknown schedule {kind!r}')
    if warmup_steps:
        warm, after = _linear(0.0, base_lr, warmup_steps), sched
        return lambda step: warm(step) if step < warmup_steps else after(step - warmup_steps)
    return sched


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the update count and the two moments."""

    count: int
    mu: dict
    nu: dict


class Optimizer:
    """Global-norm clipping then Adam or AdamW, optax's ``chain(
    clip_by_global_norm(clip), adam(lr) | adamw(lr, weight_decay))`` with
    its arithmetic:

    * clip: ``g / (norm / clip)`` where ``norm >= clip`` (optax's ``g /
      norm * clip``, without a host sync; no epsilon, unlike
      ``torch.nn.utils.clip_grad_norm_``);
    * Adam: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``,
      bias-corrected with ``1 - b^count`` taken in f32, ``u = mu_hat /
      (sqrt(nu_hat) + eps)``; AdamW adds ``weight_decay * p`` to ``u``;
    * ``p += -lr * u``, the learning rate at the count before this update
      (so the first update uses ``schedule(0)``).

    :meth:`init` is optax's ``init``; :meth:`apply` is ``update`` followed by
    ``apply_updates``, in place on the params and the moments."""

    def __init__(self, lr: 'float | Callable[[int], float]', weight_decay: float = 0.0, clip: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = lr if callable(lr) else _constant(float(lr))
        self.weight_decay, self.clip, self.b1, self.b2, self.eps = weight_decay, clip, b1, b2, eps

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        return AdamState(0, zeros, {k: torch.zeros_like(v) for k, v in params.items()})

    def apply(self, grads: Mapping[str, torch.Tensor], state: AdamState,
              params: Mapping[str, torch.Tensor], norm: torch.Tensor) -> AdamState:
        """One update of ``params`` (in place) from ``grads``, clipped by
        ``norm``, the global norm of the whole gradients; the new state.
        ``DTensor`` params, moments and grads are updated through their
        local shards."""
        keys = list(params)
        g = [local_tensor(grads[k]).float() for k in keys]
        p = [local_tensor(params[k]) for k in keys]
        mu = [local_tensor(state.mu[k]) for k in keys]
        nu = [local_tensor(state.nu[k]) for k in keys]
        g = torch._foreach_div(g, torch.clamp(norm, min=self.clip) / self.clip)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2))
        count = state.count + 1
        bc1 = float(1 - np.float32(self.b1) ** np.float32(count))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(count))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, -self.schedule(state.count))
        torch._foreach_add_(p, u)
        return AdamState(count, state.mu, state.nu)


def make_optimizer(
    lr: 'float | Callable' = 2e-4,
    weight_decay: float = 0.0,
    clip: float = 1.0,
) -> Optimizer:
    """Adam(W) with global-norm clipping; ``lr`` may be a schedule."""
    return Optimizer(lr, weight_decay, clip)


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: the l2 norm of all the tensors together, in f32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


def _shard_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The part of the whole tensor ``full`` that this rank holds of the
    ``DTensor`` ``like`` (each ``Shard(d)`` placement a ``chunk`` along
    ``d``, as ``distribute_tensor`` splits), or ``full``."""
    if not is_sharded(like):
        return full
    mesh = like.device_mesh
    for i, pl in enumerate(like.placements):
        if pl.is_shard():
            full = full.chunk(mesh.size(i), dim=pl.dim)[mesh.get_local_rank(i)]
    return full


_NON_TRAINABLE_SUFFIXES = ('running_mean', 'running_var', 'num_batches_tracked')


def split_trainable(params: Mapping[str, torch.Tensor]):
    """Split a state dict into (float trainables, static buffers).

    BatchNorm running statistics are float but NOT trainable (torch
    registers them as buffers): with adamw their gradients are zero yet
    decoupled weight decay would still shrink them every step.  An int8
    model's int8 weights are static, as in the JAX package."""
    trainable = {k: v for k, v in params.items()
                 if v.is_floating_point() and not k.endswith(_NON_TRAINABLE_SUFFIXES)}
    static = {k: v for k, v in params.items() if k not in trainable}
    return trainable, static


def init_train_state(params: Mapping[str, torch.Tensor], optimizer: Optimizer, ema: bool = False) -> TrainState:
    """A fresh state over copies of ``params`` (float ones in f32), so the
    in-place step never writes into the model's own tensors."""
    params = {k: v.detach().to(torch.float32 if v.is_floating_point() else v.dtype, copy=True)
              for k, v in params.items()}
    trainable, _ = split_trainable(params)
    return TrainState(
        params=params,
        opt_state=optimizer.init(trainable),
        step=0,
        ema={k: v.clone() for k, v in trainable.items()} if ema else None,
    )


def train_state_from_numpy(params: Mapping[str, np.ndarray], mu: Mapping[str, np.ndarray],
                           nu: Mapping[str, np.ndarray], count: int, step: int | None = None,
                           ema: Mapping[str, np.ndarray] | None = None, device='cuda') -> TrainState:
    """The port's state from a JAX ``TrainState`` taken to numpy:
    ``params``, the Adam moments ``mu`` / ``nu`` and ``count`` (optax's
    ``ScaleByAdamState``), ``step`` (default ``count``) and the EMA."""
    from .core.factory import params_from_numpy

    p = params_from_numpy(params, device)
    trainable, _ = split_trainable(p)
    moments = [params_from_numpy({k: mom[k] for k in trainable}, device) for mom in (mu, nu)]
    e = None if ema is None else params_from_numpy({k: ema[k] for k in trainable}, device)
    count = int(count)
    return TrainState(p, AdamState(count, *moments), count if step is None else int(step), e)


def make_train_step(
    apply_fn: Callable,
    config: Any,
    optimizer: Optimizer,
    loss: str | Callable = 'charbonnier',
    ema_decay: float = 0.0,
    remat: bool = False,
    mesh=None,
):
    """Build a ``(state, lr, hr) -> (state, metrics)`` step function.

    ``apply_fn(config, params, x)`` takes the raw params
    (``SRModel.raw_apply_fn``); ``lr`` / ``hr`` are NHWC batches on the
    params' device.  The step differentiates the loss with autograd and
    updates the params, the optimizer state and the EMA in place (JAX's
    buffer donation has no counterpart: the returned state holds the same
    tensors).  ``remat`` recomputes the forward's activations in the
    backward pass (``torch.utils.checkpoint``, non-reentrant) instead of
    keeping them.  ``ema_decay`` > 0 keeps an exponential moving average of
    the float params in ``state.ema``.  ``metrics``: the loss and the
    global norm of the gradients before clipping, as 0-d tensors.  The
    forward runs inside the span :data:`FORWARD_RANGE`, the norm,
    the update and the EMA inside :data:`OPTIMIZER_RANGE`; the backward
    runs on autograd's threads, outside both.

    ``mesh``: a ``DeviceMesh`` with a ``dp`` axis (``parallel.make_mesh``).
    Every rank calls the step with the same GLOBAL batch, which ``dp``
    divides, and runs its contiguous slice (ranks that differ only along
    other axes, such as ``tp``, run the same slice); the loss is each rank's
    local mean, and the gradients are averaged over ``dp`` with one
    ``all_reduce``, which with equal slices is JAX's gradient of the mean
    over the global batch.  The global norm and the clipping read the whole
    gradients; ``DTensor`` params are gathered whole for the forward and
    updated through their local shards.  ``metrics['loss']`` is the mean
    over ``dp``."""
    loss_fn = LOSSES[loss] if isinstance(loss, str) else loss
    if mesh is not None:
        dp = axis_size(mesh, 'dp')
        dp_rank, dp_group = mesh.get_local_rank('dp'), mesh.get_group('dp')

    def model(params, x):
        if remat:
            return torch.utils.checkpoint.checkpoint(apply_fn, config, params, x, use_reentrant=False)
        return apply_fn(config, params, x)

    def train_step(state: TrainState, lr_batch, hr_batch):
        trainable, static = split_trainable(state.params)
        if mesh is not None:
            if lr_batch.shape[0] % dp or hr_batch.shape[0] != lr_batch.shape[0]:
                raise ValueError(f'global batch {lr_batch.shape[0]} (HR {hr_batch.shape[0]}) not divisible by dp={dp}')
            n = lr_batch.shape[0] // dp
            lr_batch, hr_batch = lr_batch[dp_rank * n:(dp_rank + 1) * n], hr_batch[dp_rank * n:(dp_rank + 1) * n]
            static = {k: full_tensor(v) for k, v in static.items()}
        leaves = {k: full_tensor(v).detach().requires_grad_(True) for k, v in trainable.items()}
        with torch.enable_grad():
            with tracing.span(FORWARD_RANGE):
                loss_val = loss_fn(model({**leaves, **static}, lr_batch), hr_batch)
            grads = torch.autograd.grad(loss_val, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(leaves.items(), grads)}
        loss_val = loss_val.detach()
        with torch.no_grad():
            if mesh is not None:
                grads = _mean_over(grads, dp, dp_group)
                loss_val = _mean_over({'loss': loss_val}, dp, dp_group)['loss']
            with tracing.span(OPTIMIZER_RANGE):
                gnorm = global_norm(grads.values())
                local = {k: _shard_of(grads[k], v) for k, v in trainable.items()}
                opt_state = optimizer.apply(local, state.opt_state, trainable, norm=gnorm)
                ema = state.ema
                if ema_decay and ema is not None:
                    e = [local_tensor(ema[k]) for k in trainable]
                    torch._foreach_mul_(e, ema_decay)
                    torch._foreach_add_(e, torch._foreach_mul([local_tensor(v) for v in trainable.values()],
                                                              1.0 - ema_decay))
        return (
            TrainState(state.params, opt_state, state.step + 1, ema),
            {'loss': loss_val, 'grad_norm': gnorm},
        )

    return train_step


def _mean_over(tensors: Mapping[str, torch.Tensor], n: int, group) -> dict:
    """The tensors averaged over the ``n`` ranks of ``group``: one
    ``all_reduce`` of them flattened into one f32 buffer, copied out into
    tensors of their layouts (``empty_like``: autograd leaves some
    gradients strided, and the path of the global norm's reduction, so its
    rounding, depends on the layout)."""
    keys = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1).float() for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= n
    return {k: torch.empty_like(tensors[k]).copy_(part.view(tensors[k].shape))
            for k, part in zip(keys, flat.split([tensors[k].numel() for k in keys]))}


def ema_params(state: TrainState):
    """Full param dict with EMA weights swapped in for the float params."""
    if state.ema is None:
        return state.params
    _, static = split_trainable(state.params)
    return {**state.ema, **static}


def psnr(pred, target, max_val: float = 1.0):
    mse = torch.mean(torch.square(pred - target))
    return 10.0 * torch.log10(max_val * max_val / torch.clamp(mse, min=1e-12))


def save_train_state(state: TrainState, path: str) -> None:
    """Write the FULL training state (params, Adam moments and count, step,
    EMA) to one ``torch.save`` file, for exact resume.  The JAX package's
    orbax directories are another format: this reads and writes only its
    own files.  A sharded state is gathered whole first, so every rank of
    its mesh calls this; under ``torch.distributed`` only rank 0 writes."""
    def whole(tree):
        return None if tree is None else {k: full_tensor(v) for k, v in tree.items()}

    opt = state.opt_state
    raw = {'params': whole(state.params), 'opt_state': {'count': opt.count, 'mu': whole(opt.mu), 'nu': whole(opt.nu)},
           'step': state.step, 'ema': whole(state.ema)}
    if not dist.is_initialized() or dist.get_rank() == 0:
        torch.save(raw, path)


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Restore a state written by :func:`save_train_state` onto the device
    of ``template`` (a fresh state from the same model and optimizer),
    whose keys, shapes and dtypes it must have; where the template holds a
    ``DTensor``, the restored tensor is one of the same layout (each rank
    keeps its shard of the whole tensor it read)."""
    device = local_tensor(next(iter(template.params.values()))).device
    raw = torch.load(path, map_location=device, weights_only=True)
    opt = raw['opt_state']
    got_all = (raw['params'], opt['mu'], opt['nu'], raw['ema'] or {})
    want_all = (template.params, template.opt_state.mu, template.opt_state.nu, template.ema or {})
    for name, got, want in zip(('params', 'mu', 'nu', 'ema'), got_all, want_all):
        if set(got) != set(want) or any(got[k].shape != want[k].shape or got[k].dtype != want[k].dtype
                                        for k in want):
            raise ValueError(f'{path}: its {name} do not match the template state')

    def placed(got, want):
        if not any(is_sharded(v) for v in want.values()):
            return got
        from torch.distributed.tensor import DTensor

        return {k: DTensor.from_local(_shard_of(v, want[k]).contiguous(), want[k].device_mesh, want[k].placements,
                                      run_check=False) if is_sharded(want[k]) else v
                for k, v in got.items()}

    params, mu, nu, ema = (placed(g, w) for g, w in zip(got_all, want_all))
    return TrainState(params, AdamState(int(opt['count']), mu, nu), int(raw['step']),
                      ema if raw['ema'] is not None else None)
