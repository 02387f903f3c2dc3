"""Helpers that run the port's mesh code in gloo ranks on the CPU, for the
``test_torch_*`` mesh tests.

The tests run the JAX reference in the pytest process (on its 8 virtual
CPU devices) and the port in ranks that :func:`spawn` starts, one process a
rank, with a file rendezvous.  A rank imports this module and the port
only, never JAX or the JAX package; inputs reach it as an ``.npz`` and each
rank writes its results to ``r{rank}.npz`` beside it.  :func:`one_rank`
starts a world of one in the calling process and ends it on exit.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import re
import time

import numpy as np
import torch


def _rank_main(rank: int, n: int, fn, workdir: str) -> None:
    import torch.distributed as dist

    from resselt_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed('cpu', init_method=f'file://{os.path.join(workdir, "rendezvous")}', rank=rank, world_size=n)
    try:
        inputs = dict(np.load(os.path.join(workdir, 'inputs.npz'), allow_pickle=False))
        out = fn(rank, n, inputs, workdir)
        np.savez(os.path.join(workdir, f'r{rank}.npz'), **{k: np.asarray(v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


#: seconds the ranks of one :func:`spawn` may take; a deadlocked collective
#: then fails its test instead of holding the whole run until its time limit
DEADLINE_S = 240.0


def spawn(fn, n: int, workdir: str, inputs: dict, deadline_s: float = DEADLINE_S) -> list[dict]:
    """Run ``fn(rank, n, inputs, workdir) -> {name: array}`` in ``n`` gloo
    ranks; returns each rank's results.  Ranks still running after
    ``deadline_s`` seconds are terminated and TimeoutError is raised."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    np.savez(os.path.join(workdir, 'inputs.npz'), **inputs)
    ctx = mp.spawn(_rank_main, args=(n, fn, workdir), nprocs=n, join=False)
    end = time.monotonic() + deadline_s
    while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
        if time.monotonic() >= end:
            alive = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(f'{fn.__name__}: ranks {alive} of {n} still running after {deadline_s} s')
    return [dict(np.load(os.path.join(workdir, f'r{r}.npz'))) for r in range(n)]


@contextlib.contextmanager
def one_rank():
    """A gloo world of one in this process, ended on exit."""
    import torch.distributed as dist

    from resselt_tpu_torch.parallel.mesh import init_distributed

    init_distributed('cpu')
    try:
        yield
    finally:
        dist.destroy_process_group()


def sub(inputs: dict, prefix: str) -> dict:
    """The inputs under ``prefix/``, with the prefix taken off."""
    return {k[len(prefix) + 1:]: v for k, v in inputs.items() if k.startswith(prefix + '/')}


def conv_stage(params, x):
    """tests/test_pipeline_moe.py's stage: a 3x3 conv then PReLU, NHWC."""
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), params['w'], params['b'], padding=1).permute(0, 2, 3, 1)
    return torch.where(y >= 0, y, params['alpha'] * y)


def _tensors(d: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in d.items()}


# -- tests/test_torch_pipeline_moe.py ----------------------------------------------------


PIPELINE_CASES = ((4, 4), (4, 8), (2, 2))
ESRGAN_CASES = (('esrgan6', 'pp4', None), ('esrgan4', 'pp2', 4))
MOE_GRAD_CASES = (4, 2)  # ep


def grads_of(loss: torch.Tensor, named: dict) -> dict:
    """``d loss / d t`` for each named leaf ``t``: a ``DTensor``'s as this
    rank's local shard; zeros for a leaf the loss does not reach."""
    from resselt_tpu_torch.parallel.mesh import local_tensor

    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return {k: torch.zeros_like(local_tensor(t)) if g is None else local_tensor(g).detach()
            for (k, t), g in zip(named.items(), gs)}


def _leaves(d: dict) -> dict:
    """Fresh leaves that require grad, of the floating tensors of ``d``."""
    return {k: v.detach().clone().requires_grad_() if v.is_floating_point() else v for k, v in d.items()}


def pipeline_moe_cases(rank: int, n: int, inputs: dict, workdir: str) -> dict:
    """In a 4-rank world: the conv-stage pipelines (4 stages on a 'pp' mesh
    of 4; 2 stages on the 'pp' axis of a (2, 2) mesh), ESRGAN with 6 blocks
    on 4 stages and with 4 blocks on 2 stages at m = 4, the MoE over 'ep' of
    4, and whether indivisible experts raise.  Then the gradients of the
    loss ``sum(y ** 2)``, the same on every rank, by ``torch.autograd.grad``:
    of each pipeline's ``x`` and stacked params, whole and sharded
    (``grad/pipe{n}_{m}_{placement}/...``), of each ESRGAN's ``x`` and raw
    params (``grad/{name}/...``), and of the MoE's ``x`` and params at ep 4
    and 2, whole and sharded (``grad/moe{ep}_{placement}/...``), with this
    rank's coordinate on each mesh's axis (``coord/...``)."""
    from torch.distributed.device_mesh import init_device_mesh

    import resselt_tpu_torch
    from resselt_tpu_torch.archs.esrgan import apply_pipelined
    from resselt_tpu_torch.parallel import (moe_apply_ep, pipeline_apply, shard_moe_params, shard_stacked_params,
                                            stack_stages)

    meshes = {'pp4': init_device_mesh('cpu', (4,), mesh_dim_names=('pp',)),
              'pp2': init_device_mesh('cpu', (2, 2), mesh_dim_names=('pp', 'rep'))}
    out = {'coord/pp4': np.array(meshes['pp4'].get_local_rank('pp')),
           'coord/pp2': np.array(meshes['pp2'].get_local_rank('pp'))}
    for n_stages, m in PIPELINE_CASES:
        case = sub(inputs, f'pipe{n_stages}_{m}')
        stages = [_tensors(sub(case, f's{i}')) for i in range(n_stages)]
        mesh = meshes['pp4' if n_stages == 4 else 'pp2']
        stacked = shard_stacked_params(stack_stages(stages), mesh, 'pp')
        out[f'pipe{n_stages}_{m}'] = pipeline_apply(conv_stage, stacked, torch.from_numpy(case['x']), mesh, axis='pp',
                                                    num_microbatches=m).detach()
        for placement in ('whole', 'sharded'):
            stacked = stack_stages(stages)
            if placement == 'sharded':
                stacked = shard_stacked_params(stacked, mesh, 'pp')
            stacked = {k: v.requires_grad_() for k, v in stacked.items()}
            x = torch.from_numpy(case['x']).requires_grad_()
            y = pipeline_apply(conv_stage, stacked, x, mesh, axis='pp', num_microbatches=m)
            g = grads_of((y ** 2).sum(), {'x': x, **stacked})
            out.update({f'grad/pipe{n_stages}_{m}_{placement}/{k}': v for k, v in g.items()})
    for name, mesh_name, m in ESRGAN_CASES:
        case = sub(inputs, name)
        model = resselt_tpu_torch.load_from_state_dict(sub(case, 'sd'), device='cpu')
        mesh = meshes[mesh_name]
        with torch.no_grad():
            out[name] = apply_pipelined(model.config, model.params, torch.from_numpy(case['x']), mesh, axis='pp',
                                        num_microbatches=m)
        params = _leaves(model.params)
        x = torch.from_numpy(case['x']).requires_grad_()
        y = apply_pipelined(model.config, params, x, mesh, axis='pp', num_microbatches=m)
        g = grads_of((y ** 2).sum(), {'x': x, **{f'p/{k}': v for k, v in params.items() if v.requires_grad}})
        out.update({f'grad/{name}/{k}': v for k, v in g.items()})
    ep = init_device_mesh('cpu', (4,), mesh_dim_names=('ep',))
    moe = _tensors(sub(inputs, 'moe'))
    x = moe.pop('x')
    out['moe'] = moe_apply_ep(shard_moe_params(moe, ep, 'ep'), x, ep, 'ep')
    odd = _tensors(sub(inputs, 'moe_odd'))
    try:
        moe_apply_ep(odd, torch.zeros((4, 8)), ep, 'ep')
        out['odd_raised'] = np.array(False)
    except ValueError:
        out['odd_raised'] = np.array(True)
    ep_meshes = {4: ep, 2: init_device_mesh('cpu', (2, 2), mesh_dim_names=('ep', 'rep'))}
    for size in MOE_GRAD_CASES:
        mesh = ep_meshes[size]
        out[f'coord/ep{size}'] = np.array(mesh.get_local_rank('ep'))
        for placement in ('whole', 'sharded'):
            params = moe if placement == 'whole' else shard_moe_params(moe, mesh, 'ep')
            params = {k: v.detach().requires_grad_() for k, v in params.items()}
            xg = x.clone().requires_grad_()
            y = moe_apply_ep(params, xg, mesh, 'ep')
            g = grads_of((y ** 2).sum(), {'x': xg, **params})
            out.update({f'grad/moe{size}_{placement}/{k}': v for k, v in g.items()})
    return out


# -- tests/test_torch_parallel_mesh.py ---------------------------------------------------


def mesh_cases(rank: int, n: int, inputs: dict, workdir: str) -> dict:
    """In a 4-rank world: which keys ``param_sharding`` shards at tp = 2;
    Compact served tiled over a dp = 4 mesh on both paths, with and without
    ``bucket``, and through ``tiled_program``; ESRGAN with tp-sharded params
    over a 2 x 2 mesh on both paths; the meshless runs beside them."""
    import resselt_tpu_torch
    from resselt_tpu_torch.parallel import make_mesh, param_sharding, shard_params, tiled_program, upscale_tiled

    dp4 = make_mesh(n_devices=4, dp=None, tp=1, axis_names=('dp', 'tp'), device='cpu')
    mesh22 = make_mesh(n_devices=4, tp=2, axis_names=('dp', 'tp'), device='cpu')
    out = {}
    esrgan = resselt_tpu_torch.load_from_state_dict(sub(inputs, 'esrgan'), device='cpu')
    for min_size in (1, 1024):
        spec = param_sharding(mesh22, esrgan.params, min_size=min_size)
        out[f'sharded_keys_{min_size}'] = np.array(sorted(k for k, p in spec.items() if p[1].is_shard()))
    compact = resselt_tpu_torch.load_from_state_dict(sub(inputs, 'compact'), device='cpu')
    img = inputs['img_compact']
    for on_device in (False, True):
        out[f'compact_mesh_{on_device}'] = upscale_tiled(compact, img, tile=16, halo=8, mesh=dp4, on_device=on_device)
        out[f'compact_solo_{on_device}'] = upscale_tiled(compact, img, tile=16, halo=8, on_device=on_device)
    out['compact_bucket_mesh'] = upscale_tiled(compact, inputs['img_bucket'], tile=32, halo=8, mesh=dp4, bucket=True)
    out['compact_bucket_solo'] = upscale_tiled(compact, inputs['img_bucket'], tile=32, halo=8, bucket=True)
    fn, scale = tiled_program(compact, *img.shape[:2], tile=16, halo=8, mesh=dp4)
    out['compact_program'] = fn(torch.from_numpy(img))
    out['program_batch'] = np.array(fn.batch_size)
    sharded = copy.copy(esrgan)
    sharded.__dict__.pop('_tiled_fn_cache', None)
    sharded._by_dtype = {}
    sharded.params = shard_params(mesh22, esrgan.params, min_size=1)
    out['esrgan_local_numel'] = np.array(sum(v.to_local().numel() for v in sharded.params.values()))
    for on_device in (False, True):
        out[f'esrgan_mesh_{on_device}'] = upscale_tiled(sharded, inputs['img_esrgan'], tile=16, halo=8, mesh=mesh22,
                                                        on_device=on_device)
        out[f'esrgan_solo_{on_device}'] = upscale_tiled(esrgan, inputs['img_esrgan'], tile=16, halo=8,
                                                        on_device=on_device)
    return out


# -- tests/test_torch_train_dp.py --------------------------------------------------------


TRAIN_LR, TRAIN_STEPS, TRAIN_EMA = 1e-3, 3, 0.9


def _compact_steps(mesh, inputs: dict, min_size: int):
    import resselt_tpu_torch
    from resselt_tpu_torch.parallel import shard_params
    from resselt_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    model = resselt_tpu_torch.load_from_state_dict(sub(inputs, 'compact'), device='cpu')
    opt = make_optimizer(lr=TRAIN_LR)
    state = init_train_state(shard_params(mesh, model.params, min_size=min_size), opt, ema=True)
    step = make_train_step(model.raw_apply_fn, model.config, opt, ema_decay=TRAIN_EMA, mesh=mesh)
    lr_b, hr_b = torch.from_numpy(inputs['lr']), torch.from_numpy(inputs['hr'])
    losses, norms = [], []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, lr_b, hr_b)
        losses.append(float(metrics['loss']))
        norms.append(float(metrics['grad_norm']))
    out = {'losses': np.array(losses), 'grad_norms': np.array(norms)}
    out.update({f'p/{k}': v.full_tensor() for k, v in state.params.items()})
    out.update({f'e/{k}': v.full_tensor() for k, v in state.ema.items()})
    out['n_sharded'] = np.array(sum(any(p.is_shard() for p in v.placements) for v in state.params.values()))
    return out, state, (model, opt)


class StepLog(logging.Handler):
    """Collects ``train_sr``'s step lines: ``steps[step] = (loss,
    grad_norm)``."""

    def __init__(self):
        super().__init__()
        self.steps = {}

    def emit(self, record):
        m = re.match(r'step (\d+) loss (\S+) grad_norm (\S+) ', record.getMessage())
        if m:
            self.steps[int(m[1])] = (float(m[2]), float(m[3]))


def train_dp2_cases(rank: int, n: int, inputs: dict, workdir: str) -> dict:
    """In a 2-rank world: Compact's steps over dp = 2, then ``train_sr``
    under the two ranks, with the loss and gradient norm rank 0 logs."""
    from resselt_tpu_torch.parallel import make_mesh
    from resselt_tpu_torch.train_sr import main

    out = _compact_steps(make_mesh(dp=2, tp=1, device='cpu'), inputs, 1 << 16)[0]
    args = [str(inputs['train_sr_args'][0])] + [str(a) for a in inputs['train_sr_args'][1:]]
    log = StepLog()
    logging.getLogger('resselt_tpu_torch.train').addHandler(log)
    out['train_sr_rc'] = np.array(main(args))
    out['train_sr_steps'] = np.array([log.steps[k] for k in sorted(log.steps)] if rank == 0 else [])
    return out


def train_dp4_cases(rank: int, n: int, inputs: dict, workdir: str) -> dict:
    """In a 4-rank world: Compact's steps over a 2 x 2 mesh with its convs
    sharded over tp (min_size 1024), its sharded state saved (gathered) and
    loaded back into a sharded template, and one step of a small SwinIR."""
    import torch.distributed as dist

    import resselt_tpu_torch
    from resselt_tpu_torch.parallel import make_mesh, shard_params
    from resselt_tpu_torch.parallel.mesh import is_sharded
    from resselt_tpu_torch.train import (ema_params, init_train_state, load_train_state, make_optimizer,
                                         make_train_step, save_train_state)

    mesh = make_mesh(n_devices=4, tp=2, device='cpu')
    out, state, (compact, opt) = _compact_steps(mesh, inputs, 1024)
    path = os.path.join(workdir, 'state.pt')
    save_train_state(state, path)
    dist.barrier()
    template = init_train_state(shard_params(mesh, compact.params, min_size=1024), opt, ema=True)
    back = load_train_state(path, template)
    pairs = [(back.params, state.params), (back.opt_state.mu, state.opt_state.mu),
             (back.opt_state.nu, state.opt_state.nu), (back.ema, state.ema)]
    out['state_round_trip'] = np.array(back.step == state.step and back.opt_state.count == state.opt_state.count and all(
        type(a[k]) is type(b[k]) and a[k].placements == b[k].placements and torch.equal(a[k].to_local(), b[k].to_local())
        for a, b in pairs for k in b))
    out['ema_params_sharded'] = np.array(all(is_sharded(v) for v in ema_params(state).values()))
    model = resselt_tpu_torch.load_from_state_dict(sub(inputs, 'swinir'), device='cpu')
    opt = make_optimizer(lr=1e-4)
    state = init_train_state(shard_params(mesh, model.params, min_size=1024), opt)
    step = make_train_step(model.raw_apply_fn, model.config, opt, mesh=mesh)
    rng = np.random.default_rng(5)
    hr = torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32))
    state, metrics = step(state, hr[:, ::2, ::2].contiguous(), hr)
    out['swinir_loss'] = metrics['loss']
    out['swinir_grad_norm'] = metrics['grad_norm']
    return out
