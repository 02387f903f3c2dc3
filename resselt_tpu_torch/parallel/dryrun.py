"""The multi-device dry run: one train step over a (dp, tp) mesh, ESRGAN's
pipelined trunk over ``pp``, a mixture of experts over ``ep`` and tiled
serving over ``dp``, each on ``n`` ranks.

Counterpart of ``__graft_entry__.dryrun_multichip``, which runs JAX on ``n``
virtual CPU devices in a subprocess; here :func:`dryrun_multichip` spawns
``n`` ranks (``torch.multiprocessing``, a file rendezvous in a temporary
directory), gloo on the CPU or NCCL on ``n`` cards.  JAX's ``sp`` step
(a jitted forward that XLA partitions along H) has no counterpart: no
module of either package splits a forward spatially, and the port's spatial
split is ``upscale_tiled(mesh=...)``, which this run checks.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

SERVE_TOL = 1e-5  # the JAX dry run's bound on mesh-sharded against single-device tiled serving


def _body(rank: int, n: int, device: str, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import resselt_tpu_torch
    from resselt_tpu_torch.archs.esrgan import apply_pipelined
    from resselt_tpu_torch.parallel import (init_distributed, init_moe_params, make_mesh, moe_apply_dense,
                                            moe_apply_ep, shard_moe_params, shard_params, upscale_tiled)
    from resselt_tpu_torch.train import init_train_state, make_optimizer, make_train_step
    from resselt_tpu_torch.zoo import make_esrgan, make_swinir

    torch.set_num_threads(1)
    dev = init_distributed(device, init_method=f'file://{os.path.join(tmp, "rendezvous")}', rank=rank, world_size=n)
    try:
        tp = 2 if n % 2 == 0 and n >= 4 else 1
        dp = n // tp
        mesh = make_mesh(n_devices=n, dp=dp, tp=tp, device=device)

        # one train step of a small SwinIR: params tensor-parallel over tp (JAX's param_sharding rule at
        # min_size 1024), the batch over dp
        model = resselt_tpu_torch.load_from_state_dict(
            make_swinir(embed_dim=16, depths=(1, 1), num_heads=(2, 2), window_size=8, upscale=2), device=dev)
        optimizer = make_optimizer(lr=1e-4)
        state = init_train_state(shard_params(mesh, model.params, min_size=1024), optimizer)
        sharded = sum(1 for v in state.params.values() if any(p.is_shard() for p in v.placements))
        step = make_train_step(model.raw_apply_fn, model.config, optimizer, mesh=mesh)
        lr = torch.zeros((dp, 16, 16, 3), device=dev)
        hr = torch.zeros((dp, 32, 32, 3), device=dev)
        state, metrics = step(state, lr, hr)
        loss = float(metrics['loss'])
        if not np.isfinite(loss):
            raise AssertionError(f'train step loss {loss}')

        # pp: ESRGAN's RRDB trunk, 2n blocks in n stages of two
        pp_mesh = init_device_mesh(device, (n,), mesh_dim_names=('pp',))
        pp_model = resselt_tpu_torch.load_from_state_dict(make_esrgan(num_filters=16, num_blocks=2 * n, scale=2),
                                                          device=dev)
        xs = torch.rand((n, 16, 16, 3), generator=torch.Generator().manual_seed(1)).to(dev)
        with torch.no_grad():
            pp_out = apply_pipelined(pp_model.config, pp_model.params, xs, pp_mesh, axis='pp')
        pp_err = float((pp_out - pp_model(xs)).abs().max())
        if not pp_err <= 2e-5:  # tests/test_pipeline_moe.py's tolerance
            raise AssertionError(f'pipelined ESRGAN against its forward: {pp_err}')

        # ep: the experts split over an 'ep' axis
        ep_mesh = init_device_mesh(device, (n,), mesh_dim_names=('ep',))
        moe = init_moe_params(torch.Generator().manual_seed(0), d=16, d_hidden=32, n_experts=2 * n, device=dev)
        tokens = torch.rand((32, 16), generator=torch.Generator().manual_seed(2)).to(dev)
        ep_out = moe_apply_ep(shard_moe_params(moe, ep_mesh, 'ep'), tokens, ep_mesh, 'ep')
        ep_err = float((ep_out - moe_apply_dense(moe, tokens)).abs().max())
        if not ep_err <= 2e-5:
            raise AssertionError(f'expert-parallel MoE against the dense one: {ep_err}')

        # tiled serving over dp: each tile batch split over the mesh's first axis
        serve_mesh = init_device_mesh(device, (n,), mesh_dim_names=('dp',))
        img = np.random.default_rng(3).random((80, 96, 3), dtype=np.float32)
        served = upscale_tiled(model, img, tile=32, halo=8, mesh=serve_mesh)
        solo = upscale_tiled(model, img, tile=32, halo=8)
        serve_err = float((served - solo).abs().max())
        if not serve_err <= SERVE_TOL:
            raise AssertionError(f'mesh-sharded tiled serving mismatch: {serve_err}')

        if rank == 0:
            line = (f'dryrun_multichip OK ({device}, {n} ranks): dp={dp} tp={tp} loss={loss:.4f} '
                    f'sharded_params={sharded} pp_out={tuple(pp_out.shape)} (err {pp_err:.1e}) '
                    f'ep_out={tuple(ep_out.shape)} (err {ep_err:.1e}) tiled_serve={tuple(served.shape)} '
                    f'(dp-sharded, err {serve_err:.1e}); sp: no counterpart')
            with open(os.path.join(tmp, 'summary.txt'), 'w') as fh:
                fh.write(line)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = 'cuda') -> str:
    """Run the dry run on ``n_devices`` spawned ranks (NCCL on as many cards,
    or gloo with ``device='cpu'``); prints and returns rank 0's summary
    line.  Raises if a rank fails or a check misses its bound."""
    import torch.multiprocessing as mp

    device = torch.device(device).type
    if device == 'cuda' and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f'{n_devices} cards asked for, {torch.cuda.device_count()} found; pass device="cpu"')
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_body, args=(n_devices, device, tmp), nprocs=n_devices, join=True)
        with open(os.path.join(tmp, 'summary.txt')) as fh:
            line = fh.read()
    print(line)
    return line
