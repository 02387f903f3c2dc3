"""SR fine-tuning / training loop over a folder of images.

Counterpart of ``tools/train_sr.py``, with its flags and loop: random HR
crops paired with box-downsampled LR inputs from the native sampler
(``data.py``) behind a prefetch thread, the batch moved to the card from
pinned memory, schedule / loss / EMA / remat (``train.py``), eval PSNR
and SSIM (``metrics.py``), train-state checkpoints for resume, and the
fine-tuned model saved as ``.npz`` (``cache.py``) or ``.safetensors``.

    python -m resselt_tpu_torch.train_sr CKPT_OR_NPZ IMAGE_DIR --steps 1000

Runs on ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  Under ``torchrun`` it trains data-parallel, as the JAX loop
does over its ``dp`` mesh: one rank a card (NCCL), or gloo ranks with
``--device cpu``,

    torchrun --nproc-per-node=N -m resselt_tpu_torch.train_sr CKPT IMAGE_DIR --steps 1000

The batch is rounded to a multiple of the ranks (``max(batch - batch % n,
n)``); every rank draws the same global batch from the same seeded sampler
and trains on its slice (``train.make_train_step(mesh=...)``), the eval
PSNR is taken over the global eval batch, and only rank 0 logs and writes
files.  One process started without ``torchrun`` trains alone.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys
import time

import numpy as np

logger = logging.getLogger('resselt_tpu_torch.train')


def load_images(image_dir: str, min_size: int) -> list[np.ndarray]:
    from PIL import Image

    files = sorted(
        f for ext in ('png', 'jpg', 'jpeg', 'webp', 'bmp')
        for f in glob.glob(os.path.join(image_dir, f'*.{ext}'))
    )
    out = []
    for f in files:
        img = np.asarray(Image.open(f).convert('RGB'), dtype=np.float32) / 255.0
        if img.shape[0] >= min_size and img.shape[1] >= min_size:
            out.append(img)
    if not out:
        raise SystemExit(f'no usable images >= {min_size}px in {image_dir}')
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Fine-tune an SR model; under torchrun, data-parallel over the ranks.')
    parser.add_argument('model', help='checkpoint (.pth/.safetensors/...) or cached .npz')
    parser.add_argument('images', help='directory of training images')
    parser.add_argument('--steps', type=int, default=200)
    parser.add_argument('--batch', type=int, default=8)
    parser.add_argument('--crop', type=int, default=64, help='HR crop size')
    parser.add_argument('--lr', type=float, default=2e-4)
    parser.add_argument('--schedule', default='constant', choices=['constant', 'cosine', 'multistep'])
    parser.add_argument('--warmup', type=int, default=0, help='linear warmup steps')
    parser.add_argument('--loss', default='charbonnier', choices=['charbonnier', 'l1', 'l2'])
    parser.add_argument('--ema', type=float, default=0.0, help='EMA decay (0 disables; e.g. 0.999)')
    parser.add_argument('--remat', action='store_true',
                        help='rematerialize activations in the backward pass (fit bigger crops/batches)')
    parser.add_argument('--save', default=None, help='write the fine-tuned model (.npz cache or .safetensors)')
    parser.add_argument('--checkpoint', default=None, help='train-state file (torch.save) for save/resume')
    parser.add_argument('--checkpoint-every', type=int, default=0, help='save train state every N steps')
    parser.add_argument('--log-every', type=int, default=20)
    parser.add_argument('--loader', default='auto', choices=['auto', 'native', 'numpy'],
                        help='batch sampler backend (native = threaded C++ via ctypes)')
    parser.add_argument('--device', default='cuda',
                        help="torch device to train on (default cuda; 'cpu' runs the kernels' plain versions)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format='%(asctime)s %(levelname)s %(message)s')

    import torch
    import torch.distributed as dist

    from . import load_from_file
    from .cache import load_model, save_model
    from .core.factory import resolve_device
    from .data import CropSampler, Prefetcher
    from .metrics import ssim
    from .train import (
        ema_params, init_train_state, load_train_state, make_lr_schedule, make_optimizer, make_train_step, psnr,
        save_train_state,
    )

    mesh, started = None, False
    if dist.is_initialized() or 'WORLD_SIZE' in os.environ:
        from .parallel.mesh import init_distributed, make_mesh

        started = not dist.is_initialized()
        device = init_distributed(args.device)
        mesh = make_mesh(tp=1, device=device.type)
        if dist.get_rank() != 0:
            logger.setLevel(logging.WARNING)
    else:
        device = resolve_device(args.device)
    model = load_model(args.model, device=device) if args.model.endswith('.npz') else load_from_file(args.model,
                                                                                                   device=device)
    scale = model.metadata.upscale
    if not isinstance(scale, int):
        scale = 2
    logger.info('model %s (%s), scale %s, device %s', model.arch_id, model.metadata.name, scale, device)

    images = load_images(args.images, args.crop)
    images_u8 = [(im * 255.0 + 0.5).astype(np.uint8) for im in images]
    sampler = CropSampler(images_u8, crop=args.crop, scale=scale, seed=0, backend=args.loader)
    logger.info('%d training images (%s sampler)', len(images), sampler.backend)
    batch = args.batch
    if mesh is not None:
        n = mesh.size(0)
        batch = max(batch - batch % n, n)
        logger.info('data-parallel ranks=%d batch=%d', n, batch)

    def to_device(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if device.type == 'cuda':
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    schedule = make_lr_schedule(args.lr, args.schedule, total_steps=args.steps, warmup_steps=args.warmup)
    optimizer = make_optimizer(lr=schedule)
    state = init_train_state(model.params, optimizer, ema=args.ema > 0)
    start_step = 0
    if args.checkpoint and os.path.isfile(args.checkpoint):
        state = load_train_state(args.checkpoint, state)
        start_step = int(state.step)
        logger.info('resumed train state from %s at step %d', args.checkpoint, start_step)
    step_fn = make_train_step(model.raw_apply_fn, model.config, optimizer, loss=args.loss,
                              ema_decay=args.ema, remat=args.remat, mesh=mesh)

    eval_lr, eval_hr = (to_device(a) for a in sampler.next_batch(batch))
    mine = slice(None)
    if mesh is not None:  # each rank evaluates its slice of the global eval batch
        n = batch // mesh.size(0)
        mine = slice(mesh.get_local_rank(0) * n, (mesh.get_local_rank(0) + 1) * n)

    def evaluate(params):
        """The eval batch's output (each rank's slice) and the PSNR over
        the global eval batch: the squared errors summed across the ranks."""
        with torch.no_grad():
            out = model.apply(params, eval_lr[mine])
        if mesh is None:
            return out, float(psnr(out, eval_hr))
        sq = torch.square(out - eval_hr[mine]).sum().reshape(1)
        dist.all_reduce(sq, group=mesh.get_group(0))
        mse = sq / eval_hr.numel()
        return out, float(10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12)))

    base_psnr = evaluate(state.params)[1]
    logger.info('initial eval PSNR %.2f dB', base_psnr)

    t0 = time.perf_counter()
    prefetch = Prefetcher(sampler, batch)
    try:
        for step in range(start_step + 1, args.steps + 1):
            lr_np, hr_np = prefetch.next()
            state, metrics = step_fn(state, to_device(lr_np), to_device(hr_np))
            if step % args.log_every == 0 or step == args.steps:
                loss = float(metrics['loss'])
                gn = float(metrics['grad_norm'])
                ips = (step - start_step) * batch / (time.perf_counter() - t0)
                logger.info('step %d loss %.7g grad_norm %.7g (%.1f img/s)', step, loss, gn, ips)
            if args.checkpoint and args.checkpoint_every and step % args.checkpoint_every == 0:  # rank 0 writes
                save_train_state(state, args.checkpoint)
                logger.info('checkpointed train state at step %d -> %s', step, args.checkpoint)
    finally:
        prefetch.close()

    if args.checkpoint:
        save_train_state(state, args.checkpoint)
        logger.info('checkpointed final train state -> %s', args.checkpoint)

    out_params = ema_params(state) if args.ema > 0 else state.params
    final_out, final_psnr = evaluate(out_params)
    if mesh is not None:  # the global eval batch's output, for the SSIM
        parts = [torch.empty_like(final_out) for _ in range(mesh.size(0))]
        dist.all_gather(parts, final_out.contiguous(), group=mesh.get_group(0))
        final_out = torch.cat(parts)
    final_ssim = ssim(final_out.clamp(0, 1).float().cpu().numpy(), eval_hr.float().cpu().numpy())
    logger.info('final eval PSNR %.2f dB / SSIM %.4f (was %.2f dB)%s',
                final_psnr, final_ssim, base_psnr,
                ' [EMA weights]' if args.ema > 0 else '')

    if args.save and (mesh is None or dist.get_rank() == 0):
        model.params = dict(out_params)
        if args.save.endswith('.safetensors'):
            from .io import write_safetensors

            write_safetensors({k: v.detach().cpu().numpy() for k, v in out_params.items()}, args.save,
                              metadata={'arch': model.arch_id})
        else:
            save_model(model, args.save)
        logger.info('saved fine-tuned model to %s', args.save)
    if started:
        dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
