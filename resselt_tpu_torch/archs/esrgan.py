"""ESRGAN / RRDBNet (old-arch layout), incl. BSRGAN/RealSR, Real-ESRGAN and
ESRGAN+ checkpoints.

Counterpart of ``resselt_tpu/archs/esrgan.py``: the same key remap, config
inference and serving hints, and the same producer-decomposed RDB.  Every
3x3 conv runs through ``ops.fused_conv3x3_act`` (351 launches per 4x
forward of RRDBNet-23); in the served 16-bit forward each RDB producer runs
``ops.fused_conv3x3_step`` instead, with the block's glue (carry, lrelu'd
feature, residuals) in the kernel's epilogue and the chain's bits.  Its
weights are repacked for the kernel once per compute dtype (``prepare``),
the RDB producer weights and biases concatenated there rather than on
every forward.  A quantized model's int8 convs (``SRModel.quantize_int8``)
run ``F.conv2d_int8`` instead, the RDB's as JAX's ``_rdb`` int8 path: one
concatenated int8 conv a stage when all five producer weights are int8, the
int8 members dequantized (exact) when they are mixed with float ones.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..ops.conv_route import conv, prepare_conv, prepare_named_conv
from ..ops.fused_conv import conv3x3_step_takes, fused_conv3x3_step


@dataclass(frozen=True)
class ESRGANConfig:
    in_nc: int
    out_nc: int
    num_filters: int
    num_blocks: int
    scale: int  # checkpoint-level scale (before shuffle_factor division)
    plus: bool
    shuffle_factor: int | None


# -- new-arch -> old-arch key remap ------------------------------------------
#
# New-arch checkpoints come in two key spellings (BSRGAN/RealSR
# 'RRDB_trunk.N.RDBk.convM.*' and Real-ESRGAN 'body.N.rdbk.convM.*'); the
# forward pass uses the flattened old-arch 'model.N' naming.

# body blocks, in detection-priority order; group 1 of each regex is the
# block index.  The third spelling is the old layout itself (counting only).
_BODY_PATTERNS = (
    re.compile(r'RRDB_trunk\.(\d+)\.RDB(\d)\.conv(\d+)\.(weight|bias)'),
    re.compile(r'body\.(\d+)\.rdb(\d)\.conv(\d+)\.(weight|bias)'),
    re.compile(r'model\.\d+\.sub\.(\d+)\.RDB(\d+)\.conv(\d+)\.0\.(weight|bias)'),
)
_BODY_TEMPLATE = r'model.1.sub.\1.RDB\2.conv\3.0.\4'

# head / trunk convs: new name -> old index template ({nb} = num body blocks)
_HEAD_RENAMES = {
    'conv_first': 'model.0',
    'trunk_conv': 'model.1.sub.{nb}',
    'conv_body': 'model.1.sub.{nb}',
}

# upsampling tail: upconvN/conv_upN -> model.{3N}; HR conv and last conv sit
# 2 and 4 slots past the highest upconv (0 when there is none)
_UPCONV_PATTERN = re.compile(r'(?:upconv|conv_up)(\d)\.(weight|bias)')
_TAIL_OFFSETS = {'HRconv': 2, 'conv_hr': 2, 'conv_last': 4}


def _num_body_blocks(state) -> int:
    for pattern in _BODY_PATTERNS:
        idxs = [int(m.group(1)) for k in state if (m := pattern.search(k))]
        if idxs:
            return max(idxs) + 1
    raise ValueError('ESRGAN: no RRDB body keys found')


def _to_old_arch(state):
    if 'params_ema' in state:
        state = state['params_ema']
    if 'conv_first.weight' not in state:
        return state  # already old-arch
    nb = _num_body_blocks(state)

    out = {}
    for pattern in _BODY_PATTERNS[:2]:
        for k, v in state.items():
            new_key, n = pattern.subn(_BODY_TEMPLATE, k)
            if n:
                out[new_key] = v
    for src, dst in _HEAD_RENAMES.items():
        for kind in ('weight', 'bias'):
            if f'{src}.{kind}' in state:
                out[f'{dst.format(nb=nb)}.{kind}'] = state[f'{src}.{kind}']

    max_upconv = 0
    for k, v in state.items():
        m = _UPCONV_PATTERN.match(k)
        if m:
            idx = 3 * int(m.group(1))
            out[f'model.{idx}.{m.group(2)}'] = v
            max_upconv = max(max_upconv, idx)
    for src, offset in _TAIL_OFFSETS.items():
        for kind in ('weight', 'bias'):
            if f'{src}.{kind}' in state:
                out[f'model.{max_upconv + offset}.{kind}'] = state[f'{src}.{kind}']

    return dict(sorted(out.items(), key=lambda kv: int(kv[0].split('.')[1])))


def _get_scale(state) -> int:
    seq_len = get_seq_len(state, 'model')
    return 2 ** ((seq_len - 5) // 3)


def _n_up(cfg: ESRGANConfig) -> int:
    return int(math.log2(cfg.scale)) if cfg.scale != 3 else 1


# -- weights for the kernel ---------------------------------------------------


def _rdb_weights(p: PTree, dtype: torch.dtype, plus: bool) -> dict:
    """One RDB's producer convs.

    The reference's five convs c_i = conv(concat(x, f_1..f_{i-1})) are
    regrouped by PRODUCER: stage j's conv reads f_j (stage 0: x) and emits
    the slices of every later conv that consume it, so the output widths
    are 4gc+nf, 3gc+nf, 2gc+nf, gc+nf, nf.  All five biases land once, in
    the stage-0 output.  int8 weights (``quantize_int8``): the regroup
    concatenates the five, so the int8 path needs ALL of them quantized,
    their per-out-channel scales concatenated along the same axis; a
    partly quantized RDB (gc and nf on both sides of the eligibility
    bound) dequantizes its int8 members, which is exact in the math."""
    pairs = [p.conv_weight_int8(f'conv{i}.0') for i in range(1, 6)]
    int8 = all(s is not None for _, s in pairs)
    ws = [w if int8 or s is None else w.float() * s[:, None, None, None] for w, s in pairs]
    nf = ws[0].shape[1]
    gc = ws[0].shape[0]
    biases = [p.get(f'conv{i}.0.bias') for i in range(1, 6)]
    bias0 = None
    if any(b is not None for b in biases):
        bias0 = torch.cat([b.float() if b is not None else torch.zeros(w.shape[0], device=w.device)
                           for b, w in zip(biases, ws)]).contiguous()
    producers = []
    for j in range(5):
        lo = 0 if j == 0 else nf + (j - 1) * gc
        hi = nf if j == 0 else lo + gc
        w = torch.cat([ws[i][:, lo:hi] for i in range(j, 5)], dim=0)
        scale = torch.cat([pairs[i][1] for i in range(j, 5)]) if int8 else None
        producers.append(prepare_conv(w, bias0 if j == 0 else None, dtype, scale=scale))
    out = {'producers': producers, 'gc': gc}
    if plus:
        w11, s11 = p.conv_weight_int8('conv1x1')
        out['conv1x1'] = prepare_conv(w11, None, dtype, scale=s11)
    return out


def _rrdb_weights(cfg: ESRGANConfig, p: PTree, dtype: torch.dtype) -> list:
    """One RRDB's three RDBs (``p``: the block's params, ``RDB1`` ...)."""
    return [_rdb_weights(p.sub(f'RDB{r}'), dtype, cfg.plus) for r in (1, 2, 3)]


def _head_tail_weights(cfg: ESRGANConfig, params, dtype: torch.dtype) -> dict:
    """The head, trunk and tail convs as ``ops.conv_route`` builds them (the
    kernel's taps, or int8)."""
    n_up = _n_up(cfg)
    names = ['model.0', f'model.1.sub.{cfg.num_blocks}']
    names += [f'model.{3 * i}' for i in range(1, n_up + 1)]
    names += [f'model.{3 * n_up + 2}', f'model.{3 * n_up + 4}']
    return {name: prepare_named_conv(params, name, dtype) for name in names}


def prepare(cfg: ESRGANConfig, params, dtype: torch.dtype) -> dict:
    """Every conv's weights for inputs of ``dtype``: the head, trunk and
    tail convs, each RDB's producers."""
    p = PTree(params)
    out = _head_tail_weights(cfg, params, dtype)
    out['rdb'] = [_rrdb_weights(cfg, p.sub(f'model.1.sub.{i}'), dtype) for i in range(cfg.num_blocks)]
    return out


# -- forward ----------------------------------------------------------------


def _rdb(rw: dict, x, plus: bool):
    """ResidualDenseBlock_5C, producer-decomposed (see ``_rdb_weights``)."""
    gc = rw['gc']
    producers = rw['producers']
    a = conv(producers[0], x)
    f2 = None
    for j in range(1, 5):
        f = F.leaky_relu(a[..., :gc], 0.2)
        if plus and j == 2:
            f = f + conv(rw['conv1x1'], x)
            f2 = f
        if plus and j == 4:
            f = f + f2
        a = a[..., gc:] + conv(producers[j], f)
    return (a * 0.2 + x).contiguous()


def _rdb_steps(rw: dict, x, outer=None):
    """``_rdb`` (not plus) as five ``fused_conv3x3_step`` launches, each
    producer's glue in its epilogue: the lrelu'd feature and the carry
    split off the first four, the residual added by the last, and with
    ``outer`` (the RRDB's input) also ``_rrdb``'s ``out * 0.2 + outer``."""
    gc = rw['gc']
    first, *middle, last = rw['producers']
    f, a = fused_conv3x3_step(x, first.w, first.b, split=gc)
    for p in middle:
        f, a = fused_conv3x3_step(f, p.w, p.b, addend=a, split=gc)
    return fused_conv3x3_step(f, last.w, last.b, addend=a, residuals=(x,) if outer is None else (x, outer))


def _fuses(rws, x, plus: bool) -> bool:
    """Whether an RRDB runs as producer steps (``_rdb_steps``): 16-bit
    ``x``, every producer a routed kernel conv (not int8), no ESRGAN+
    conv1x1, nothing for autograd to record (the served forward runs
    under ``no_grad``), and on the card every producer a shape the step
    kernel takes (``conv3x3_step_takes``: its wgmma path, Cout and gc
    multiples of 8).  Training, int8, ESRGAN+, f32 and the other widths
    run the chain of ``_rdb``."""
    convs = [c for rw in rws for c in rw['producers']]
    if plus or x.dtype not in (torch.bfloat16, torch.float16) or not all(c.kernel for c in convs):
        return False
    operands = [x] + [t for c in convs for t in (c.w, c.b) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return False
    return x.device.type == 'cpu' or all(
        conv3x3_step_takes(c.shape[1], c.shape[0], rw['gc'] if j < 4 else None)
        for rw in rws for j, c in enumerate(rw['producers']))


def _rrdb(rws, x, plus: bool):
    if _fuses(rws, x, plus):
        out = x
        for i, rw in enumerate(rws):
            out = _rdb_steps(rw, out, x if i == len(rws) - 1 else None)
        return out
    out = x
    for rw in rws:
        out = _rdb(rw, out, plus)
    return out * 0.2 + x


def _head(cfg: ESRGANConfig, w: dict, x):
    """Input shuffle + first conv; returns (feat, (h, w)) for the tail crop."""
    sf = cfg.shuffle_factor
    h, wd = x.shape[1], x.shape[2]
    if sf:
        x = F.pad2d(x, (0, (sf - wd % sf) % sf, 0, (sf - h % sf) % sf), mode='reflect')
        x = F.pixel_unshuffle(x, sf).contiguous()
    return conv(w['model.0'], x), (h, wd)


def _tail(cfg: ESRGANConfig, w: dict, feat, body, hw):
    out = feat + conv(w[f'model.1.sub.{cfg.num_blocks}'], body)

    n_up = _n_up(cfg)
    up_factor = 3 if cfg.scale == 3 else 2
    for i in range(1, n_up + 1):
        out = F.interpolate_nearest(out, scale_factor=up_factor)
        out = conv(w[f'model.{i * 3}'], out, 'lrelu')
    out = conv(w[f'model.{3 * n_up + 2}'], out, 'lrelu')
    out = conv(w[f'model.{3 * n_up + 4}'], out)

    if cfg.shuffle_factor:
        run_scale = cfg.scale // cfg.shuffle_factor
        out = out[:, : hw[0] * run_scale, : hw[1] * run_scale].contiguous()
    return out


def apply(cfg: ESRGANConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    feat, hw = _head(cfg, w, x)
    body = feat
    for rws in w['rdb']:
        body = _rrdb(rws, body, cfg.plus)
    return _tail(cfg, w, feat, body, hw)


def apply_pipelined(cfg: ESRGANConfig, params, x, mesh, axis: str = 'pp', num_microbatches: int | None = None):
    """The forward of the RAW ``params`` on NHWC ``x`` with the RRDB trunk run
    by the pipeline executor (``parallel/pipeline.py``) over the ``mesh``
    axis ``axis``, as the JAX package's ``apply_pipelined``; the head and
    tail run on every rank.  The RRDBs go into ``mesh.shape[axis]`` stages
    of ``k = ceil(num_blocks / stages)`` blocks, the layout of
    ``chunk_blocks`` (the last stages short, where JAX pads them with
    masked-out blocks), and each rank prepares the weights of the head, the
    tail and its own stage's RRDBs only, for ``x.dtype``.  Every rank
    passes the same ``x`` and returns the whole output, equal to ``apply``.
    Under grad, with the same loss on every rank, every rank gets the whole
    gradient of ``params``: the trunk's blocks' summed over the axis from
    the stage that runs each."""
    from ..parallel.mesh import axis_size, replicated_grad
    from ..parallel.pipeline import pipeline_run

    k = -(-cfg.num_blocks // axis_size(mesh, axis))
    first = mesh.get_local_rank(axis) * k
    mine = range(first, min(first + k, cfg.num_blocks))
    w = _head_tail_weights(cfg, params, x.dtype)
    feat, hw = _head(cfg, w, x.contiguous())
    # one all_reduce in the backward: the trunk input's gradient (from stage 0) and the blocks' (each
    # from the rank that runs it).  Every rank hands the pipeline every block, so that every rank takes
    # the same path and reaches the all_reduce, also one that runs no block
    block_of = {key: i for key in params if (i := _trunk_block(key, cfg.num_blocks)) is not None}
    trunk_in, *trunk = replicated_grad([feat] + [params[key] for key in block_of], mesh.get_group(axis))

    def make_stage(blocks):
        p = PTree(blocks)
        rrdbs = [_rrdb_weights(cfg, p.sub(f'model.1.sub.{i}'), x.dtype) for i in mine]

        def stage(h):
            for rws in rrdbs:
                h = _rrdb(rws, h, cfg.plus)
            return h

        return stage

    body = pipeline_run(make_stage, dict(zip(block_of, trunk)), trunk_in, mesh, axis=axis,
                        num_microbatches=num_microbatches)
    return _tail(cfg, w, feat, body, hw)


def _trunk_block(key: str, num_blocks: int) -> int | None:
    """The RRDB index of a trunk block's param key, else None (the trunk
    conv ``model.1.sub.{num_blocks}`` is no block)."""
    m = re.match(r'model\.1\.sub\.(\d+)\.', key)
    return int(m[1]) if m and int(m[1]) < num_blocks else None


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/esrgan.py::_load``."""
    sd = _to_old_arch(sd)

    model_seq_len = get_seq_len(sd, 'model')
    in_nc = sd['model.0.weight'].shape[1]
    out_nc = sd[f'model.{model_seq_len - 1}.weight'].shape[0]
    scale = _get_scale(sd)
    num_blocks = get_seq_len(sd, 'model.1.sub') - 1
    num_filters = sd['model.0.weight'].shape[0]
    plus = any('.conv1x1.' in k for k in sd.keys())

    if in_nc in (out_nc * 4, out_nc * 16) and out_nc in (in_nc / 4, in_nc / 16):
        shuffle_factor = int(math.sqrt(in_nc / out_nc))
    else:
        shuffle_factor = None

    cfg = ESRGANConfig(
        in_nc=in_nc,
        out_nc=out_nc,
        num_filters=num_filters,
        num_blocks=num_blocks,
        scale=scale,
        plus=plus,
        shuffle_factor=shuffle_factor,
    )
    meta_in_nc, meta_scale = in_nc, scale
    if shuffle_factor:
        meta_in_nc //= shuffle_factor**2
        meta_scale //= shuffle_factor
    meta = ModelMetadata(in_channels=meta_in_nc, out_channels=out_nc, upscale=meta_scale, name='ESRGAN')
    model = SRModel('ESRGAN', cfg, params_from_numpy(sd, device), meta, apply, prepare)
    # the JAX package's hint, kept so that tiled outputs match it; its
    # value has not been re-measured on a GPU
    model.serving_halo = 4
    return model


ARCH = Architecture(
    id='ESRGAN',
    detect_condition=KeyCondition.has_any(
        KeyCondition.has_all('model.0.weight', 'model.1.sub.0.RDB1.conv1.0.weight'),
        KeyCondition.has_all('conv_first.weight', 'body.0.rdb1.conv1.weight', 'conv_body.weight', 'conv_last.weight'),
        KeyCondition.has_all('conv_first.weight', 'RRDB_trunk.0.RDB1.conv1.weight', 'trunk_conv.weight', 'conv_last.weight'),
        KeyCondition.has_all('model.0.weight', 'model.1.sub.0.RDB1.conv1x1.weight'),
    ),
    load_fn=_load,
)
