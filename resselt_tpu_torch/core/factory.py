"""Architecture contract: detection conditions, metadata, and the SRModel
runtime object returned by the loaders.

Counterpart of ``resselt_tpu/core/factory.py``.  Params are a flat dict of
tensors under the checkpoint names, in torch layouts (conv = OIHW), on the
model's device.  The forward is ``apply_fn(config, weights, x)`` on an NHWC
tensor; ``weights`` is what the loader's ``prepare_fn`` builds from the
params once per compute dtype (for ESRGAN: the conv weights repacked for
the 3x3 kernel), or the params themselves when there is no ``prepare_fn``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Literal, Mapping, Sequence

import numpy as np
import torch


class KeyCondition:
    """Recursive boolean key-presence predicate over a state dict."""

    def __init__(self, kind: Literal['all', 'any'], keys: tuple['str | KeyCondition', ...]):
        self._kind = kind
        self._keys = keys

    @staticmethod
    def has_all(*keys: 'str | KeyCondition') -> 'KeyCondition':
        return KeyCondition('all', keys)

    @staticmethod
    def has_any(*keys: 'str | KeyCondition') -> 'KeyCondition':
        return KeyCondition('any', keys)

    def __call__(self, state_dict: Mapping[str, Any]) -> bool:
        def check(key: 'str | KeyCondition') -> bool:
            if isinstance(key, KeyCondition):
                return key(state_dict)
            return key in state_dict

        op = all if self._kind == 'all' else any
        return op(check(k) for k in self._keys)


@dataclass
class ModelMetadata:
    """SR model metadata attached to every loaded model."""

    in_channels: int
    out_channels: int
    upscale: int | Sequence[int]
    name: str


_DTYPE_NAMES = {
    'float32': torch.float32, 'f32': torch.float32,
    'bfloat16': torch.bfloat16, 'bf16': torch.bfloat16,
    'float16': torch.float16, 'f16': torch.float16,
}


def as_torch_dtype(dtype) -> torch.dtype | None:
    """A torch dtype from a torch dtype, a name ('bfloat16', 'bf16', ...) or
    a numpy dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _DTYPE_NAMES[name]
    except KeyError:
        raise ValueError(f'unsupported compute dtype {dtype!r}') from None


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; a CUDA device without a card raises
    (entry points never drop to the CPU on their own)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available; pass device='cpu'")
    return dev


def params_from_numpy(params: Mapping[str, np.ndarray], device, dtype=None) -> dict[str, torch.Tensor]:
    """Tensors on ``device`` from a numpy state dict: floating arrays of
    another width (f16, f64, bf16) become f32, as the JAX package loads
    them, then ``dtype`` (if given) applies to the floating ones.  Also
    carries a JAX model's ``{k: np.asarray(v) for k, v in params.items()}``
    across."""
    dev = resolve_device(device)
    dtype = as_torch_dtype(dtype)
    out = {}
    for k, v in params.items():
        arr = np.asarray(v)
        if arr.dtype.kind == 'f' and arr.dtype.itemsize != 4 or arr.dtype.name == 'bfloat16':
            arr = arr.astype(np.float32)
        t = torch.tensor(arr, device=dev)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t
    return out


_PRECISIONS = {
    # name: (torch.backends.cudnn.allow_tf32, torch.set_float32_matmul_precision); JAX's names for
    # jax.default_matmul_precision and the three dot-algorithm presets that have a counterpart here
    'highest': (False, 'highest'),
    'float32': (False, 'highest'),
    'F32_F32_F32': (False, 'highest'),
    'high': (True, 'high'),
    'tensorfloat32': (True, 'high'),
    'TF32_TF32_F32': (True, 'high'),
    'bfloat16': (True, 'medium'),
    'BF16_BF16_F32': (True, 'medium'),
}


@contextlib.contextmanager
def _precision(precision: str | None):
    """``SRModel.__call__``'s ``precision``, for f32 inputs to the plain
    torch ops: None and 'default' keep torch's settings; 'highest' and
    'float32' turn TF32 off for cuDNN and matmul; 'tensorfloat32' and
    'high' turn it on; 'bfloat16' turns it on for cuDNN and lets f32
    matmuls run as bf16 passes (``torch.set_float32_matmul_precision
    ('medium')``), the nearest thing the card has to the JAX package's bf16
    passes.  JAX's presets 'F32_F32_F32', 'TF32_TF32_F32' and
    'BF16_BF16_F32' are the same three settings.  The matmul precision
    (which ``torch.backends.cuda.matmul.allow_tf32`` mirrors) and cuDNN's
    TF32 switch are restored on exit.  The hand-written f32 kernels are
    exact FMA whatever it says.  Any other string raises ValueError."""
    if precision is None or precision == 'default':
        yield
        return
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be None, 'default' or one of {sorted(_PRECISIONS)}, got {precision!r}")
    cudnn_tf32, matmul = _PRECISIONS[precision]
    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(matmul)
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


class SRModel:
    """A loaded super-resolution model.

    * ``params``: flat dict of tensors keyed by the (transformed)
      checkpoint names, torch layouts, on the model's device.
    * ``apply_fn(config, weights, x)``: forward on an NHWC tensor.
    * ``prepare_fn(config, params, dtype)``: the weights ``apply_fn`` reads
      for inputs of ``dtype``, built once per dtype and kept.
    """

    def __init__(
        self,
        arch_id: str,
        config: Any,
        params: Mapping[str, torch.Tensor],
        metadata: ModelMetadata,
        apply_fn: Callable[[Any, Any, torch.Tensor], torch.Tensor],
        prepare_fn: Callable[[Any, Mapping[str, torch.Tensor], torch.dtype], Any] | None = None,
    ):
        self.arch_id = arch_id
        self.config = config
        self.params = dict(params)
        self.parameters_info = metadata  # reference attribute name
        self.metadata = metadata
        # serving hints for tiled inference (parallel/tiling.py): an int,
        # or a {'f32': n, 'bf16': m} dict when the value depends on dtype
        self.tile_batch: int | dict | None = None
        self.serving_tile: int | dict | None = None
        self.serving_halo: int | dict | None = None
        # the model pads (H, W) internally up to multiples of this; None =
        # no internal spatial padding (plain conv archs)
        self.size_multiple: int | None = None
        self._apply_fn = apply_fn
        self._prepare_fn = prepare_fn
        self._by_dtype: dict[torch.dtype, Any] = {}

    @property
    def upscale(self) -> int | Sequence[int]:
        return self.metadata.upscale

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device if self.params else torch.device('cpu')

    def with_config(self, **overrides) -> 'SRModel':
        """New SRModel sharing these params with config fields replaced."""
        cfg = dataclasses.replace(self.config, **overrides)
        meta = self.metadata
        if 'eval_scale' in overrides:
            meta = dataclasses.replace(meta, upscale=int(overrides['eval_scale']))
        return self._copy_hints(SRModel(self.arch_id, cfg, self.params, meta, self._apply_fn, self._prepare_fn))

    def _copy_hints(self, clone: 'SRModel') -> 'SRModel':
        clone.tile_batch = self.tile_batch
        clone.serving_tile = self.serving_tile
        clone.serving_halo = self.serving_halo
        clone.size_multiple = self.size_multiple
        return clone

    def _prepared(self, params: Mapping[str, torch.Tensor], dtype: torch.dtype):
        """What ``apply_fn`` reads of ``params`` for inputs of ``dtype``."""
        return params if self._prepare_fn is None else self._prepare_fn(self.config, params, dtype)

    def quantize_int8(self) -> 'SRModel':
        """Opt-in int8 serving copy (``resselt_tpu_torch.quant``): eligible
        conv weights become per-channel int8 with a ``.weight_scale``, run
        by ``F.conv2d_int8`` with a dynamic activation quant.  Explicitly
        lossy; raises ValueError if nothing is eligible.

        Eligibility = shape (plain conv, cin/cout >= 32) AND consumption,
        as in the JAX package: a discovery run of ``prepare_fn`` and
        ``apply_fn`` on a 1 x 64 x 64 x C_in probe on the CPU records which
        weights flow only through int8-aware ops (``PTree.conv`` with groups
        1, a groups-1 conv that ``ops.conv_route`` prepared, esrgan's
        producer RDB).  It sees through ``prepare``: params reach it through
        ``nn.params.RecordingParams``, so a weight that ``prepare`` repacks,
        concatenates or slices (other than into such a conv), or that
        ``apply`` reads raw, stays float.  The copy keeps the serving hints
        and lives on this model's device."""
        from ..nn import params as params_mod
        from ..quant import quantize_params

        cpu = {k: v.detach().cpu() for k, v in self.params.items()}
        rec = {'safe': set(), 'raw': set()}
        probe = torch.zeros((1, 64, 64, self.metadata.in_channels))
        params_mod._INT8_DISCOVERY = rec
        try:
            with torch.no_grad():
                weights = self._prepared(params_mod.RecordingParams(cpu), torch.float32)
                self._apply_fn(self.config, params_mod.RecordingParams(params_mod.quiet(weights)), probe)
        finally:
            params_mod._INT8_DISCOVERY = None
        q, n = quantize_params({k: v.numpy() for k, v in cpu.items()}, allowed=rec['safe'] - rec['raw'])
        if n == 0:
            raise ValueError(f'{self.arch_id}: no int8-eligible conv weights')
        clone = SRModel(self.arch_id, self.config, params_from_numpy(q, self.device), self.metadata,
                        self._apply_fn, self._prepare_fn)
        return self._copy_hints(clone)

    def cost(self, height: int, width: int, batch: int = 1) -> dict:
        """Cost of one forward at ``(batch, height, width, C_in)``, the JAX
        package's ``SRModel.cost`` keys.

        ``flops``: ``torch.utils.flop_counter``'s count over the plain path,
        run on the CPU in f32 (the hand-written kernels are ctypes calls,
        invisible to it; their plain versions are torch ops it counts).
        ``params``: the number of parameter elements.  ``bytes_accessed``:
        -1.0, as JAX returns when XLA reports none: the flop counter counts
        no bytes, and eager PyTorch has no compiled program to analyse."""
        from torch.utils.flop_counter import FlopCounterMode

        x = torch.zeros((batch, height, width, self.metadata.in_channels))
        with torch.no_grad():
            weights = self._prepared({k: v.detach().cpu() for k, v in self.params.items()}, torch.float32)
            with FlopCounterMode(display=False) as counter:
                self._apply_fn(self.config, weights, x)
        return {
            'flops': float(counter.get_total_flops()),
            'bytes_accessed': -1.0,
            'params': int(sum(v.numel() for v in self.params.values())),
        }

    def weights(self, dtype: torch.dtype):
        """What ``apply_fn`` reads for inputs of ``dtype`` (built once)."""
        w = self._by_dtype.get(dtype)
        if w is None:
            w = self._by_dtype[dtype] = self._prepared(self.params, dtype)
        return w

    def apply(self, params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """Forward with the given params (prepared on every call)."""
        weights = self._prepared(params, x.dtype)
        with torch.no_grad():
            return self._apply_fn(self.config, weights, x.contiguous())

    def __call__(self, x, dtype=None, precision: str | None = None) -> torch.Tensor:
        """Run the model on an NHWC (or HWC) image batch, a numpy array or a
        tensor; it is moved to the model's device.

        Float inputs are expected in [0, 1]; uint8 images are converted
        automatically.  ``dtype`` is the compute dtype: float32, bfloat16
        or float16, on either device.  ``precision`` (for f32 inputs to the
        plain torch ops): None or 'default' keeps torch's settings,
        'highest' / 'float32' turns TF32 off, 'tensorfloat32' / 'high' on,
        'bfloat16' also lets f32 matmuls run as bf16 passes; any other name
        raises ValueError (:func:`_precision`).  The hand-written f32
        kernels are exact FMA whatever it says."""
        x = torch.as_tensor(x).to(self.device)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        dtype = as_torch_dtype(dtype)
        if dtype is not None:
            x = x.to(dtype)
        elif x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            x = x.float()
        with torch.no_grad():
            weights = self.weights(x.dtype)  # built outside ``precision``: a kept weight does not depend on it
            with _precision(precision):
                y = self._apply_fn(self.config, weights, x.contiguous())
        return y[0] if squeeze else y


@dataclass
class Architecture:
    """Detection + loading adapter for one architecture family."""

    id: str
    detect_condition: KeyCondition = field(repr=False)
    load_fn: Callable[[Mapping[str, np.ndarray], Any], SRModel] = field(repr=False)

    def detect(self, state_dict: Mapping[str, Any]) -> bool:
        return self.detect_condition(state_dict)

    def load(self, state_dict: Mapping[str, Any], device='cuda') -> SRModel:
        return self.load_fn(state_dict, device)
