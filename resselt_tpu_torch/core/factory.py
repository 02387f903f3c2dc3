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


@contextlib.contextmanager
def _precision(precision: str | None):
    """``SRModel.__call__``'s ``precision``: None keeps torch's defaults,
    'highest' turns TF32 off for cuDNN and matmul, 'tensorfloat32' on."""
    if precision is None:
        yield
        return
    if precision not in ('highest', 'tensorfloat32'):
        raise ValueError(f"precision must be None, 'highest' or 'tensorfloat32', got {precision!r}")
    allow = precision == 'tensorfloat32'
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


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
        self._prepared: dict[torch.dtype, Any] = {}

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
        clone = SRModel(self.arch_id, cfg, self.params, meta, self._apply_fn, self._prepare_fn)
        clone.tile_batch = self.tile_batch
        clone.serving_tile = self.serving_tile
        clone.serving_halo = self.serving_halo
        clone.size_multiple = self.size_multiple
        return clone

    def weights(self, dtype: torch.dtype):
        """What ``apply_fn`` reads for inputs of ``dtype`` (built once)."""
        if self._prepare_fn is None:
            return self.params
        w = self._prepared.get(dtype)
        if w is None:
            w = self._prepared[dtype] = self._prepare_fn(self.config, self.params, dtype)
        return w

    def apply(self, params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """Forward with the given params (prepared on every call)."""
        weights = params if self._prepare_fn is None else self._prepare_fn(self.config, params, x.dtype)
        with torch.no_grad():
            return self._apply_fn(self.config, weights, x.contiguous())

    def __call__(self, x, dtype=None, precision: str | None = None) -> torch.Tensor:
        """Run the model on an NHWC (or HWC) image batch, a numpy array or a
        tensor; it is moved to the model's device.

        Float inputs are expected in [0, 1]; uint8 images are converted
        automatically.  ``dtype`` is the compute dtype (float32 or
        bfloat16; float16 is refused by the CUDA kernels).  ``precision``:
        None keeps torch's defaults, 'highest' turns TF32 off for the plain
        torch ops, 'tensorfloat32' on; the 3x3 kernel is exact f32 FMA in
        float32 whatever it says."""
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
        with torch.no_grad(), _precision(precision):
            y = self._apply_fn(self.config, self.weights(x.dtype), x.contiguous())
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
