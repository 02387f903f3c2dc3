"""Pure-Python reader for PyTorch checkpoint files.

Reads ``.pth`` / ``.ckpt`` / ``.pt`` files into plain numpy arrays without
importing torch.  Security model mirrors the reference's restricted
unpickler (reference: resselt/registry.py:20-46): only data-bearing
globals are allowed; any callable global outside the allow-list raises.

Supports both on-disk formats produced by ``torch.save``:

* the modern zipfile container (``archive/data.pkl`` + raw storage blobs
  under ``archive/data/<key>``), and
* the legacy streaming format (magic-number pickle, protocol pickle,
  sys-info pickle, object pickle with persistent ids, storage-key list,
  then raw storages each prefixed by an int64 element count).
"""

from __future__ import annotations

import io
import pickle
import struct
import zipfile
from typing import Any, BinaryIO, Callable

import numpy as np

try:  # bfloat16 via ml_dtypes, where it is installed
    import ml_dtypes

    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
except Exception:  # pragma: no cover
    _BFLOAT16 = None


class UnsafeCheckpointError(pickle.UnpicklingError):
    pass


# Storage-type name -> numpy dtype. Data-only analogue of the reference
# allow-list (resselt/registry.py:20-30) plus storage types the reference
# forgot but its own archs need (uint8 MetaUpsample buffers, bool markers).
_STORAGE_DTYPES: dict[str, np.dtype] = {
    'FloatStorage': np.dtype('<f4'),
    'DoubleStorage': np.dtype('<f8'),
    'HalfStorage': np.dtype('<f2'),
    'LongStorage': np.dtype('<i8'),
    'IntStorage': np.dtype('<i4'),
    'ShortStorage': np.dtype('<i2'),
    'CharStorage': np.dtype('<i1'),
    'ByteStorage': np.dtype('<u1'),
    'BoolStorage': np.dtype('?'),
    'ComplexFloatStorage': np.dtype('<c8'),
    'ComplexDoubleStorage': np.dtype('<c16'),
}
if _BFLOAT16 is not None:
    _STORAGE_DTYPES['BFloat16Storage'] = _BFLOAT16


class _StorageType:
    """Sentinel returned by find_class for ``torch.XStorage`` globals."""

    __slots__ = ('dtype',)

    def __init__(self, dtype: np.dtype):
        self.dtype = dtype


class _Storage:
    """A (possibly not-yet-filled) flat storage buffer.

    May be a *view* of another storage (legacy-format persistent ids carry
    ``view_metadata = (view_key, offset, numel)``; torch's ``_legacy_load``
    materializes them as ``root[offset:offset+numel]``)."""

    __slots__ = ('data', 'dtype', 'base', 'base_offset', 'base_numel')

    def __init__(self, dtype: np.dtype, data: np.ndarray | None = None,
                 base: '_Storage | None' = None, base_offset: int = 0, base_numel: int = 0):
        self.dtype = dtype
        self.data = data
        self.base = base
        self.base_offset = base_offset
        self.base_numel = base_numel

    def resolve(self) -> np.ndarray | None:
        """Flat buffer, or None if the backing data has not been read yet."""
        if self.base is None:
            return self.data
        buf = self.base.resolve()
        if buf is None:
            return None
        if self.base_offset + self.base_numel > buf.size:
            raise UnsafeCheckpointError(
                f'Storage view [{self.base_offset}:{self.base_offset + self.base_numel}] '
                f'outside base storage of {buf.size} elements'
            )
        return buf[self.base_offset: self.base_offset + self.base_numel]


class _LazyTensor:
    """Tensor view over a storage that may be filled in later (legacy fmt)."""

    __slots__ = ('storage', 'offset', 'size', 'stride')

    def __init__(self, storage: _Storage, offset: int, size, stride):
        self.storage = storage
        self.offset = offset
        self.size = tuple(size)
        self.stride = tuple(stride)

    def materialize(self) -> np.ndarray:
        buf = self.storage.resolve()
        if buf is None:
            raise ValueError('Storage data never deserialized')
        dtype = self.storage.dtype
        # Checkpoint-controlled view geometry must stay inside the storage
        # buffer (torch's loader enforces the same invariant); otherwise
        # as_strided would read adjacent process memory.
        if self.offset < 0 or any(st < 0 for st in self.stride) or any(s < 0 for s in self.size):
            raise UnsafeCheckpointError(
                f'Tensor view with negative offset/size/stride: '
                f'offset={self.offset} size={self.size} stride={self.stride}'
            )
        if len(self.size) == 0:
            if self.offset >= buf.size:
                raise UnsafeCheckpointError(f'Scalar offset {self.offset} outside storage of {buf.size} elements')
            return buf[self.offset].copy().reshape(())
        if any(s == 0 for s in self.size):
            return np.empty(self.size, dtype=dtype)
        needed = self.offset + 1 + sum((s - 1) * st for s, st in zip(self.size, self.stride))
        if needed > buf.size:
            raise UnsafeCheckpointError(
                f'Tensor view needs {needed} elements but storage holds {buf.size} '
                f'(offset={self.offset} size={self.size} stride={self.stride})'
            )
        strides = tuple(s * dtype.itemsize for s in self.stride)
        view = np.lib.stride_tricks.as_strided(buf[self.offset :], shape=self.size, strides=strides)
        return np.ascontiguousarray(view)


def _rebuild_tensor_v2(storage, storage_offset, size, stride, requires_grad=False, backward_hooks=None, metadata=None):
    lazy = _LazyTensor(storage, storage_offset, size, stride)
    return lazy if storage.resolve() is None else lazy.materialize()


def _rebuild_tensor(storage, storage_offset, size, stride):
    return _rebuild_tensor_v2(storage, storage_offset, size, stride)


def _rebuild_parameter(data, requires_grad=False, backward_hooks=None):
    return data


class _StateDict(dict):
    """OrderedDict stand-in tolerating pickle BUILD state (``_metadata``)."""

    def __setstate__(self, state):
        pass


_SAFE_GLOBALS: dict[tuple[str, str], Any] = {
    ('collections', 'OrderedDict'): _StateDict,
    ('typing', 'OrderedDict'): _StateDict,
    ('torch._utils', '_rebuild_tensor_v2'): _rebuild_tensor_v2,
    ('torch._utils', '_rebuild_tensor'): _rebuild_tensor,
    ('torch._utils', '_rebuild_parameter'): _rebuild_parameter,
    ('torch.serialization', '_get_layout'): lambda name: name,
    ('torch', 'Size'): tuple,
}


class _ScriptObject:
    """Attribute bag standing in for a ``__torch__.*`` class in a
    TorchScript archive's data.pkl: pickle NEWOBJ creates it and BUILD
    fills ``__dict__`` — no TorchScript code is ever loaded or run."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):  # plain attribute state (the normal case)
            self.__dict__.update(state)
            return
        # objects using the __getstate__ protocol (e.g. quantized modules)
        # carry opaque state tuples; record them so the walker can reject
        # the archive and the caller can fall back to the torch runtime
        self.__dict__['_opaque_state'] = state


def _build_list(data):
    return list(data)


def _reject_tensor_from_id(data):
    raise ValueError(
        'TorchScript archive references tensors by constants-table id '
        '(torch.jit._pickle.build_tensor_from_id), which the pure reader '
        'does not resolve'
    )


_SCRIPT_GLOBALS: dict[tuple[str, str], Any] = {
    ('torch.jit._pickle', 'build_intlist'): _build_list,
    ('torch.jit._pickle', 'build_doublelist'): _build_list,
    ('torch.jit._pickle', 'build_boollist'): _build_list,
    ('torch.jit._pickle', 'build_strlist'): _build_list,
    ('torch.jit._pickle', 'build_tensorlist'): _build_list,
    # Tensors referenced by id live in the constants table, which this
    # reader does not resolve — returning a placeholder would silently drop
    # parameters from the state dict, so reject and let io/__init__ fall
    # back to torch.jit.load when available.
    ('torch.jit._pickle', 'build_tensor_from_id'): _reject_tensor_from_id,
    ('torch.jit._pickle', 'restore_type_tag'): lambda value, type_str: value,
}


class _Unpickler(pickle.Unpickler):
    """Restricted unpickler resolving torch globals to numpy constructors."""

    def __init__(self, file: BinaryIO, load_storage: Callable[[str, np.dtype, int], _Storage] | None = None,
                 allow_script: bool = False):
        super().__init__(file, encoding='latin1')
        self._load_storage = load_storage
        self._allow_script = allow_script
        self._views: dict[str, _Storage] = {}

    def find_class(self, module: str, name: str):
        if (module, name) in _SAFE_GLOBALS:
            return _SAFE_GLOBALS[(module, name)]
        if module == 'torch' and name in _STORAGE_DTYPES:
            return _StorageType(_STORAGE_DTYPES[name])
        if self._allow_script:
            if module.startswith('__torch__'):
                return _ScriptObject
            if (module, name) in _SCRIPT_GLOBALS:
                return _SCRIPT_GLOBALS[(module, name)]
        raise UnsafeCheckpointError(f"Global '{module}.{name}' is forbidden in checkpoints")

    def persistent_load(self, pid):
        # ('storage', storage_type, key, location, numel[, view_metadata])
        if not (isinstance(pid, tuple) and len(pid) in (5, 6) and pid[0] == 'storage'):
            raise UnsafeCheckpointError(f'Unsupported persistent id: {pid!r}')
        _, storage_type, key, _location, numel = pid[:5]
        if not isinstance(storage_type, _StorageType):
            raise UnsafeCheckpointError(f'Unsupported storage type: {storage_type!r}')
        if self._load_storage is None:
            raise UnsafeCheckpointError('Unexpected persistent id in metadata pickle')
        root = self._load_storage(str(key), storage_type.dtype, int(numel))
        view = pid[5] if len(pid) == 6 else None
        if view is None:
            return root
        # legacy-format storage view: torch's _legacy_load materializes it
        # as root[offset:offset+numel] (shared/tied weights in pre-1.6
        # checkpoints); ignoring it would silently read the wrong region
        if not (isinstance(view, tuple) and len(view) == 3):
            raise UnsafeCheckpointError(f'Unsupported view metadata: {view!r}')
        view_key, offset, view_numel = view
        vk = str(view_key)
        if vk not in self._views:
            offset, view_numel = int(offset), int(view_numel)
            if offset < 0 or view_numel < 0:
                raise UnsafeCheckpointError(
                    f'Storage view with negative offset/numel: {view!r}')
            self._views[vk] = _Storage(storage_type.dtype, base=root,
                                       base_offset=offset, base_numel=view_numel)
        return self._views[vk]


def _materialize(obj):
    if isinstance(obj, _LazyTensor):
        return obj.materialize()
    if isinstance(obj, dict):
        return {k: _materialize(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, (list, tuple)):
        vals = [_materialize(v) for v in obj]
        return vals if isinstance(obj, list) else tuple(vals)
    return obj


def _read_zip(zf: zipfile.ZipFile) -> Any:
    prefix = None
    for name in zf.namelist():
        if name.endswith('data.pkl'):
            prefix = name[: -len('data.pkl')]
            break
    if prefix is None:
        raise ValueError('Not a torch zip checkpoint: no data.pkl member')

    cache: dict[str, _Storage] = {}

    def load_storage(key: str, dtype: np.dtype, numel: int) -> _Storage:
        if key not in cache:
            raw = zf.read(f'{prefix}data/{key}')
            cache[key] = _Storage(dtype, np.frombuffer(raw, dtype=dtype))
        return cache[key]

    with zf.open(prefix + 'data.pkl') as f:
        obj = _Unpickler(io.BytesIO(f.read()), load_storage).load()
    return _materialize(obj)


def read_torchscript_state_dict(path: str) -> dict[str, np.ndarray]:
    """Extract the state dict from a TorchScript archive WITHOUT the torch
    runtime.

    data.pkl pickles the script module as a tree of ``__torch__.*`` objects
    whose tensor-valued attributes are exactly the parameters and buffers
    (torch's ``Module.state_dict()`` view); tensors use the same
    ``_rebuild_tensor_v2`` + persistent-id scheme as eager zip checkpoints.
    The restricted unpickler maps every ``__torch__.*`` class to an inert
    attribute bag — the archive's compiled code is never touched.  Raises
    ``UnsafeCheckpointError`` on objects with opaque ``__getstate__`` state
    (e.g. quantized modules), where the attribute view is not the state
    dict."""
    with zipfile.ZipFile(path) as zf:
        prefix = None
        for name in zf.namelist():
            if name.endswith('data.pkl'):
                prefix = name[: -len('data.pkl')]
                break
        if prefix is None:
            raise ValueError('Not a TorchScript archive: no data.pkl member')

        cache: dict[str, _Storage] = {}

        def load_storage(key: str, dtype: np.dtype, numel: int) -> _Storage:
            if key not in cache:
                raw = zf.read(f'{prefix}data/{key}')
                cache[key] = _Storage(dtype, np.frombuffer(raw, dtype=dtype))
            return cache[key]

        with zf.open(prefix + 'data.pkl') as f:
            root = _Unpickler(io.BytesIO(f.read()), load_storage, allow_script=True).load()

    out: dict[str, np.ndarray] = {}

    def walk(node, pfx: str):
        attrs = getattr(node, '__dict__', {})
        if '_opaque_state' in attrs:
            raise UnsafeCheckpointError(
                'TorchScript archive contains objects with opaque __getstate__ '
                'state; use the torch runtime to load it'
            )
        for k, v in attrs.items():
            _visit(v, pfx + k)

    def _visit(v, name: str):
        if isinstance(v, (_LazyTensor, np.ndarray)):
            out[name] = v
        elif isinstance(v, _ScriptObject):
            walk(v, name + '.')
        elif isinstance(v, (list, tuple)):
            # containers of tensors/submodules (e.g. build_tensorlist
            # results) use state-dict-style numeric suffixes
            for i, item in enumerate(v):
                _visit(item, f'{name}.{i}')
        elif isinstance(v, dict):
            for dk, item in v.items():
                _visit(item, f'{name}.{dk}')

    if not isinstance(root, _ScriptObject):
        raise ValueError('TorchScript archive does not contain a script module')
    walk(root, '')
    return _materialize(out)


_LEGACY_MAGIC = 0x1950A86A20F9469CFC6C


def _read_legacy(f: BinaryIO) -> Any:
    def plain(b):
        return _Unpickler(b).load()

    magic = plain(f)
    if magic != _LEGACY_MAGIC:
        raise ValueError('Invalid legacy torch checkpoint magic number')
    plain(f)  # protocol version
    plain(f)  # sys info

    storages: dict[str, _Storage] = {}

    def load_storage(key: str, dtype: np.dtype, numel: int) -> _Storage:
        return storages.setdefault(key, _Storage(dtype))

    result = _Unpickler(f, load_storage).load()

    keys = plain(f)
    for key in keys:
        st = storages[key]
        (numel,) = struct.unpack('<q', f.read(8))
        raw = f.read(numel * st.dtype.itemsize)
        st.data = np.frombuffer(raw, dtype=st.dtype)

    return _materialize(result)


def read_torch_checkpoint(path: str) -> Any:
    """Read a ``torch.save`` file into numpy-valued python objects."""
    with open(path, 'rb') as f:
        head = f.read(4)
        f.seek(0)
        if head[:4] == b'PK\x03\x04':
            with zipfile.ZipFile(f) as zf:
                return _read_zip(zf)
        return _read_legacy(f)
