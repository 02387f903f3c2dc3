"""Minimal pure-numpy safetensors reader.

Format: ``<u8 header_len><header JSON><raw tensor data>``; each header entry
maps a tensor name to ``{dtype, shape, data_offsets: [begin, end)}`` relative
to the start of the data section.  Replaces the reference's dependency on
``safetensors.torch.load_file`` (resselt/registry.py:97-100).
"""

from __future__ import annotations

import json
import struct

import numpy as np

try:
    import ml_dtypes

    _BF16 = np.dtype(ml_dtypes.bfloat16)
    _F8_E4M3 = np.dtype(ml_dtypes.float8_e4m3fn)
    _F8_E5M2 = np.dtype(ml_dtypes.float8_e5m2)
except Exception:  # pragma: no cover
    _BF16 = _F8_E4M3 = _F8_E5M2 = None

_DTYPES: dict[str, np.dtype] = {
    'F64': np.dtype('<f8'),
    'F32': np.dtype('<f4'),
    'F16': np.dtype('<f2'),
    'I64': np.dtype('<i8'),
    'I32': np.dtype('<i4'),
    'I16': np.dtype('<i2'),
    'I8': np.dtype('i1'),
    'U8': np.dtype('u1'),
    'BOOL': np.dtype('?'),
}
if _BF16 is not None:
    _DTYPES['BF16'] = _BF16
    _DTYPES['F8_E4M3'] = _F8_E4M3
    _DTYPES['F8_E5M2'] = _F8_E5M2


def write_safetensors(state_dict, path: str, metadata: dict | None = None) -> None:
    """Write a state dict of numpy arrays (or CPU tensors) as a .safetensors file.

    The file is readable by torch's safetensors reader and by this
    package's own loader, since every key is kept as given."""
    names = {v: k for k, v in _DTYPES.items()}
    header: dict = {}
    blobs: list[bytes] = []
    offset = 0
    for key, value in state_dict.items():
        arr = np.ascontiguousarray(np.asarray(value))
        if arr.dtype.byteorder == '>':
            arr = arr.astype(arr.dtype.newbyteorder('<'))
        dt = names.get(arr.dtype)
        if dt is None:
            # normalize unsupported dtypes (e.g. int bool variants) to f32
            arr = arr.astype(np.float32)
            dt = 'F32'
        blob = arr.tobytes()
        header[key] = {'dtype': dt, 'shape': list(arr.shape), 'data_offsets': [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    if metadata:
        header['__metadata__'] = {str(k): str(v) for k, v in metadata.items()}
    hj = json.dumps(header).encode()
    pad = (-len(hj)) % 8
    hj += b' ' * pad
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(hj)))
        f.write(hj)
        for blob in blobs:
            f.write(blob)


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    with open(path, 'rb') as f:
        (header_len,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(header_len))
        data = f.read()

    out: dict[str, np.ndarray] = {}
    for name, spec in header.items():
        if name == '__metadata__':
            continue
        dtype = _DTYPES[spec['dtype']]
        begin, end = spec['data_offsets']
        arr = np.frombuffer(data[begin:end], dtype=dtype)
        out[name] = arr.reshape(spec['shape'])
    return out
