"""The port's checkpoint readers (resselt_tpu_torch.io) against
resselt_tpu.io on the inputs of test_core.py and test_io_fuzz.py: arrays
must be identical (same dtype, same bits), and unsafe, truncated or corrupt
files refused with the same exception class."""

import collections
import io
import os
import pickle
import struct
import zipfile

import numpy as np
import pytest
import torch

import resselt_tpu.io as jio
import resselt_tpu_torch.io as tio
from resselt_tpu.core import KeyCondition as JKeyCondition, canonicalize_state_dict as jcanon, get_seq_len as jseq
from resselt_tpu_torch.core import KeyCondition as TKeyCondition, canonicalize_state_dict as tcanon, get_seq_len as tseq


torch.set_num_threads(2)


def _assert_same_tree(a, b):
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict))
    if isinstance(a, dict):
        assert list(a.keys()) == list(b.keys())
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        assert a == b


def _both(fn_name, path):
    """(jax result or exception, port result or exception)."""
    out = []
    for mod in (jio, tio):
        try:
            out.append(getattr(mod, fn_name)(str(path)))
        except Exception as e:  # noqa: BLE001 - the exception class is what is compared
            out.append(e)
    return out


def _assert_same_outcome(path, fn_name='load_state_dict_from_file'):
    a, b = _both(fn_name, path)
    if isinstance(a, Exception) or isinstance(b, Exception):
        assert type(a).__name__ == type(b).__name__, (a, b)
        return None
    _assert_same_tree(a, b)
    return b


_TENSORS = {
    'w': torch.randn(4, 3, 3, 3, generator=torch.Generator().manual_seed(0)),
    'h': torch.randn(5, generator=torch.Generator().manual_seed(1)).half(),
    'bf': torch.randn(5, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16),
    'u8': torch.tensor([1, 2, 3], dtype=torch.uint8),
    'i64': torch.tensor(7),
}


@pytest.mark.parametrize('kwargs', [{}, {'_use_new_zipfile_serialization': False}], ids=['zip', 'legacy'])
def test_read_torch_checkpoint_identical(tmp_path, kwargs):
    p = tmp_path / 'm.pth'
    torch.save(_TENSORS, p, **kwargs)
    out = _assert_same_outcome(p, 'read_torch_checkpoint')
    assert set(out) == set(_TENSORS)
    np.testing.assert_array_equal(out['w'], _TENSORS['w'].numpy())


def _legacy_views_file(path, view):
    class _Stor:
        def __init__(self, pid):
            self.pid = pid

    class _T:
        def __init__(self, stor, numel):
            self.stor, self.numel = stor, numel

        def __reduce__(self):
            return (torch._utils._rebuild_tensor_v2, (self.stor, 0, (self.numel,), (1,), False, None))

    class _P(pickle.Pickler):
        def persistent_id(self, obj):
            return obj.pid if isinstance(obj, _Stor) else None

    root_pid = ('storage', torch.FloatStorage, 'root', 'cpu', 8)
    view_pid = ('storage', torch.FloatStorage, 'root', 'cpu', 8, view)
    obj = {'full': _T(_Stor(root_pid), 8), 'tail': _T(_Stor(view_pid), 4), 'tail2': _T(_Stor(view_pid), 4)}
    with open(path, 'wb') as f:
        for meta in (0x1950A86A20F9469CFC6C, 1001, {'little_endian': True}):
            pickle.dump(meta, f, protocol=2)
        _P(f, protocol=2).dump(obj)
        pickle.dump(['root'], f, protocol=2)
        f.write(struct.pack('<q', 8))
        f.write(np.arange(8, dtype=np.float32).tobytes())


@pytest.mark.parametrize('view', [('v0', 4, 4), ('v1', 6, 4)], ids=['in_bounds', 'out_of_bounds'])
def test_legacy_storage_views(tmp_path, view):
    p = tmp_path / 'views.pth'
    _legacy_views_file(p, view)
    out = _assert_same_outcome(p, 'read_torch_checkpoint')
    if view[1] == 4:
        np.testing.assert_array_equal(out['tail'], np.asarray([4, 5, 6, 7], np.float32))
    else:
        with pytest.raises(tio.UnsafeCheckpointError):
            tio.read_torch_checkpoint(str(p))


def test_safetensors_identical(tmp_path):
    import safetensors.torch

    sd = {'a': torch.randn(3, 4), 'b': torch.randn(2).half(), 'c': torch.randn(2).to(torch.bfloat16)}
    p = tmp_path / 'm.safetensors'
    safetensors.torch.save_file(sd, str(p))
    _assert_same_outcome(p)


def test_write_safetensors_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    sd = {'w': rng.standard_normal((4, 3, 3, 3)).astype(np.float32), 'i': np.arange(5, dtype=np.int64),
          'h': rng.standard_normal(3).astype(np.float16)}
    pt, pj = tmp_path / 'port.safetensors', tmp_path / 'jax.safetensors'
    tio.write_safetensors(sd, str(pt), metadata={'k': 1})
    jio.write_safetensors(sd, str(pj), metadata={'k': 1})
    assert pt.read_bytes() == pj.read_bytes()
    _assert_same_tree(tio.read_safetensors(str(pj)), jio.read_safetensors(str(pt)))


def test_write_safetensors_keeps_0d_shape(tmp_path):
    """A 0-d array (BatchNorm's num_batches_tracked) stays 0-d, as torch's
    safetensors writer keeps it."""
    import safetensors.torch

    sd = {'n': np.zeros((), np.int64), 'w': np.ones((2, 3), np.float32)}
    p = tmp_path / 'm.safetensors'
    tio.write_safetensors(sd, str(p))
    back = tio.read_safetensors(str(p))
    assert back['n'].shape == () and back['w'].shape == (2, 3)
    assert safetensors.torch.load_file(str(p))['n'].shape == ()


def test_evil_pickle_rejected(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ('true',))

    p = tmp_path / 'evil.pth'
    with open(p, 'wb') as f:
        pickle.dump({'x': Evil()}, f)
    a, b = _both('read_torch_checkpoint', p)
    assert isinstance(b, tio.UnsafeCheckpointError)
    assert type(a).__name__ == type(b).__name__


def _evil_view_checkpoint(path, offset, size, stride, numel=4):
    store = object()

    class _P(pickle.Pickler):
        def persistent_id(self, obj):
            return ('storage', torch.FloatStorage, '0', 'cpu', numel) if obj is store else None

    class _EvilTensor:
        def __reduce__(self):
            return (torch._utils._rebuild_tensor_v2, (store, offset, size, stride, False, collections.OrderedDict()))

    buf = io.BytesIO()
    _P(buf, protocol=2).dump({'w': _EvilTensor()})
    with zipfile.ZipFile(path, 'w') as zf:
        zf.writestr('archive/data.pkl', buf.getvalue())
        zf.writestr('archive/data/0', b'\x00\x00\x80?' * numel)


@pytest.mark.parametrize('offset,size,stride', [
    (0, (100000,), (1,)), (1, (2,), (-1,)), (-4, (1,), (1,)), (0, (2, 2), (4, 1)), (4, (), ()), (1, (3,), (1,)),
])
def test_view_geometry(tmp_path, offset, size, stride):
    p = tmp_path / 'v.pth'
    _evil_view_checkpoint(str(p), offset, size, stride)
    out = _assert_same_outcome(p, 'read_torch_checkpoint')
    if offset == 1 and size == (3,):
        assert out['w'].shape == (3,)


def _make_zip_pth(path):
    torch.save({'w': torch.randn(4, 3, generator=torch.Generator().manual_seed(3)),
                'b': torch.randn(4, generator=torch.Generator().manual_seed(4))}, str(path))


def _make_legacy_pth(path):
    torch.save({'w': torch.randn(4, 3, generator=torch.Generator().manual_seed(5))}, str(path),
               _use_new_zipfile_serialization=False)


def _make_safetensors(path):
    import safetensors.torch

    safetensors.torch.save_file({'w': torch.randn(4, 3, generator=torch.Generator().manual_seed(6))}, str(path))


MAKERS = {'zip.pth': _make_zip_pth, 'legacy.pth': _make_legacy_pth, 's.safetensors': _make_safetensors}


@pytest.mark.parametrize('fname', list(MAKERS))
@pytest.mark.parametrize('frac', [0.05, 0.3, 0.6, 0.9, 0.99])
def test_truncated_checkpoint_same_refusal(tmp_path, fname, frac):
    p = tmp_path / fname
    MAKERS[fname](p)
    data = p.read_bytes()
    cut = tmp_path / ('cut_' + fname)
    cut.write_bytes(data[: max(1, int(len(data) * frac))])
    a, b = _both('load_state_dict_from_file', cut)
    assert isinstance(b, Exception)
    assert type(a).__name__ == type(b).__name__


@pytest.mark.parametrize('fname', list(MAKERS))
@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_corrupted_checkpoint_same_outcome(tmp_path, fname, seed):
    p = tmp_path / fname
    MAKERS[fname](p)
    data = bytearray(p.read_bytes())
    rng = np.random.default_rng(seed)
    pos = int(rng.integers(0, max(1, len(data) - 16)))
    for i in range(16):
        data[pos + i] ^= 0xFF
    bad = tmp_path / ('bad_' + fname)
    bad.write_bytes(bytes(data))
    _assert_same_outcome(bad)


def test_junk_pickle_member_rejected(tmp_path):
    p = tmp_path / 'junk.pth'
    with zipfile.ZipFile(p, 'w') as zf:
        zf.writestr('archive/data.pkl', b'\xff' * 1024)
        zf.writestr('archive/data/0', b'\x00' * 16)
    a, b = _both('load_state_dict_from_file', p)
    assert isinstance(b, Exception) and type(a).__name__ == type(b).__name__


def test_torchscript_pt(tmp_path):
    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 4, 3)

        def forward(self, x):
            return self.conv(x)

    m = Tiny().eval()
    p = tmp_path / 'model.pt'
    torch.jit.save(torch.jit.script(m), str(p))
    out = _assert_same_outcome(p)
    np.testing.assert_array_equal(out['conv.weight'], m.conv.weight.detach().numpy())
    p2 = tmp_path / 'plain.pt'
    torch.save(m.state_dict(), str(p2))
    _assert_same_outcome(p2)


def test_unknown_extension(tmp_path):
    p = tmp_path / 'm.onnx'
    p.write_bytes(b'x')
    a, b = _both('load_state_dict_from_file', p)
    assert isinstance(a, ValueError) and isinstance(b, ValueError)


@pytest.mark.parametrize('sd', [
    {'params_ema': {'module.a': 1, 'module.b': 2}},
    {'state_dict': {'netG.x': 1}},
    {'model': {'a.0.w': 1}, 'extra': 2},
    {'module.a': 1, 'b': 2},
    {},
])
def test_canonicalize_identical(sd):
    assert dict(tcanon(sd)) == dict(jcanon(sd))


def test_seq_len_and_key_condition():
    sd = {'model.0.weight': 0, 'model.3.weight': 0, 'model.10.bias': 0, 'model.x.y': 0, 'other.1': 0}
    for key in ('model', 'other', 'missing', 'model.0'):
        assert tseq(sd, key) == jseq(sd, key)
    for make in (lambda K: K.has_all('model.0.weight', K.has_any('nope', 'other.1')),
                 lambda K: K.has_any('nope', K.has_all('model.3.weight', 'nope2'))):
        assert make(TKeyCondition)(sd) == make(JKeyCondition)(sd)
