"""The port's cache, tools and CLI flags against resselt_tpu on the CPU:
``cache.save_model`` / ``load_model`` (hints kept, outputs equal, int8
round-tripping, a cache the JAX package wrote read within the family
test's TOL, a header naming a foreign module refused), ``convert`` to
``.npz`` and ``.safetensors``, ``inspect --json`` against JAX's fields,
``metrics`` within 1e-5 of JAX's, ``SRModel.cost``, and the CLI against
the JAX CLI's PNGs (within 1 LSB) on an ``.npz`` model, with ``--int8``,
on a directory, with ``--trace`` and with the three ``--no-*`` flags."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import resselt_tpu
import resselt_tpu_torch
from resselt_tpu import cache as jcache, convert as jconvert, inspect as jinspect, metrics as jmetrics
from resselt_tpu.upscale import main as jax_main
from resselt_tpu_torch import cache, convert, inspect as tinspect, metrics
from resselt_tpu_torch.io import write_safetensors
from resselt_tpu_torch.nn.window import fused_attention_enabled
from resselt_tpu_torch.ops.fused_conv import fused_lk_enabled
from resselt_tpu_torch.upscale import main as port_main
from resselt_tpu_torch.zoo import make_compact, make_esrgan, make_plksr, make_swinir


torch.set_num_threads(2)

_FAMILIES = {  # state dict, the family test's TOL
    'esrgan': (lambda: make_esrgan(16, 1, 2, gc=8, seed=41), 5e-4),
    'swinir': (lambda: make_swinir(24, (2,), (3,), 8, upscale=2, img_size=32, seed=42), 2e-3),
    'plksr': (lambda: make_plksr(16, 2, 2, kernel_size=9, split_ratio=0.5, seed=43), 5e-4),
}


def _x(h=24, w=28, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('family', sorted(_FAMILIES))
def test_cache_round_trip(tmp_path, family):
    tm = resselt_tpu_torch.load_from_state_dict(_FAMILIES[family][0](), device='cpu')
    path = str(tmp_path / 'm.npz')
    resselt_tpu_torch.save_model(tm, path)
    lm = resselt_tpu_torch.load_model(path, device='cpu')
    assert (lm.arch_id, lm.config, lm.metadata) == (tm.arch_id, tm.config, tm.metadata)
    hints = ('tile_batch', 'serving_tile', 'serving_halo', 'size_multiple')
    assert [getattr(lm, h) for h in hints] == [getattr(tm, h) for h in hints]
    assert set(lm.params) == set(tm.params) and all(torch.equal(lm.params[k], tm.params[k]) for k in tm.params)
    assert torch.equal(lm(_x()), tm(_x()))


def test_cache_keeps_int8_weights(tmp_path):
    qm = resselt_tpu_torch.load_from_state_dict(make_compact(32, 2, 2), device='cpu').quantize_int8()
    path = str(tmp_path / 'q.npz')
    cache.save_model(qm, path)
    lm = cache.load_model(path, device='cpu')
    int8 = {k for k, v in lm.params.items() if v.dtype == torch.int8}
    assert int8 == {k for k, v in qm.params.items() if v.dtype == torch.int8} != set()
    assert all(lm.params[k + '_scale'].dtype == torch.float32 for k in int8)
    assert torch.equal(lm(_x()), qm(_x()))


@pytest.mark.parametrize('family', sorted(_FAMILIES))
def test_reads_a_cache_the_jax_package_wrote(tmp_path, family):
    sd, tol = _FAMILIES[family][0](), _FAMILIES[family][1]
    jm = resselt_tpu.load_from_state_dict(sd)
    path = str(tmp_path / 'j.npz')
    jcache.save_model(jm, path)
    lm = cache.load_model(path, device='cpu')
    assert type(lm.config).__module__.startswith('resselt_tpu_torch.archs.')
    assert (lm.serving_halo, lm.serving_tile, lm.tile_batch) == (jm.serving_halo, jm.serving_tile, jm.tile_batch)
    want = np.asarray(jm(_x()))
    assert float(np.abs(lm(_x()).numpy() - want).max()) < tol


@pytest.mark.parametrize('module', ['os', 'resselt_tpu.nn.functional', 'resselt_tpu_torch.nn.functional', 7])
def test_cache_refuses_a_foreign_module(tmp_path, module):
    tm = resselt_tpu_torch.load_from_state_dict(make_compact(8, 1, 2), device='cpu')
    path = str(tmp_path / 'm.npz')
    cache.save_model(tm, path)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    header = json.loads(bytes(arrays['__header__']).decode())
    header['config_module'] = module
    arrays['__header__'] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match='non-architecture module'):
        cache.load_model(path, device='cpu')


def test_convert_to_both_formats(tmp_path):
    sd = make_esrgan(16, 1, 2, gc=8, seed=44)
    src = str(tmp_path / 'm.safetensors')
    write_safetensors(sd, src)
    npz, st = str(tmp_path / 'm.npz'), str(tmp_path / 'out.safetensors')
    assert convert.main([src, npz, '--device', 'cpu']) == 0
    assert convert.main([src, st, '--device', 'cpu']) == 0
    with pytest.raises(SystemExit):
        convert.main([src, str(tmp_path / 'm.bin'), '--device', 'cpu'])
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    from_npz = cache.load_model(npz, device='cpu')
    from_st = resselt_tpu_torch.load_from_file(st, device='cpu')
    assert from_st.arch_id == from_npz.arch_id == 'ESRGAN'
    for m in (from_npz, from_st):
        assert torch.equal(m(_x()), tm(_x()))
    jnpz = str(tmp_path / 'j.npz')  # the JAX package's converter writes the same params
    assert jconvert.main([src, jnpz]) == 0
    with np.load(jnpz) as a, np.load(npz) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files if k != '__header__')


def test_inspect_json_matches_jax(tmp_path, capsys):
    src = str(tmp_path / 'm.safetensors')
    write_safetensors(make_compact(24, 4, 2, seed=45), src)
    assert jinspect.main([src, '--json', '--size', '32', '32']) == 0
    want = json.loads(capsys.readouterr().out)
    assert tinspect.main([src, '--json', '--size', '32', '32', '--device', 'cpu']) == 0
    got = json.loads(capsys.readouterr().out)
    for k in ('arch', 'name', 'upscale', 'in_channels', 'out_channels', 'params', 'config'):
        assert got[k] == want[k], k
    assert got['cost_at_size']['input'] == [32, 32] and got['cost_at_size']['gflops'] > 0
    assert tinspect.main([src, '--size', '32', '32', '--device', 'cpu']) == 0
    assert 'Compact' in capsys.readouterr().out


def test_cost_counts_the_plain_path():
    """JAX's test_model_cost_analysis: FLOPs at 32x32 dominate the param
    count; the count is torch.utils.flop_counter's over the plain path."""
    tm = resselt_tpu_torch.load_from_state_dict(make_compact(24, 4, 2, seed=45), device='cpu')
    c = tm.cost(32, 32)
    assert c['params'] == sum(v.numel() for v in tm.params.values()) > 0
    assert c['flops'] > 1e6 and c['bytes_accessed'] == -1.0
    # six 3x3 convs at 32x32: 2 * 9 * (3*24 + 4*24*24 + 24*12) FLOPs a pixel
    assert c['flops'] == 2 * 9 * (3 * 24 + 4 * 24 * 24 + 24 * 12) * 32 * 32
    assert tm.cost(32, 32, batch=2)['flops'] == 2 * c['flops']


@pytest.mark.parametrize('kw', [{}, {'crop_border': 3}, {'test_y_channel': True}, {'crop_border': 2, 'test_y_channel': True}])
def test_metrics_match_jax(kw):
    rng = np.random.default_rng(1)
    a = rng.random((2, 20, 23, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for x, y in ((a, b), (torch.from_numpy(a[0]), torch.from_numpy(b[0]))):
        jx, jy = np.asarray(x), np.asarray(y)
        assert abs(metrics.psnr(x, y, **kw) - jmetrics.psnr(jx, jy, **kw)) < 1e-5 * 40
        assert abs(metrics.ssim(x, y, **kw) - jmetrics.ssim(jx, jy, **kw)) < 1e-5
    got = metrics.rgb_to_y(a)
    assert got.shape == (2, 20, 23, 1)
    assert float(np.abs(got.numpy() - np.asarray(jmetrics.rgb_to_y(a))).max()) < 1e-5
    gray = rng.random((16, 17)).astype(np.float32)
    assert abs(metrics.ssim(gray, gray) - 1.0) < 1e-6 and metrics.psnr(gray, gray) > 100
    with pytest.raises(ValueError):
        metrics.ssim(a[:, :8], b[:, :8])
    with pytest.raises(ValueError):
        metrics.psnr(a, b[:, :5])


@pytest.fixture
def cli_files(tmp_path):
    sd = make_compact(32, 2, 2, seed=46)
    ckpt = str(tmp_path / 'm.safetensors')
    write_safetensors(sd, ckpt)
    jnpz, tnpz = str(tmp_path / 'j.npz'), str(tmp_path / 't.npz')
    assert jconvert.main([ckpt, jnpz]) == 0
    assert convert.main([ckpt, tnpz, '--device', 'cpu']) == 0
    indir = tmp_path / 'in'
    indir.mkdir()
    for i in range(3):
        Image.fromarray((np.random.default_rng(i).random((18 + i, 22, 3)) * 255).astype(np.uint8)).save(
            str(indir / f'{i}.png'))
    return {'ckpt': ckpt, 'jnpz': jnpz, 'tnpz': tnpz, 'indir': str(indir), 'tmp': tmp_path}


def _pngs(path):
    names = sorted(os.listdir(path)) if os.path.isdir(path) else ['']
    return [np.asarray(Image.open(os.path.join(path, n) if n else path)).astype(np.int16) for n in names]


@pytest.mark.parametrize('flags', [[], ['--int8'], ['--no-fused-attention', '--no-fused-lk', '--no-chunked-attention'],
                                   ['--tile', '16', '--int8']], ids=['plain', 'int8', 'no_kernels', 'tiled_int8'])
@pytest.mark.parametrize('model', ['npz', 'ckpt'])
def test_cli_matches_jax(cli_files, model, flags):
    """A directory of three PNGs through both CLIs (the port's images read
    and written on its background thread), from a checkpoint or an ``.npz``
    cache (JAX's CLI reads the JAX package's cache, the port's both)."""
    f, tmp = cli_files, cli_files['tmp']
    jsrc, tsrcs = (f['jnpz'], [f['tnpz'], f['jnpz']]) if model == 'npz' else (f['ckpt'], [f['ckpt']])
    assert jax_main([jsrc, f['indir'], str(tmp / 'oj'), *flags]) == 0
    want = _pngs(str(tmp / 'oj'))
    for i, src in enumerate(tsrcs):
        out = str(tmp / f'op{i}')
        assert port_main([src, f['indir'], out, '--device', 'cpu', *flags]) == 0
        got = _pngs(out)
        assert len(got) == len(want) == 3
        assert all(g.shape == w.shape and int(np.abs(g - w).max()) <= 1 for g, w in zip(got, want))
    assert fused_attention_enabled() and fused_lk_enabled()  # the switches are the run's, then restored


def test_cli_trace(cli_files):
    f, tmp = cli_files, cli_files['tmp']
    src = os.path.join(f['indir'], '0.png')
    assert jax_main([f['ckpt'], src, str(tmp / 'j.png'), '--trace', str(tmp / 'jtrace')]) == 0
    assert port_main([f['ckpt'], src, str(tmp / 't.png'), '--device', 'cpu', '--trace', str(tmp / 'trace')]) == 0
    trace = tmp / 'trace' / 'resselt_tpu_torch.trace.json'
    assert trace.is_file() and json.loads(trace.read_text())['traceEvents']
    (got,), (want,) = _pngs(str(tmp / 't.png')), _pngs(str(tmp / 'j.png'))
    assert int(np.abs(got - want).max()) <= 1


def test_cli_reports_a_failed_write(cli_files):
    """The background writer's failure surfaces as the run's error, after
    the futures in flight are drained."""
    f, tmp = cli_files, cli_files['tmp']
    out = tmp / 'out'
    (out / '1.png').mkdir(parents=True)  # the second image's output path is a directory
    with pytest.raises(IsADirectoryError):
        port_main([f['ckpt'], f['indir'], str(out), '--device', 'cpu'])
    assert (out / '0.png').is_file() and not (out / '2.png').exists()


@pytest.mark.parametrize('bucket', [False, True])
def test_cli_tiles_shared_sizes_on_the_graph_path(tmp_path, monkeypatch, bucket):
    """Tiled, the CLI sends an image to the one-dispatch path when another
    input of the run has its size (with ``--bucket``, its padded size), and
    to the host loop when the size is its own; the images are the same
    either way."""
    import resselt_tpu_torch.parallel as parallel

    ckpt = str(tmp_path / 'm.safetensors')
    write_safetensors(make_compact(16, 2, 2, seed=47), ckpt)
    indir = tmp_path / 'in'
    indir.mkdir()
    for name, (h, w) in (('a', (20, 22)), ('b', (18, 22)), ('c', (20, 22))):  # 18 and 20 pad to one bucket of 8
        Image.fromarray((np.random.default_rng(len(name) + h).random((h, w, 3)) * 255).astype(np.uint8)).save(
            str(indir / f'{name}.png'))
    seen, real = [], parallel.upscale_tiled
    monkeypatch.setattr(parallel, 'upscale_tiled', lambda *a, **k: seen.append(k['on_device']) or real(*a, **k))
    flags = ['--tile', '8', '--device', 'cpu'] + (['--bucket'] if bucket else [])
    assert port_main([ckpt, str(indir), str(tmp_path / 'out'), *flags]) == 0
    assert seen == ([None, None, None] if bucket else [None, False, None])
    tm = resselt_tpu_torch.load_from_file(ckpt, device='cpu')
    for name, got in zip('abc', _pngs(str(tmp_path / 'out'))):
        img = np.asarray(Image.open(str(indir / f'{name}.png')), dtype=np.float32) / 255.0
        want = real(tm, img, tile=8, on_device=False, bucket=bucket)
        want = torch.clamp(want * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8).numpy().astype(np.int16)
        assert np.array_equal(got, want)
