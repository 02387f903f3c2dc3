"""``nn/spectral.py``: the port's ``rfft2_planes`` / ``irfft2_planes``
against ``np.fft`` (in f64) and ``resselt_tpu.nn.spectral`` on the same
inputs, in f32 within 1e-5: both norms, odd and even sizes, leading batch
axes, 16-bit inputs taken to f32, and inverse half-spectra that are not
Hermitian-consistent (the FourierUnits change the half-spectrum freely),
whose DC and Nyquist columns' imaginary parts a real inverse drops."""

import numpy as np
import pytest
import torch

from resselt_tpu.nn import spectral as jspectral
from resselt_tpu_torch.nn import spectral

TOL = 1e-5

SIZES = [(7, 9), (8, 10), (6, 7), (16, 16), (5, 2), (2, 5)]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize('norm', ['ortho', 'backward'])
@pytest.mark.parametrize('h,w', SIZES)
def test_rfft2_planes(h, w, norm):
    x = _rand((2, 3, h, w), h * w)
    re, im = spectral.rfft2_planes(torch.from_numpy(x), norm=norm)
    want = np.fft.rfft2(x.astype(np.float64), norm=norm)
    assert re.dtype == im.dtype == torch.float32 and re.shape == want.shape
    np.testing.assert_allclose(re.numpy(), want.real, rtol=0, atol=TOL)
    np.testing.assert_allclose(im.numpy(), want.imag, rtol=0, atol=TOL)
    jre, jim = jspectral.rfft2_planes(x, norm=norm)
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), rtol=0, atol=TOL)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), rtol=0, atol=TOL)


@pytest.mark.parametrize('norm', ['ortho', 'backward'])
@pytest.mark.parametrize('h,w', SIZES)
def test_irfft2_planes_of_any_half_spectrum(h, w, norm):
    """Random planes: not the rfft2 of any real image."""
    wf = w // 2 + 1
    re, im = _rand((2, 3, h, wf), 1), _rand((2, 3, h, wf), 2)
    got = spectral.irfft2_planes(torch.from_numpy(re), torch.from_numpy(im), s=(h, w), norm=norm)
    want = np.fft.irfft2(re.astype(np.float64) + 1j * im, s=(h, w), norm=norm)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    jgot = jspectral.irfft2_planes(re, im, s=(h, w), norm=norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=0, atol=TOL)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_16_bit_inputs_transform_in_f32(dtype):
    x = torch.from_numpy(_rand((1, 4, 12, 14), 3)).to(dtype)
    re, im = spectral.rfft2_planes(x, norm='ortho')
    want = np.fft.rfft2(x.float().numpy().astype(np.float64), norm='ortho')
    assert re.dtype == torch.float32
    np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), want, rtol=0, atol=TOL)
    back = spectral.irfft2_planes(re.to(dtype), im.to(dtype), s=(12, 14), norm='ortho')
    assert back.dtype == torch.float32


def test_roundtrip_and_patch_axes():
    """rfft2 then irfft2 is the identity, over the last two axes of a
    six-axis patch layout (LAWFFT's windowed correlation)."""
    x = torch.from_numpy(_rand((1, 2, 3, 4, 8, 8), 4))
    re, im = spectral.rfft2_planes(x)
    torch.testing.assert_close(spectral.irfft2_planes(re, im, s=(8, 8)), x, rtol=0, atol=TOL)
