"""2-D real FFTs on real / imaginary planes.

Counterpart of ``resselt_tpu/nn/spectral.py``'s ``rfft2_planes`` and
``irfft2_planes``, on ``torch.fft.rfft2`` / ``irfft2``.  The FourierUnit
and FSAS blocks of GFISR, GFISRV2, FIGSR and LAWFFT split the spectrum into
real and imaginary planes at once, so the API is plane-based.  Both
transforms run in f32 whatever the input's dtype, as the JAX package casts
them (torch.fft has no bf16 path at these sizes).  The JAX package's matmul
DFT (``_dft_mats``, ``use_mm_dft``, ``mm_dft_supported``) works around the
TPU's FFT lowering and has no counterpart here.
"""

from __future__ import annotations

import torch


def rfft2_planes(x, norm: str = 'backward'):
    """rfft2 over the last two axes of a real tensor -> (re, im) planes of
    shape (..., h, w // 2 + 1), f32."""
    f = torch.fft.rfft2(x.float(), norm=norm)
    return f.real, f.imag


def irfft2_planes(re, im, s, norm: str = 'backward'):
    """irfft2 of a half-spectrum given as (re, im) planes -> a real f32
    tensor of shape (..., *s).  Like ``np.fft.irfft2``, it takes any planes,
    Hermitian-consistent or not: the inverse along h is a full complex
    transform, and of the w-direction's DC and Nyquist columns only the real
    parts reach a real inverse.  Those imaginary parts are dropped here
    before the last transform, since cuFFT's complex-to-real transform
    assumes a Hermitian input and does not promise to ignore them."""
    h, w = int(s[0]), int(s[1])
    z = torch.fft.ifft(torch.complex(re.float(), im.float()), n=h, dim=-2, norm=norm)
    zi = z.imag.clone()
    zi[..., 0] = 0
    if w % 2 == 0 and zi.shape[-1] > w // 2:
        zi[..., w // 2] = 0
    return torch.fft.irfft(torch.complex(z.real, zi), n=w, dim=-1, norm=norm)
