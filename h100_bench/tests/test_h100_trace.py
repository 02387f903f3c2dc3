"""The trace arithmetic: kernel names, busy time, idle gaps and what the
host was doing in them."""

import pytest

from h100_bench import trace


@pytest.mark.parametrize('name, base', [
    ('void (anonymous namespace)::conv3x3_wgmma_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*, int)',
     'conv3x3_wgmma_kernel'),
    ('void wattn_h16_kernel<__nv_bfloat16, 32>(float const*)', 'wattn_h16_kernel'),
    ('void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::BFloat16> >(int)',
     'vectorized_elementwise_kernel'),
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc', 'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc'),
])
def test_kernel_base_name(name, base):
    assert trace.kernel_base_name(name) == base


def test_kernels_in_the_program_sources():
    import os

    import resselt_tpu_torch

    csrc = os.path.join(os.path.dirname(resselt_tpu_torch.__file__), 'csrc')
    assert {'conv3x3_wgmma_kernel', 'conv3x3_mma_kernel', 'conv3x3_f32_kernel'} <= trace.kernels_in(
        os.path.join(csrc, 'conv3x3.cu'))
    assert {'wattn_h16_kernel', 'wattn_h16_any_kernel'} <= trace.kernels_in(os.path.join(csrc, 'window_attn.cu'))


def test_union_and_gaps():
    busy, gaps = trace._union([(10, 20), (15, 30), (40, 50), (45, 46)], 0, 60)
    assert busy == 30 and gaps == [(0, 10), (30, 40), (50, 60)]


def test_gaps_go_to_the_innermost_open_host_range():
    host = [(0, 100, 'request'), (5, 25, 'aten::copy_'), (30, 60, 'cudaStreamSynchronize'), (70, 71, 'x')]
    got = trace._attribute([(10, 20), (40, 50), (80, 90), (200, 210)], host)
    assert got == {'aten::copy_': 10e-9, 'cudaStreamSynchronize': 10e-9, 'request': 10e-9, 'idle host': 10e-9}
