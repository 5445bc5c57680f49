"""The helpers behind cogaps_tpu_torch/profile_iter.py's device busy time:
the union of device intervals and the kernel classes."""

import pytest

from cogaps_tpu_torch.profile_iter import busy_ns, kernel_class


@pytest.mark.parametrize("intervals,expected", [
    ([], 0),
    ([(0, 10)], 10),
    ([(20, 25), (0, 10)], 15),  # disjoint, any order
    ([(0, 10), (5, 12)], 12),  # overlapping
    ([(0, 10), (2, 4), (10, 13)], 13),  # nested, then touching
    ([(0, 10), (5, 12), (20, 25), (21, 22)], 17),
])
def test_busy_ns_is_the_union(intervals, expected):
    assert busy_ns(intervals) == expected


@pytest.mark.parametrize("name,expected", [
    ("sweep_kernel(Params)", "sweep_kernel"),
    ("(anonymous namespace)::span_kernel((anonymous namespace)::SpanArgs, "
     "cogaps::SweepArgs, cogaps::SweepArgs)", "span_kernel"),
    ("(anonymous namespace)::sweep_kernel((anonymous namespace)::Params)",
     "sweep_kernel"),
    ("void (anonymous namespace)::sweep_kernel<32>(cogaps::SweepArgs, "
     "float *, const float *, const float *)", "sweep_kernel"),
    ("void (anonymous namespace)::sweep_kernel<1024>(cogaps::SweepArgs, "
     "float *, const float *, const float *)", "sweep_kernel"),
    ("void (anonymous namespace)::rows_kernel<10>((anonymous namespace)"
     "::Args)", "tables_kernel"),
    ("void (anonymous namespace)::quads_kernel<17>((anonymous namespace)"
     "::Args)", "tables_kernel"),
    ("void (anonymous namespace)::mma_kernel<10>((anonymous namespace)"
     "::Args)", "tables_kernel"),
    ("void (anonymous namespace)::mma_tiles_kernel<16, 2>((anonymous "
     "namespace)::MmaArgs)", "tables_kernel"),
    ("(anonymous namespace)::simt_tiles_kernel((anonymous namespace)"
     "::Args)", "tables_kernel"),
    ("void gemmSN_NN_kernel<float, 128, 2, 4, 8, 5, 4, false>", "matmuls"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32", "matmuls"),
    ("cutlass_80_simt_sgemm_128x64_8x5_nn_align1", "matmuls"),
    ("void splitKreduce_kernel<32, 16, int, float>", "matmuls"),
    ("Memcpy HtoD (Pageable -> Device)", "copies"),
    ("Memset (Device)", "copies"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise_reduce"),
    ("void at::native::reduce_kernel<512, 1, ...>", "elementwise_reduce"),
])
def test_kernel_class(name, expected):
    assert kernel_class(name) == expected
