// K3: float32 sums in a fixed order, one left-to-right chain per column.
//
// Not the counterpart of a TPU kernel: of an XLA:CPU reduction. XLA:CPU
// turns a large float32 reduce into exact-size 32x32 reduce-windows and
// then reduces the window sums one after another, row-major, in float32
// (svt_hevc_tpu/tpu/analysis.py lookahead_stats: the zero-MV and global-
// motion SADs of a 1080p lookahead batch, 9 x 15 window sums each). Where
// the running sum passes 2^24 units its rounding depends on that order,
// so the port adds the window sums in the same order:
//
//   out[n] = (((0 + parts[0][n]) + parts[1][n]) + ...) + parts[L-1][n]
//
// with every add rounded to nearest even in float32 (__fadd_rn: never
// contracted, never reassociated), so the card and the plain version
// (gpu/kernels.ordered_sum_ref) agree bit for bit.
//
// parts is (L, N) row-major: chain i of column n reads parts[i * N + n],
// so the threads of a warp read consecutive words. One thread per column;
// a lookahead batch has 289 * (T - 1) columns of L = 135 at 1080p, so the
// kernel is one small wave whose time is its launch.

#include <cuda_runtime.h>

namespace {

__global__ void ordered_sum_kernel(const float* __restrict__ parts,
                                   float* __restrict__ out, int len,
                                   int cols) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= cols) return;
    float acc = 0.0f;
    const float* p = parts + n;
    for (int i = 0; i < len; ++i) {
        acc = __fadd_rn(acc, p[static_cast<size_t>(i) * cols]);
    }
    out[n] = acc;
}

}  // namespace

// parts: (len, cols) float32; out: (cols,) float32. Returns a cudaError_t.
extern "C" int ordered_sum_launch(const void* parts, void* out, int len,
                                  int cols, void* stream) {
    if (len < 0 || cols <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    constexpr int THREADS = 256;
    const dim3 grid((cols + THREADS - 1) / THREADS);
    ordered_sum_kernel<<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(parts), static_cast<float*>(out), len,
        cols);
    return static_cast<int>(cudaGetLastError());
}
