// K3: float32 sums in a fixed order: XLA:CPU's order for the reduce of a
// grid of window sums, one column of window sums per thread.
//
// Not the counterpart of a TPU kernel: of an XLA:CPU reduction. XLA:CPU
// turns a large float32 reduce into exact-size 32x32 reduce-windows (the
// first level: exact here, since every window sum stays below 2^24) and
// then reduces the grid of window sums in float32 (svt_hevc_tpu/tpu/
// analysis.py lookahead_stats: the zero-MV and global-motion SADs of a
// lookahead batch; 9 x 15 window sums at 1080p, 34 x 60 at 4320p). Where
// the running sums pass 2^24 units their rounding depends on that order,
// so the port adds the window sums in the same order. The order
// (gpu/analysis.xla_reduce_plan gives it for a grid) is:
//
//   - the grid of gh x gw window sums is cut into an oh x ow grid of
//     wh x ww windows (the second level), after ph rows and pw columns of
//     zero padding above and left (a grid of at most 32 x 32 is one
//     window: XLA reduces it in one step);
//   - in a window, row i goes to lane i mod `lanes` (lanes 1, 2, 4 or
//     8: LLVM vectorized the loop over the window's rows) for the first
//     wh - wh mod lanes rows; each lane adds its rows' values row by row,
//     left to right; the lanes are combined by halving (lane l += lane
//     l + h for h = lanes/2, ..., 1); the remaining rows are then added
//     row by row; with `split`, the window's last column is left out of
//     all that and added last, top to bottom;
//   - the windows of an output row are added left to right, and the
//     output rows top to bottom.
//
// That is the reference compile's order (the default compile of an
// AVX-512 host) for every grid up to 34 x 64, the lookahead's at every
// frame size the encoder accepts. An AVX2 or SSE4_2 compile orders 550
// or 609 of those grids otherwise (more of them over lanes: 2160p's
// 17 x 30 among them); the port keeps the reference's (ROADMAP §3).
//
// Every add is rounded to nearest even in float32 (__fadd_rn: never
// contracted, never reassociated), and every sum starts from +0, so the
// card and the plain version (gpu/kernels.ordered_sum_ref) agree bit for
// bit. A left-to-right chain over L values is the plan of an L x 1 grid.
//
// parts is (L, N) row-major with L = gh * gw: value (r, c) of column n is
// parts[(r * gw + c) * N + n], so the threads of a warp read consecutive
// words. One thread per column: a lookahead batch has 289 * (T - 1)
// columns (L = 135 at 1080p, 2040 at 4320p), so the kernel is one small
// wave whose time is its launch plus a thread's L dependent adds and
// loads; it reads each value once, so the bytes bound it only in name
// (PERF.md).

#include <cuda_runtime.h>

namespace {

struct Plan {
    int gh, gw;      // the grid of window sums
    int wh, ww;      // a second-level window
    int ph, pw;      // zero padding above and left of the grid
    int oh, ow;      // the grid of second-level windows
    int lanes;       // 1, 2, 4 or 8
    int split;       // the window's last column added last
};

// acc plus row r's values of columns [c0, c1) of the grid, left to right
// (nothing where the row or the columns lie in the padding).
__device__ __forceinline__ float add_row(const float* p, const Plan& q,
                                         int r, int c0, int c1, size_t n,
                                         float acc) {
    const int lo = c0 < 0 ? 0 : c0;
    const int hi = c1 < q.gw ? c1 : q.gw;
    if (r < 0 || r >= q.gh || lo >= hi) return acc;
    const float* v = p + static_cast<size_t>(r * q.gw + lo) * n;
#pragma unroll 4
    for (int c = lo; c < hi; ++c, v += n) {
        acc = __fadd_rn(acc, *v);
    }
    return acc;
}

// LANES is the plan's lane count as a template argument, so the lane
// accumulators stay in registers (the loop over a window's rows steps
// LANES rows at a time, each row to its own accumulator).
template <int LANES>
__global__ void ordered_sum_kernel(const float* __restrict__ parts,
                                   float* __restrict__ out, Plan q,
                                   int cols) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= cols) return;
    const float* p = parts + n;
    const size_t stride = static_cast<size_t>(cols);
    const int main_rows = q.wh - q.wh % LANES;
    const int body_cols = q.ww - q.split;
    float total = 0.0f;
    for (int a = 0; a < q.oh; ++a) {
        float row_sum = 0.0f;
        for (int b = 0; b < q.ow; ++b) {
            const int r0 = a * q.wh - q.ph;
            const int c0 = b * q.ww - q.pw;
            float lane[LANES];
#pragma unroll
            for (int l = 0; l < LANES; ++l) lane[l] = 0.0f;
            for (int i = 0; i < main_rows; i += LANES) {
#pragma unroll
                for (int l = 0; l < LANES; ++l) {
                    lane[l] = add_row(p, q, r0 + i + l, c0, c0 + body_cols,
                                      stride, lane[l]);
                }
            }
#pragma unroll
            for (int h = LANES / 2; h >= 1; h /= 2) {
#pragma unroll
                for (int l = 0; l < h; ++l) {
                    lane[l] = __fadd_rn(lane[l], lane[l + h]);
                }
            }
            float w = lane[0];
            for (int i = main_rows; i < q.wh; ++i) {
                w = add_row(p, q, r0 + i, c0, c0 + body_cols, stride, w);
            }
            if (q.split) {
                const int c = c0 + q.ww - 1;
                for (int i = 0; i < q.wh; ++i) {
                    w = add_row(p, q, r0 + i, c, c + 1, stride, w);
                }
            }
            row_sum = __fadd_rn(row_sum, w);
        }
        total = __fadd_rn(total, row_sum);
    }
    out[n] = total;
}

}  // namespace

// parts: (gh * gw, cols) float32; out: (cols,) float32; the plan's ten
// integers as described above. Returns a cudaError_t.
extern "C" int ordered_sum_launch(const void* parts, void* out, int gh,
                                  int gw, int wh, int ww, int ph, int pw,
                                  int oh, int ow, int lanes, int split,
                                  int cols, void* stream) {
    if (cols <= 0 || gh < 0 || gw < 0 || wh <= 0 || ww <= 0 || oh < 0
        || ow < 0
        || (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8)
        || (split != 0 && split != 1)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Plan q{gh, gw, wh, ww, ph, pw, oh, ow, lanes, split};
    // small blocks spread a batch's few hundred to few thousand threads
    // over many SMs: each thread's chain of dependent adds is its time
    constexpr int THREADS = 64;
    const dim3 grid((cols + THREADS - 1) / THREADS);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* in = static_cast<const float*>(parts);
    auto* o = static_cast<float*>(out);
    switch (lanes) {
        case 1: ordered_sum_kernel<1><<<grid, THREADS, 0, st>>>(in, o, q,
                                                               cols); break;
        case 2: ordered_sum_kernel<2><<<grid, THREADS, 0, st>>>(in, o, q,
                                                               cols); break;
        case 4: ordered_sum_kernel<4><<<grid, THREADS, 0, st>>>(in, o, q,
                                                               cols); break;
        default: ordered_sum_kernel<8><<<grid, THREADS, 0, st>>>(in, o, q,
                                                                cols);
    }
    return static_cast<int>(cudaGetLastError());
}
