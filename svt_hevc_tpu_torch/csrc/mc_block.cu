// K2: per-block motion-compensated prediction from an edge-padded plane,
// batched over MV fields and reference planes.
//
// Replaces svt_hevc_tpu/tpu/pallas_kernels.py mc_block_pallas
// (_mc_row_kernel). For every n x n block (by, bx) of every output plane
// (p, k), the (n+taps-1)^2 integer window whose origin is
// (by*n + sy[k], bx*n + sx[k]) in ref_ext[p] is filtered with the
// separable HEVC interpolation filter of phase (fx[k], fy[k]): horizontal
// pass >> (bit_depth - 8), vertical pass >> 6 (the 14-bit intermediate);
// when ROUNDED the result is rounded back to pixels and clipped to
// [0, maxval]. int32 throughout, the same shift pairing as the plain
// version (gpu/kernels.mc_block_ref), so the result is exact. The
// wrapper clamps the MVs so every window lies inside ref_ext; window
// coordinates are clamped here as well, the plain version's per-element
// clamp, so a malformed call stays inside the allocation.
//
// What bounds it on the H100: bytes. Per 8x8 luma block it does
// 8*(15*8 + 8*8) = 1472 multiply-adds (~2900 operations) against ~530
// bytes the function must move (its share of the plane, four map
// entries, 64 int32 outputs): ~5.5 operations per byte, below the card's
// ~20, so the floor is one read of the planes plus the int32 output write.
// A 1080p luma plane (10 MB) sits in the 50 MB L2, so the window rereads
// (15x15 per 8x8 block) are L2 and L1 traffic, not device-memory traffic.
// In practice the window staging sets the pace: ~45 sector requests per
// 8x8 block, in flight at L2 latency. A variant that only stages takes
// most of the full kernel's time, and fields whose neighbouring blocks
// share windows run little faster (PERF.md, Findings).
//
// The design, against what held the first version back (runtime n/taps
// with integer division per element, maps and filters re-read from
// global memory per sample, three shared-memory phases, one plane and one
// field per launch):
//  - Specialised at compile time on (n, taps, rounded): luma 8/8 and
//    chroma 4/4. The filter tables sit in __constant__ memory (H.265
//    Tables 8-11 and 8-12; tests/test_torch_kernels.py holds them equal
//    to core/inter.py); each block's four map entries are loaded once, by
//    one lane, and handed to the lanes that need them by warp shuffles.
//  - A CTA is one warp; it owns a run of BPW horizontally adjacent blocks
//    of one block row (luma 16, chroma 32), and each thread owns 4
//    adjacent output columns of one block (luma 2 threads per block,
//    chroma 1). The warp stages its blocks' windows in shared memory with
//    cp.async (WS lanes per window row, consecutive addresses), with the
//    per-sample edge clamp only for windows that reach past the plane,
//    and syncs the warp only. 16.5 KB of shared memory per warp lets 13
//    warps share an SM.
//  - Each thread reads a window row as 2-3 aligned 16-byte loads, forms
//    its 4 horizontal outputs for all n+taps-1 rows into registers, and
//    runs the vertical pass from registers; each output row goes out as
//    one 16-byte store, a warp's stores covering 512 contiguous bytes.
//    The per-block shared stride is padded so that a quarter-warp's
//    16-byte loads hit 32 distinct banks.
//  - One launch takes P reference planes of one shape (Cb and Cr) and K
//    MV fields on them: maps (K, nby, nbx), output (P, K, h, w); the
//    grid's z walks P x K.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// H.265 Table 8-11: luma 8-tap filters, quarter positions 0..3
__constant__ int c_luma[4 * 8] = {
    0, 0, 0, 64, 0, 0, 0, 0,
    -1, 4, -10, 58, 17, -5, 1, 0,
    -1, 4, -11, 40, 40, -11, 4, -1,
    0, 1, -5, 17, 58, -10, 4, -1,
};
// H.265 Table 8-12: chroma 4-tap filters, eighth positions 0..7
__constant__ int c_chroma[8 * 4] = {
    0, 64, 0, 0,
    -2, 58, 10, -2,
    -4, 54, 16, -2,
    -6, 46, 28, -4,
    -4, 36, 36, -4,
    -4, 28, 46, -6,
    -2, 16, 54, -4,
    -2, 10, 58, -2,
};

template <int TAPS>
__device__ __forceinline__ int coef(int i) {
    return TAPS == 8 ? c_luma[i] : c_chroma[i];
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int N, int TAPS>
struct Geo {
    static constexpr int M = N + TAPS - 1;        // window side
    static constexpr int WS = N + TAPS;           // staged row width
    static constexpr int TPB = N / 4;             // threads per block
    static constexpr int BPW = 32 / TPB;          // blocks per warp
    static constexpr int PHASES = 32 / TAPS;
    static constexpr int NV = (TAPS + 3 + 3) / 4; // 16-byte loads per row
    // per-block stride: == 4*TPB (mod 32) words, so the 8 threads of a
    // quarter-warp (8/TPB blocks x TPB column quads) hit distinct banks
    static constexpr int STRIDE = M * WS + ((4 * TPB - (M * WS) % 32) + 32) % 32;
    static_assert(N % 4 == 0 && WS % 4 == 0, "rows must be 16-byte aligned");
    static_assert(4 * (TPB - 1) + 4 * NV <= WS, "row loads stay in the row");
};

template <int N, int TAPS, bool ROUNDED>
__global__ void __launch_bounds__(32)
mc_block_kernel(const int* __restrict__ ref, int hp, int wp,
                const int* __restrict__ sy, const int* __restrict__ sx,
                const int* __restrict__ fx, const int* __restrict__ fy,
                int* __restrict__ out, int nk, int nby,
                int nbx, int shift1, int round_shift, int maxval) {
    using G = Geo<N, TAPS>;
    __shared__ __align__(16) int sw[G::BPW * G::STRIDE];

    // the mask tells the compiler lane < 32, which folds the staging
    // loop's row predicates (the unmasked form measured slower)
    const int lane = threadIdx.x & 31;
    const int by = blockIdx.y;
    const int bx0 = blockIdx.x * G::BPW;
    const int z = blockIdx.z;                     // p * nk + k
    const int p = z / nk;
    const int k = z - p * nk;
    const int* plane = ref + static_cast<size_t>(p) * hp * wp;

    // the maps of this warp's blocks, one block per lane
    int org_r = 0, org_c = 0, fxl = 0, fyl = 0;
    if (lane < G::BPW && bx0 + lane < nbx) {
        const size_t mi = (static_cast<size_t>(k) * nby + by) * nbx + bx0 + lane;
        org_r = by * N + sy[mi];
        org_c = (bx0 + lane) * N + sx[mi];
        fxl = fx[mi];
        fyl = fy[mi];
    }

    // stage every block's window rows: WS words per row (the last column
    // is past the window and never read), lanes j = lane % WS on
    // consecutive addresses, RPI rows per warp load
    constexpr int RPI = 32 / G::WS;
    const int j = lane % G::WS;
    const int i0 = lane / G::WS;
    for (int b = 0; b < G::BPW; ++b) {
        const int r0 = __shfl_sync(FULL, org_r, b);
        const int c0 = __shfl_sync(FULL, org_c, b);
        if (bx0 + b >= nbx) break;                // warp-uniform
        int* dst = sw + b * G::STRIDE + i0 * G::WS + j;
        if (r0 >= 0 && c0 >= 0 && r0 + G::M <= hp && c0 + G::WS <= wp) {
            const int* src = plane + static_cast<size_t>(r0 + i0) * wp + c0 + j;
#pragma unroll
            for (int it = 0; it < (G::M + RPI - 1) / RPI; ++it) {
                if (i0 + it * RPI < G::M) {
                    cp_async4(dst + it * RPI * G::WS,
                              src + static_cast<size_t>(it * RPI) * wp);
                }
            }
        } else {                                  // edge-clamped samples
            const int* col = plane + min(max(c0 + j, 0), wp - 1);
#pragma unroll
            for (int it = 0; it < (G::M + RPI - 1) / RPI; ++it) {
                const int i = i0 + it * RPI;
                if (i < G::M) {
                    const int yy = min(max(r0 + i, 0), hp - 1);
                    cp_async4(dst + it * RPI * G::WS,
                              col + static_cast<size_t>(yy) * wp);
                }
            }
        }
    }
    cp_async_wait_all();
    __syncwarp();

    const int b = lane / G::TPB;
    const int q = (lane % G::TPB) * 4;            // first of 4 columns
    const int ph_x = __shfl_sync(FULL, fxl, b) & (G::PHASES - 1);
    const int ph_y = __shfl_sync(FULL, fyl, b) & (G::PHASES - 1);
    if (bx0 + b >= nbx) return;

    int fh[TAPS], fv[TAPS];
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
        fh[t] = coef<TAPS>(ph_x * TAPS + t);
        fv[t] = coef<TAPS>(ph_y * TAPS + t);
    }

    // horizontal pass: mid[i][c] = (sum_t fh[t] * win[i][q+c+t]) >> shift1
    int mid[G::M][4];
    const int* wrow = sw + b * G::STRIDE + q;
#pragma unroll
    for (int i = 0; i < G::M; ++i) {
        int v[4 * G::NV];
#pragma unroll
        for (int u = 0; u < G::NV; ++u) {
            const int4 x = *reinterpret_cast<const int4*>(wrow + i * G::WS + 4 * u);
            v[4 * u] = x.x;
            v[4 * u + 1] = x.y;
            v[4 * u + 2] = x.z;
            v[4 * u + 3] = x.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            int acc = 0;
#pragma unroll
            for (int t = 0; t < TAPS; ++t) acc += fh[t] * v[c + t];
            mid[i][c] = acc >> shift1;
        }
    }

    // vertical pass from registers: out = (sum_t fv[t] * mid[r+t][c]) >> 6
    const int w = nbx * N;
    int* orow = out + (static_cast<size_t>(z) * nby * N + by * N) * w
                + (bx0 + b) * N + q;
    const int half = ROUNDED ? (1 << (round_shift - 1)) : 0;
#pragma unroll
    for (int r = 0; r < N; ++r) {
        int o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            int acc = 0;
#pragma unroll
            for (int t = 0; t < TAPS; ++t) acc += fv[t] * mid[r + t][c];
            acc >>= 6;
            if (ROUNDED) {
                acc = (acc + half) >> round_shift;
                acc = min(max(acc, 0), maxval);
            }
            o[c] = acc;
        }
        *reinterpret_cast<int4*>(orow + static_cast<size_t>(r) * w) =
            make_int4(o[0], o[1], o[2], o[3]);
    }
}

template <int N, int TAPS, bool ROUNDED>
cudaError_t launch(const int* ref, int np, int hp, int wp, const int* sy,
                   const int* sx, const int* fx, const int* fy,
                   int* out, int nk, int nby, int nbx,
                   int shift1, int round_shift, int maxval,
                   cudaStream_t stream) {
    using G = Geo<N, TAPS>;
    const dim3 grid((nbx + G::BPW - 1) / G::BPW, nby, np * nk);
    mc_block_kernel<N, TAPS, ROUNDED><<<grid, 32, 0, stream>>>(
        ref, hp, wp, sy, sx, fx, fy, out, nk, nby, nbx, shift1,
        round_shift, maxval);
    return cudaGetLastError();
}

}  // namespace

// ref: (np, hp, wp) int32; sy/sx/fx/fy: (nk, nby, nbx) int32;
// out: (np, nk, nby*n, nbx*n) int32.
// Returns a cudaError_t; cudaErrorInvalidValue for an (n, taps) pair
// that has no instance or a grid the card cannot take.
extern "C" int mc_block_launch(const void* ref, int np, int hp, int wp,
                               const void* sy, const void* sx,
                               const void* fx, const void* fy,
                               void* out, int nk, int nby,
                               int nbx, int n, int taps, int shift1,
                               int round_shift, int maxval, void* stream) {
    if (np * nk > 65535 || nby > 65535 || np < 1 || nk < 1 || nby < 1
        || nbx < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int* r = static_cast<const int*>(ref);
    const int* a = static_cast<const int*>(sy);
    const int* b = static_cast<const int*>(sx);
    const int* c = static_cast<const int*>(fx);
    const int* d = static_cast<const int*>(fy);
    int* o = static_cast<int*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool rounded = round_shift > 0;
    cudaError_t err;
    if (n == 8 && taps == 8) {
        err = rounded
            ? launch<8, 8, true>(r, np, hp, wp, a, b, c, d, o, nk, nby, nbx,
                                 shift1, round_shift, maxval, s)
            : launch<8, 8, false>(r, np, hp, wp, a, b, c, d, o, nk, nby,
                                  nbx, shift1, round_shift, maxval, s);
    } else if (n == 4 && taps == 4) {
        err = rounded
            ? launch<4, 4, true>(r, np, hp, wp, a, b, c, d, o, nk, nby, nbx,
                                 shift1, round_shift, maxval, s)
            : launch<4, 4, false>(r, np, hp, wp, a, b, c, d, o, nk, nby,
                                  nbx, shift1, round_shift, maxval, s);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err);
}
