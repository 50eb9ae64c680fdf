// K1: full-search SAD field of every aligned 16x16 block.
//
// Replaces svt_hevc_tpu/tpu/pallas_kernels.py sad_field_pallas
// (_sad_row_kernel): out[dy][dx][by][bx] = sum over the block at
// (by*16, bx*16) of |src - ref(y + dy - r, x + dx - r)|, with ref read in
// "edge" mode (coordinates clamped into the plane), for every
// displacement (dy, dx) in [0, 2r]^2. float32 in and out.
//
// Exactness: the inputs are 2x2 means of means of 8-bit samples, so every
// value is a multiple of 1/16 below 256, and every partial sum over one
// 16x16 block is a multiple of 1/16 below 2^16, i.e. fewer than 2^20
// sixteenths, which float32's 24-bit significand holds exactly. So the
// float32 sum is exact in any order (here: per row, then across the
// threads that split a block's rows) and equals the plain version bit for
// bit. float32 is kept because it is the type both callers already hold.
//
// What bounds it on the H100: operations. Each sample is compared against
// (2r+1)^2 displacements at 3 operations each (sub, abs, add) for 8 bytes
// of input (src + ref): ~30 operations per byte at r=4 and ~110 at r=8,
// above the card's ~20 (67 TFLOP/s fp32 over 3.35 TB/s). An absolute
// difference and its accumulation are two FADDs (the abs is an operand
// modifier), so the instruction issue rate, not memory, sets the floor.
//
// The design, against what held the first version back (one CTA of 96
// threads per block, 256 serial steps per thread with two shared loads
// per absolute difference, bank conflicts across mixed (dy, dx)):
//  - Specialised at compile time on r (4 and 8, the radii hme_search uses).
//  - One CTA covers a strip of S blocks of one block row (S = 4 at r=4,
//    2 at r=8): it stages the strip's 16 source rows and the (16+2r) x
//    (16*S+2r) reference window shared by the strip in shared memory
//    once, with cp.async (every load in flight at once), so neighbouring
//    blocks share their overlapping window columns.
//  - A thread owns one (block, dy) and every dx, over one in YG of the
//    block's rows (YG = 8 at r=4, 16 at r=8). Per row it loads the 16
//    source samples and the 16+2r reference samples into registers with
//    16-byte loads and reuses them for all 2r+1 dx: (2r+1)*16 absolute
//    differences per 4 + (16+2r)/4 shared loads, against two loads per
//    difference before. The YG threads of a (block, dy) sit in adjacent
//    lanes and add their partial sums with warp shuffles. CTAs are 288
//    threads at r=4 and 544 at r=8. At r=8 the coarsest level (272x480)
//    gets 255 CTAs of 2 blocks rather than 136 of 4: on 132 SMs the
//    busiest SM then carries 4 blocks, not 8.
//  - Row strides are padded to an odd number of 16-byte words, so the
//    rows a quarter-warp reads at once fall in distinct banks.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int N = 16;             // block side

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a row stride of at least `w` floats that is an odd number of float4s
constexpr int odd_quads(int w) {
    return ((w + 3) / 4 % 2 == 1) ? (w + 3) / 4 * 4 : (w + 3) / 4 * 4 + 4;
}

template <int R>
struct Geo {
    static constexpr int S = R == 8 ? 2 : 4;          // blocks per CTA
    static constexpr int YG = R == 8 ? 16 : 8;        // row groups per block
    static constexpr int S2 = 2 * R + 1;
    static constexpr int WIN = N + 2 * R;             // window rows and cols per block
    static constexpr int SW = N * S;                  // strip width
    static constexpr int SSTR = odd_quads(SW);        // src row stride
    static constexpr int RW = SW + 2 * R;             // ref window width
    static constexpr int RSTR = odd_quads(RW);        // ref row stride
    static constexpr int NT = S * S2 * YG;            // working threads
    static constexpr int THREADS = (NT + 31) / 32 * 32;
    static_assert(WIN % 4 == 0, "reference rows are read as float4");
    static_assert(32 % YG == 0, "a block's row groups share a warp");
};

template <int R>
__global__ void __launch_bounds__(Geo<R>::THREADS)
sad_field_kernel(const float* __restrict__ src, const float* __restrict__ ref,
                 float* __restrict__ out, int h, int w) {
    using G = Geo<R>;
    __shared__ __align__(16) float s_src[N * G::SSTR];
    __shared__ __align__(16) float s_ref[G::WIN * G::RSTR];

    const int nbx = w / N, nby = h / N;
    const int by = blockIdx.y;
    const int bx0 = blockIdx.x * G::S;
    const int y0 = by * N, x0 = bx0 * N;

    // stage the strip (columns past the plane are clamped; their blocks
    // are never stored) and its edge-clamped reference window
#pragma unroll
    for (int i = threadIdx.x; i < N * G::SW; i += G::THREADS) {
        const int yy = i / G::SW, xx = i % G::SW;
        cp_async4(s_src + yy * G::SSTR + xx,
                  src + static_cast<size_t>(y0 + yy) * w + min(x0 + xx, w - 1));
    }
#pragma unroll
    for (int i = threadIdx.x; i < G::WIN * G::RW; i += G::THREADS) {
        const int yy = i / G::RW, xx = i % G::RW;
        const int gy = min(max(y0 - R + yy, 0), h - 1);
        const int gx = min(max(x0 - R + xx, 0), w - 1);
        cp_async4(s_ref + yy * G::RSTR + xx, ref + static_cast<size_t>(gy) * w + gx);
    }
    cp_async_wait_all();
    __syncthreads();

    const int t = threadIdx.x < G::NT ? threadIdx.x : 0;  // spare lanes idle
    const int g = t % G::YG;
    const int dy = (t / G::YG) % G::S2;
    const int b = t / (G::YG * G::S2);
    const bool store = threadIdx.x < G::NT && bx0 + b < nbx && g == 0;

    float acc[G::S2];
#pragma unroll
    for (int dx = 0; dx < G::S2; ++dx) acc[dx] = 0.0f;
    const float* sp = s_src + b * N;
    const float* rp = s_ref + dy * G::RSTR + b * N;
    for (int y = g; y < N; y += G::YG) {
        float s[N], r[G::WIN];
#pragma unroll
        for (int u = 0; u < N / 4; ++u) {
            const float4 v = *reinterpret_cast<const float4*>(sp + y * G::SSTR + 4 * u);
            s[4 * u] = v.x;
            s[4 * u + 1] = v.y;
            s[4 * u + 2] = v.z;
            s[4 * u + 3] = v.w;
        }
#pragma unroll
        for (int u = 0; u < G::WIN / 4; ++u) {
            const float4 v = *reinterpret_cast<const float4*>(rp + y * G::RSTR + 4 * u);
            r[4 * u] = v.x;
            r[4 * u + 1] = v.y;
            r[4 * u + 2] = v.z;
            r[4 * u + 3] = v.w;
        }
#pragma unroll
        for (int dx = 0; dx < G::S2; ++dx) {
#pragma unroll
            for (int x = 0; x < N; ++x) acc[dx] += fabsf(s[x] - r[x + dx]);
        }
    }
#pragma unroll
    for (int o = 1; o < G::YG; o <<= 1) {
#pragma unroll
        for (int dx = 0; dx < G::S2; ++dx) {
            acc[dx] += __shfl_xor_sync(FULL, acc[dx], o);
        }
    }
    if (store) {
        const size_t plane = static_cast<size_t>(nby) * nbx;
        float* o = out + (static_cast<size_t>(dy) * G::S2) * plane
                   + static_cast<size_t>(by) * nbx + bx0 + b;
#pragma unroll
        for (int dx = 0; dx < G::S2; ++dx) o[dx * plane] = acc[dx];
    }
}

template <int R>
cudaError_t launch(const float* src, const float* ref, float* out, int h,
                   int w, cudaStream_t stream) {
    const dim3 grid((w / N + Geo<R>::S - 1) / Geo<R>::S, h / N);
    sad_field_kernel<R><<<grid, Geo<R>::THREADS, 0, stream>>>(src, ref, out,
                                                              h, w);
    return cudaGetLastError();
}

}  // namespace

// src, ref: (h, w) float32; out: (2r+1, 2r+1, h/n, w/n) float32. Returns a
// cudaError_t; cudaErrorInvalidValue for an (n, r) without an instance.
extern "C" int sad_field_launch(const void* src, const void* ref, void* out,
                                int h, int w, int n, int r, void* stream) {
    if (n != N || h % N || w % N || h < N || w < N) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const float* s = static_cast<const float*>(src);
    const float* f = static_cast<const float*>(ref);
    float* o = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (r == 4) {
        err = launch<4>(s, f, o, h, w, st);
    } else if (r == 8) {
        err = launch<8>(s, f, o, h, w, st);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err);
}
