// K2: per-block motion-compensated prediction from an edge-padded plane.
//
// Replaces svt_hevc_tpu/tpu/pallas_kernels.py mc_block_pallas
// (_mc_row_kernel). For every n x n block (by, bx) of the output, the
// (n+taps-1)^2 integer window whose origin is (by*n + sy, bx*n + sx) in
// ref_ext is filtered with the separable HEVC interpolation filter of
// phase (fx, fy): horizontal pass >> (bit_depth - 8), vertical pass >> 6
// (the 14-bit intermediate); when round_shift > 0 the result is rounded
// back to pixels and clipped to [0, maxval]. int32 throughout, the same
// shift pairing as the plain version, so the result is exact.
//
// The wrapper clamps the motion vectors so that every window lies inside
// ref_ext; the window coordinates are clamped here as well, which only
// keeps a malformed call inside the allocation and is the same per-element
// clamp the plain version applies.
//
// What bounds it on the H100: bytes. Per 8x8 luma block the kernel does
// 8*(15*8 + 8*8) = 1472 multiply-adds (~2900 operations) while the
// function must move ~530 bytes (its share of the reference plane, four
// map entries, 64 int32 outputs): ~5.5 operations per byte, below the
// card's ~20, so the floor is the memory traffic. The design reads each
// window from device memory once: one CTA handles a tile of consecutive
// blocks in raster order, stages each block's window in shared memory,
// runs the horizontal pass into shared memory and the vertical pass from
// it, and writes each output sample once. No padded copy of the plane is
// built.

#include <cuda_runtime.h>

__global__ void mc_block_kernel(const int* __restrict__ ref, int hp, int wp,
                                const int* __restrict__ sy,
                                const int* __restrict__ sx,
                                const int* __restrict__ fx,
                                const int* __restrict__ fy,
                                const int* __restrict__ filt,
                                int* __restrict__ out, int nby, int nbx,
                                int n, int taps, int bpc, int shift1,
                                int round_shift, int maxval) {
    extern __shared__ int smem[];
    const int m = n + taps - 1;
    const int w = nbx * n;
    int* s_win = smem;                  // bpc * m * m
    int* s_mid = smem + bpc * m * m;    // bpc * m * n
    const int first = blockIdx.x * bpc;
    const int nblk = nby * nbx;

    for (int i = threadIdx.x; i < bpc * m * m; i += blockDim.x) {
        const int b = i / (m * m), e = i % (m * m);
        const int blk = first + b;
        if (blk >= nblk) continue;
        const int by = blk / nbx, bx = blk % nbx;
        int yy = by * n + sy[blk] + e / m;
        int xx = bx * n + sx[blk] + e % m;
        yy = min(max(yy, 0), hp - 1);
        xx = min(max(xx, 0), wp - 1);
        s_win[i] = ref[(size_t)yy * wp + xx];
    }
    __syncthreads();

    // horizontal pass: mid[b][i][j] = (sum_k f[fx][k] * win[b][i][j+k]) >> shift1
    for (int i = threadIdx.x; i < bpc * m * n; i += blockDim.x) {
        const int b = i / (m * n), e = i % (m * n);
        const int blk = first + b;
        if (blk >= nblk) continue;
        const int row = e / n, col = e % n;
        const int* f = filt + fx[blk] * taps;
        const int* wr = s_win + b * m * m + row * m + col;
        int acc = 0;
        for (int k = 0; k < taps; ++k) acc += f[k] * wr[k];
        s_mid[i] = acc >> shift1;
    }
    __syncthreads();

    // vertical pass: out = (sum_k f[fy][k] * mid[b][i+k][j]) >> 6
    for (int i = threadIdx.x; i < bpc * n * n; i += blockDim.x) {
        const int b = i / (n * n), e = i % (n * n);
        const int blk = first + b;
        if (blk >= nblk) continue;
        const int row = e / n, col = e % n;
        const int* f = filt + fy[blk] * taps;
        const int* mc = s_mid + b * m * n + row * n + col;
        int acc = 0;
        for (int k = 0; k < taps; ++k) acc += f[k] * mc[k * n];
        acc >>= 6;
        if (round_shift > 0) {
            acc = (acc + (1 << (round_shift - 1))) >> round_shift;
            acc = min(max(acc, 0), maxval);
        }
        const int by = blk / nbx, bx = blk % nbx;
        out[(size_t)(by * n + row) * w + bx * n + col] = acc;
    }
}

extern "C" int mc_block_launch(const void* ref, int hp, int wp,
                               const void* sy, const void* sx,
                               const void* fx, const void* fy,
                               const void* filt, void* out, int nby, int nbx,
                               int n, int taps, int shift1, int round_shift,
                               int maxval, void* stream) {
    const int threads = 256;
    const int bpc = threads / (n * n) > 0 ? threads / (n * n) : 1;
    const int m = n + taps - 1;
    const size_t smem = sizeof(int) * bpc * (m * m + m * n);
    const int nblk = nby * nbx;
    const int grid = (nblk + bpc - 1) / bpc;
    mc_block_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const int*)ref, hp, wp, (const int*)sy, (const int*)sx,
        (const int*)fx, (const int*)fy, (const int*)filt, (int*)out,
        nby, nbx, n, taps, bpc, shift1, round_shift, maxval);
    return (int)cudaGetLastError();
}
