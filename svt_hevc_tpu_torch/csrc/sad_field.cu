// K1: full-search SAD field of every aligned n x n block.
//
// Replaces svt_hevc_tpu/tpu/pallas_kernels.py sad_field_pallas
// (_sad_row_kernel): out[dy][dx][by][bx] = sum over the block at
// (by*n, bx*n) of |src - ref(y + dy - r, x + dx - r)|, with ref read in
// "edge" mode (coordinates clamped into the plane), for every
// displacement (dy, dx) in [0, 2r]^2. float32 in and out.
//
// Exactness: the inputs are 2x2 means of means of 8-bit samples, so every
// value is a multiple of 1/16 below 256, and every partial sum over one
// 16x16 block is a multiple of 1/16 below 2^16, i.e. fewer than 2^20
// sixteenths, which float32's 24-bit significand holds exactly. So the
// float32 sum is exact in any order and equals the plain version bit for
// bit. float32 is kept (no x16 int conversion) because it is the type
// both callers already hold.
//
// What bounds it on the H100: operations. Each sample is compared against
// (2r+1)^2 displacements at 3 operations each (sub, abs, add) for 8 bytes
// of input (src + ref): ~30 operations per byte at r=4 and ~110 at r=8,
// above the card's ~20 (67 TFLOP/s fp32 over 3.35 TB/s). The design keeps
// every reread on chip: one CTA per 16x16 block stages the block and its
// (16+2r)^2 reference window in shared memory once, and one thread per
// displacement sums its 256 differences from shared memory into a
// register, so device memory sees each input about once (windows of
// neighbouring blocks overlap by 2r, which L2 absorbs) and each output
// exactly once.

#include <cuda_runtime.h>

__global__ void sad_field_kernel(const float* __restrict__ src,
                                 const float* __restrict__ ref,
                                 float* __restrict__ out,
                                 int h, int w, int n, int r) {
    extern __shared__ float smem[];
    const int s2 = 2 * r + 1;
    const int win = n + 2 * r;
    float* s_src = smem;              // n * n
    float* s_ref = smem + n * n;      // win * win
    const int bx = blockIdx.x, by = blockIdx.y;
    const int bw = gridDim.x, bh = gridDim.y;
    const int y0 = by * n, x0 = bx * n;

    for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
        s_src[i] = src[(y0 + i / n) * w + x0 + i % n];
    }
    for (int i = threadIdx.x; i < win * win; i += blockDim.x) {
        int yy = y0 - r + i / win;
        int xx = x0 - r + i % win;
        yy = min(max(yy, 0), h - 1);   // edge padding
        xx = min(max(xx, 0), w - 1);
        s_ref[i] = ref[yy * w + xx];
    }
    __syncthreads();

    const int d = threadIdx.x;
    if (d >= s2 * s2) return;
    const int dy = d / s2, dx = d % s2;
    float acc = 0.0f;
    for (int y = 0; y < n; ++y) {
        const float* rrow = s_ref + (y + dy) * win + dx;
        const float* srow = s_src + y * n;
        for (int x = 0; x < n; ++x) {
            acc += fabsf(srow[x] - rrow[x]);
        }
    }
    out[((size_t)d * bh + by) * bw + bx] = acc;
}

extern "C" int sad_field_launch(const void* src, const void* ref, void* out,
                                int h, int w, int n, int r, void* stream) {
    const int s2 = 2 * r + 1;
    const int threads = ((s2 * s2 + 31) / 32) * 32;
    const size_t smem = sizeof(float) * (n * n + (n + 2 * r) * (n + 2 * r));
    dim3 grid(w / n, h / n);
    sad_field_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const float*)src, (const float*)ref, (float*)out, h, w, n, r);
    return (int)cudaGetLastError();
}
