// Tiled rank-factored DFT imager for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel smartcal_tpu/ops/pallas_imager.py
// `_factored_kernel` (wrapper `dirty_image_factored_pallas`).  On a
// separable pixel grid (row coordinate l_i, column coordinate m_j, both
// from the same axis vector) the image is
//
//   img[i, j] = (1/R) sum_r [p1[i,r] cb[j,r] + p2[i,r] sb[j,r]],
//   p1 = cos(a) v_re + sin(a) v_im,  p2 = cos(a) v_im - sin(a) v_re,
//   a = l_i u_r,  b = m_j v_r,  cb = cos(b),  sb = sin(b),
//
// with the TPU kernel's explicit range reduction x - 2pi * rint(x / 2pi)
// (true division, round-half-even) before the trig.
//
// Design.  A GEMM whose operand tiles are made on chip: the (npix, R) trig
// planes (~2.7 GB each at npix=1024, R=652800) never exist in device
// memory.  One block per 128x128 output tile, 256 threads, each owning an
// 8x8 register micro-tile (rows ty*4 + {0..3, 64..67}, the same for
// columns, so every 16-byte shared load of a quarter-warp is contiguous).
// The block walks its range of R in tiles of 16 samples: it stages the
// samples, builds p1/p2 for its 128 rows and cos b / sin b for its 128
// columns in shared memory (16 sine/cosine pairs per thread per tile), then
// every thread does 2 x 64 FP32 FMAs per sample.  The TPU grid reduces R
// across sequential steps; here R is split across gridDim.z so that the
// 64 tiles of a 1024^2 image fill the card, and a second pass adds the
// partial images in a fixed order and divides by the true R (no atomics,
// bit-reproducible).  Ragged npix and R are masked in the kernel: rows and
// columns past npix are not stored, samples past R enter as zeros.
//
// Precision.  FP32 FMAs on the CUDA cores, no TF32 and no tensor cores: the
// JAX policy keeps the `imager_matmul` row at f32 unless asked for bf16.
//
// Bound.  4 npix^2 R FP32 flops (2.74e12 at npix=1024, R=652800) are
// >= 41 ms at the H100 SXM's 67 TFLOP/s; 4 npix R sine/cosine values (the
// least any tiling needs) are ~0.6 ms on the SFUs; the bytes (R x 16 in,
// npix^2 x 4 out) are negligible.  So it is bound by operations.  This
// tiling recomputes the trig once per output tile (2 x 128 x R per tile,
// ~1.1e10 values in all), well below the FMA time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;          // output rows = columns per block
constexpr int kThreads = 256;       // 16 x 16 threads, 8 x 8 micro-tiles
constexpr int kRT = 16;             // samples per shared R tile
constexpr int kHalf = kTile / 2;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float reduce_2pi(float x) {
  return x - kTwoPi * rintf(x / kTwoPi);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads, 2)
factored_partial_kernel(const float* __restrict__ axis,   // (npix,)
                        const float* __restrict__ uv,     // (R, 2) scaled
                        const float* __restrict__ vis,    // (R, 2) re, im
                        int npix, int R, int chunk,
                        float* __restrict__ partial) {    // (S, npix, npix)
  __shared__ float4 s_smp[kRT];
  __shared__ __align__(16) float s_p1[kRT][kTile];
  __shared__ __align__(16) float s_p2[kRT][kTile];
  __shared__ __align__(16) float s_cb[kRT][kTile];
  __shared__ __align__(16) float s_sb[kRT][kTile];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;

  // build phase: thread owns one row (and one column) of the tile and
  // samples tid / kTile + 2 j
  const int br = tid % kTile;
  const int r_sub = tid / kTile;
  const float l_row = row0 + br < npix ? axis[row0 + br] : 0.0f;
  const float m_col = col0 + br < npix ? axis[col0 + br] : 0.0f;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(R, r_begin + chunk);
  for (int base = r_begin; base < r_end; base += kRT) {
    if (tid < kRT) {
      const int r = base + tid;
      s_smp[tid] = r < r_end
          ? make_float4(uv[2 * r], uv[2 * r + 1], vis[2 * r], vis[2 * r + 1])
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRT / 2; ++j) {
      const int rr = r_sub + 2 * j;
      const float4 smp = s_smp[rr];
      float sa, ca, sb, cb;
      __sincosf(reduce_2pi(l_row * smp.x), &sa, &ca);
      __sincosf(reduce_2pi(m_col * smp.y), &sb, &cb);
      s_p1[rr][br] = ca * smp.z + sa * smp.w;
      s_p2[rr][br] = ca * smp.w - sa * smp.z;
      s_cb[rr][br] = cb;
      s_sb[rr][br] = sb;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kRT; ++r) {
      const float4 p1lo = load4(&s_p1[r][ty * 4]);
      const float4 p1hi = load4(&s_p1[r][kHalf + ty * 4]);
      const float4 p2lo = load4(&s_p2[r][ty * 4]);
      const float4 p2hi = load4(&s_p2[r][kHalf + ty * 4]);
      const float4 cblo = load4(&s_cb[r][tx * 4]);
      const float4 cbhi = load4(&s_cb[r][kHalf + tx * 4]);
      const float4 sblo = load4(&s_sb[r][tx * 4]);
      const float4 sbhi = load4(&s_sb[r][kHalf + tx * 4]);
      const float a1[8] = {p1lo.x, p1lo.y, p1lo.z, p1lo.w,
                           p1hi.x, p1hi.y, p1hi.z, p1hi.w};
      const float a2[8] = {p2lo.x, p2lo.y, p2lo.z, p2lo.w,
                           p2hi.x, p2hi.y, p2hi.z, p2hi.w};
      const float b1[8] = {cblo.x, cblo.y, cblo.z, cblo.w,
                           cbhi.x, cbhi.y, cbhi.z, cbhi.w};
      const float b2[8] = {sblo.x, sblo.y, sblo.z, sblo.w,
                           sbhi.x, sbhi.y, sbhi.z, sbhi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(a2[i], b2[j], fmaf(a1[i], b1[j], acc[i][j]));
    }
    __syncthreads();
  }

  float* dst = partial + static_cast<int64_t>(blockIdx.z) * npix * npix;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? ty * 4 + i : kHalf + ty * 4 + i - 4);
    if (row >= npix) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : kHalf + tx * 4 + j - 4);
      if (col < npix) dst[static_cast<int64_t>(row) * npix + col] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(256)
factored_reduce_kernel(const float* __restrict__ partial, int64_t P, int S,
                       int R, float* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (p >= P) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += partial[s * P + p];
  out[p] = acc / static_cast<float>(R);
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns the cudaError_t of the launches
// (0 on success).  The caller allocates `partial` (n_split * npix^2 floats)
// and `out` (npix^2 floats); nothing is allocated or synchronised here.
int factored_image_launch(const float* axis, const float* uv,
                          const float* vis, float* partial, float* out,
                          int npix, int R, int n_split, int chunk,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (npix + kTile - 1) / kTile;
  const dim3 grid1(tiles, tiles, n_split);
  factored_partial_kernel<<<grid1, kThreads, 0, st>>>(axis, uv, vis, npix, R,
                                                      chunk, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t P = static_cast<int64_t>(npix) * npix;
  const dim3 grid2(static_cast<unsigned>((P + 255) / 256));
  factored_reduce_kernel<<<grid2, 256, 0, st>>>(partial, P, n_split, R, out);
  return static_cast<int>(cudaGetLastError());
}

const char* factored_image_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
