// Direct-DFT dirty imager for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel smartcal_tpu/ops/pallas_imager.py
// `_imager_kernel` (wrapper `dirty_image_pallas`).  It computes
//
//     img[p] = (1/R) * sum_r [cos(phi_pr) v_re[r] + sin(phi_pr) v_im[r]],
//     phi_pr = l_p * u_r + m_p * v_r,
//
// with the same explicit mod-2pi range reduction before the trig:
// phi - 2pi * rint(phi / 2pi), a true (IEEE) division and round-half-even,
// as jnp.round does.
//
// Design.  The TPU kernel carries each output tile across the R axis of a
// sequential grid; CUDA blocks run in parallel, so here each thread owns two
// pixels and LOOPS over R, in tiles of 256 samples (u, v, v_re, v_im) that
// the block stages in shared memory, one float4 per sample.  At the
// episode's shapes (P = 16384 pixels) one block per 512 pixels gives only 32
// blocks for 132 SMs, so R is split
// into S chunks along gridDim.y: pass 1 writes an (S, P) buffer of partial
// sums, pass 2 adds the S partials of each pixel in a FIXED order and divides
// by the true R.  No atomics, so the image is bit-reproducible.  The ragged
// R tail is masked inside the loop (no host-side zero padding).
//
// Bound.  Per (pixel, sample) pair the work is one sine and one cosine on the
// special-function units (16 results per clock per SM on sm_90) plus a
// handful of FP32 operations; 2*P*R transcendentals (~1.24e9 per band at
// P = 16384, R = 37820) make the SFU bound ~0.3 ms per band on an H100 SXM,
// derived from the data sheet.  Memory traffic (R*16 + P*12 bytes, ~0.6 MB)
// is negligible.
//
// Trig choice: the fast __sincosf.  After the range reduction its argument
// lies in [-pi, pi], where its absolute error is ~4e-7, far inside the
// imager's rtol 2e-4 / atol 2e-5; chip_smoke.py measures the error against
// the plain PyTorch version on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads per block = samples per R tile
constexpr int kPix = 2;           // pixels per thread
constexpr float kTwoPi = 6.28318530717958647692f;

__global__ void __launch_bounds__(kThreads)
dft_partial_kernel(const float* __restrict__ lm,    // (P, 2)
                   const float* __restrict__ uv,    // (R, 2) scaled u, v
                   const float* __restrict__ vis,   // (R, 2) re, im
                   int P, int R, int chunk,
                   float* __restrict__ partial) {   // (S, P)
  // one (u, v, re, im) sample per float4: a single 16-byte shared load
  // feeds kPix pixels
  __shared__ float4 s_smp[kThreads];

  const int p0 = blockIdx.x * (kThreads * kPix) + threadIdx.x;
  const int r_begin = blockIdx.y * chunk;
  const int r_end = min(R, r_begin + chunk);
  float l[kPix], m[kPix], acc[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = p0 + k * kThreads;
    l[k] = p < P ? lm[2 * p] : 0.0f;
    m[k] = p < P ? lm[2 * p + 1] : 0.0f;
    acc[k] = 0.0f;
  }
  for (int base = r_begin; base < r_end; base += kThreads) {
    const int r = base + threadIdx.x;
    if (r < r_end) {
      s_smp[threadIdx.x] = make_float4(uv[2 * r], uv[2 * r + 1], vis[2 * r],
                                       vis[2 * r + 1]);
    }
    __syncthreads();
    const int n = min(kThreads, r_end - base);   // masks the ragged tail
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 smp = s_smp[j];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        float ph = l[k] * smp.x + m[k] * smp.y;
        ph = ph - kTwoPi * rintf(ph / kTwoPi);
        float s, c;
        __sincosf(ph, &s, &c);
        acc[k] += c * smp.z + s * smp.w;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = p0 + k * kThreads;
    if (p < P) partial[static_cast<size_t>(blockIdx.y) * P + p] = acc[k];
  }
}

__global__ void __launch_bounds__(kThreads)
dft_reduce_kernel(const float* __restrict__ partial, int P, int S, int R,
                  float* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += partial[static_cast<size_t>(s) * P + p];
  out[p] = acc / static_cast<float>(R);
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns the cudaError_t of the launches
// (0 on success).  The caller allocates `partial` (n_split * P floats) and
// `out` (P floats); nothing is allocated or synchronised here.
int dft_image_launch(const float* lm, const float* uv, const float* vis,
                     float* partial, float* out, int P, int R, int n_split,
                     int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1((P + kThreads * kPix - 1) / (kThreads * kPix), n_split);
  dft_partial_kernel<<<grid1, kThreads, 0, st>>>(lm, uv, vis, P, R, chunk,
                                                 partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((P + kThreads - 1) / kThreads);
  dft_reduce_kernel<<<grid2, kThreads, 0, st>>>(partial, P, n_split, R, out);
  return static_cast<int>(cudaGetLastError());
}

const char* dft_image_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
