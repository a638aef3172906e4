// Blocked residual-Hessian sums for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel smartcal_tpu/ops/pallas_hessian.py
// `_hessian_kernel` (wrappers `hessian_block_sums_pallas` and
// `hessian_res_core_pallas_sr`).  Per baseline b, direction k, over the Td
// samples of one calibration interval (split-real 2x2 complex blocks):
//
//   off[k,b,(i,u),(j,v)] = -sum_t conj(C[k,t,b])[i,j] * R[t,b][u,v]
//   Sp[k,b] = sum_t A1 A1^H,  A1 = C[k,t,b] conj(Jq[k,b])^T
//   Sq[k,b] = sum_t A2^H A2,  A2 = Jp[k,b] C[k,t,b]
//   Dsum[k,n] = sum_{b: p(b)=n} Sp[k,b] + sum_{b: q(b)=n} Sq[k,b]
//
// Design.  The TPU kernel accumulates Dsum in VMEM across a SEQUENTIAL grid
// over baseline tiles.  CUDA blocks run in parallel and in no order, so the
// station sums are a second pass:
//
// * pass 1: one thread per (k, b), grid (ceil(B/128), K).  Neighbouring
//   threads take neighbouring baselines, so the (..., B, 8) operand rows
//   are read as 32-byte float4 pairs, nearly fully coalesced.  Each thread
//   loops over t in registers (32 floats of off, 8 of Sp, 8 of Sq).  The
//   block's off rows are one contiguous range of the (K, B, 4, 4, 2) output:
//   they are staged in shared memory (row stride 33 floats, free of bank
//   conflicts) and written out coalesced.  Sp and Sq go to a (2, K, B, 8)
//   scratch.
// * pass 2: one thread per (k, station n, component), component fastest so
//   eight neighbouring threads read one 32-byte row.  It sums Sp over the
//   baselines whose p is n and Sq over those whose q is n, each list given
//   as a CSR (baselines sorted stably by station, offsets per station) that
//   the wrapper builds from p_idx / q_idx.  Indices >= N (pad sentinels) lie
//   past the last offset and are never read.  No atomics: the sum order is
//   fixed and the result is bit-reproducible.
//
// The ragged baseline edge is masked in pass 1; no host-side padding.
// Every offset that scales with K*Td*B is formed in 64 bits.
//
// Bound.  Per launch the kernel must read C5, R3, Jp, Jq once and write off
// and Dsum once: ~178 MB at K=10, Td=10, B=32640 (N=256), i.e. >= 53 us at
// the H100 SXM's 3.35 TB/s, against ~1.25 GFLOP (>= 19 us at 67 TFLOP/s
// FP32).  So it is bound by bytes; the design reads every operand once,
// coalesced, and keeps all per-sample algebra in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // baselines per pass-1 block
constexpr int kOffRow = 32;        // floats of off per (k, b)
constexpr int kPad = kOffRow + 1;  // shared row stride (no bank conflicts)

__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float (&re)[4], float (&im)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  // (2, 2, 2) split-real block: [i][j][z] -> re/im[i*2 + j]
  re[0] = a.x; im[0] = a.y; re[1] = a.z; im[1] = a.w;
  re[2] = b.x; im[2] = b.y; re[3] = b.z; im[3] = b.w;
}

__global__ void __launch_bounds__(kThreads)
hessian_pass1_kernel(const float* __restrict__ C5,   // (K, Td, B, 2, 2, 2)
                     const float* __restrict__ R3,   // (Td, B, 2, 2, 2)
                     const float* __restrict__ Jp,   // (K, B, 2, 2, 2)
                     const float* __restrict__ Jq,   // (K, B, 2, 2, 2)
                     int Td, int B,
                     float* __restrict__ off,        // (K, B, 4, 4, 2)
                     float* __restrict__ spsq) {     // (2, K, B, 8)
  __shared__ float s_off[kThreads * kPad];

  const int k = blockIdx.y;
  const int K = gridDim.y;
  const int b0 = blockIdx.x * kThreads;
  const int b = b0 + threadIdx.x;
  const bool live = b < B;

  float offr[16], offi[16], spr[4], spi[4], sqr[4], sqi[4];
#pragma unroll
  for (int i = 0; i < 16; ++i) offr[i] = offi[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) spr[i] = spi[i] = sqr[i] = sqi[i] = 0.0f;

  if (live) {
    const int64_t kb = static_cast<int64_t>(k) * B + b;
    float jpr[4], jpi[4], jqr[4], jqi[4];
    load8(Jp + kb * 8, jpr, jpi);
    load8(Jq + kb * 8, jqr, jqi);
    for (int t = 0; t < Td; ++t) {
      float cr[4], ci[4], rr[4], ri[4];
      load8(C5 + ((static_cast<int64_t>(k) * Td + t) * B + b) * 8, cr, ci);
      load8(R3 + (static_cast<int64_t>(t) * B + b) * 8, rr, ri);

      // off[(i,u),(j,v)] -= conj(C[i,j]) * R[u,v]
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int o = (i * 2 + u) * 4 + (j * 2 + v);
              const float xr = cr[i * 2 + j], xi = ci[i * 2 + j];
              const float yr = rr[u * 2 + v], yi = ri[u * 2 + v];
              offr[o] -= xr * yr + xi * yi;
              offi[o] -= xr * yi - xi * yr;
            }

      // A1[u,w] = sum_v C[u,v] conj(Jq[w,v]);  Sp[u,v] += sum_w A1[u,w]
      // conj(A1[v,w])
      float a1r[4], a1i[4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          float ar = 0.0f, ai = 0.0f;
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const float xr = cr[u * 2 + v], xi = ci[u * 2 + v];
            const float yr = jqr[w * 2 + v], yi = jqi[w * 2 + v];
            ar += xr * yr + xi * yi;
            ai += xi * yr - xr * yi;
          }
          a1r[u * 2 + w] = ar;
          a1i[u * 2 + w] = ai;
        }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const float xr = a1r[u * 2 + w], xi = a1i[u * 2 + w];
            const float yr = a1r[v * 2 + w], yi = a1i[v * 2 + w];
            spr[u * 2 + v] += xr * yr + xi * yi;
            spi[u * 2 + v] += xi * yr - xr * yi;
          }

      // A2[u,w] = sum_v Jp[u,v] C[v,w];  Sq[v,w] += sum_u conj(A2[u,v])
      // A2[u,w]
      float a2r[4], a2i[4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          float ar = 0.0f, ai = 0.0f;
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const float xr = jpr[u * 2 + v], xi = jpi[u * 2 + v];
            const float yr = cr[v * 2 + w], yi = ci[v * 2 + w];
            ar += xr * yr - xi * yi;
            ai += xr * yi + xi * yr;
          }
          a2r[u * 2 + w] = ar;
          a2i[u * 2 + w] = ai;
        }
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int w = 0; w < 2; ++w)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float xr = a2r[u * 2 + v], xi = a2i[u * 2 + v];
            const float yr = a2r[u * 2 + w], yi = a2i[u * 2 + w];
            sqr[v * 2 + w] += xr * yr + xi * yi;
            sqi[v * 2 + w] += xr * yi - xi * yr;
          }
    }

    const int64_t KB8 = static_cast<int64_t>(K) * B * 8;
    float4* sp = reinterpret_cast<float4*>(spsq + kb * 8);
    float4* sq = reinterpret_cast<float4*>(spsq + KB8 + kb * 8);
    sp[0] = make_float4(spr[0], spi[0], spr[1], spi[1]);
    sp[1] = make_float4(spr[2], spi[2], spr[3], spi[3]);
    sq[0] = make_float4(sqr[0], sqi[0], sqr[1], sqi[1]);
    sq[1] = make_float4(sqr[2], sqi[2], sqr[3], sqi[3]);
  }

  // stage this block's off rows, then write them out coalesced: rows
  // (k, b0 .. b0 + nb) are one contiguous range of the output
#pragma unroll
  for (int o = 0; o < 16; ++o) {
    s_off[threadIdx.x * kPad + 2 * o] = offr[o];
    s_off[threadIdx.x * kPad + 2 * o + 1] = offi[o];
  }
  __syncthreads();
  const int nb = min(kThreads, B - b0);
  float* dst = off + (static_cast<int64_t>(k) * B + b0) * kOffRow;
  for (int e = threadIdx.x; e < nb * kOffRow; e += kThreads) {
    dst[e] = s_off[(e / kOffRow) * kPad + (e % kOffRow)];
  }
}

__global__ void __launch_bounds__(256)
hessian_pass2_kernel(const float* __restrict__ spsq,   // (2, K, B, 8)
                     const int* __restrict__ p_perm,   // (B,) sorted by p
                     const int* __restrict__ p_off,    // (N + 1,)
                     const int* __restrict__ q_perm,   // (B,) sorted by q
                     const int* __restrict__ q_off,    // (N + 1,)
                     int K, int B, int N,
                     float* __restrict__ dsum) {       // (K, N, 2, 2, 2)
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (g >= static_cast<int64_t>(K) * N * 8) return;
  const int comp = static_cast<int>(g % 8);
  const int n = static_cast<int>((g / 8) % N);
  const int k = static_cast<int>(g / (8 * static_cast<int64_t>(N)));
  const float* sp = spsq + static_cast<int64_t>(k) * B * 8 + comp;
  const float* sq = sp + static_cast<int64_t>(K) * B * 8;

  float acc_p = 0.0f;
  const int pe = p_off[n + 1];
#pragma unroll 8
  for (int i = p_off[n]; i < pe; ++i) {
    acc_p += sp[static_cast<int64_t>(p_perm[i]) * 8];
  }
  float acc_q = 0.0f;
  const int qe = q_off[n + 1];
#pragma unroll 8
  for (int i = q_off[n]; i < qe; ++i) {
    acc_q += sq[static_cast<int64_t>(q_perm[i]) * 8];
  }
  dsum[g] = acc_p + acc_q;
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns the cudaError_t of the launches
// (0 on success).  The caller allocates off (K*B*32 floats), spsq
// (2*K*B*8 floats) and dsum (K*N*8 floats); every float pointer must be
// 16-byte aligned.  Nothing is allocated or synchronised here.
int hessian_blocks_launch(const float* C5, const float* R3, const float* Jp,
                          const float* Jq, const int* p_perm,
                          const int* p_off, const int* q_perm,
                          const int* q_off, int K, int Td, int B, int N,
                          float* off, float* spsq, float* dsum,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1((B + kThreads - 1) / kThreads, K);
  hessian_pass1_kernel<<<grid1, kThreads, 0, st>>>(C5, R3, Jp, Jq, Td, B,
                                                   off, spsq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n2 = static_cast<int64_t>(K) * N * 8;
  const dim3 grid2(static_cast<unsigned>((n2 + 255) / 256));
  hessian_pass2_kernel<<<grid2, 256, 0, st>>>(spsq, p_perm, p_off, q_perm,
                                              q_off, K, B, N, dsum);
  return static_cast<int>(cudaGetLastError());
}

const char* hessian_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
