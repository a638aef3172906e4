// Separable-grid imaging engine for Hopper (sm_90a), shared by
// dft_imager.cu and factored_imager.cu.
//
// Both TPU kernels of smartcal_tpu/ops/pallas_imager.py image the SAME
// function on the separable pixel grid l_i = m_i = (i - npix/2) * cell:
// `_imager_kernel` (the direct DFT, wrapper `dirty_image_pallas`) and
// `_factored_kernel` (wrapper `dirty_image_factored_pallas`).  By angle
// addition, cos(a+b) vr + sin(a+b) vi = cb (ca vr + sa vi) + sb (ca vi - sa vr)
// with a = l_i u_r and b = m_j v_r, so
//
//   img[i, j] = (1/R) sum_r [p1[i,r] cb[j,r] + p2[i,r] sb[j,r]],
//   p1 = ca vr + sa vi,  p2 = ca vi - sa vr,
//
// one GEMM of depth K = 2R: A = [p1 | p2] (rows), B = [cb | sb] (columns).
// Each phase is reduced as the TPU kernels do, x - 2pi * rint(x / 2pi)
// (round-half-even), before __sincosf.
//
// Bound.  The product is 4 npix^2 R flops (2.74e12 at npix=1024,
// R=652800).  In FP32 on the CUDA cores that is >= 41 ms at the H100 SXM's
// 67 TFLOP/s.  This engine runs it on the TF32 tensor cores as 3xTF32: each
// operand x is split into a TF32 big part and small = x - big, and
// big*big + big*small + small*big keep ~21 bits of each product (f32 level;
// 1xTF32 would keep ~11 and is not used).  Three products at the 495
// TFLOP/s dense TF32 rate are >= 16.6 ms at those shapes.  The trig needs
// 4 npix R sine/cosine values at least; the bytes (16 B per sample in, 4 B
// per pixel out) are negligible.  So it is bound by operations.
//
// Design.  One block of two warpgroups (256 threads) per 128x128 output
// tile and R chunk; the trig operands are made on chip and never reach
// device memory.  Per stage of 16 samples (GEMM depth 32):
//  - A lives in registers, in the fragment layout of `wgmma` with A from
//    registers: each thread computes the p1/p2 of its own 2 rows x 4
//    samples (8 sine/cosine pairs) and splits them into big and small;
//  - B lives in shared memory in the K-major 128-byte-swizzled layout
//    `wgmma` reads (a 128-byte row of 32 k per output column, 16-byte chunk
//    c of row r at chunk c ^ (r & 7)): each thread computes cos b / sin b of
//    one column x 8 samples (8 pairs) and stores their big and small parts;
//  - the 16 samples (u, v, re, im) are staged through shared memory, fetched
//    two stages ahead.
// Two stages form a ring: while the tensor cores run the 12 asynchronous
// `wgmma.m64n128k8.f32.tf32.tf32` of stage t (each warpgroup its 64 rows;
// per 8-deep k-step small*big, big*small, big*big), the same threads build
// stage t+1, so the trig overlaps the MACs.  Keeping A out of shared memory
// cuts the shared-memory traffic per stage from 208 KB to 128 KB.  The
// tensor cores' f32 accumulation is not rounded to nearest and drifts over
// long sums: summed over a whole R chunk, a coherent image is off by 2.8e-3
// relative, 13x the DFT tolerance (`chip_smoke.py --ablation`, PERF.md).  So
// the tensor-core sum restarts every kPromote stages and is added into an
// f32 register accumulator on the CUDA cores (round to nearest).  R is
// split across gridDim.z so that the tiles fill the card once (one block
// per SM); a second pass adds the partial images in a fixed order and
// divides by the true R (no atomics, bit-reproducible).  Ragged npix and R
// are masked in the kernel: rows and columns past npix are not stored, and
// samples past R enter as zeros.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace separable {

constexpr int kTile = 128;                 // output rows = columns per block
constexpr int kThreads = 256;              // two warpgroups
constexpr int kSamples = 16;               // samples per stage
constexpr int kDepth = 2 * kSamples;       // GEMM depth per stage: 128 B/row
constexpr int kStages = 2;
constexpr int kPlane = kTile * kDepth;     // floats of one B part
constexpr int kPlanes = kStages * 2 * kPlane;  // B big and small per stage
constexpr int kSmemBytes = (kPlanes + kStages * kSamples * 4) * 4 + 1024;
constexpr int kPromote = 8;                // stages per tensor-core partial
constexpr int kAcc = 64;                   // accumulators per thread
constexpr int kFrag = 16;                  // A registers per stage and part
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInvTwoPi = 0.159154943091895335769f;
constexpr float kRoundMagic = 12582912.0f;   // 1.5 * 2^23
constexpr float kSplitter = 8193.0f;         // 2^13 + 1

// x - 2pi rint(x / 2pi) with full-rate FP32 operations only: the quotient is
// the reciprocal product with one FMA correction (the correctly rounded
// x / 2pi but in rare double-rounding cases, where k moves by one and the
// argument by 2pi, which leaves the trig as it is), rounded half-even by
// adding and subtracting 1.5 * 2^23 (exact for |x / 2pi| < 2^22).  With the
// IEEE division and rintf the operand build, not the tensor cores, sets the
// pace: 2.5x the kernel's time (`chip_smoke.py --ablation`, PERF.md).
__device__ __forceinline__ float reduce_2pi(float x) {
  const float q0 = x * kInvTwoPi;
  const float q = fmaf(fmaf(-q0, kTwoPi, x), kInvTwoPi, q0);
  const float k = __fsub_rn(__fadd_rn(q, kRoundMagic), kRoundMagic);
  return fmaf(-kTwoPi, k, x);
}

// 3xTF32 operand split by Veltkamp's method: big holds the top 11
// significant bits of x (a TF32 value, rounded to nearest), small = x - big
// exactly; the tensor cores read the top 11 bits of small.  FP32 adds and
// multiplies, not the integer pipe that cvt.rna.tf32 takes.
__device__ __forceinline__ void split_tf32(float x, float& big, float& small) {
  const float t = __fmul_rn(x, kSplitter);
  big = __fsub_rn(t, __fsub_rn(t, x));
  small = __fsub_rn(x, big);
}

// float offset of 16-byte chunk `chunk` of row `row` in a swizzled plane
__device__ __forceinline__ int swizzled(int row, int chunk) {
  return row * kDepth + ((chunk ^ (row & 7)) << 2);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ------------------------------------------------------------------

// K-major, 128-byte swizzle: rows of 128 B, 8-row groups 1024 B apart
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wait_wgmma(float (&part)[kAcc]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(part);
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[kAcc],
                                              const uint32_t* a, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fence_frag(uint32_t (&f)[kFrag]) {
#pragma unroll
  for (int i = 0; i < kFrag; ++i) asm volatile("" : "+r"(f[i])::"memory");
}

__device__ __forceinline__ void split_u32(float x, uint32_t& big,
                                          uint32_t& small) {
  float b, s;
  split_tf32(x, b, s);
  big = __float_as_uint(b);
  small = __float_as_uint(s);
}

// A fragments of one stage for the thread's rows g (l0) and g + 8 (l1) of
// its warp's 16, t = lane % 4: k-step kk holds (g, k t), (g+8, k t),
// (g, k t+4), (g+8, k t+4) = p1, p1, p2, p2 of sample 4 kk + t.  B orders
// its k the same way (produce_b).
__device__ __forceinline__ void produce_a(const float4* sm, float l0, float l1,
                                          int tq, uint32_t (&big)[kFrag],
                                          uint32_t (&small)[kFrag]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float4 s = sm[4 * kk + tq];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float sa, ca;
      __sincosf(reduce_2pi((rr ? l1 : l0) * s.x), &sa, &ca);
      split_u32(ca * s.z + sa * s.w, big[4 * kk + rr], small[4 * kk + rr]);
      split_u32(ca * s.w - sa * s.z, big[4 * kk + 2 + rr],
                small[4 * kk + 2 + rr]);
    }
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// B planes of one stage, row `col`: chunk 2 kk holds cos b of samples
// 4 kk .. 4 kk + 3, chunk 2 kk + 1 their sin b
__device__ __forceinline__ void produce_b(float* big, float* small,
                                          const float4* sm, float m, int col,
                                          int half) {
  float cv[8], sv[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    __sincosf(reduce_2pi(m * sm[8 * half + q].y), &sv[q], &cv[q]);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int kk = 2 * half + c;
    float b[4], t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(cv[4 * c + e], b[e], t[e]);
    int off = swizzled(col, 2 * kk);
    store4(big + off, b);
    store4(small + off, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(sv[4 * c + e], b[e], t[e]);
    off = swizzled(col, 2 * kk + 1);
    store4(big + off, b);
    store4(small + off, t);
  }
}

// the 12 products of one stage for this warpgroup's 64 rows, asynchronous;
// scale_d = 0 restarts the tensor-core sum
__device__ __forceinline__ void issue_wgmma(const float* planes,
                                            uint32_t (&ab)[kFrag],
                                            uint32_t (&as)[kFrag],
                                            float (&part)[kAcc], int scale_d) {
  const uint64_t b_big = smem_desc(planes);
  const uint64_t b_small = smem_desc(planes + kPlane);
  fence_acc(part);
  fence_frag(ab);
  fence_frag(as);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t k = 2 * kk;
    wgmma_tf32_rs(part, as + 4 * kk, b_big + k, kk == 0 ? scale_d : 1);
    wgmma_tf32_rs(part, ab + 4 * kk, b_small + k, 1);
    wgmma_tf32_rs(part, ab + 4 * kk, b_big + k, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_acc(part);
}

// what every stage of a block reads
struct Block {
  float* planes;
  float4* samp;
  const float4* smp;
  float l0, l1, m;
  int tid, tq, col, half, r_begin, r_end, n_t;
};

// stage t: issue its products (A in cb/cs), build stage t+1 (A into nb/ns,
// B into the other planes), stage the samples of t+2, wait, promote
__device__ __forceinline__ void step(const Block& c, int t,
                                     uint32_t (&cb)[kFrag],
                                     uint32_t (&cs)[kFrag],
                                     uint32_t (&nb)[kFrag],
                                     uint32_t (&ns)[kFrag],
                                     float (&part)[kAcc], float (&acc)[kAcc]) {
  const int r2 = c.r_begin + (t + 2) * kSamples + c.tid;
  const float4 nxt = c.tid < kSamples && r2 < c.r_end
                         ? __ldg(c.smp + r2)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  issue_wgmma(c.planes + (t & 1) * 2 * kPlane, cb, cs, part,
           t % kPromote == 0 ? 0 : 1);
  if (t + 1 < c.n_t) {
    const float4* sm = c.samp + ((t + 1) & 1) * kSamples;
    produce_a(sm, c.l0, c.l1, c.tq, nb, ns);
    float* nxt_planes = c.planes + ((t + 1) & 1) * 2 * kPlane;
    produce_b(nxt_planes, nxt_planes + kPlane, sm, c.m, c.col, c.half);
    fence_proxy_async();
  }
  if (c.tid < kSamples) c.samp[(t & 1) * kSamples + c.tid] = nxt;
  wait_wgmma(part);
  fence_frag(cb);
  fence_frag(cs);
  if (t % kPromote == kPromote - 1 || t == c.n_t - 1) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
separable_partial_kernel(const float* __restrict__ axis,   // (npix,)
                         const float4* __restrict__ smp,   // (R,) u v re im
                         int npix, int R, int chunk,
                         float* __restrict__ partial) {    // (S, npix, npix)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  float* smem = reinterpret_cast<float*>(
      smem_raw + ((1024 - (base_addr & 1023)) & 1023));
  Block c;
  c.planes = smem;
  c.samp = reinterpret_cast<float4*>(smem + kPlanes);
  c.smp = smp;
  c.tid = threadIdx.x;
  const int lane = c.tid & 31, g = lane >> 2;
  c.tq = lane & 3;
  c.col = c.tid & (kTile - 1);
  c.half = c.tid >> 7;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const int ra = row0 + (c.tid >> 7) * 64 + ((c.tid >> 5) & 3) * 16 + g;
  c.l0 = ra < npix ? axis[ra] : 0.0f;
  c.l1 = ra + 8 < npix ? axis[ra + 8] : 0.0f;
  c.m = col0 + c.col < npix ? axis[col0 + c.col] : 0.0f;
  c.r_begin = blockIdx.z * chunk;
  c.r_end = min(R, c.r_begin + chunk);
  c.n_t = c.r_begin < c.r_end
              ? (c.r_end - c.r_begin + kSamples - 1) / kSamples : 0;

  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.0f;
  uint32_t fb0[kFrag], fs0[kFrag], fb1[kFrag], fs1[kFrag];
#pragma unroll
  for (int i = 0; i < kFrag; ++i) fb0[i] = fs0[i] = fb1[i] = fs1[i] = 0u;

  if (c.tid < 2 * kSamples) {
    const int r = c.r_begin + c.tid;
    c.samp[c.tid] = r < c.r_end ? __ldg(smp + r)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  if (c.n_t > 0) {
    produce_a(c.samp, c.l0, c.l1, c.tq, fb0, fs0);
    produce_b(c.planes, c.planes + kPlane, c.samp, c.m, c.col, c.half);
    fence_proxy_async();
  }
  __syncthreads();
  for (int t = 0; t < c.n_t; t += 2) {
    step(c, t, fb0, fs0, fb1, fs1, part, acc);
    if (t + 1 < c.n_t) step(c, t + 1, fb1, fs1, fb0, fs0, part, acc);
  }

  float* dst = partial + static_cast<int64_t>(blockIdx.z) * npix * npix;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    // m64nNk8 accumulator: value i = 4 j + 2 h + e of thread t of warpgroup
    // w sits at row 64 w + 16 (t / 32) + (t % 32) / 4 + 8 h, column
    // 8 j + 2 (t % 4) + e
    const int t = c.tid & 127, j = i >> 2, h = (i >> 1) & 1, e = i & 1;
    const int r = row0 + (c.tid >> 7) * 64 + (t >> 5) * 16 + ((t & 31) >> 2)
                  + 8 * h;
    const int cc = col0 + 8 * j + 2 * (t & 3) + e;
    if (r < npix && cc < npix)
      dst[static_cast<int64_t>(r) * npix + cc] = acc[i];
  }
}

__global__ void __launch_bounds__(256)
separable_reduce_kernel(const float* __restrict__ partial, int64_t P, int S,
                        int R, float* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (p >= P) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += partial[s * P + p];
  out[p] = acc / static_cast<float>(R);
}

// Launches both passes on `stream`; returns the cudaError_t (0 on success).
// axis (npix,) holds l = m of the grid, samples (R, 4) the scaled u, v and
// the visibility's re, im (16-byte aligned); the caller allocates partial
// (n_split * npix^2 floats) and out (npix^2); nothing is allocated or
// synchronised here.
inline int image_launch(const float* axis, const float* samples,
                        float* partial, float* out, int npix, int R,
                        int n_split, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      separable_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (npix + kTile - 1) / kTile;
  const dim3 grid1(tiles, tiles, n_split);
  separable_partial_kernel<<<grid1, kThreads, kSmemBytes, st>>>(
      axis, reinterpret_cast<const float4*>(samples), npix, R, chunk, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t P = static_cast<int64_t>(npix) * npix;
  const dim3 grid2(static_cast<unsigned>((P + 255) / 256));
  separable_reduce_kernel<<<grid2, 256, 0, st>>>(partial, P, n_split, R, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace separable
