// Rank-factored imager for Hopper (sm_90a): an entry point of the shared
// separable-grid engine (separable_imager.cuh), and its bf16 mode.
//
// Replaces the Pallas TPU kernel smartcal_tpu/ops/pallas_imager.py
// `_factored_kernel` (wrapper `dirty_image_factored_pallas`), the
// influence-map imager from npix >= 512:
//
//   img[i, j] = (1/R) sum_r [p1[i,r] cb[j,r] + p2[i,r] sb[j,r]],
//   p1 = cos(a) v_re + sin(a) v_im,  p2 = cos(a) v_im - sin(a) v_re,
//   a = l_i u_r,  b = m_j v_r,  cb = cos(b),  sb = sin(b),
//
// each phase reduced mod 2 pi before the trig, as the TPU kernel does.
//
// f32 mode (`factored_image_launch`).  Bound: 4 npix^2 R flops (2.74e12 at
// npix=1024, R=652800): >= 16.6 ms as 3xTF32 at the H100 SXM's 495 TFLOP/s
// dense TF32 rate (>= 41 ms in FP32 on the CUDA cores); the 4 npix R
// sine/cosine values and the bytes are far below.  Bound by operations.
// The design (trig operands made on chip beside the asynchronous wgmma, A
// in registers and B in shared memory, 3xTF32 split, split R with a
// fixed-order second pass) is the engine's; see separable_imager.cuh.
//
// bf16 mode (`factored_image_bf16_launch`): the TPU kernel with
// dt = bfloat16 (pallas_imager.py:176-178) rounds p1, p2, cb and sb to bf16
// and accumulates their products in f32.  Here the trig and the phase
// reduction are the f32 mode's; each of the four operands is rounded to
// nearest even (cvt.rn.bf16x2.f32) and the tensor cores take one
// `wgmma.m64n128k16.f32.bf16.bf16` per 16-deep k-step (a bf16 product is
// exact in f32), where 3xTF32 takes three 8-deep ones.
//
// Bound (bf16).  The same 2.74e12 flops at the 989 TFLOP/s dense BF16 rate:
// >= 2.77 ms; the 4 npix R sine/cosine values on the SFUs (16 per clock
// per SM at 1.98 GHz) >= 0.64 ms; the bytes ~0.01 ms.  Bound by operations.
// The engine's design remakes, in each of the (npix/128)^2 output tiles,
// the trig of its 128 rows and 128 columns for every sample: 256 sine/
// cosine pairs per sample and tile, 1.07e10 pairs at those shapes, ~5 ms
// on the SFUs.  So in this mode the trig, not the tensor cores, is likely
// what sets the time; a later redesign would share the trig across tiles.
//
// Design (bf16).  The engine's pipeline with a 32-sample stage, so that one
// stage of B is again a 128-byte row per output column (64 bf16: cb of the
// stage's 32 samples and sb of them) and the 128-byte swizzle, its
// descriptor and the 32-byte advance per k-step stay the f32 mode's:
//  - A (p1 | p2) lives in registers in the m16n8k16 fragment layout of
//    `wgmma` with A from registers: k-step kk of a stage holds k 0..7 =
//    p1 of samples 8 kk .. 8 kk + 7 and k 8..15 = p2 of the same samples,
//    so thread (g, t) makes rows g and g + 8 of samples 8 kk + 2t, +1;
//  - B (cb | sb) lives in shared memory: 16-byte chunk 2 kk of a column's
//    row holds cb of samples 8 kk .. 8 kk + 7, chunk 2 kk + 1 their sb;
//  - two stages form a ring: while the tensor cores run stage t's four
//    asynchronous products, the same threads build stage t+1;
//  - the tensor cores' f32 accumulation is not rounded to nearest, so the
//    sum restarts every kPromoteBf16 stages (128 samples, as the f32 mode)
//    and is added into an f32 register accumulator on the CUDA cores;
//  - R is split across gridDim.z and the engine's second pass adds the
//    partial images in a fixed order (no atomics: two launches give the
//    same bits).  Ragged npix and R are masked as in the f32 mode.
// The f32 mode's engine (separable_imager.cuh) is shared with dft_imager.cu
// and is used here unchanged.

#include "separable_imager.cuh"

namespace separable_bf16 {

using separable::Block;
using separable::kAcc;
using separable::kTile;
using separable::kThreads;

constexpr int kSamples = 32;              // samples per stage
constexpr int kSteps = kSamples / 8;      // 16-deep k-steps per stage
constexpr int kStages = 2;
constexpr int kPlane = kTile * 32;        // floats of one stage's B (16 KB)
constexpr int kSmemBytes =
    (kStages * kPlane + kStages * kSamples * 4) * 4 + 1024;
constexpr int kPromote = 4;               // stages per tensor-core partial
constexpr int kFrag = 4 * kSteps;         // A registers per stage

// two floats rounded to nearest even into one bf16x2 register: lo in the
// low half (the lower k index), hi in the high half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[kAcc],
                                              const uint32_t* a, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
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

// A fragments of one stage for the thread's rows g (l0) and g + 8 (l1) of
// its warp's 16, t = lane % 4: k-step kk holds {p1(g, s), p1(g, s+1)},
// {p1(g+8, s), p1(g+8, s+1)}, {p2(g, s), p2(g, s+1)}, {p2(g+8, s),
// p2(g+8, s+1)} with s = 8 kk + 2 t, the m16n8k16 layout's (g, 2t..2t+1),
// (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9).
__device__ __forceinline__ void produce_a(const float4* sm, float l0, float l1,
                                          int tq, uint32_t (&f)[kFrag]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const float4 s0 = sm[8 * kk + 2 * tq];
    const float4 s1 = sm[8 * kk + 2 * tq + 1];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float l = rr ? l1 : l0;
      float sa0, ca0, sa1, ca1;
      __sincosf(separable::reduce_2pi(l * s0.x), &sa0, &ca0);
      __sincosf(separable::reduce_2pi(l * s1.x), &sa1, &ca1);
      f[4 * kk + rr] = pack_bf16(ca0 * s0.z + sa0 * s0.w,
                                 ca1 * s1.z + sa1 * s1.w);
      f[4 * kk + 2 + rr] = pack_bf16(ca0 * s0.w - sa0 * s0.z,
                                     ca1 * s1.w - sa1 * s1.z);
    }
  }
}

// B of one stage, row `col`: chunk 2 kk holds cos b of samples 8 kk ..
// 8 kk + 7, chunk 2 kk + 1 their sin b; thread half h makes k-steps 2h and
// 2h + 1 (samples 16 h .. 16 h + 15)
__device__ __forceinline__ void produce_b(float* plane, const float4* sm,
                                          float m, int col, int half) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int kk = 2 * half + c;
    float cv[8], sv[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      __sincosf(separable::reduce_2pi(m * sm[8 * kk + q].y), &sv[q], &cv[q]);
    *reinterpret_cast<uint4*>(plane + separable::swizzled(col, 2 * kk)) =
        make_uint4(pack_bf16(cv[0], cv[1]), pack_bf16(cv[2], cv[3]),
                   pack_bf16(cv[4], cv[5]), pack_bf16(cv[6], cv[7]));
    *reinterpret_cast<uint4*>(plane + separable::swizzled(col, 2 * kk + 1)) =
        make_uint4(pack_bf16(sv[0], sv[1]), pack_bf16(sv[2], sv[3]),
                   pack_bf16(sv[4], sv[5]), pack_bf16(sv[6], sv[7]));
  }
}

// the 4 products of one stage for this warpgroup's 64 rows, asynchronous;
// scale_d = 0 restarts the tensor-core sum
__device__ __forceinline__ void issue_wgmma(const float* plane,
                                            uint32_t (&a)[kFrag],
                                            float (&part)[kAcc], int scale_d) {
  const uint64_t b = separable::smem_desc(plane);
  separable::fence_acc(part);
  fence_frag(a);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_bf16_rs(part, a + 4 * kk, b + 2 * kk, kk == 0 ? scale_d : 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  separable::fence_acc(part);
}

// stage t: issue its products (A in cur), build stage t+1 (A into nxt, B
// into the other plane), stage the samples of t+2, wait, promote
__device__ __forceinline__ void step(const Block& c, int t,
                                     uint32_t (&cur)[kFrag],
                                     uint32_t (&nxt)[kFrag],
                                     float (&part)[kAcc], float (&acc)[kAcc]) {
  const int r2 = c.r_begin + (t + 2) * kSamples + c.tid;
  const float4 ahead = c.tid < kSamples && r2 < c.r_end
                           ? __ldg(c.smp + r2)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  issue_wgmma(c.planes + (t & 1) * kPlane, cur, part,
              t % kPromote == 0 ? 0 : 1);
  if (t + 1 < c.n_t) {
    const float4* sm = c.samp + ((t + 1) & 1) * kSamples;
    produce_a(sm, c.l0, c.l1, c.tq, nxt);
    produce_b(c.planes + ((t + 1) & 1) * kPlane, sm, c.m, c.col, c.half);
    separable::fence_proxy_async();
  }
  if (c.tid < kSamples) c.samp[(t & 1) * kSamples + c.tid] = ahead;
  separable::wait_wgmma(part);
  fence_frag(cur);
  if (t % kPromote == kPromote - 1 || t == c.n_t - 1) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
partial_kernel(const float* __restrict__ axis,   // (npix,)
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
  c.samp = reinterpret_cast<float4*>(smem + kStages * kPlane);
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
  uint32_t f0[kFrag], f1[kFrag];
#pragma unroll
  for (int i = 0; i < kFrag; ++i) f0[i] = f1[i] = 0u;

  if (c.tid < 2 * kSamples) {
    const int r = c.r_begin + c.tid;
    c.samp[c.tid] = r < c.r_end ? __ldg(smp + r)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  if (c.n_t > 0) {
    produce_a(c.samp, c.l0, c.l1, c.tq, f0);
    produce_b(c.planes, c.samp, c.m, c.col, c.half);
    separable::fence_proxy_async();
  }
  __syncthreads();
  for (int t = 0; t < c.n_t; t += 2) {
    step(c, t, f0, f1, part, acc);
    if (t + 1 < c.n_t) step(c, t + 1, f1, f0, part, acc);
  }

  float* dst = partial + static_cast<int64_t>(blockIdx.z) * npix * npix;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    // the m64nNk16 accumulator has the m64nNk8 layout (separable_imager.cuh)
    const int t = c.tid & 127, j = i >> 2, h = (i >> 1) & 1, e = i & 1;
    const int r = row0 + (c.tid >> 7) * 64 + (t >> 5) * 16 + ((t & 31) >> 2)
                  + 8 * h;
    const int cc = col0 + 8 * j + 2 * (t & 3) + e;
    if (r < npix && cc < npix)
      dst[static_cast<int64_t>(r) * npix + cc] = acc[i];
  }
}

// both passes on `stream`, the engine's contract (separable::image_launch)
inline int image_launch(const float* axis, const float* samples,
                        float* partial, float* out, int npix, int R,
                        int n_split, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (npix + kTile - 1) / kTile;
  const dim3 grid1(tiles, tiles, n_split);
  partial_kernel<<<grid1, kThreads, kSmemBytes, st>>>(
      axis, reinterpret_cast<const float4*>(samples), npix, R, chunk, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t P = static_cast<int64_t>(npix) * npix;
  const dim3 grid2(static_cast<unsigned>((P + 255) / 256));
  separable::separable_reduce_kernel<<<grid2, 256, 0, st>>>(
      partial, P, n_split, R, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace separable_bf16

extern "C" {

// See separable::image_launch.
int factored_image_launch(const float* axis, const float* samples,
                          float* partial, float* out, int npix, int R,
                          int n_split, int chunk, void* stream) {
  return separable::image_launch(axis, samples, partial, out, npix, R,
                                 n_split, chunk, stream);
}

const char* factored_image_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The bf16 mode, with the same arguments as factored_image_launch.
int factored_image_bf16_launch(const float* axis, const float* samples,
                               float* partial, float* out, int npix, int R,
                               int n_split, int chunk, void* stream) {
  return separable_bf16::image_launch(axis, samples, partial, out, npix, R,
                                      n_split, chunk, stream);
}

const char* factored_image_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
