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
// dt = bfloat16 (`_factored_kernel`, pallas_imager.py:159, its dt at
// :176-178) rounds p1, p2, cb and sb to bf16 and accumulates their products
// in f32.  Here each of the four operands is rounded to nearest even
// (cvt.rn.bf16x2.f32) and the tensor cores take one
// `wgmma.m64n256k16.f32.bf16.bf16` per 16-deep k-step and warpgroup, both
// operands read from shared memory (a bf16 product is exact in f32).
//
// Bound (bf16).  The same 2.74e12 flops at the 989 TFLOP/s dense BF16 rate:
// >= 2.77 ms at npix=1024, R=652800; the 4 npix R sine/cosine values on the
// SFUs (16 per clock per SM at 1.98 GHz) >= 0.64 ms; the bytes ~0.01 ms.
// Bound by operations.  Two things stand between a kernel and that bound:
//  - the operands: remaking the trig of a tile's rows and columns for
//    every sample costs the SFUs about twice the tensor cores' time, and
//    when the same threads make operands and issue products in turn, the
//    two add up;
//  - shared memory: the tensor cores read both operands from it and the
//    operand makers write them into it, through one port per SM.
//
// Design (bf16).  One block of three warpgroups per SM and tile of 128 rows
// x 256 columns (`ops/factored_imager.bf16_plan`), warp-specialised on a
// ring of kRing 48 KB stages of 32 samples (GEMM depth 64) with full/empty
// mbarriers:
//  - the producer warpgroup writes A = p1 | p2 (128 rows) and B = cb | sb
//    (256 columns) of a stage in the K-major 128-byte-swizzled layout (row
//    r of a stage is 128 bytes, 16-byte chunk c at chunk c ^ (r & 7); chunk
//    2 kk holds p1 (cb) of samples 8 kk .. 8 kk + 7, chunk 2 kk + 1 their
//    p2 (sb));
//  - it makes no trig per (row, sample): the grid is uniform, l_k =
//    (k - npix/2) cell, so down a column of the tile the phasors of one
//    sample form a geometric progression.  A thread walks 8 rows (16
//    columns), 8 apart, of 4 samples: two reduced __sincosf per sample
//    start a walk and a three-term recurrence, two FFMAs per element,
//    makes the rest (see `walk`).  The phases differ from the reference's
//    f32 l u by its own rounding (~2^-24 |l u|), far below bf16's 2^-9;
//  - the two consumer warpgroups (64 rows each) only wait for a full
//    stage, issue its four asynchronous products and release it, so the
//    SFU and FP32 work runs beside the tensor cores.  The 128 x 256 tile
//    needs a fifth fewer shared-memory bytes per flop than 128 x 128 (B is
//    read once per 256 columns, and each operand row serves more of the
//    other), which is why a block has 384 threads: a consumer thread holds
//    128 accumulators, more than a 512-thread block's 128 registers allow;
//  - the tensor cores' f32 accumulation is not rounded to nearest, so the
//    sum restarts every kPromote stages (8192 samples) and is added, in
//    round to nearest, into the block's own slice of the partial images
//    (each element has one writer, in program order: two launches give
//    the same bits; `chip_smoke.py --bf16-ablation` measures the error of
//    the cadence on a coherent image against every 4 stages and never);
//  - R is split across gridDim.z so that the tiles fill the card once, and
//    the engine's second pass adds the partial images in a fixed order.
//    Rows and columns past npix are not stored; samples past R enter as
//    zeros (v = 0, so p1 = p2 = 0).
// The f32 mode's engine (separable_imager.cuh) is shared with dft_imager.cu
// and is used here unchanged; its phase reduction and constants are reused.

#include "separable_imager.cuh"

namespace separable_bf16 {

constexpr int kRows = 128;           // output rows per block (A: p1 | p2)
constexpr int kCols = 256;           // output columns per block (B: cb | sb)
constexpr int kAcc = 128;            // accumulators per consumer thread
constexpr int kSamples = 32;         // samples per stage
constexpr int kKSteps = 4;           // 16-deep k-steps per stage
constexpr int kRing = 4;             // stages in the ring
constexpr int kRowBytes = 128;       // a row (column) of one stage
constexpr int kABytes = kRows * kRowBytes;               // 16 KB
constexpr int kStageBytes = kABytes + kCols * kRowBytes;   // 48 KB
constexpr int kSmemBytes = kRing * kStageBytes + 2 * kRing * 8 + 1024;
constexpr int kThreads = 384;  // consumers: warpgroups 0, 1; producer 2
constexpr int kProducerThreads = 128;
constexpr int kConsumerWarps = 8;
constexpr int kPromote = 256;       // stages per tensor-core partial
constexpr int kStride = 8;          // rows (columns) between walk steps
// what the stages are made of; only chip_smoke.py --bf16-ablation builds
// copies with one of them off
constexpr bool kMakeOperands = true;   // else constant operands
constexpr bool kIssueWgmma = true;     // else no products

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats rounded to nearest even into one bf16x2 register: lo in the
// low half (the lower k index), hi in the high half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void st_shared_v2(uint32_t a, uint32_t x,
                                             uint32_t y) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n"
               :: "r"(a), "r"(x), "r"(y) : "memory");
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// K-major, 128-byte swizzle at shared address a (separable::smem_desc)
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[kAcc], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// what both roles of a block share
struct Ring {
  uint32_t stages;   // shared address of stage 0 (1024-byte aligned)
  uint32_t full;     // kRing mbarriers: the producer's 128 threads arrive
  uint32_t empty;    // kRing mbarriers: the consumers' 8 warps arrive
  int n_t;           // stages of this block's R chunk
};

// x - 2 pi k, the phase x reduced by k = rint(q) turns for q ~ x / 2 pi:
// where x / 2 pi lies within rounding of a half-integer k may differ from
// rint(x / 2 pi) by one, which moves the argument by 2 pi and leaves the
// trig as it is (separable::reduce_2pi corrects the quotient instead)
__device__ __forceinline__ float reduce_turns(float x, float q) {
  const float k = __fsub_rn(__fadd_rn(q, separable::kRoundMagic),
                            separable::kRoundMagic);
  return fmaf(-separable::kTwoPi, k, x);
}

// The walk of one operand for 4 samples: z_j (ar, ai) and z_{j+1} (br, bi)
// of each, and 2 cos(theta) (tc).
struct Walk {
  float ar[4], ai[4], br[4], bi[4], tc[4];
};

// The start of a walk (see `walk`) for samples s[0..3]: l = the phase
// factor of its first row, step = kStride cell; lq = l / 2 pi and
// sq = step / 2 pi, for the reduction.
template <bool kIsA>
__device__ __forceinline__ void start(Walk& z, const float4 (&s)[4],
                                      float l, float lq, float step,
                                      float sq) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = kIsA ? s[i].x : s[i].y;
    float sn, cs, ss, cc;
    __sincosf(reduce_turns(l * x, lq * x), &sn, &cs);
    __sincosf(reduce_turns(step * x, sq * x), &ss, &cc);
    if (kIsA) {                           // conj(e^{i l u}) (re + i im)
      z.ar[i] = cs * s[i].z + sn * s[i].w;
      z.ai[i] = cs * s[i].w - sn * s[i].z;
    } else {                              // e^{i m v}
      z.ar[i] = cs;
      z.ai[i] = sn;
    }
    // rows go by e^{-i theta} from one to the next, columns by e^{+i theta}
    const float wi = kIsA ? -ss : ss;
    z.br[i] = z.ar[i] * cc - z.ai[i] * wi;
    z.bi[i] = z.ar[i] * wi + z.ai[i] * cc;
    z.tc[i] = 2.0f * cc;
  }
}

// One operand of one stage from producer thread p (warpgroup 2): kIsA, A =
// p1 | p2 of the tile's 128 rows; else B = cb | sb of its 256 columns.
// Lane bits: sample quad q = lane % 8 (samples 4 q .. 4 q + 3 of the stage:
// k-step q / 2, 8-byte half q % 2 of its chunks) and, with the warp, the
// walk w = 4 warp + lane / 8 over rows r0 + 8 j, j < kWalk (8 for A, 16 for
// B), r0 = w % 8 + 8 kWalk (w / 8).  Per sample the walk starts (`start`)
// from one reduced __sincosf of its first row's phase (the reference's
// own, l u rounded in f32) and one of the step, theta = 8 cell u; after
// that z_{j+1} = 2 cos(theta) z_j - z_{j-1}, one FFMA per part (exact for
// z_j = A e^{-+i j theta}; its round-off grows at most as j^2 2^-24).  A
// walk keeps row % 8, so its swizzle and its store addresses are fixed but
// for 1024 j; the two walks of a half-warp have row % 8 of either parity,
// so its 16 8-byte stores fill the 32 banks.  base = the stage's shared
// address.
template <bool kIsA>
__device__ __forceinline__ void walk(Walk& z, uint32_t base, int p) {
  constexpr int kWalk = kIsA ? 8 : 16;
  const int lane = p & 31, q = lane & 7;
  const int w = (p >> 5) * 4 + (lane >> 3);
  const int r0 = (w & 7) + kStride * kWalk * (w >> 3), sw = w & 7;
  const uint32_t lo = 2 * (q >> 1);
  const uint32_t off =
      base + (kIsA ? 0 : kABytes) + r0 * kRowBytes + 8 * (q & 1);
  const uint32_t off1 = off + 16 * (lo ^ sw);
  const uint32_t off2 = off + 16 * ((lo + 1) ^ sw);
#pragma unroll
  for (int j = 0; j < kWalk; ++j) {
    uint32_t w0 = 0x3F803F80u, w1 = 0x3F803F80u;   // bf16 1.0, 1.0
    uint32_t w2 = 0x3F803F80u, w3 = 0x3F803F80u;
    if (kMakeOperands) {
      w0 = pack_bf16(z.ar[0], z.ar[1]);
      w1 = pack_bf16(z.ar[2], z.ar[3]);
      w2 = pack_bf16(z.ai[0], z.ai[1]);
      w3 = pack_bf16(z.ai[2], z.ai[3]);
    }
    st_shared_v2(off1 + j * kStride * kRowBytes, w0, w1);
    st_shared_v2(off2 + j * kStride * kRowBytes, w2, w3);
    if (kMakeOperands && j + 1 < kWalk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float nr = fmaf(z.tc[i], z.br[i], -z.ar[i]);
        const float ni = fmaf(z.tc[i], z.bi[i], -z.ai[i]);
        z.ar[i] = z.br[i];
        z.ai[i] = z.bi[i];
        z.br[i] = nr;
        z.bi[i] = ni;
      }
    }
  }
}

// Producer thread p (warpgroup 2): for every stage t of the chunk, wait
// for its ring slot to be empty, walk stage t's A and B (`walk`: the
// stores), then start stage t+1's walks (`start`: the sines and cosines,
// from its samples 4 q .. 4 q + 3, loaded a stage earlier), and only then
// fence and arrive on the slot's full barrier: the fence waits for the
// stores to drain, which they do behind the tensor cores' reads while the
// warpgroup's one warp per SM sub-partition makes the next start.  Samples
// past the chunk enter as zeros, so the start past the last stage is
// harmless.  row0, col0 = the tile's first row and column.
__device__ __forceinline__ void produce(const Ring& c, const float* axis,
                                        const float4* smp, int npix,
                                        int r_begin, int r_end, int row0,
                                        int col0, int p) {
  const int lane = p & 31, q = lane & 7;
  const int w = (p >> 5) * 4 + (lane >> 3);
  // the grid's spacing, exactly: axis[npix/2] = 0, axis[npix/2 - 1] = -cell
  const float cell = npix > 1 ? axis[npix / 2] - axis[npix / 2 - 1] : 0.0f;
  auto line = [&](int k) {    // the grid at k, also past npix
    return k < npix ? axis[k] : static_cast<float>(k - npix / 2) * cell;
  };
  const float la = line(row0 + (w & 7) + 64 * (w >> 3));
  const float lb = line(col0 + (w & 7) + 128 * (w >> 3));
  const float step = kStride * cell;
  const float laq = la * separable::kInvTwoPi;
  const float lbq = lb * separable::kInvTwoPi;
  const float sq = step * separable::kInvTwoPi;
  float4 nxt[4];
  auto load = [&](int t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r_begin + t * kSamples + 4 * q + i;
      nxt[i] = r < r_end ? __ldg(smp + r)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto begin = [&](Walk& za, Walk& zb) {  // the walks of nxt's stage
    float4 s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = nxt[i];
    start<true>(za, s, la, laq, step, sq);
    start<false>(zb, s, lb, lbq, step, sq);
  };
  auto stage = [&](int t, Walk& za, Walk& zb, Walk& na, Walk& nb) {
    const int slot = t % kRing;
    if (t >= kRing)
      bar_wait(c.empty + 8 * slot, ((t / kRing) + 1) & 1);
    const uint32_t base = c.stages + slot * kStageBytes;
    walk<true>(za, base, p);
    walk<false>(zb, base, p);
    if (kMakeOperands) {
      begin(na, nb);
      load(t + 2);
    }
    separable::fence_proxy_async();
    bar_arrive(c.full + 8 * slot);
  };
  Walk a0, b0, a1, b1;
  if (kMakeOperands) {
    load(0);
    begin(a0, b0);
    load(1);
  }
  for (int t = 0; t < c.n_t; t += 2) {
    stage(t, a0, b0, a1, b1);
    if (t + 1 < c.n_t) stage(t + 1, a1, b1, a0, b0);
  }
}

// Consumer warpgroup wg (rows 64 wg .. 64 wg + 63 of the tile): per stage
// wait until it is full, issue its 4 products and release it once they are
// done.  Every kPromote stages, and at the end, it waits for all of them
// and adds the tensor-core sum into the block's own slice of `partial`:
// each element has one writer, which stores it at the first promotion and
// adds to it (red.global.add, round to nearest; pairs of columns as one
// float2 where the tile lies inside the image) after, in program order, so
// the sum's order is fixed.  dst = partial + z npix^2.
__device__ __forceinline__ void consume(const Ring& c, int wg, float* dst,
                                        int npix, int row0, int col0) {
  float part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) part[i] = 0.0f;
  const int tt = threadIdx.x & 127;
  const int r = row0 + wg * 64 + (tt >> 5) * 16 + ((tt & 31) >> 2);
  const int cc0 = col0 + 2 * (tt & 3);
  const bool leader = (tt & 31) == 0;
  // a tile inside the image with 8-byte aligned pairs: unmasked float2s
  const bool inside = row0 + kRows <= npix && col0 + kCols <= npix
                      && npix % 2 == 0;
  bool pending = false;              // the previous stage is not released
  bool stored = false;               // dst holds a first partial
  for (int t = 0; t < c.n_t; ++t) {
    const int slot = t % kRing;
    bar_wait(c.full + 8 * slot, (t / kRing) & 1);
    if (kIssueWgmma) {
      const uint32_t st = c.stages + slot * kStageBytes;
      const uint64_t da = desc(st + wg * 64 * kRowBytes);
      const uint64_t db = desc(st + kABytes);
      fence_acc(part);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        wgmma_bf16_ss(part, da + 2 * kk, db + 2 * kk,
                      kk == 0 && t % kPromote == 0 ? 0 : 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(part);
    }
    if (t % kPromote == kPromote - 1 || t == c.n_t - 1) {
      if (kIssueWgmma) {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(part);
      }
      if (leader) {
        if (pending) bar_arrive(c.empty + 8 * ((t - 1) % kRing));
        bar_arrive(c.empty + 8 * slot);
      }
      pending = false;
      // the m64nNk16 accumulator: value i = 4 j + 2 h + e at row
      // (t / 32) 16 + (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + e
      if (inside) {
#pragma unroll
        for (int i = 0; i < kAcc; i += 2) {
          float2* a = reinterpret_cast<float2*>(
              dst + static_cast<int64_t>(r + 8 * ((i >> 1) & 1)) * npix
              + cc0 + 8 * (i >> 2));
          const float2 v = make_float2(part[i], part[i + 1]);
          if (stored)
            atomicAdd(a, v);
          else
            *a = v;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int rr = r + 8 * ((i >> 1) & 1);
          const int cc = cc0 + 8 * (i >> 2) + (i & 1);
          if (rr < npix && cc < npix) {
            float* a = dst + static_cast<int64_t>(rr) * npix + cc;
            if (stored)
              atomicAdd(a, part[i]);
            else
              *a = part[i];
          }
        }
      }
      stored = true;
    } else {
      if (kIssueWgmma) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(part);
      }
      if (leader && pending) bar_arrive(c.empty + 8 * ((t - 1) % kRing));
      pending = true;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
partial_kernel(const float* __restrict__ axis,   // (npix,) uniform grid
               const float4* __restrict__ smp,   // (R,) u v re im
               int npix, int R, int chunk,
               float* __restrict__ partial) {    // (S, npix, npix)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Ring c;
  c.stages = raw + ((1024 - (raw & 1023)) & 1023);
  c.full = c.stages + kRing * kStageBytes;
  c.empty = c.full + 8 * kRing;
  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(R, r_begin + chunk);
  c.n_t = r_begin < r_end ? (r_end - r_begin + kSamples - 1) / kSamples : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      bar_init(c.full + 8 * s, kProducerThreads);
      bar_init(c.empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const int row0 = blockIdx.y * kRows, col0 = blockIdx.x * kCols;
  if (wg == 2) {
    produce(c, axis, smp, npix, r_begin, r_end, row0, col0,
            threadIdx.x & 127);
    return;
  }
  consume(c, wg, partial + static_cast<int64_t>(blockIdx.z) * npix * npix,
          npix, row0, col0);
}

// both passes on `stream`, the engine's contract (separable::image_launch);
// axis must be the uniform grid (i - npix/2) cell of ops/dft_imager.axis_grid
// and chunk a multiple of kSamples with every chunk non-empty
// (ops/factored_imager.bf16_plan)
inline int image_launch(const float* axis, const float* samples,
                        float* partial, float* out, int npix, int R,
                        int n_split, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1((npix + kCols - 1) / kCols, (npix + kRows - 1) / kRows,
                   n_split);
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

// The bf16 mode, with the same arguments as factored_image_launch (axis
// the uniform grid (i - npix/2) cell; see separable_bf16::image_launch).
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
