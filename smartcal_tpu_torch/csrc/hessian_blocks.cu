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
// Bound.  Per launch the kernel must read C5, R3, Jp, Jq once and write off
// and Dsum once: ~178 MB at K=10, Td=10, B=32640 (N=256), i.e. >= 53 us at
// the H100 SXM's 3.35 TB/s.  Its arithmetic (below: 96 FMAs per sample,
// ~0.65 GFLOP in all) takes >= 10 us at 67 TFLOP/s FP32.  So it is bound by
// bytes, and the design is about moving each byte once with enough of them
// in flight, while the arithmetic stays small enough to hide under them.
//
// Algebra.  Sp and Sq depend on t only through C: with G = Jq^H Jq and
// H = Jp^H Jp (2x2, fixed per (k, b)),
//
//   Sp[u,u'] = sum_{v,v'} G[v,v'] Q[(u,v),(u',v')]
//   Sq[v,w]  = sum_{a,a'} H[a,a'] conj(Q[(a,v),(a',w)])
//   Q = sum_t vec(C) vec(C)^H    (4x4 Hermitian: 4 real + 6 complex)
//
// so a sample costs 32 FMAs for Q plus 64 for off, and J is read once per
// (k, b), after the t loop: a quarter of the 128 FMAs per sample of forming
// A1, A1 A1^H, A2 and A2^H A2.
//
// Design.  The baselines are cut into TILES of a kRows x kCols = 8 x 8 grid
// of CELLS, each cell one baseline or empty (-1), laid out by the host
// (ops/hessian_blocks.py).  For the full baseline set a tile is a block of
// 8 p-stations x 8 q-stations, so every baseline of a cell row shares its
// p and every baseline of a cell column shares its q; any other index set
// is laid out one baseline per row and column.  (4 x 16 and 2 x 32 read
// longer runs but were slower at N=256: 544 and 576 tiles against 528,
// where 2 waves of 264 CTAs take 528.)  One CTA takes one tile for ALL K
// directions:
//
// * 256 threads = 64 cells x 4 direction lanes; the directions go in chunks
//   of 4, and each thread keeps its (k, b) sums in registers over t (32
//   floats of off, 16 of Q), as the TPU kernel keeps a tile.
// * The tile's R3 (Td x 64 cells x 32 bytes) is copied into shared memory
//   once and read by every direction from there, so R3 leaves device
//   memory once (when Td is too large for that, each step copies its own
//   R3 row beside C5).
// * C5 streams through a 3-stage ring of cp.async copies over the (chunk,
//   t) steps: 2 steps (16 KB per CTA, 2 CTAs per SM) are in flight while a
//   step's algebra runs (4 and 5 stages were no faster).  Each thread
//   copies and reads only its own 32-byte slot, so the ring needs no
//   barrier.  A warp's 32 cells are 4 runs of 8 consecutive baselines:
//   256-byte runs, whole sectors.
// * At the end of a chunk the off rows of a warp are staged in shared
//   memory (row stride 36 floats: no bank conflicts for float4) and leave
//   as whole 128-byte lines.  Sp and Sq go to shared memory and are summed
//   along cell rows (p side) and cell columns (q side), each in cell
//   order, into one PARTIAL row per (tile, slot): (K, rows, 8), ~2.7 MB at
//   N=256.
// * A second short launch gives each (k, station) one warp: lane group
//   g = 0..3 sums the station's partial rows g, g+4, ... in order (the host
//   numbered them p side first, then q side, each in tile order), and the
//   four group sums are added as (g0 + g1) + (g2 + g3).
//
// No atomics anywhere: two launches on the same inputs give the same bits.
// Every offset that scales with K*Td*B is formed in 64 bits; empty cells
// and direction lanes past K are masked in the kernel, with no padding of
// the operands on the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;                   // p-stations per tile
constexpr int kCols = 8;                   // q-stations per tile
constexpr int kCells = kRows * kCols;      // baselines per tile
constexpr int kLanes = 4;                  // directions per chunk
constexpr int kThreads = kCells * kLanes;  // 256
constexpr int kStages = 3;                 // cp.async ring depth
constexpr int kSlots = kRows + kCols;      // partial rows per tile
constexpr int kSpqPad = 17;                // shared row stride of Sp|Sq
constexpr int kOffPad = 36;                // shared row stride of off
constexpr int kMaxSmem = 232448;           // per block, sm_90
constexpr int kGroups = 4;                 // row groups per combine warp

static_assert(kThreads % (2 * kCells) == 0, "R3 prologue mapping");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (2, 2, 2) split-real block: [i][j][z] -> re/im[i*2 + j]
__device__ __forceinline__ void split8(float4 a, float4 b, float (&re)[4],
                                       float (&im)[4]) {
  re[0] = a.x; im[0] = a.y; re[1] = a.z; im[1] = a.w;
  re[2] = b.x; im[2] = b.y; re[3] = b.z; im[3] = b.w;
}

__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float (&re)[4], float (&im)[4]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  split8(__ldg(q), __ldg(q + 1), re, im);
}

__device__ __forceinline__ void smem8(const float* p, float (&re)[4],
                                      float (&im)[4]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  split8(q[0], q[1], re, im);
}

// index of the pair (m, n), m < n, of the 4x4 upper triangle
__host__ __device__ constexpr int pair(int m, int n) {
  return m * (7 - m) / 2 + (n - m - 1);
}

// X^H X of a 2x2 complex X (re/im[i*2 + j]): out[a][a'] = sum_u
// conj(X[u][a]) X[u][a']
__device__ __forceinline__ void gram2(const float (&xr)[4],
                                      const float (&xi)[4], float (&gr)[4],
                                      float (&gi)[4]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float r = 0.0f, i = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        r = fmaf(xr[u * 2 + a], xr[u * 2 + b], r);
        r = fmaf(xi[u * 2 + a], xi[u * 2 + b], r);
        i = fmaf(xr[u * 2 + a], xi[u * 2 + b], i);
        i = fmaf(-xi[u * 2 + a], xr[u * 2 + b], i);
      }
      gr[a * 2 + b] = r;
      gi[a * 2 + b] = i;
    }
}

size_t smem_bytes(int Td, bool resident) {
  const size_t r3 = resident ? static_cast<size_t>(Td) * kCells * 8 : 0;
  const size_t ring = static_cast<size_t>(kStages) * kThreads
                      * (resident ? 8 : 16);
  const size_t spq = static_cast<size_t>(kLanes) * kCells * kSpqPad;
  const size_t offst = static_cast<size_t>(kThreads) * kOffPad;
  return (r3 + ring + spq + offst) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 2)
hessian_tiles_kernel(const float* __restrict__ C5,    // (K, Td, B, 2, 2, 2)
                     const float* __restrict__ R3,    // (Td, B, 2, 2, 2)
                     const float* __restrict__ Jp,    // (K, B, 2, 2, 2)
                     const float* __restrict__ Jq,    // (K, B, 2, 2, 2)
                     const int* __restrict__ cell_b,  // (tiles, 64)
                     const int* __restrict__ slot_dst,  // (tiles, 16)
                     int K, int Td, int B, int n_rows, int resident,
                     float* __restrict__ off,         // (K, B, 4, 4, 2)
                     float* __restrict__ part) {      // (K, n_rows, 8)
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int slot = resident ? 8 : 16;
  float* const r3s = smem;
  float* const ring = r3s + (resident ? Td * kCells * 8 : 0);
  float* const spq = ring + kStages * kThreads * slot;
  float* const offst = spq + kLanes * kCells * kSpqPad;

  const int tid = threadIdx.x;
  const int lane = tid / kCells;
  const int cell = tid % kCells;
  const int warp = tid / 32;
  const int wl = tid % 32;
  const int64_t tile = blockIdx.x;
  const int b = cell_b[tile * kCells + cell];
  const int n_chunks = (K + kLanes - 1) / kLanes;
  const int S = n_chunks * Td;

  // the tile's R3, once: thread -> (cell, half), t strided
  if (resident) {
    const int rc = (tid % (2 * kCells)) / 2, rh = tid % 2;
    const int rb = cell_b[tile * kCells + rc];
    if (rb >= 0) {
      for (int t = tid / (2 * kCells); t < Td; t += kThreads / (2 * kCells))
        cp_async16(r3s + (t * kCells + rc) * 8 + rh * 4,
                   R3 + (static_cast<int64_t>(t) * B + rb) * 8 + rh * 4);
    }
  }

  // step s = (chunk, t) -> this thread's slot of ring stage s % kStages
  int ikc = 0, it = 0;  // the next step to issue
  auto issue = [&]() {
    const int k = ikc * kLanes + lane;
    float* dst = ring + (((ikc * Td + it) % kStages) * kThreads + tid)
                        * slot;
    if (b >= 0 && k < K) {
      const float* src = C5 + ((static_cast<int64_t>(k) * Td + it) * B + b)
                              * 8;
      cp_async16(dst, src);
      cp_async16(dst + 4, src + 4);
      if (!resident) {
        const float* r = R3 + (static_cast<int64_t>(it) * B + b) * 8;
        cp_async16(dst + 8, r);
        cp_async16(dst + 12, r + 4);
      }
    }
    if (++it == Td) { it = 0; ++ikc; }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < S) issue();
    cp_async_commit();
  }

  float offr[16], offi[16], qd[4], qor[6], qoi[6];
  float jpr[4], jpi[4], jqr[4], jqi[4];
  int kc = 0, t = 0;
  for (int s = 0; s < S; ++s) {
    const int k = kc * kLanes + lane;
    const bool live = b >= 0 && k < K;
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) offr[i] = offi[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 6; ++i) qor[i] = qoi[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) qd[i] = 0.0f;
    }
    if (t == Td - 1 && live) {  // used after this step's algebra
      const int64_t kb = static_cast<int64_t>(k) * B + b;
      load8(Jp + kb * 8, jpr, jpi);
      load8(Jq + kb * 8, jqr, jqi);
    }
    if (s + kStages - 1 < S) issue();
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    if (s == 0 && resident) __syncthreads();  // every thread's R3 copies

    if (live) {
      const float* cs = ring + ((s % kStages) * kThreads + tid) * slot;
      float cr[4], ci[4], rr[4], ri[4];
      smem8(cs, cr, ci);
      smem8(resident ? r3s + (t * kCells + cell) * 8 : cs + 8, rr, ri);

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
              offr[o] = fmaf(-xr, yr, offr[o]);
              offr[o] = fmaf(-xi, yi, offr[o]);
              offi[o] = fmaf(-xr, yi, offi[o]);
              offi[o] = fmaf(xi, yr, offi[o]);
            }

      // Q[m,n] += c_m conj(c_n), m = (u,v) flattened
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        qd[m] = fmaf(cr[m], cr[m], qd[m]);
        qd[m] = fmaf(ci[m], ci[m], qd[m]);
#pragma unroll
        for (int n = m + 1; n < 4; ++n) {
          const int e = pair(m, n);
          qor[e] = fmaf(cr[m], cr[n], qor[e]);
          qor[e] = fmaf(ci[m], ci[n], qor[e]);
          qoi[e] = fmaf(ci[m], cr[n], qoi[e]);
          qoi[e] = fmaf(-cr[m], ci[n], qoi[e]);
        }
      }
    }

    if (t == Td - 1) {
      // -- end of a direction chunk: off, then the station partials -----
      float4* st = reinterpret_cast<float4*>(offst + tid * kOffPad);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        st[j] = make_float4(offr[2 * j], offi[2 * j], offr[2 * j + 1],
                            offi[2 * j + 1]);
      __syncwarp();
      if (k < K) {  // uniform over the warp: one direction lane per warp
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int idx = j * 32 + wl;
          const int c = idx / 8, q4 = idx % 8;
          const int bc = __shfl_sync(0xffffffffu, b, c);
          if (bc >= 0) {
            const float4 v = *reinterpret_cast<const float4*>(
                offst + (warp * 32 + c) * kOffPad + q4 * 4);
            *reinterpret_cast<float4*>(
                off + (static_cast<int64_t>(k) * B + bc) * 32 + q4 * 4) = v;
          }
        }
      }
      __syncwarp();  // the staging rows are rewritten at the next chunk

      // Sp, Sq from Q: zero for an empty cell or a lane past K
      float spr[4] = {}, spi[4] = {}, sqr[4] = {}, sqi[4] = {};
      if (live) {
        float qr[4][4], qi[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          qr[m][m] = qd[m];
          qi[m][m] = 0.0f;
#pragma unroll
          for (int n = m + 1; n < 4; ++n) {
            qr[m][n] = qr[n][m] = qor[pair(m, n)];
            qi[m][n] = qoi[pair(m, n)];
            qi[n][m] = -qoi[pair(m, n)];
          }
        }
        float gr[4], gi[4], hr[4], hi[4];
        gram2(jqr, jqi, gr, gi);  // G = Jq^H Jq
        gram2(jpr, jpi, hr, hi);  // H = Jp^H Jp
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int y = 0; y < 2; ++y)
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                // Sp[x,y] += G[a,c] Q[(x,a),(y,c)]
                const float g_r = gr[a * 2 + c], g_i = gi[a * 2 + c];
                const float p_r = qr[x * 2 + a][y * 2 + c];
                const float p_i = qi[x * 2 + a][y * 2 + c];
                spr[x * 2 + y] = fmaf(g_r, p_r, spr[x * 2 + y]);
                spr[x * 2 + y] = fmaf(-g_i, p_i, spr[x * 2 + y]);
                spi[x * 2 + y] = fmaf(g_r, p_i, spi[x * 2 + y]);
                spi[x * 2 + y] = fmaf(g_i, p_r, spi[x * 2 + y]);
                // Sq[x,y] += H[a,c] conj(Q[(a,x),(c,y)])
                const float h_r = hr[a * 2 + c], h_i = hi[a * 2 + c];
                const float s_r = qr[a * 2 + x][c * 2 + y];
                const float s_i = qi[a * 2 + x][c * 2 + y];
                sqr[x * 2 + y] = fmaf(h_r, s_r, sqr[x * 2 + y]);
                sqr[x * 2 + y] = fmaf(h_i, s_i, sqr[x * 2 + y]);
                sqi[x * 2 + y] = fmaf(h_i, s_r, sqi[x * 2 + y]);
                sqi[x * 2 + y] = fmaf(-h_r, s_i, sqi[x * 2 + y]);
              }
      }
      float* my = spq + (lane * kCells + cell) * kSpqPad;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        my[2 * i] = spr[i];
        my[2 * i + 1] = spi[i];
        my[8 + 2 * i] = sqr[i];
        my[8 + 2 * i + 1] = sqi[i];
      }
      __syncthreads();
      // (lane, slot, component) -> a thread: slot x < kRows sums Sp over
      // the cells (x, y) of cell row x, slot kRows + y sums Sq over the
      // cells (x, y) of cell column y, each in order
      for (int i = tid; i < kLanes * kSlots * 8; i += kThreads) {
        const int l2 = i / (kSlots * 8), sl = (i / 8) % kSlots, comp = i % 8;
        const int k2 = kc * kLanes + l2;
        const int dst = slot_dst[tile * kSlots + sl];
        if (k2 >= K || dst < 0) continue;
        const float* base = spq + l2 * kCells * kSpqPad;
        float acc = 0.0f;
        if (sl < kRows) {
#pragma unroll
          for (int y = 0; y < kCols; ++y)
            acc += base[(sl * kCols + y) * kSpqPad + comp];
        } else {
#pragma unroll
          for (int x = 0; x < kRows; ++x)
            acc += base[(x * kCols + sl - kRows) * kSpqPad + 8 + comp];
        }
        part[(static_cast<int64_t>(k2) * n_rows + dst) * 8 + comp] = acc;
      }
      __syncthreads();  // spq is rewritten at the next chunk's end
    }
    if (++t == Td) { t = 0; ++kc; }
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(256)
hessian_combine_kernel(const float* __restrict__ part,   // (K, n_rows, 8)
                       const int* __restrict__ st_off,   // (N + 1,)
                       int K, int N, int n_rows,
                       float* __restrict__ dsum) {       // (K, N, 2, 2, 2)
  const int64_t kn = (static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x) / 32;
  if (kn >= static_cast<int64_t>(K) * N) return;  // whole warps
  const int lane = threadIdx.x % 32;
  const int comp = lane % 8, grp = lane / 8;
  const int n = static_cast<int>(kn % N);
  const float* src = part + (kn / N) * n_rows * 8 + comp;
  float acc = 0.0f;
  const int e = st_off[n + 1];
#pragma unroll 4
  for (int i = st_off[n] + grp; i < e; i += kGroups)
    acc += src[static_cast<int64_t>(i) * 8];
  acc += __shfl_down_sync(0xffffffffu, acc, 8);   // g0 + g1, g2 + g3
  acc += __shfl_down_sync(0xffffffffu, acc, 16);  // (g0 + g1) + (g2 + g3)
  if (grp == 0) dsum[kn * 8 + comp] = acc;
}

}  // namespace

extern "C" {

// Launches the tile pass and the station combine on `stream`; returns the
// cudaError_t of the launches (0 on success).  The caller allocates off
// (K*B*32 floats), part (K*n_rows*8) and dsum (K*N*8); every float pointer
// must be 16-byte aligned.  cell_b (n_tiles, 64), slot_dst (n_tiles, 16)
// and st_off (N + 1) are the host-built schedule.  Nothing is allocated or
// synchronised here.
int hessian_blocks_launch(const float* C5, const float* R3, const float* Jp,
                          const float* Jq, const int* cell_b,
                          const int* slot_dst, const int* st_off, int K,
                          int Td, int B, int N, int n_tiles, int n_rows,
                          float* off, float* part, float* dsum,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool resident = smem_bytes(Td, true) <= kMaxSmem;
  const size_t smem = smem_bytes(Td, resident);
  cudaError_t err = cudaFuncSetAttribute(
      hessian_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  hessian_tiles_kernel<<<n_tiles, kThreads, smem, st>>>(
      C5, R3, Jp, Jq, cell_b, slot_dst, K, Td, B, n_rows, resident ? 1 : 0,
      off, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n2 = static_cast<int64_t>(K) * N * 32;
  hessian_combine_kernel<<<static_cast<unsigned>((n2 + 255) / 256), 256, 0,
                           st>>>(part, st_off, K, N, n_rows, dsum);
  return static_cast<int>(cudaGetLastError());
}

const char* hessian_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
