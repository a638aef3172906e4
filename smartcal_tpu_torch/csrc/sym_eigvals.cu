// Kernel 5 of the port: the eigenvalues of the symmetric part
// 0.5 (B + B^T) of a stack of small square matrices, ascending.
//
// Replaces no Pallas kernel.  The JAX package takes them with
// jnp.linalg.eigvalsh inside its one-program episode
// (smartcal_tpu/envs/enet.py _eig_state); torch.linalg.eigvalsh on CUDA
// synchronises the device with the host for its error check, so a CUDA
// graph cannot hold it.  This kernel keeps the episode capturable.
//
// Parallel cyclic Jacobi, one block per matrix.  The symmetric part is
// formed in float32 exactly as the plain version forms it, then rotated in
// float64 in shared memory.  A sweep is the round-robin (Brent-Luk)
// tournament over the indices, padded to an even count n_p with an
// all-zero phantom index when n is odd: n_p - 1 rounds of n_p / 2 disjoint
// pairs, each pair (p, q) once per sweep.  The schedule is built on the
// host (ops/sym_eigvals.round_robin) and copied to shared memory.  The
// rotations of a round are disjoint, so they are applied together: the
// matrix falls into (n_p / 2)^2 blocks of 2 x 2, block (k, l) the rows of
// pair k and the columns of pair l, and thread (k, l), k <= l, computes
// rotations k and l itself from a_pp, a_qq and a_pq of each pair, mixes
// its block's columns by rotation l and its rows by rotation k, and writes
// the block and its mirror into the other of two buffers.  Each rotation
// is exactly orthogonal in float64 while its angle is chosen in float32
// (see rotation), which leaves a_pq near 1e-7 of itself for the next
// sweep.  One barrier per round.  Every rotation is computed from the same
// bits by every thread that needs it and the order is fixed, so two
// launches give the same bits.  Sweeps run until the off-diagonal
// Frobenius norm is below 1e-12 of the whole norm (far below float32's
// resolution), at most 40; a NaN anywhere ends before the first sweep.
// The diagonal is rounded to float32 and ranked (NaN last, ties by index)
// into ascending order, the order eigvalsh returns.
//
// Bound: latency, not bytes or flops (n = 20: 1.6 KB in, 80 B out).  The
// previous design walked the n (n - 1) / 2 rotations of a sweep one after
// another, each through float64 division and square roots; here a sweep
// is n_p - 1 dependent rounds, each one rotation's short chain (the angle
// in float32, one Newton step and two mixes in float64) and one barrier.
// Matrices run side by side, one per block.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSweeps = 40;
constexpr double kRelTol = 1e-12;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;   // the H100's per-block opt-in maximum

__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return nb;              // numbers before NaN
  if (na) return ia < ib;
  return a < b || (a == b && ia < ib);
}

// The block-wide sum of v in a fixed order: a butterfly within each warp,
// then the warps' sums in index order; every thread returns the same bits.
// `red` holds one double per warp; a barrier separates two calls.
__device__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int nw = blockDim.x / kWarp;
  if ((threadIdx.x & (kWarp - 1)) == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  double s = 0.0;
  for (int i = 0; i < nw; ++i) s += red[i];
  return s;
}

// The rotation (c, s) of the pair (p, q), c = cos and s = sin of the
// angle that zeroes a_pq: tan = t, the smaller root of t^2 + 2 theta t - 1
// = 0, theta = (a_qq - a_pp) / (2 a_pq), i.e. t = sgn(theta) |e| / (|d| +
// sqrt(d^2 + e^2)) with d = a_qq - a_pp and e = 2 a_pq.  The angle is
// chosen in float32 (d and e scaled by a power of two to a maximum in
// [1, 2), then approximate square root and division), so a_pq is left
// at about 1e-7 of itself and the next sweep takes it; c and s are then
// made in float64, c = 1 / sqrt(1 + t^2) by one Newton step from
// float32's estimate, so c^2 + s^2 = 1 to ~1e-14 and the rotation keeps
// the spectrum.  This replaces float64 division, square root and
// reciprocal square root, each a long chain of dependent float64
// instructions; a_pq = 0 gives t = 0, c = 1, s = 0.
__device__ __forceinline__ void rotation(double app, double aqq, double apq,
                                         double& c, double& s) {
  const double d = aqq - app, e = 2.0 * apq;
  const long long big = __double_as_longlong(fmax(fabs(d), fabs(e)));
  const int ebits = static_cast<int>((big >> 52) & 0x7ff);
  const double scale = __longlong_as_double(
      static_cast<long long>(2046 - ebits) << 52);     // 2^(1023 - ebits)
  const float df = static_cast<float>(d * scale);
  const float ef = static_cast<float>(e * scale);
  const float num = df > 0.f ? ef : (df < 0.f ? -ef : fabsf(ef));
  const float h2 = fmaf(df, df, ef * ef);               // in [1, 8)
  float t = __fdividef(num, fabsf(df) + h2 * rsqrtf(h2));
  t = apq == 0.0 ? 0.f : t;                             // no rotation
  const float y0 = rsqrtf(fmaf(t, t, 1.f));
  const double td = t, x = fma(td, td, 1.0);
  double y = y0;
  y = y * fma(-0.5 * x, y * y, 1.5);
  c = y;
  s = td * y;
}

__global__ void sym_eigvals_kernel(const float* __restrict__ B, int n,
                                   int np, const int* __restrict__ sched,
                                   float* __restrict__ out,
                                   int* __restrict__ sweeps_out,
                                   unsigned long long* launch_count) {
  extern __shared__ double smem[];     // two (np, np) buffers, warp sums,
  double* cur = smem;                  // n floats of diagonal, then the
  double* nxt = cur + np * np;         // schedule
  double* red = nxt + np * np;
  float* diag = reinterpret_cast<float*>(red + kMaxThreads / kWarp);
  int* rounds = reinterpret_cast<int*>(diag + n);
  const int tid = threadIdx.x, P = np / 2;
  // the wrapper's count of this kernel's runs, kept on the card so that
  // launches replayed from a CUDA graph count too
  if (launch_count != nullptr && blockIdx.x == 0 && tid == 0)
    atomicAdd(launch_count, 1ull);
  const float* b = B + (size_t)blockIdx.x * n * n;
  for (int k = tid; k < (np - 1) * np; k += blockDim.x) rounds[k] = sched[k];
  for (int k = tid; k < np * np; k += blockDim.x) {
    const int i = k / np, j = k % np;
    float v = 0.f;
    if (i < n && j < n) v = 0.5f * (b[i * n + j] + b[j * n + i]);
    cur[k] = static_cast<double>(v);
  }
  // this thread's block (k, l), k <= l, of the upper triangle of blocks
  int bk = 0, bl = tid;
  while (bk < P && bl >= P - bk) { bl -= P - bk; ++bk; }
  bl += bk;
  const bool owner = bk < P;
  __syncthreads();

  double fro = 0.0;
  for (int k = tid; k < np * np; k += blockDim.x) fro += cur[k] * cur[k];
  fro = block_sum(fro, red);

  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
    if (owner) {
      const int* pr = rounds;           // round 0 of the schedule
      const int p = pr[2 * bk], q = pr[2 * bk + 1];
      const int r = pr[2 * bl], u = pr[2 * bl + 1];
      if (bk == bl) {
        off = 2.0 * cur[p * np + q] * cur[p * np + q];
      } else {
        const double x0 = cur[p * np + r], x1 = cur[p * np + u];
        const double x2 = cur[q * np + r], x3 = cur[q * np + u];
        off = 2.0 * (x0 * x0 + x1 * x1 + x2 * x2 + x3 * x3);
      }
    }
    __syncthreads();                    // red is read by the last call
    off = block_sum(off, red);
    if (!(off > kRelTol * kRelTol * fro)) break;   // NaN ends too
    for (int round = 0; round < np - 1; ++round) {
      if (owner) {
        const int* pr = rounds + 2 * P * round;
        const int p = pr[2 * bk], q = pr[2 * bk + 1];
        const int r = pr[2 * bl], u = pr[2 * bl + 1];
        // both rotations at once, without branches, so that their chains
        // overlap (on a diagonal block they are the same rotation)
        double ck, sk, cl, sl;
        rotation(cur[p * np + p], cur[q * np + q], cur[p * np + q], ck, sk);
        rotation(cur[r * np + r], cur[u * np + u], cur[r * np + u], cl, sl);
        const double apr = cur[p * np + r], apu = cur[p * np + u];
        const double aqr = cur[q * np + r], aqu = cur[q * np + u];
        // columns r, u by rotation l, then rows p, q by rotation k; on a
        // diagonal block (r, u) = (p, q) and the writes below leave it
        // symmetric, a_pq = a_qp taken from the last
        const double xpr = cl * apr - sl * apu, xpu = sl * apr + cl * apu;
        const double xqr = cl * aqr - sl * aqu, xqu = sl * aqr + cl * aqu;
        const double ypr = ck * xpr - sk * xqr, yqr = sk * xpr + ck * xqr;
        const double ypu = ck * xpu - sk * xqu, yqu = sk * xpu + ck * xqu;
        nxt[p * np + r] = ypr; nxt[r * np + p] = ypr;
        nxt[p * np + u] = ypu; nxt[u * np + p] = ypu;
        nxt[q * np + r] = yqr; nxt[r * np + q] = yqr;
        nxt[q * np + u] = yqu; nxt[u * np + q] = yqu;
      }
      __syncthreads();
      double* tmp = cur; cur = nxt; nxt = tmp;
    }
  }
  for (int i = tid; i < n; i += blockDim.x)
    diag[i] = static_cast<float>(cur[i * np + i]);
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) {
    const float v = diag[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += before(diag[j], j, v, i) ? 1 : 0;
    out[(size_t)blockIdx.x * n + rank] = v;
  }
  if (tid == 0 && sweeps_out) sweeps_out[blockIdx.x] = sweep;
}

int padded(int n) { return n + (n & 1); }

int threads(int n) {
  const int P = padded(n) / 2, blocks = P * (P + 1) / 2;
  return (blocks + kWarp - 1) / kWarp * kWarp;
}

}  // namespace

extern "C" {

// Shared memory of one matrix's block, in bytes.
size_t sym_eigvals_smem_bytes(int n) {
  const size_t np = padded(n);
  return sizeof(double) * (2 * np * np + kMaxThreads / kWarp) +
         sizeof(float) * (size_t)n + sizeof(int) * (np - 1) * np;
}

// Launches one block per matrix of B (L, n, n) on `stream`.  sched is the
// round-robin schedule (ops/sym_eigvals.round_robin): for each of the
// n_p - 1 rounds, n_p / 2 pairs (p, q) as int32, every index 0..n_p - 1
// once per round, n_p = n rounded up to even.  out (L, n); sweeps (L,)
// the sweeps each matrix took (or null); launch_count (or null) is
// incremented by one on the device each time the kernel runs.  Returns a
// CUDA error code (0 on success), -1 for bad sizes.
int sym_eigvals_launch(const float* B, int L, int n, const int* sched,
                       float* out, int* sweeps,
                       unsigned long long* launch_count, void* stream) {
  if (L <= 0 || n <= 0 || threads(n) > kMaxThreads) return -1;
  const size_t smem = sym_eigvals_smem_bytes(n);
  if (smem > (size_t)kMaxSmem) return -1;
  if (smem > 48 * 1024) {
    static int opted = 0;   // once, outside any capture (the first launch)
    if (!opted) {
      cudaError_t e = cudaFuncSetAttribute(
          sym_eigvals_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      opted = 1;
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sym_eigvals_kernel<<<L, threads(n), smem, st>>>(B, n, padded(n), sched,
                                                   out, sweeps, launch_count);
  return static_cast<int>(cudaGetLastError());
}

const char* sym_eigvals_error_string(int code) {
  if (code == -1) return "bad sizes, or n above 88 (1024 threads)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
