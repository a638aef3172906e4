// Kernel 5 of the port: the eigenvalues of the symmetric part
// 0.5 (B + B^T) of a stack of small square matrices, ascending.
//
// Replaces no Pallas kernel.  The JAX package takes them with
// jnp.linalg.eigvalsh inside its one-program episode
// (smartcal_tpu/envs/enet.py _eig_state); torch.linalg.eigvalsh on CUDA
// synchronises the device with the host for its error check, so a CUDA
// graph cannot hold it.  This kernel keeps the episode capturable.
//
// Cyclic Jacobi, one warp per matrix: the symmetric part is formed in
// float32 exactly as the plain version forms it, then rotated in float64
// in shared memory (n^2 doubles), row by row over the pairs (p, q), each
// rotation zeroing a_pq.  Every thread computes the rotation from the same
// three entries; thread k updates the entries (k, p), (k, q) and their
// mirrors, and one thread the 2 x 2 block, so the rotations of a sweep run
// in a fixed order and two launches give the same bits.  Sweeps run until
// the off-diagonal Frobenius norm is below 1e-12 of the whole norm (far
// below float32's resolution: the float64 rotations leave the diagonal
// within a few float64 ulps of the eigenvalues), at most 40.  The diagonal
// is rounded to float32 and ranked (NaN last, ties by index) into
// ascending order, the order eigvalsh returns.
//
// Bound: latency, not bytes or flops (n = 20: 1.6 KB in, 80 B out, ~8
// sweeps of 190 dependent rotations); matrices run side by side, one per
// block.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxSweeps = 40;
constexpr double kRelTol = 1e-12;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return nb;              // numbers before NaN
  if (na) return ia < ib;
  return a < b || (a == b && ia < ib);
}

__global__ void sym_eigvals_kernel(const float* __restrict__ B, int n,
                                   float* __restrict__ out,
                                   int* __restrict__ sweeps_out,
                                   unsigned long long* launch_count) {
  extern __shared__ double a[];        // (n, n), then n floats of diagonal
  float* diag = reinterpret_cast<float*>(a + (size_t)n * n);
  const int lane = threadIdx.x;
  // the wrapper's count of this kernel's runs, kept on the card so that
  // launches replayed from a CUDA graph count too
  if (launch_count != nullptr && blockIdx.x == 0 && lane == 0)
    atomicAdd(launch_count, 1ull);
  const float* b = B + (size_t)blockIdx.x * n * n;
  double fro = 0.0;
  for (int k = lane; k < n * n; k += kWarp) {
    const int i = k / n, j = k % n;
    const float s = 0.5f * (b[i * n + j] + b[j * n + i]);
    a[k] = static_cast<double>(s);
    fro += static_cast<double>(s) * static_cast<double>(s);
  }
  fro = warp_sum(fro);
  __syncwarp();

  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
    for (int k = lane; k < n * n; k += kWarp)
      if (k / n != k % n) off += a[k] * a[k];
    off = warp_sum(off);
    if (!(off > kRelTol * kRelTol * fro)) break;   // NaN ends too
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        __syncwarp();
        const double apq = a[p * n + q];
        const double app = a[p * n + p], aqq = a[q * n + q];
        __syncwarp();
        if (apq == 0.0) continue;
        const double theta = (aqq - app) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                         (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = lane; k < n; k += kWarp) {
          if (k == p || k == q) continue;
          const double akp = a[k * n + p], akq = a[k * n + q];
          const double nkp = c * akp - s * akq, nkq = s * akp + c * akq;
          a[k * n + p] = nkp;
          a[p * n + k] = nkp;
          a[k * n + q] = nkq;
          a[q * n + k] = nkq;
        }
        if (lane == 0) {
          a[p * n + p] = app - t * apq;
          a[q * n + q] = aqq + t * apq;
          a[p * n + q] = 0.0;
          a[q * n + p] = 0.0;
        }
      }
    }
    __syncwarp();
  }
  __syncwarp();
  for (int i = lane; i < n; i += kWarp)
    diag[i] = static_cast<float>(a[i * n + i]);
  __syncwarp();
  for (int i = lane; i < n; i += kWarp) {
    const float v = diag[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += before(diag[j], j, v, i) ? 1 : 0;
    out[(size_t)blockIdx.x * n + rank] = v;
  }
  if (lane == 0 && sweeps_out) sweeps_out[blockIdx.x] = sweep;
}

}  // namespace

extern "C" {

// Shared memory of one matrix's block, in bytes.
size_t sym_eigvals_smem_bytes(int n) {
  return sizeof(double) * (size_t)n * n + sizeof(float) * (size_t)n;
}

// Launches one block per matrix of B (L, n, n) on `stream`; out (L, n),
// sweeps (L,) the sweeps each matrix took (or null); launch_count (or
// null) is incremented by one on the device each time the kernel runs.
// Returns a CUDA error code (0 on success), -1 for bad sizes.
int sym_eigvals_launch(const float* B, int L, int n, float* out, int* sweeps,
                       unsigned long long* launch_count, void* stream) {
  if (L <= 0 || n <= 0) return -1;
  const size_t smem = sym_eigvals_smem_bytes(n);
  if (smem > 48 * 1024) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sym_eigvals_kernel<<<L, kWarp, smem, st>>>(B, n, out, sweeps,
                                              launch_count);
  return static_cast<int>(cudaGetLastError());
}

const char* sym_eigvals_error_string(int code) {
  if (code == -1) return "bad sizes, or n above 78 (48 KB of shared memory)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
