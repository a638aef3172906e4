// Kernel 4 of the port: the elastic-net L-BFGS solve, one lane per block,
// the whole loop in one launch.
//
// Replaces no Pallas kernel.  The JAX package runs this solve as plain XLA
// inside its one-program episode (smartcal_tpu/envs/enet.py _solve and the
// hint's 2-fold CV, ops/lbfgs.py lbfgs_solve under vmap), its while_loop on
// the device.  The port's eager form (ops/lbfgs.py over autograd) launches
// ~677 kernels per iteration and asks the host once per iteration whether
// a lane is still active; a CUDA graph cannot hold that loop.  This kernel
// keeps the loop on the device, so the episode programs can be captured.
//
// Per lane l (blockIdx.x), with A = A[l / (L / n_groups)] (N x M, row
// major), y likewise, an optional row weight w[l] (N) and (l2[l], l1[l]):
//
//   f(x) = sum((w (y - A x))^2) + l2 ||x||^2 + l1 sum |x|
//   g(x) = -2 A^T (w (w (y - A x))) + 2 l2 x + l1 s(x),  s(x) = +1 at x >= 0
//
// from x = 0, the algorithm of smartcal_tpu_torch/ops/lbfgs.py step for
// step: the two-loop direction over the ring whose valid rows sit at the
// end, the strong-Wolfe cubic search (3 bracket trips, 4 zoom trips, the
// cubic choice, the degenerate-slope and NaN guards), the curvature
// acceptance and the six stop tests, capped at max_iters.  A lane that
// stops ends: what a frozen lane of the lane-masked loop does.  The search
// skips only evaluations whose value the lane discards (the cubic's trial
// point when its discriminant is not positive).
//
// Bound: the work is tiny (a few hundred flops per objective evaluation at
// 20 x 20) and serial: each evaluation depends on the last, so a lane's
// time is its chain of dependent steps times their latency, and the lanes
// run side by side on the SMs.  One warp per lane; every reduction has a
// fixed order, so two launches give the same bits and every thread holds
// the same scalars (the control flow stays uniform).
//
// The fast path (M, N <= 32, a history of at most 8) shortens each step
// of that chain and keeps its arithmetic: the same operations in the same
// order as the wide path below (nvcc fuses a few products into FMAs
// otherwise, so the bits differ at round-off).  One thread per element
// of x and of the residual: the thread's row and column of A, its
// elements of x, g, d and of the history all sit in registers, the
// matrix-vector products are unrolled over a compile-time width, 20 for
// the enet env and 32 above it (each the wide path's sequential FMA
// chain; a predicated FMA past the width would still cost its latency),
// the iterate and the residual reach the other threads through one
// 32-float buffer each, the sums of one evaluation go through one
// interleaved butterfly, and the search's phi(0), the accepted point's
// loss and g . d, is not evaluated again.  Levers that shorten the chain
// further by reassociating the arithmetic (phi along the line from y - A x
// and A d, the two-loop from one reduction of the ring's Gram dots) each
// moved a lane of the enet step's holds on the card, so the evaluation
// keeps the wide path's order.  A switch puts A back in shared memory, for
// chip_smoke.py --enet-kernel-ablation.  Larger problems take the wide
// path: A and A^T in shared memory, loops over the elements.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef ENET_A_REGISTERS
#define ENET_A_REGISTERS 1    // A's row and column in registers
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxSmem = 232448;   // the H100's per-block opt-in maximum
constexpr int kHist = 8;           // the fast path's deepest history

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits (fp add commutes)
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// K independent butterflies, interleaved stage by stage
template <int K>
__device__ __forceinline__ void warp_sums(float (&v)[K]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(kFull, v[k], o);
  }
}

// NaN-propagating min / max, as torch.minimum / torch.maximum / clamp
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// -- the strong-Wolfe cubic search, on any lane with
// phi(alpha, f, slope) = (f(x + alpha d), g(x + alpha d) . d) --------------

// ops/lbfgs._cubic_choose on one lane
template <class L>
__device__ __forceinline__ void cubic(L& ln, float a, float fa, float fad,
                                      float b, float fb, float fbd, float& p,
                                      float& fp, float& fpd) {
  float denom = (b == a) ? 1.f : b - a;
  float aa = 3.f * (fa - fb) / denom + fbd - fad;
  float disc = aa * aa - fad * fbd;
  if (disc > 0.f) {
    float cc = sqrtf(nmax(disc, 0.f));
    float den2 = fbd - fad + 2.f * cc;
    float z0 = (den2 == 0.f) ? 0.5f * (a + b)
                             : b - (fbd + cc - aa) * (b - a) / den2;
    float hi = nmax(a, b), lo = nmin(a, b);
    bool inside = (z0 <= hi) && (z0 >= lo);
    float fz0, fz0d;
    ln.phi(z0, fz0, fz0d);
    if (!inside) fz0 = INFINITY;
    bool pick_a = (fa < fb) && (fa < fz0);
    bool pick_b = (!pick_a) && (fb < fz0);
    p = pick_a ? a : (pick_b ? b : z0);
    fp = pick_a ? fa : (pick_b ? fb : fz0);
    fpd = pick_a ? fad : (pick_b ? fbd : fz0d);
  } else {
    bool pa = fa < fb;
    p = pa ? a : b;
    fp = pa ? fa : fb;
    fpd = pa ? fad : fbd;
  }
}

template <class L>
__device__ __forceinline__ float zoom(L& ln, float aj, float bj, float faj,
                                      float fajd, float phi0, float gphi0,
                                      float lr) {
  const float sigma = 0.1f, rho_ls = 0.01f, t2 = 0.1f, t3 = 0.5f;
  float alphak = lr;
  for (int trip = 0; trip < 4; ++trip) {
    float p01 = aj + t2 * (bj - aj);
    float p02 = bj - t3 * (bj - aj);
    float f01, f01d, f02, f02d;
    ln.phi(p01, f01, f01d);
    ln.phi(p02, f02, f02d);
    float alj, phj, gphj;
    cubic(ln, p01, f01, f01d, p02, f02, f02d, alj, phj, gphj);
    bool shrink = (phj > phi0 + rho_ls * alj * gphi0) || (phj >= faj);
    bool term1 = (aj - alj) * gphj <= 1e-6f;
    bool term2 = fabsf(gphj) <= -sigma * gphi0;
    bool found = (!shrink) && (term1 || term2);
    float bj_new = shrink ? alj : ((gphj * (bj - aj) >= 0.f) ? aj : bj);
    float aj_new = shrink ? aj : alj;
    float faj_new = shrink ? faj : phj;
    float fajd_new = shrink ? fajd : gphj;
    alphak = alj;
    aj = aj_new; bj = bj_new; faj = faj_new; fajd = fajd_new;
    if (found) break;
  }
  return alphak;
}

// ops/lbfgs.strong_wolfe_cubic on one lane, from (phi0, gphi0) = phi(0)
template <class L>
__device__ __forceinline__ float search(L& ln, float lr, float phi0,
                                        float gphi0) {
  const float sigma = 0.1f, rho_ls = 0.01f, t1 = 9.f;
  float tol = nmin(phi0 * 0.01f, 1e-6f);
  float mu = (tol - phi0) / (rho_ls * gphi0);
  float alphai = 10.f * lr, alphai1 = 0.f;
  float fi, fid;
  ln.phi(alphai, fi, fid);
  float fi1 = phi0, fi1d = gphi0, phi_prev = phi0;
  float alphak = lr;
  for (int i = 0; i < 3; ++i) {
    float phi_i = fi, gphi_i = fid;
    bool c0 = phi_i < tol;
    bool c1 = phi_i > phi0 + alphai * gphi0;
    if (i > 0) c1 = c1 || (phi_i >= phi_prev);
    bool c2 = fabsf(gphi_i) <= -sigma * gphi0;
    bool c3 = gphi_i >= 0.f;
    if (c0 || c1 || c2 || c3) {
      bool need_zoom = (!c0) && (c1 || ((!c2) && c3));
      float zoom_val = lr;
      if (need_zoom) {
        float za = c1 ? alphai1 : alphai, zb = c1 ? alphai : alphai1;
        float fza = c1 ? fi1 : fi, fzad = c1 ? fi1d : fid;
        zoom_val = zoom(ln, za, zb, fza, fzad, phi0, gphi0, lr);
      }
      alphak = c0 ? alphai : (c1 ? zoom_val : (c2 ? alphai : zoom_val));
      break;
    }
    float lo = 2.f * alphai - alphai1;
    float hi = nmin(mu, alphai + t1 * (alphai - alphai1));
    float flo, flod, fhi, fhid;
    ln.phi(lo, flo, flod);
    ln.phi(hi, fhi, fhid);
    float cand, fcand, fcandd;
    cubic(ln, lo, flo, flod, hi, fhi, fhid, cand, fcand, fcandd);
    bool use_mu = mu <= lo;
    float fmu, fmud;
    ln.phi(mu, fmu, fmud);
    float next_ai = use_mu ? mu : cand;
    float next_ai1 = use_mu ? alphai : alphai1;
    float fnext = use_mu ? fmu : fcand, fnextd = use_mu ? fmud : fcandd;
    float fnext1 = use_mu ? fi : fi1, fnext1d = use_mu ? fid : fi1d;
    alphai = next_ai; alphai1 = next_ai1;
    fi = fnext; fid = fnextd; fi1 = fnext1; fi1d = fnext1d;
    phi_prev = phi_i;
  }
  if (fabsf(gphi0) < 1e-12f || mu != mu) alphak = 1.f;
  if (alphak != alphak) alphak = lr;
  return alphak;
}

// -- the fast path: one thread per element -------------------------------

// this thread's element of A v over the first n entries of v (shared
// memory), one FMA after another in index order: the FMAs nvcc makes of
// the wide path's loop
template <int W>
__device__ __forceinline__ float row_dot(const float (&row)[W],
                                         const float* v, int n) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < W; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(v + j);
    if (j < n) acc = fmaf(row[j], q.x, acc);
    if (j + 1 < n) acc = fmaf(row[j + 1], q.y, acc);
    if (j + 2 < n) acc = fmaf(row[j + 2], q.z, acc);
    if (j + 3 < n) acc = fmaf(row[j + 3], q.w, acc);
  }
  return acc;
}

template <int W>   // the widest M and N this copy takes, a multiple of 4
struct Fast {
  int lane, N, M, evals;
  float l2, l1, yi, wi;
  bool weighted;
  float* vb;       // (32) shared: the operand of A, a trial point
  float* rb;       // (32) shared: the twice-weighted residual, for A^T
#if ENET_A_REGISTERS
  float arow[W], acol[W];   // A[lane][:] and A[:][lane], 0 beyond
#else
  const float* As;   // (N, M) shared
  const float* ATs;  // (M, N) shared
#endif
  float x, d;      // this element of the iterate and the direction (< M)

  __device__ __forceinline__ float times_a(const float* v) const {
#if ENET_A_REGISTERS
    return row_dot<W>(arow, v, M);
#else
    float acc = 0.f;
    for (int j = 0; j < M; ++j) acc += As[lane * M + j] * v[j];
    return acc;
#endif
  }
  __device__ __forceinline__ float times_at(const float* v) const {
#if ENET_A_REGISTERS
    return row_dot<W>(acol, v, N);
#else
    float acc = 0.f;
    for (int i = 0; i < N; ++i) acc += ATs[lane * N + i] * v[i];
    return acc;
#endif
  }

  // f at this thread's z (0 beyond M): the partial sums of its three
  // terms, the gradient's element into gz
  __device__ __forceinline__ void full(float z, float& gz, float& p_lsq,
                                       float& p_xx, float& p_xa) {
    ++evals;
    __syncwarp();
    if (lane < M) vb[lane] = z;
    __syncwarp();
    p_lsq = 0.f;
    if (lane < N) {
      const float r = yi - times_a(vb);
      const float e = weighted ? r * wi : r;
      rb[lane] = weighted ? e * wi : e;   // the weight applied twice
      p_lsq = e * e;
    }
    __syncwarp();
    gz = 0.f;
    p_xx = 0.f;
    p_xa = 0.f;
    if (lane < M) {
      gz = -2.f * times_at(rb) + 2.f * l2 * z + l1 * (z >= 0.f ? 1.f : -1.f);
      p_xx = z * z;
      p_xa = fabsf(z);
    }
  }

  // phi(alpha) = (f(x + alpha d), g(x + alpha d) . d)
  __device__ __forceinline__ void phi(float alpha, float& f, float& slope) {
    float gz, p[4];
    full(lane < M ? x + alpha * d : 0.f, gz, p[0], p[1], p[2]);
    p[3] = gz * d;
    warp_sums(p);
    f = p[0] + l2 * p[1] + l1 * p[2];
    slope = p[3];
  }
};

template <int W>
__global__ void __launch_bounds__(kWarp) enet_lbfgs_fast_kernel(
    const float* __restrict__ A_all, const float* __restrict__ y_all,
    const float* __restrict__ w_all, const float* __restrict__ l2_all,
    const float* __restrict__ l1_all, int per_group, int N, int M, int m,
    int max_iters, float tol_grad, float tol_change, float* x_out,
    float* loss_out, float* grad_out, float* S_out, float* Y_out,
    int* count_out, float* gamma_out, int* iters_out, uint8_t* conv_out,
    uint8_t* stop_out, uint8_t* div_out, int* evals_out,
    unsigned long long* launch_count) {
  extern __shared__ float sm[];
  const int l = blockIdx.x, lane = threadIdx.x;
  if (launch_count != nullptr && l == 0 && lane == 0)
    atomicAdd(launch_count, 1ull);
  const int grp = l / per_group;
  const float* Ag = A_all + (size_t)grp * N * M;

  Fast<W> F;
  F.lane = lane; F.N = N; F.M = M; F.evals = 0;
  F.l2 = l2_all[l]; F.l1 = l1_all[l];
  F.weighted = w_all != nullptr;
  F.yi = lane < N ? y_all[(size_t)grp * N + lane] : 0.f;
  F.wi = (F.weighted && lane < N) ? w_all[(size_t)l * N + lane] : 1.f;
  F.vb = sm;
  F.rb = sm + kWarp;
  F.vb[lane] = 0.f;
  F.rb[lane] = 0.f;
#if ENET_A_REGISTERS
#pragma unroll
  for (int j = 0; j < W; ++j) {
    F.arow[j] = (lane < N && j < M) ? Ag[lane * M + j] : 0.f;
    F.acol[j] = (lane < M && j < N) ? Ag[j * M + lane] : 0.f;
  }
#else
  float* As = sm + 2 * kWarp;
  float* ATs = As + N * M;
  for (int k = lane; k < N * M; k += kWarp) {
    As[k] = Ag[k];
    ATs[(k % M) * N + k / M] = Ag[k];
  }
  F.As = As;
  F.ATs = ATs;
#endif
  F.x = 0.f; F.d = 0.f;
  float S[kHist], Y[kHist], rho[kHist];
#pragma unroll
  for (int k = 0; k < kHist; ++k) S[k] = Y[k] = rho[k] = 0.f;

  float g, pl[4];
  F.full(0.f, g, pl[0], pl[1], pl[2]);
  pl[3] = fabsf(g);
  warp_sums(pl);
  float loss = pl[0] + F.l2 * pl[1] + F.l1 * pl[2];
  bool stop = pl[3] <= tol_grad;
  bool diverged = loss != loss;
  int count = 0, it = 0;
  float gamma = 1.f;

  while (it < max_iters && !stop) {
    // two-loop direction, newest valid pair first
    const float scale = count > 0 ? gamma : 1.f;
    float al[kHist], be[kHist];
    // the ring right-aligned in registers: its newest pair at kHist - 1
    const int lo = kHist - count;
    float q = lane < M ? -g : 0.f;   // +0 beyond M, as the wide path sums
#pragma unroll
    for (int k = kHist - 1; k >= 0; --k) {
      al[k] = 0.f;
      if (k >= lo) {
        al[k] = rho[k] * warp_sum(S[k] * q);
        q = q - al[k] * Y[k];
      }
    }
    float dj = q * scale;
#pragma unroll
    for (int k = 0; k < kHist; ++k) {
      be[k] = 0.f;
      if (k >= lo) {
        be[k] = rho[k] * warp_sum(Y[k] * dj);
        dj = dj + (al[k] - be[k]) * S[k];
      }
    }
    F.d = dj;
    const float gtd = warp_sum(g * dj);        // phi(0) is (loss, g . d)
    const float t = search(F, 1.f, loss, gtd);

    // the step: s = t d, x_new = x + s, evaluated at x_new
    const float sj = t * dj;
    const float z = F.x + sj;
    float gz, pv[8];
    F.full(lane < M ? z : 0.f, gz, pv[0], pv[1], pv[2]);
    const float yj = gz - g;
    pv[3] = sj * sj;
    pv[4] = fabsf(sj);
    pv[5] = yj * sj;
    pv[6] = yj * yj;
    pv[7] = fabsf(gz);
    warp_sums(pv);
    const float loss_new = pv[0] + F.l2 * pv[1] + F.l1 * pv[2];
    const float ss = pv[3], sabs = pv[4], ys = pv[5], yy = pv[6];
    const float gnew_abs = pv[7];
    if (ys > 1e-10f * ss) {      // curvature acceptance: push the pair
      // every register moves, so the indices stay constant; rows below
      // kHist - m leave the ring and are never read
#pragma unroll
      for (int k = 0; k < kHist - 1; ++k) {
        S[k] = S[k + 1];
        Y[k] = Y[k + 1];
        rho[k] = rho[k + 1];
      }
      S[kHist - 1] = sj;
      Y[kHist - 1] = yj;
      rho[kHist - 1] = 1.f / ys;
      count = min(count + 1, m);
      gamma = ys / yy;
    }
    const bool div_new = diverged || (gnew_abs != gnew_abs) ||
                         (loss_new != loss_new);
    const bool stop_new = (gnew_abs <= tol_grad) || (gtd > -tol_change) ||
                          (sabs <= tol_change) ||
                          (fabsf(loss_new - loss) < tol_change) || div_new;
    F.x = lane < M ? z : 0.f;
    g = gz;
    loss = loss_new;
    it += 1;
    stop = stop_new;
    diverged = div_new;
  }

  if (lane < M) {
    x_out[(size_t)l * M + lane] = F.x;
    grad_out[(size_t)l * M + lane] = g;
#pragma unroll
    for (int k = 0; k < kHist; ++k) {
      const int row = k - (kHist - m);         // the ring's row, oldest 0
      if (row >= 0) {
        S_out[((size_t)l * m + row) * M + lane] = S[k];
        Y_out[((size_t)l * m + row) * M + lane] = Y[k];
      }
    }
  }
  if (lane == 0) {
    loss_out[l] = loss;
    count_out[l] = count;
    gamma_out[l] = gamma;
    iters_out[l] = it;
    conv_out[l] = (stop && !diverged) ? 1 : 0;
    stop_out[l] = stop ? 1 : 0;
    div_out[l] = diverged ? 1 : 0;
    evals_out[l] = F.evals;
  }
}

// -- the wide path: any M, N and history within shared memory -------------

struct Lane {
  const float* A;    // (N, M) row major
  const float* AT;   // (M, N)
  const float* y;    // (N,)
  const float* w;    // (N,) or nullptr
  float* r;          // (N,) scratch: the weighted residual
  float* z;          // (M,) scratch: the trial point
  float* gz;         // (M,) the gradient at the last evaluation
  const float* x;    // (M,) the iterate
  const float* d;    // (M,) the direction
  float l2, l1;
  int N, M, lane;
  int evals;         // objective evaluations so far

  // f(z) into the return value and g(z) into gz; z must be written and
  // visible to the warp
  __device__ float eval() {
    ++evals;
    float lsq = 0.f;
    for (int i = lane; i < N; i += kWarp) {
      float acc = 0.f;
      for (int j = 0; j < M; ++j) acc += AT[j * N + i] * z[j];
      float e = y[i] - acc;
      if (w) e = e * w[i];
      r[i] = w ? e * w[i] : e;   // the residual's weight applied twice
      lsq += e * e;
    }
    __syncwarp();
    lsq = warp_sum(lsq);
    float xx = 0.f, xa = 0.f;
    for (int j = lane; j < M; j += kWarp) {
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc += A[i * M + j] * r[i];
      float zj = z[j];
      gz[j] = -2.f * acc + 2.f * l2 * zj + l1 * (zj >= 0.f ? 1.f : -1.f);
      xx += zj * zj;
      xa += fabsf(zj);
    }
    xx = warp_sum(xx);
    xa = warp_sum(xa);
    __syncwarp();
    return lsq + l2 * xx + l1 * xa;
  }

  __device__ float dot(const float* a, const float* b) const {
    float s = 0.f;
    for (int j = lane; j < M; j += kWarp) s += a[j] * b[j];
    return warp_sum(s);
  }

  // phi(alpha) = (f(x + alpha d), g(x + alpha d) . d)
  __device__ void phi(float alpha, float& f, float& slope) {
    __syncwarp();
    for (int j = lane; j < M; j += kWarp) z[j] = x[j] + alpha * d[j];
    __syncwarp();
    f = eval();
    slope = dot(gz, d);
  }
};

__global__ void enet_lbfgs_kernel(
    const float* __restrict__ A_all, const float* __restrict__ y_all,
    const float* __restrict__ w_all, const float* __restrict__ l2_all,
    const float* __restrict__ l1_all, int per_group, int N, int M, int m,
    int max_iters, float tol_grad, float tol_change, float* x_out,
    float* loss_out, float* grad_out, float* S_out, float* Y_out,
    int* count_out, float* gamma_out, int* iters_out, uint8_t* conv_out,
    uint8_t* stop_out, uint8_t* div_out, int* evals_out,
    unsigned long long* launch_count) {
  extern __shared__ float sm[];
  const int l = blockIdx.x, lane = threadIdx.x;
  // the wrapper's count of this kernel's runs, kept on the card so that
  // launches replayed from a CUDA graph count too
  if (launch_count != nullptr && l == 0 && lane == 0)
    atomicAdd(launch_count, 1ull);
  const int grp = l / per_group;
  float* A = sm;
  float* AT = A + N * M;
  float* y = AT + N * M;
  float* w = y + N;
  float* r = w + N;
  float* x = r + N;
  float* g = x + M;
  float* d = g + M;
  float* z = d + M;
  float* gz = z + M;
  float* q = gz + M;
  float* S = q + M;
  float* Y = S + m * M;
  float* rho = Y + m * M;   // (m,)
  float* al = rho + m;      // (m,)

  const float* Ag = A_all + (size_t)grp * N * M;
  for (int k = lane; k < N * M; k += kWarp) {
    float v = Ag[k];
    A[k] = v;
    AT[(k % M) * N + k / M] = v;
  }
  for (int i = lane; i < N; i += kWarp) {
    y[i] = y_all[(size_t)grp * N + i];
    if (w_all) w[i] = w_all[(size_t)l * N + i];
  }
  for (int j = lane; j < M; j += kWarp) {
    x[j] = 0.f;
    z[j] = 0.f;
    for (int k = 0; k < m; ++k) S[k * M + j] = Y[k * M + j] = 0.f;
  }
  __syncwarp();

  Lane L;
  L.A = A; L.AT = AT; L.y = y; L.w = w_all ? w : nullptr; L.r = r;
  L.z = z; L.gz = gz; L.x = x; L.d = d;
  L.l2 = l2_all[l]; L.l1 = l1_all[l]; L.N = N; L.M = M; L.lane = lane;
  L.evals = 0;

  float loss = L.eval();
  for (int j = lane; j < M; j += kWarp) g[j] = gz[j];
  __syncwarp();
  float gabs = 0.f;
  for (int j = lane; j < M; j += kWarp) gabs += fabsf(g[j]);
  gabs = warp_sum(gabs);
  bool stop = gabs <= tol_grad;
  bool diverged = loss != loss;
  int count = 0, it = 0;
  float gamma = 1.f;

  while (it < max_iters && !stop) {
    // two-loop direction, newest valid pair first
    for (int j = lane; j < M; j += kWarp) q[j] = -g[j];
    __syncwarp();
    for (int k = m - 1; k >= m - count; --k) {
      const float a = rho[k] * L.dot(S + k * M, q);
      if (lane == 0) al[k] = a;
      for (int j = lane; j < M; j += kWarp) q[j] = q[j] - a * Y[k * M + j];
      __syncwarp();
    }
    const float scale = count > 0 ? gamma : 1.f;
    for (int j = lane; j < M; j += kWarp) d[j] = q[j] * scale;
    __syncwarp();
    for (int k = m - count; k < m; ++k) {
      float be = rho[k] * L.dot(Y + k * M, d);
      for (int j = lane; j < M; j += kWarp) d[j] = d[j] + (al[k] - be) * S[k * M + j];
      __syncwarp();
    }
    const float gtd = L.dot(g, d);
    float phi0, gphi0;
    L.phi(0.f, phi0, gphi0);
    const float t = search(L, 1.f, phi0, gphi0);

    // the step: s = t d, x_new = x + s, evaluated at x_new
    __syncwarp();
    float ss = 0.f, sabs = 0.f;
    for (int j = lane; j < M; j += kWarp) {
      float s = t * d[j];
      q[j] = s;                  // q holds s from here on
      z[j] = x[j] + s;
      ss += s * s;
      sabs += fabsf(s);
    }
    ss = warp_sum(ss);
    sabs = warp_sum(sabs);
    __syncwarp();
    const float loss_new = L.eval();
    float ys = 0.f, yy = 0.f, gnew_abs = 0.f;
    for (int j = lane; j < M; j += kWarp) {
      float yj = gz[j] - g[j];
      ys += yj * q[j];
      yy += yj * yj;
      gnew_abs += fabsf(gz[j]);
    }
    ys = warp_sum(ys);
    yy = warp_sum(yy);
    gnew_abs = warp_sum(gnew_abs);
    __syncwarp();
    if (ys > 1e-10f * ss) {      // curvature acceptance: push the pair
      for (int j = lane; j < M; j += kWarp) {
        for (int k = 0; k < m - 1; ++k) {
          S[k * M + j] = S[(k + 1) * M + j];
          Y[k * M + j] = Y[(k + 1) * M + j];
        }
        S[(m - 1) * M + j] = q[j];
        Y[(m - 1) * M + j] = gz[j] - g[j];
      }
      if (lane == 0) {          // one writer: the shift reads what it moves
        for (int k = 0; k < m - 1; ++k) rho[k] = rho[k + 1];
        rho[m - 1] = 1.f / ys;
      }
      __syncwarp();
      count = min(count + 1, m);
      gamma = ys / yy;
    }
    const bool div_new = diverged || (gnew_abs != gnew_abs) ||
                         (loss_new != loss_new);
    const bool stop_new = (gnew_abs <= tol_grad) || (gtd > -tol_change) ||
                          (sabs <= tol_change) ||
                          (fabsf(loss_new - loss) < tol_change) || div_new;
    for (int j = lane; j < M; j += kWarp) {
      x[j] = z[j];
      g[j] = gz[j];
    }
    __syncwarp();
    loss = loss_new;
    it += 1;
    stop = stop_new;
    diverged = div_new;
  }

  for (int j = lane; j < M; j += kWarp) {
    x_out[(size_t)l * M + j] = x[j];
    grad_out[(size_t)l * M + j] = g[j];
    for (int k = 0; k < m; ++k) {
      S_out[((size_t)l * m + k) * M + j] = S[k * M + j];
      Y_out[((size_t)l * m + k) * M + j] = Y[k * M + j];
    }
  }
  if (lane == 0) {
    loss_out[l] = loss;
    count_out[l] = count;
    gamma_out[l] = gamma;
    iters_out[l] = it;
    conv_out[l] = (stop && !diverged) ? 1 : 0;
    stop_out[l] = stop ? 1 : 0;
    div_out[l] = diverged ? 1 : 0;
    evals_out[l] = L.evals;
  }
}

bool fast_path(int N, int M, int m) {
  return N <= kWarp && M <= kWarp && m <= kHist;
}

}  // namespace

extern "C" {

// Shared memory of one lane's block, in bytes.
size_t enet_lbfgs_smem_bytes(int N, int M, int m) {
  if (fast_path(N, M, m))
    return sizeof(float) *
           ((size_t)2 * kWarp + (ENET_A_REGISTERS ? 0 : (size_t)2 * N * M));
  return sizeof(float) * ((size_t)2 * N * M + 3 * (size_t)N + 6 * (size_t)M +
                          2 * (size_t)m * M + 2 * (size_t)m);
}

// Launches L lanes on `stream`; A (n_groups, N, M), y (n_groups, N): lane l
// takes group l / (L / n_groups).  w (L, N) or null.  evals (L,) receives
// each lane's objective evaluations as the kernel performs them (the
// fast path takes the search's phi(0) from the accepted point).
// launch_count (or null) is incremented by one on the device each time the
// kernel runs.  Returns a CUDA error code (0 on success); -1 for bad sizes
// or too much shared memory.
int enet_lbfgs_launch(const float* A, const float* y, const float* w,
                      const float* l2, const float* l1, int L, int n_groups,
                      int N, int M, int m, int max_iters, float tol_grad,
                      float tol_change, float* x, float* loss, float* grad,
                      float* S, float* Y, int* count, float* gamma,
                      int* n_iters, uint8_t* converged, uint8_t* stop,
                      uint8_t* diverged, int* evals,
                      unsigned long long* launch_count, void* stream) {
  if (L <= 0 || n_groups <= 0 || L % n_groups != 0 || N <= 0 || M <= 0 ||
      m <= 0)
    return -1;
  const size_t smem = enet_lbfgs_smem_bytes(N, M, m);
  if (smem > (size_t)kMaxSmem) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast_path(N, M, m)) {
    // the enet env's width (20) has a copy of its own: the unrolled
    // products then run no FMA past it
    if (N <= 20 && M <= 20)
      enet_lbfgs_fast_kernel<20><<<L, kWarp, smem, st>>>(
          A, y, w, l2, l1, L / n_groups, N, M, m, max_iters, tol_grad,
          tol_change, x, loss, grad, S, Y, count, gamma, n_iters, converged,
          stop, diverged, evals, launch_count);
    else
      enet_lbfgs_fast_kernel<kWarp><<<L, kWarp, smem, st>>>(
          A, y, w, l2, l1, L / n_groups, N, M, m, max_iters, tol_grad,
          tol_change, x, loss, grad, S, Y, count, gamma, n_iters, converged,
          stop, diverged, evals, launch_count);
    return static_cast<int>(cudaGetLastError());
  }
  if (smem > 48 * 1024) {
    static int opted = 0;   // once, outside any capture (the first launch)
    if (!opted) {
      cudaError_t e = cudaFuncSetAttribute(
          enet_lbfgs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      opted = 1;
    }
  }
  enet_lbfgs_kernel<<<L, kWarp, smem, st>>>(
      A, y, w, l2, l1, L / n_groups, N, M, m, max_iters, tol_grad,
      tol_change, x, loss, grad, S, Y, count, gamma, n_iters, converged, stop,
      diverged, evals, launch_count);
  return static_cast<int>(cudaGetLastError());
}

const char* enet_lbfgs_error_string(int code) {
  if (code == -1) return "bad sizes, or more shared memory than 232448 bytes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
