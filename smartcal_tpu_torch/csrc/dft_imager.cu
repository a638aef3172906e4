// Dirty imager for Hopper (sm_90a): an entry point of the shared
// separable-grid engine (separable_imager.cuh).
//
// Replaces the Pallas TPU kernel smartcal_tpu/ops/pallas_imager.py
// `_imager_kernel` (wrapper `dirty_image_pallas`), the data and residual
// images behind every reward:
//
//     img[p] = (1/R) * sum_r [cos(phi_pr) v_re[r] + sin(phi_pr) v_im[r]],
//     phi_pr = l_p * u_r + m_p * v_r.
//
// The TPU kernel's wrapper only ever images the separable pixel grid
// (l_i, m_j) = ((i - npix/2) cell, (j - npix/2) cell), so by angle addition
// the image is the engine's GEMM: cos(a+b) vr + sin(a+b) vi =
// cos b (cos a vr + sin a vi) + sin b (cos a vi - sin a vr), a = l_i u_r,
// b = m_j v_r, each reduced mod 2 pi before the trig.  The direct DFT
// (ops/dft_imager.dirty_image_reference) stays the definition the kernel is
// held against, at rtol 2e-4 / atol 2e-5 mean|vis|.
//
// Bound.  Evaluated directly, the image needs 2 P R sine/cosine values on
// the special-function units: >= 327 ms at P = 1024^2, R = 652800 on an
// H100 SXM (16 per clock per SM at 1.98 GHz, from the data sheet).  The
// separable form needs 4 npix R of them and 4 npix^2 R flops, >= 16.6 ms
// as 3xTF32 at the 495 TFLOP/s dense TF32 rate.  Bound by operations.  The
// design is the engine's; see separable_imager.cuh.

#include "separable_imager.cuh"

extern "C" {

// See separable::image_launch.
int dft_image_launch(const float* axis, const float* samples, float* partial,
                     float* out, int npix, int R, int n_split, int chunk,
                     void* stream) {
  return separable::image_launch(axis, samples, partial, out, npix, R,
                                 n_split, chunk, stream);
}

const char* dft_image_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
