// Rank-factored imager for Hopper (sm_90a): an entry point of the shared
// separable-grid engine (separable_imager.cuh).
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
// Bound.  4 npix^2 R flops (2.74e12 at npix=1024, R=652800): >= 16.6 ms as
// 3xTF32 at the H100 SXM's 495 TFLOP/s dense TF32 rate (>= 41 ms in FP32 on
// the CUDA cores); the 4 npix R sine/cosine values and the bytes are far
// below.  Bound by operations.  The design (trig operands made on chip beside
// the asynchronous wgmma, A in registers and B in shared memory, 3xTF32
// split, split R with a fixed-order second pass) is the engine's; see
// separable_imager.cuh.

#include "separable_imager.cuh"

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

}  // extern "C"
