// Quadrature (FM) demodulator over planar float32 rows:
//
//   y[r, i] = gain * atan2(im, re) of x[r, i] * conj(x[r, i-1]),
//   x[r, -1] = the row's carried sample (the previous frame's last).
//
// Replaces clenabled_tpu/dsp/pallas_kernels.py: qdemod_fused
// (_qdemod_kernel).  The TPU kernel shifts by one sample with a lane roll and
// carries the sample that crosses each tile in SMEM, because its grid runs in
// order; here every thread reads x[i-1] from device memory itself (the cache
// serves the neighbour's load), so blocks are independent and any length
// 1 <= n < 2^31 works.  atan2f with IEEE signed zeros follows the JAX package's XLA
// form, not the TPU kernel's polynomial; the products are rounded one by one
// (no contraction into FMAs), as the plain torch form rounds them.
//
// Bound on the H100: 8 B read and 4 B written per sample, plus one atan2f;
// memory bound at frame sizes (2^21 samples: 25 MB, about 8 us at 3.35 TB/s).

#include <cuda_runtime.h>

namespace {

// One thread per sample: blockIdx.x walks the row, blockIdx.y the rows.
__global__ void qdemod_kernel(const float* __restrict__ xr,
                              const float* __restrict__ xi,
                              const float* __restrict__ last_r,
                              const float* __restrict__ last_i,
                              float* __restrict__ y, int rows, int n,
                              float gain) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long e = (long long)row * n + i;
    float pr, pi;
    if (i == 0) {
      pr = last_r[row];
      pi = last_i[row];
    } else {
      pr = xr[e - 1];
      pi = xi[e - 1];
    }
    const float a = xr[e], b = xi[e];
    const float cr = __fadd_rn(__fmul_rn(a, pr), __fmul_rn(b, pi));
    const float ci = __fsub_rn(__fmul_rn(b, pr), __fmul_rn(a, pi));
    y[e] = __fmul_rn(gain, atan2f(ci, cr));
  }
}

}  // namespace

// rows independent rows of n samples each (n < 2^31); last_r/last_i hold
// one carried sample per row.  Returns a cudaError_t.
extern "C" int clen_qdemod(const void* xr, const void* xi, const void* last_r,
                           const void* last_i, void* y, int rows, long long n,
                           float gain, void* stream) {
  if (rows < 1 || n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((unsigned)((n + threads - 1) / threads),
                  rows < 65535 ? rows : 65535);
  qdemod_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(last_r), static_cast<const float*>(last_i),
      static_cast<float*>(y), rows, (int)n, gain);
  return cudaGetLastError();
}
