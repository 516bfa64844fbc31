// Oversampled (R < M, R | M) polyphase channelizer step over a planar
// float32 stream:
//
//   acc[i, j] = sum_{c<W} taps[c*M + j] * v[i*R + W*M - 1 - j - c*M],
//   z[i, k]   = sum_{j<M} acc[i, j] * exp(+2 pi i ((j + s_i) mod M) k / M),
//   s_i       = ((i + i_offset) * (M - R)) mod M,
//
// for the virtual stream v = tail ++ x (the tail holds the previous frame's
// last H samples), output groups i < n/R, written to z[n/R, M] in group
// order.  The second line is the reference's oversampling rotation
// out[i, (j + i*(M-R)) mod M] = acc[i, j] followed by the unscaled inverse
// DFT (clPolyphaseChannelizer_impl.cc:156-167, :208-225): rotating the
// lanes is the same as reading the twiddle table at (j + s_i) k mod M.
// Replaces clenabled_tpu/dsp/pallas_kernels.py: pfb_oversampled_fused
// (_pfb_os_kernel, _pfb_os_constants).
//
// Design.  The TPU kernel folds branch sums, rotation and DFT into banded
// E[q, f] matrices for its matrix unit and interleaves the phases in VMEM.
// Here each block owns G consecutive output groups: it stages the window
// v[i0*R, (i0+G-1)*R + W*M) of both components in shared memory (the
// tail/frame seam is index arithmetic, so the caller never concatenates),
// one thread per (group, subfilter) forms the branch sums from shared memory,
// then one thread per (group, channel) forms the M-point DFT from the sums
// and a twiddle table (float64 cos/sin cast to float32).  M | 128, so
// (j + s) k mod M is a mask.
//
// Bound on the H100: per input sample 8 B read and, per output group, 8*M B
// written (L = M/R times the input bytes): memory bound at the 16-channel,
// R = 8 path (2^23 samples: 64 MiB in, 128 MiB out, about 60 us at 3.35
// TB/s) where the 2*W + 4*M flops per output value are about 30 us of FP32.
// The direct DFT grows with M; a shared-memory FFT per group is later work.

#include <cuda_runtime.h>

namespace {

__host__ __device__ inline long long os_smem_bytes(int m, int r, int w, int g) {
  return 8LL * ((long long)(g - 1) * r + (long long)w * m) + 8LL * g * m + 8LL * m;
}

__global__ void pfb_os_kernel(const float* __restrict__ xr,
                              const float* __restrict__ xi,
                              const float* __restrict__ tr,
                              const float* __restrict__ ti,
                              const float* __restrict__ taps,
                              const float* __restrict__ tw,
                              float* __restrict__ zr, float* __restrict__ zi,
                              int n, int h, int m, int r, int w, int i_offset,
                              int groups, int nout) {
  extern __shared__ float smem[];
  const int span = (groups - 1) * r + w * m;   // window samples
  float* wr = smem;                   // [span]
  float* wi = wr + span;              // [span]
  float* ar = wi + span;              // [groups * m] branch sums, re
  float* ai = ar + groups * m;        // [groups * m] branch sums, im
  float* cs = ai + groups * m;        // [m] cos(2 pi q / m)
  float* sn = cs + m;                 // [m] sin(2 pi q / m)

  const long long i0 = (long long)blockIdx.x * groups;
  const long long q0 = i0 * r;        // first v index of the window
  const long long vend = (long long)h + n;
  const int gcount = (int)min((long long)groups, (long long)nout - i0);
  const int used = (gcount - 1) * r + w * m;

  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    cs[t] = tw[t];
    sn[t] = tw[m + t];
  }
  for (int t = threadIdx.x; t < used; t += blockDim.x) {
    const long long q = q0 + t;
    float a = 0.f, b = 0.f;
    if (q < h) {
      a = tr[q];
      b = ti[q];
    } else if (q < vend) {
      a = xr[q - h];
      b = xi[q - h];
    }
    wr[t] = a;
    wi[t] = b;
  }
  __syncthreads();

  // branch sums: neighbouring threads take neighbouring subfilters, whose
  // window words are neighbours (descending), so shared reads do not clash
  const int outs = gcount * m;
  for (int e = threadIdx.x; e < outs; e += blockDim.x) {
    const int g = e / m;
    const int j = e - g * m;
    const int base = g * r + w * m - 1 - j;
    float sr = 0.f, si = 0.f;
    for (int c = w - 1; c >= 0; --c) {      // oldest tap row first
      const float tap = taps[c * m + j];
      sr += tap * wr[base - c * m];
      si += tap * wi[base - c * m];
    }
    ar[e] = sr;
    ai[e] = si;
  }
  __syncthreads();

  // rotated unscaled inverse DFT per group; output words are contiguous
  const int mask = m - 1;
  for (int e = threadIdx.x; e < outs; e += blockDim.x) {
    const int g = e / m;
    const int k = e - g * m;
    const int s = (int)(((i0 + g + i_offset) % m) * (m - r) % m);
    const float* a_r = ar + g * m;
    const float* a_i = ai + g * m;
    float yr = 0.f, yi = 0.f;
    for (int j = 0; j < m; ++j) {
      const int q = (((j + s) & mask) * k) & mask;
      const float c = cs[q], d = sn[q];
      yr += a_r[j] * c - a_i[j] * d;
      yi += a_r[j] * d + a_i[j] * c;
    }
    const long long o = (i0 + g) * m + k;
    zr[o] = yr;
    zi[o] = yi;
  }
}

// The current card's opt-in shared memory per block, in *optin.
cudaError_t smem_optin(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace

// Shared memory of one block of `groups` output groups.
extern "C" long long clen_os_smem_bytes(int m, int r, int w, int groups) {
  return os_smem_bytes(m, r, w, groups);
}

// 1 when one output group's window fits the current card's opt-in shared
// memory (the kernel can run this configuration), 0 when it does not; a
// negative cudaError_t when the card cannot be asked.
extern "C" int clen_os_fits(int m, int r, int w) {
  int optin = 0;
  const cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return -(int)err;
  return os_smem_bytes(m, r, w, 1) <= optin ? 1 : 0;
}

// taps: [W*M] branch-major (taps[c*M + j]); tw: [2, M] cos and sin of
// 2 pi q / M.  n: frame samples (a multiple of M); h: tail samples, more than
// the reach W*M - R; i_offset in [0, M).  groups: output groups per block, at
// most; halved until the block fits the card's opt-in shared memory.
// Returns a cudaError_t; cudaErrorInvalidValue when the sizes are
// inconsistent or one group's window does not fit.
extern "C" int clen_pfb_oversampled(const void* xr, const void* xi,
                                    const void* tr, const void* ti,
                                    const void* taps, const void* tw, void* zr,
                                    void* zi, int n, int h, int m, int r, int w,
                                    int i_offset, int groups, void* stream) {
  if (m < 2 || m > 128 || (m & (m - 1)) || r < 1 || m % r || r == m ||
      w < 1 || groups < 1 || n < m || n % m || h < w * m - r ||
      i_offset < 0 || i_offset >= m)
    return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  while (groups > 1 && os_smem_bytes(m, r, w, groups) > optin) groups /= 2;
  const long long bytes = os_smem_bytes(m, r, w, groups);
  if (bytes > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(pfb_os_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int nout = n / r;
  const int blocks = (nout + groups - 1) / groups;
  pfb_os_kernel<<<blocks, 256, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(tr), static_cast<const float*>(ti),
      static_cast<const float*>(taps), static_cast<const float*>(tw),
      static_cast<float*>(zr), static_cast<float*>(zi), n, h, m, r, w, i_offset,
      groups, nout);
  return cudaGetLastError();
}
