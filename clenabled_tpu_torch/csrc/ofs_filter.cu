// Overlap-save FFT filter with complex taps over a planar float32 stream:
//
//   y[p] = sum_{k<K} taps[k] * v[T + p - k],   v = tail ++ x,  T >= K-1
//
// for p < n, where the tail holds the previous frame's last T samples, written
// at every D-th sample (y[p] at out[p/D] for p % D == 0).  Replaces
// clenabled_tpu/dsp/pallas_kernels.py: ofs_filter_planar (_ofs_kernel,
// OfsPlan), whose samples equal the overlap-add path's.
//
// Design.  The transform size P is a power of two chosen by the host
// (hopper_kernels.OfsPlan: P >= 4(K-1), at least 256, at most 16384); each
// block owns one chunk of L = P - (K-1) outputs.  It loads the P samples
// v[T + c*L - (K-1), T + c*L + L) into shared memory (the tail/frame seam is
// index arithmetic, so the caller never concatenates), runs a radix-2
// decimation-in-frequency FFT (natural order in, bit-reversed order out),
// multiplies by the tap spectrum (computed once per plan on the host in
// float64, stored in the same bit-reversed order and scaled by 1/P), runs a
// decimation-in-time inverse FFT (bit-reversed in, natural out) and writes
// the last L samples, which circular wrap does not reach.  The two
// transforms meet in bit-reversed order, so no permutation pass is needed.
// Twiddles exp(-2*pi*i*k/P), k < P/2, come from a host table (float64 cast
// to float32) staged in shared memory.
//
// Bound on the H100: per output it reads 8 B (times P/L for the overlap) and
// writes 8 B; the two transforms cost about 10*log2(P) flops per sample in
// shared memory with a barrier per stage.  At the 49-tap path (P = 256) the
// bytes are the floor; the stage barriers and shared-memory traffic are what
// this simple form pays on top.  Register-resident radix-4/8 stages are work
// for later PRs.

#include <cuda_runtime.h>

namespace {

__device__ inline float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ inline float2 cmul_conj(float2 a, float2 b) {   // a * conj(b)
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__host__ __device__ inline long long ofs_smem_bytes(int p) {
  return (long long)p * 8 + (long long)(p / 2) * 8;
}

__global__ void ofs_filter_kernel(const float* __restrict__ xr,
                                  const float* __restrict__ xi,
                                  const float* __restrict__ tr,
                                  const float* __restrict__ ti,
                                  const float2* __restrict__ hspec,
                                  const float2* __restrict__ tw,
                                  float* __restrict__ yr, float* __restrict__ yi,
                                  int n, int tail_len, int ntaps, int p,
                                  int log2p, int decim) {
  extern __shared__ float2 smem2[];
  float2* s = smem2;          // [P] the chunk, transformed in place
  float2* w = smem2 + p;      // [P/2] twiddles
  const int half_p = p >> 1;
  const int valid = p - (ntaps - 1);
  const long long c0 = (long long)blockIdx.x * valid;             // first output
  const long long g0 = (long long)tail_len + c0 - (ntaps - 1);    // first v index
  const long long vend = (long long)tail_len + n;

  for (int i = threadIdx.x; i < half_p; i += blockDim.x) w[i] = tw[i];
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    const long long g = g0 + i;
    float2 v = make_float2(0.f, 0.f);
    if (g < tail_len) {
      v = make_float2(tr[g], ti[g]);
    } else if (g < vend) {
      v = make_float2(xr[g - tail_len], xi[g - tail_len]);
    }
    s[i] = v;
  }
  __syncthreads();

  // forward DIF: spans P/2 .. 1; twiddle exp(-2 pi i pos / (2 half))
  for (int lh = log2p - 1; lh >= 0; --lh) {
    const int half = 1 << lh;
    const int stride = half_p >> lh;
    for (int j = threadIdx.x; j < half_p; j += blockDim.x) {
      const int pos = j & (half - 1);
      const int i0 = ((j >> lh) << (lh + 1)) + pos;
      const float2 a = s[i0], b = s[i0 + half];
      s[i0] = make_float2(a.x + b.x, a.y + b.y);
      s[i0 + half] = cmul(make_float2(a.x - b.x, a.y - b.y), w[pos * stride]);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < p; i += blockDim.x) s[i] = cmul(s[i], hspec[i]);
  __syncthreads();

  // inverse DIT: spans 1 .. P/2; twiddle exp(+2 pi i pos / (2 half))
  for (int lh = 0; lh < log2p; ++lh) {
    const int half = 1 << lh;
    const int stride = half_p >> lh;
    for (int j = threadIdx.x; j < half_p; j += blockDim.x) {
      const int pos = j & (half - 1);
      const int i0 = ((j >> lh) << (lh + 1)) + pos;
      const float2 a = s[i0];
      const float2 b = cmul_conj(s[i0 + half], w[pos * stride]);
      s[i0] = make_float2(a.x + b.x, a.y + b.y);
      s[i0 + half] = make_float2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
  }

  // kept outputs q = c0 + j (j < valid, q < n, q % decim == 0): the first
  // is j0, then every decim-th; neighbouring threads write neighbouring words
  const int j0 = (int)((decim - c0 % decim) % decim);
  const long long o0 = (c0 + j0) / decim;
  const int jend = (int)min((long long)valid, (long long)n - c0);
  for (int m = threadIdx.x; j0 + m * decim < jend; m += blockDim.x) {
    const float2 v = s[ntaps - 1 + j0 + m * decim];
    yr[o0 + m] = v.x;
    yi[o0 + m] = v.y;
  }
}

}  // namespace

// hspec: [P] float2, the bit-reversed tap spectrum / P; tw: [P/2] float2
// twiddles.  n is the frame length (a multiple of decim), tail_len >= K-1.
// Returns a cudaError_t; cudaErrorInvalidValue when P does not fit the
// card's opt-in shared memory or the sizes are inconsistent.
extern "C" int clen_ofs_filter(const void* xr, const void* xi, const void* tr,
                               const void* ti, const void* hspec, const void* tw,
                               void* yr, void* yi, int n, int tail_len,
                               int ntaps, int p, int decim, void* stream) {
  int log2p = 0;
  while ((1 << log2p) < p) ++log2p;
  if (p < 2 || (1 << log2p) != p || ntaps < 1 || ntaps - 1 >= p ||
      tail_len < ntaps - 1 || decim < 1 || n < decim || n % decim)
    return cudaErrorInvalidValue;
  const long long bytes = ofs_smem_bytes(p);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ofs_filter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int valid = p - (ntaps - 1);
  const int nchunks = (n + valid - 1) / valid;
  const int threads = p / 2 < 512 ? p / 2 : 512;
  ofs_filter_kernel<<<nchunks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(tr), static_cast<const float*>(ti),
      static_cast<const float2*>(hspec), static_cast<const float2*>(tw),
      static_cast<float*>(yr), static_cast<float*>(yi), n, tail_len, ntaps, p,
      log2p, decim);
  return cudaGetLastError();
}

extern "C" long long clen_ofs_smem_bytes(int p) { return ofs_smem_bytes(p); }
