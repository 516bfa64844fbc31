// Batched unscaled FFT over a planar float32 stream chopped into N-point
// vectors (N a power of two, 256 <= N <= 16384):
//
//   y[b, k] = sum_{t<N} win[t] * x[b, t] * exp(sign * 2 pi i t k / N),
//
// sign -1 forward, +1 inverse, no scaling, natural order.  The Fft block's
// shift is index arithmetic: forward, out[b, k] = y[b, (k + N/2) mod N] (an
// fftshift); inverse, x[b, t] is read at (t + N/2) mod N before the window
// (the halves swapped on load, lib/clFFT_impl.cc:544-607).  Replaces
// clenabled_tpu/dsp/pallas_kernels.py: fft_batched_fused (_fft_batched_kernel).
//
// Design.  The TPU kernel splits N = n2*128 into two DFT matmuls for its
// matrix unit and reorders the output in VMEM.  Here one block owns one
// vector: its threads load it windowed into shared memory in bit-reversed
// order, run log2(N) radix-2 decimation-in-time stages in place (bit-reversed
// in, natural order out, so no permutation pass follows) with twiddles
// exp(-2 pi i k / N), k < N/2, from a host table (float64 cast to float32)
// staged beside the data, and store natural-order words, neighbouring
// threads on neighbouring words.  12*N bytes of shared memory (192 KiB at
// N = 16384) are set per launch above the 48 KB default.
//
// Bound on the H100: 8 B read and 8 B written per sample (16 MiB each way
// for a 2^21-sample frame: about 10 us at 3.35 TB/s) against 5*log2(N)
// flops per sample (about 1.6 us of FP32 at N = 2048); the shared-memory
// butterflies and a barrier per stage are what this simple form pays on top.
// Register-resident radix-4/8 stages are work for later PRs.

#include <cuda_runtime.h>

namespace {

__host__ __device__ inline long long fft_smem_bytes(int n) {
  return (long long)n * 8 + (long long)(n / 2) * 8;
}

__global__ void fft_batched_kernel(const float* __restrict__ xr,
                                   const float* __restrict__ xi,
                                   const float* __restrict__ win,
                                   const float2* __restrict__ tw,
                                   float* __restrict__ yr,
                                   float* __restrict__ yi, int n, int log2n,
                                   int inverse, int shift) {
  extern __shared__ float2 smem2[];
  float2* s = smem2;          // [N] the vector, transformed in place
  float2* w = smem2 + n;      // [N/2] twiddles
  const int half_n = n >> 1;
  const long long base = (long long)blockIdx.x * n;
  const int in_rot = (inverse && shift) ? half_n : 0;
  const int out_rot = (!inverse && shift) ? half_n : 0;

  for (int i = threadIdx.x; i < half_n; i += blockDim.x) w[i] = tw[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long src = base + ((i + in_rot) & (n - 1));
    float a = xr[src], b = xi[src];
    if (win != nullptr) {
      const float g = win[i];
      a *= g;
      b *= g;
    }
    s[__brev((unsigned)i) >> (32 - log2n)] = make_float2(a, b);
  }
  __syncthreads();

  // decimation in time: spans 1 .. N/2, twiddle exp(sign 2 pi i pos / (2 half))
  for (int lh = 0; lh < log2n; ++lh) {
    const int half = 1 << lh;
    const int stride = half_n >> lh;
    for (int j = threadIdx.x; j < half_n; j += blockDim.x) {
      const int pos = j & (half - 1);
      const int i0 = ((j >> lh) << (lh + 1)) + pos;
      const float2 a = s[i0];
      const float2 c = s[i0 + half];
      float2 t = w[pos * stride];
      if (inverse) t.y = -t.y;
      const float2 b = make_float2(c.x * t.x - c.y * t.y, c.x * t.y + c.y * t.x);
      s[i0] = make_float2(a.x + b.x, a.y + b.y);
      s[i0 + half] = make_float2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
  }

  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float2 v = s[(k + out_rot) & (n - 1)];
    yr[base + k] = v.x;
    yi[base + k] = v.y;
  }
}

}  // namespace

// win: [N] or null; tw: [N/2] float2 exp(-2 pi i k / N).  total: stream
// samples, a multiple of N.  Returns a cudaError_t; cudaErrorInvalidValue
// when N is not a power of two in [256, 16384], the sizes disagree or the
// vector does not fit the card's opt-in shared memory.
extern "C" int clen_fft_batched(const void* xr, const void* xi, const void* win,
                                const void* tw, void* yr, void* yi,
                                long long total, int n, int inverse, int shift,
                                void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if (n < 256 || n > 16384 || (1 << log2n) != n || total < n || total % n ||
      total / n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long bytes = fft_smem_bytes(n);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fft_batched_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int threads = n / 2 < 512 ? n / 2 : 512;
  fft_batched_kernel<<<(unsigned)(total / n), threads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(win), static_cast<const float2*>(tw),
      static_cast<float*>(yr), static_cast<float*>(yi), n, log2n, inverse,
      shift);
  return cudaGetLastError();
}

extern "C" long long clen_fft_smem_bytes(int n) { return fft_smem_bytes(n); }
