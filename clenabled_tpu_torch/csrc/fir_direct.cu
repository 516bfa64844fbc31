// Direct-form FIR with real taps over one or two float32 streams (the planar
// re and im components in one launch), with optional decimation:
//
//   y[o] = sum_{k<K} taps[k] * v[o*D + K-1-k],   v = hist ++ x,  |hist| = K-1
//
// for o < n/D.  Replaces clenabled_tpu/dsp/pallas_kernels.py: fir_direct
// (_fir_kernel, the VPU shifted-MAC form) and fir_direct_mxu (_fir_mxu_kernel,
// the banded-matmul form) -- two TPU engines for one contract, one kernel here.
//
// Design.  Each block owns `tile` consecutive outputs of one component
// (blockIdx.y): it stages the taps and the window v[o0*D, (o0+tile-1)*D + K)
// in shared memory -- the history/frame seam is index arithmetic on the
// virtual stream hist ++ x, so the caller never concatenates -- and each
// thread forms kPerThread outputs, strided by blockDim so that neighbouring
// threads read neighbouring window words.  Under decimation only every D-th
// output is computed, as the JAX function's full-rate result sliced [::D].
// Multiply-adds are float32 fmaf in tap order.
//
// Bound on the H100: per output it reads about 4 B of input per component
// (the window overlap is (K-1)/(tile*D)) and does K multiply-adds, each with
// two shared-memory reads (the tap is a broadcast).  At 49 taps it is memory
// bound (about 16 B per output pair against 98 FMAs); at 241-1601 taps it is
// bound by shared-memory reads on the FP32 cores.  Register blocking of the
// window and tensor-core band products are work for later PRs.

#include <cuda_runtime.h>

namespace {

constexpr int kPerThread = 4;

__host__ __device__ inline long long fir_smem_floats(int ntaps, int decim, int tile) {
  return (long long)ntaps + (long long)(tile - 1) * decim + ntaps;
}

__global__ void fir_direct_kernel(const float* __restrict__ h0,
                                  const float* __restrict__ x0,
                                  float* __restrict__ y0,
                                  const float* __restrict__ h1,
                                  const float* __restrict__ x1,
                                  float* __restrict__ y1,
                                  const float* __restrict__ taps, int ntaps,
                                  int n, int decim, int nout) {
  extern __shared__ float smem[];
  const int tile = blockDim.x * kPerThread;
  float* s_taps = smem;                     // [ntaps]
  float* s_win = smem + ntaps;              // [(tile-1)*decim + ntaps]
  const float* hist = blockIdx.y ? h1 : h0;
  const float* x = blockIdx.y ? x1 : x0;
  float* y = blockIdx.y ? y1 : y0;

  const int hl = ntaps - 1;
  const long long o0 = (long long)blockIdx.x * tile;
  const long long v0 = o0 * decim;          // first virtual sample of the window
  const long long vend = (long long)hl + n; // virtual stream length
  const int win = (tile - 1) * decim + ntaps;
  for (int k = threadIdx.x; k < ntaps; k += blockDim.x) s_taps[k] = taps[k];
  for (int e = threadIdx.x; e < win; e += blockDim.x) {
    const long long v = v0 + e;
    float val = 0.f;
    if (v < hl) {
      val = hist[v];
    } else if (v < vend) {
      val = x[v - hl];
    }
    s_win[e] = val;
  }
  __syncthreads();

  float acc[kPerThread];
  int last[kPerThread];                     // window index of v[o*D + K-1]
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    acc[j] = 0.f;
    last[j] = (threadIdx.x + j * blockDim.x) * decim + hl;
  }
  for (int k = 0; k < ntaps; ++k) {
    const float t = s_taps[k];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc[j] = fmaf(t, s_win[last[j] - k], acc[j]);
  }
  const long long tvalid = min((long long)tile, (long long)nout - o0);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int o = threadIdx.x + j * blockDim.x;
    if (o < tvalid) y[o0 + o] = acc[j];
  }
}

// The largest block (256, 128, 64 or 32 threads) whose window fits the
// card's opt-in shared memory; 0 when none does.
int fir_threads(int ntaps, int decim, int optin) {
  for (int threads = 256; threads >= 32; threads /= 2) {
    const long long bytes =
        fir_smem_floats(ntaps, decim, threads * kPerThread) * (long long)sizeof(float);
    if (bytes <= optin) return threads;
  }
  return 0;
}

int optin_smem(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace

// One or two components (ncomp); h1/x1/y1 are ignored for one.  n is the
// frame length per component (a multiple of decim).  Returns a cudaError_t;
// cudaErrorInvalidValue when the window cannot fit in shared memory.
extern "C" int clen_fir_direct(const void* h0, const void* x0, void* y0,
                               const void* h1, const void* x1, void* y1,
                               int ncomp, const void* taps, int ntaps, int n,
                               int decim, void* stream) {
  if (ncomp < 1 || ncomp > 2 || ntaps < 1 || decim < 1 || n < decim || n % decim)
    return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = static_cast<cudaError_t>(optin_smem(&optin));
  if (err != cudaSuccess) return err;
  const int threads = fir_threads(ntaps, decim, optin);
  if (threads == 0) return cudaErrorInvalidValue;
  const int tile = threads * kPerThread;
  const long long bytes = fir_smem_floats(ntaps, decim, tile) * (long long)sizeof(float);
  err = cudaFuncSetAttribute(fir_direct_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int nout = n / decim;
  const dim3 grid((nout + tile - 1) / tile, ncomp);
  fir_direct_kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h0), static_cast<const float*>(x0),
      static_cast<float*>(y0), static_cast<const float*>(h1),
      static_cast<const float*>(x1), static_cast<float*>(y1),
      static_cast<const float*>(taps), ntaps, n, decim, nout);
  return cudaGetLastError();
}

// Shared memory the launch would ask for (the smallest block's when even
// that does not fit; -1 when the card cannot be queried).
extern "C" long long clen_fir_smem_bytes(int ntaps, int decim) {
  int optin = 0;
  if (optin_smem(&optin) != cudaSuccess) return -1;
  const int threads = fir_threads(ntaps, decim, optin);
  const int tile = (threads ? threads : 32) * kPerThread;
  return fir_smem_floats(ntaps, decim, tile) * (long long)sizeof(float);
}
