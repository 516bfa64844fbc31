// Lane-packed critically sampled PFB channelizer: branch multiply-adds and
// the per-group M-point unscaled inverse DFT, in one pass.
//
// Replaces clenabled_tpu/dsp/pallas_kernels.py: pfb_channelize_packed (kernel
// body _pfb_kernel, DFT matrix _idft_block_matrix).  With G = 2A lane groups
// of m lanes (groups 0..A-1 the antennas' re parts, A..2A-1 their im parts):
//
//   acc[i, l] = sum_{wp<W} hr[wp, l] * y[i + wp, l]
//   z_re = acc_re Fr^T - acc_im Fi^T,   z_im = acc_re Fi^T + acc_im Fr^T
//
// with F[k, j] = exp(+2*pi*i*j*k/m), per antenna, written back in the input's
// lane layout.  The lane packing itself (channelizer._pack_streams) stays
// plain torch outside the kernel, as it is XLA outside the kernel in JAX.
//
// Design.  Each block owns `tile` output rows: it stages rows
// [i0, i0 + tile + W - 1) of y in shared memory (each input row is read from
// device memory by at most two neighbouring blocks), forms the branch sums
// into shared memory, then applies the DFT from a twiddle table, one thread
// per (row, antenna, channel).
//
// Bound on the H100: at the planar entry shape (2^17 samples, A = 4, W = 25)
// the step is small; per output lane it reads 4 B and does W + 4m multiply-
// adds, so it is FP32-core compute once the tile is staged, not bytes.  This
// first version keeps every multiply-add on the FP32 cores; the DFT as a
// wgmma product and TMA loads are work for later PRs.

#include <cuda_runtime.h>

namespace {

__host__ __device__ inline long long pfb_smem_floats(int a, int m, int w, int tile) {
  const long long gm = 2LL * a * m;
  return (2LL * tile + w - 1) * gm + 2LL * m;
}

__global__ void pfb_packed_kernel(const float* __restrict__ y,
                                  const float* __restrict__ hr,
                                  const float* __restrict__ tw,
                                  float* __restrict__ out, int nout, int w,
                                  int a, int m, int tile) {
  extern __shared__ float smem[];
  const int gm = 2 * a * m;
  const int rows = tile + w - 1;
  float* ys = smem;                          // [rows][gm]
  float* acc = ys + (long long)rows * gm;    // [tile][gm]
  float* s_cos = acc + (long long)tile * gm; // [m]
  float* s_sin = s_cos + m;                  // [m]

  const long long i0 = (long long)blockIdx.x * tile;
  const int tvalid = min(tile, (int)(nout - i0));
  const int rvalid = tvalid + w - 1;
  const float* src = y + i0 * gm;
  for (int e = threadIdx.x; e < rows * gm; e += blockDim.x)
    ys[e] = e < rvalid * gm ? src[e] : 0.f;
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    s_cos[e] = tw[e];
    s_sin[e] = tw[m + e];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < tile * gm; e += blockDim.x) {
    const int r = e / gm;
    const int l = e - r * gm;
    float s = 0.f;
    for (int wp = 0; wp < w; ++wp) s = fmaf(hr[wp * gm + l], ys[(r + wp) * gm + l], s);
    acc[e] = s;
  }
  __syncthreads();

  const int am = a * m;
  for (int e = threadIdx.x; e < tvalid * am; e += blockDim.x) {
    const int r = e / am;
    const int rem = e - r * am;
    const int ai = rem / m;
    const int k = rem - ai * m;
    const float* pr = acc + (long long)r * gm + ai * m;
    const float* pi = acc + (long long)r * gm + (a + ai) * m;
    float zr = 0.f, zi = 0.f;
    int idx = 0;
    for (int j = 0; j < m; ++j) {
      const float c = s_cos[idx], s = s_sin[idx];
      zr = fmaf(pr[j], c, fmaf(-pi[j], s, zr));
      zi = fmaf(pr[j], s, fmaf(pi[j], c, zi));
      idx += k;
      if (idx >= m) idx -= m;
    }
    float* dst = out + (i0 + r) * gm;
    dst[ai * m + k] = zr;
    dst[(a + ai) * m + k] = zi;
  }
}

}  // namespace

// Returns a cudaError_t.
extern "C" int clen_pfb_packed(const void* y, const void* hr, const void* tw,
                               void* out, int nout, int w, int a, int m,
                               int tile, void* stream) {
  const long long bytes = pfb_smem_floats(a, m, w, tile) * (long long)sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(pfb_packed_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int nblk = (nout + tile - 1) / tile;
  pfb_packed_kernel<<<nblk, 256, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(hr),
      static_cast<const float*>(tw), static_cast<float*>(out), nout, w, a, m, tile);
  return cudaGetLastError();
}

extern "C" long long clen_pfb_smem_bytes(int a, int m, int w, int tile) {
  return pfb_smem_floats(a, m, w, tile) * (long long)sizeof(float);
}
