// Fused FX correlator step: critically sampled PFB -> M-point inverse DFT ->
// FD cross-correlation magnitude sums and X-Engine Gram sums, in one pass
// over the antenna streams.
//
// Replaces clenabled_tpu/dsp/pallas_kernels.py: fx_correlate_streams_v2
// (kernel body _fx_stream_kernel_v2, math _fx_tile_math).  Written from what
// that function computes, not from its TPU tiling.  With v = tail ++ frame
// per component, taps[c*m + j] = taps_rm[c, j] and t in [0, n/m):
//
//   acc[t, j]  = sum_{c<W} taps[c*m + j] * v[t*m + W*m - 1 - j - c*m]
//   z[t, k]    = sum_j acc[t, j] * exp(+2*pi*i*j*k/m)      (unscaled; re part
//                from antenna a's re stream, im part from its im stream)
//   fd[f, l]   = sum_t | sum_k z_p[t,k] conj(z_q[t,k]) exp(+2*pi*i*k*l/m) |
//   gram[b, k] = sum_t Re(z_s1 conj z_s2),  gram[b, m + k] = sum_t Im(...)
//
// Design.  Each block owns a tile of `tile` output vectors.  It stages its
// window of v for all 2A components in shared memory (index arithmetic picks
// the tail or the frame, so no host concat; int8/bf16 widen to f32 after the
// load and int8 stays unscaled), computes the branch sums, the stage-1 DFT
// from a twiddle table, the per-pair lag DFT and sqrtf, and reduces over its
// t in fixed order into a per-block partial row.  A second launch sums the
// partial rows in fixed block order, so the output is deterministic and no
// atomics are used.  (On the TPU the sums ride a sequential grid in VMEM
// scratch; Hopper blocks run in no order, hence the two passes.)
//
// Bound on the H100: about 11.5 GFLOP per 2^23-sample, 4-antenna step against
// 256 MiB read for f32 ingest, i.e. FP32-core compute rather than bytes.  This
// first version runs every multiply-add on the FP32 cores out of shared
// memory; moving the branch stage and the DFTs onto wgmma with TMA-fed tiles
// is work for later PRs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }

// Shared-memory floats for one block; the layout is spelled out in the kernel.
__host__ __device__ inline long long fx_smem_floats(int a, int m, int w, int tile) {
  const long long tm = (long long)tile * m;
  const long long span = tm + (long long)w * m - 1;
  return 2LL * a * span + 2LL * a * tm + tm + (long long)w * m + 2LL * m;
}

template <typename T>
__global__ void fx_tile_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                               const T* __restrict__ tr, const T* __restrict__ ti,
                               const float* __restrict__ taps,
                               const float* __restrict__ tw,
                               const int* __restrict__ fd_pairs, int nfd,
                               const int* __restrict__ xe_pairs, int nb,
                               int a, int m, int w, int n, int h, int tile,
                               float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int g = 2 * a;
  const int tm = tile * m;
  const int span = tm + w * m - 1;
  float* win = smem;                   // [g][span] window of v; later z [g][tm]
  float* acc = win + (long long)g * span;  // [g][tm] branch sums; later prod [2][tm]
  float* mag = acc + (long long)g * tm;    // [tm] lag-DFT magnitudes
  float* s_taps = mag + tm;            // [w*m]
  float* s_cos = s_taps + w * m;       // [m]
  float* s_sin = s_cos + m;            // [m]

  const int nout = n / m;
  const long long t0 = (long long)blockIdx.x * tile;
  const int tvalid = min(tile, (int)(nout - t0));
  const int span_valid = tvalid * m + w * m - 1;
  const long long base = t0 * m;       // index in v of win[c][0]

  for (int e = threadIdx.x; e < w * m; e += blockDim.x) s_taps[e] = taps[e];
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    s_cos[e] = tw[e];
    s_sin[e] = tw[m + e];
  }
  for (int e = threadIdx.x; e < g * span; e += blockDim.x) {
    const int c = e / span;
    const int k = e - c * span;
    float v = 0.f;
    if (k < span_valid) {
      const long long s = base + k;
      const int ant = c < a ? c : c - a;
      if (s < h) {
        v = widen((c < a ? tr : ti)[(long long)ant * h + s]);
      } else {
        v = widen((c < a ? xr : xi)[(long long)ant * n + (s - h)]);
      }
    }
    win[e] = v;
  }
  __syncthreads();

  // polyphase branch sums
  for (int e = threadIdx.x; e < g * tm; e += blockDim.x) {
    const int c = e / tm;
    const int r = e - c * tm;
    const int tl = r / m;
    const int j = r - tl * m;
    const float* src = win + (long long)c * span + tl * m + w * m - 1 - j;
    float s = 0.f;
    for (int cc = 0; cc < w; ++cc) s = fmaf(s_taps[cc * m + j], src[-cc * m], s);
    acc[e] = s;
  }
  __syncthreads();

  // stage-1 unscaled inverse DFT per antenna: z = (acc_re + i acc_im) F
  float* z = win;
  for (int e = threadIdx.x; e < a * tm; e += blockDim.x) {
    const int ai = e / tm;
    const int r = e - ai * tm;
    const int tl = r / m;
    const int k = r - tl * m;
    const float* pr = acc + (long long)ai * tm + tl * m;
    const float* pi = acc + (long long)(a + ai) * tm + tl * m;
    float zr = 0.f, zi = 0.f;
    int idx = 0;
    for (int j = 0; j < m; ++j) {
      const float c = s_cos[idx], s = s_sin[idx];
      zr = fmaf(pr[j], c, fmaf(-pi[j], s, zr));
      zi = fmaf(pr[j], s, fmaf(pi[j], c, zi));
      idx += k;
      if (idx >= m) idx -= m;
    }
    z[(long long)ai * tm + r] = zr;
    z[(long long)(a + ai) * tm + r] = zi;
  }
  __syncthreads();

  const int width = nfd * m + 2 * nb * m;
  float* out = partial + (long long)blockIdx.x * width;

  // X-Engine Gram sums over this block's t, one thread per (baseline, k)
  for (int e = threadIdx.x; e < nb * m; e += blockDim.x) {
    const int b = e / m;
    const int k = e - b * m;
    const int s1 = xe_pairs[2 * b], s2 = xe_pairs[2 * b + 1];
    const float* r1 = z + (long long)s1 * tm + k;
    const float* i1 = z + (long long)(a + s1) * tm + k;
    const float* r2 = z + (long long)s2 * tm + k;
    const float* i2 = z + (long long)(a + s2) * tm + k;
    float gr = 0.f, gi = 0.f;
    for (int tl = 0; tl < tvalid; ++tl) {
      const int o = tl * m;
      gr += r1[o] * r2[o] + i1[o] * i2[o];
      gi += i1[o] * r2[o] - r1[o] * i2[o];
    }
    out[nfd * m + 2 * b * m + k] = gr;
    out[nfd * m + 2 * b * m + m + k] = gi;
  }

  // FD correlator, one pair at a time
  float* prr = acc;
  float* pri = acc + tm;
  for (int f = 0; f < nfd; ++f) {
    const int p = fd_pairs[2 * f], q = fd_pairs[2 * f + 1];
    for (int e = threadIdx.x; e < tm; e += blockDim.x) {
      const float r0 = z[(long long)p * tm + e], i0 = z[(long long)(a + p) * tm + e];
      const float rq = z[(long long)q * tm + e], iq = z[(long long)(a + q) * tm + e];
      prr[e] = r0 * rq + i0 * iq;
      pri[e] = i0 * rq - r0 * iq;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < tm; e += blockDim.x) {
      const int tl = e / m;
      const int l = e - tl * m;
      const float* xr_ = prr + tl * m;
      const float* xi_ = pri + tl * m;
      float yr = 0.f, yi = 0.f;
      int idx = 0;
      for (int k = 0; k < m; ++k) {
        const float c = s_cos[idx], s = s_sin[idx];
        yr = fmaf(xr_[k], c, fmaf(-xi_[k], s, yr));
        yi = fmaf(xr_[k], s, fmaf(xi_[k], c, yi));
        idx += l;
        if (idx >= m) idx -= m;
      }
      mag[e] = sqrtf(yr * yr + yi * yi);
    }
    __syncthreads();
    for (int l = threadIdx.x; l < m; l += blockDim.x) {
      float s = 0.f;
      for (int tl = 0; tl < tvalid; ++tl) s += mag[tl * m + l];
      out[f * m + l] = s;
    }
  }
}

// out[o] = sum over blocks of partial[blk][o], in a fixed order: thread i
// sums blocks i, i + 256, ... and a fixed tree folds the 256 threads.
constexpr int kReduceThreads = 256;

__global__ void fx_reduce_kernel(const float* __restrict__ partial, int nblk,
                                 int width, float* __restrict__ out) {
  __shared__ float red[kReduceThreads];
  const int o = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < nblk; b += kReduceThreads)
    s += partial[(long long)b * width + o];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[o] = red[0];
}

template <typename T>
cudaError_t launch_fx(const void* xr, const void* xi, const void* tr,
                      const void* ti, const float* taps, const float* tw,
                      const int* fd_pairs, int nfd, const int* xe_pairs, int nb,
                      int a, int m, int w, int n, int h, int tile,
                      float* partial, float* out, cudaStream_t stream) {
  const long long bytes = fx_smem_floats(a, m, w, tile) * (long long)sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fx_tile_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int nout = n / m;
  const int nblk = (nout + tile - 1) / tile;
  fx_tile_kernel<T><<<nblk, 256, bytes, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<const T*>(tr), static_cast<const T*>(ti), taps, tw,
      fd_pairs, nfd, xe_pairs, nb, a, m, w, n, h, tile, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = nfd * m + 2 * nb * m;
  if (width > 0) {
    fx_reduce_kernel<<<width, kReduceThreads, 0, stream>>>(partial, nblk, width, out);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8.  Returns a cudaError_t.
extern "C" int clen_fx_correlate(const void* xr, const void* xi, const void* tr,
                                 const void* ti, int dtype, const void* taps,
                                 const void* tw, const void* fd_pairs, int nfd,
                                 const void* xe_pairs, int nb, int a, int m,
                                 int w, int n, int h, int tile, void* partial,
                                 void* out, void* stream) {
  const float* tp = static_cast<const float*>(taps);
  const float* twp = static_cast<const float*>(tw);
  const int* fdp = static_cast<const int*>(fd_pairs);
  const int* xep = static_cast<const int*>(xe_pairs);
  float* pp = static_cast<float*>(partial);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_fx<float>(xr, xi, tr, ti, tp, twp, fdp, nfd, xep, nb, a, m,
                              w, n, h, tile, pp, op, st);
    case 1:
      return launch_fx<__nv_bfloat16>(xr, xi, tr, ti, tp, twp, fdp, nfd, xep, nb,
                                      a, m, w, n, h, tile, pp, op, st);
    case 2:
      return launch_fx<int8_t>(xr, xi, tr, ti, tp, twp, fdp, nfd, xep, nb, a, m,
                               w, n, h, tile, pp, op, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" long long clen_fx_smem_bytes(int a, int m, int w, int tile) {
  return fx_smem_floats(a, m, w, tile) * (long long)sizeof(float);
}
