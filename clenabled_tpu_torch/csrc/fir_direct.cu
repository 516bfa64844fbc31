// Direct-form FIR with real taps over one or two float32 streams (the planar
// re and im components in one launch), with optional decimation:
//
//   y[o] = sum_{k<K} taps[k] * v[o*D + K-1-k],   v = hist ++ x,  |hist| = K-1
//
// for o < n/D.  Replaces clenabled_tpu/dsp/pallas_kernels.py: fir_direct
// (_fir_kernel, the VPU shifted-MAC form) and fir_direct_mxu (_fir_mxu_kernel,
// the banded-matmul form) -- two TPU engines for one contract, one C entry
// here with two bodies (hopper_kernels.fir_body names the one a call runs).
// Both form each output as one float32 fmaf chain in ascending tap order
// from 0.f, so at D = 1 they agree bit for bit.
//
// fir_direct_kernel, any D (the first design): each block owns `tile`
// consecutive outputs of one component (blockIdx.y), stages the taps and
// the window v[o0*D, (o0+tile-1)*D + K) in shared memory one float at a time
// -- the history/frame seam is index arithmetic on the virtual stream
// hist ++ x, so the caller never concatenates -- and each thread forms
// kPerThread outputs strided by blockDim, one shared-memory load per
// multiply-add plus the tap's broadcast.  Under decimation only every D-th
// output is computed.  At D = 1 that is about one 4-byte shared load per
// FMA: bound by shared-memory loads (128 B a clock an SM) at every K.
//
// fir_reg_kernel, D = 1 (register-tiled sliding window): 256 threads, each
// owning R = 16 consecutive outputs (kFirOuts = 4096 a block; R = 8 read
// 10% slower at 1601 taps, its 2048-output blocks filling 3.1 of 4 waves).
// The window is indexed by the frame's own sample index f (x[f], hist[K-1+f]
// for f < 0), covering f in [o0 - KP, o0 + 4096), KP = K rounded up to 4,
// so that the frame's 16-byte groups stay 16-byte groups whatever K is.
//   stage  taps (zero past K) word by word; the window in 4-sample groups,
//          4 in flight a thread, each one 16-byte __ldg where the frame
//          pointer is 16-byte aligned and the group lies inside the frame,
//          else sample by sample (the history, the frame's ragged end, an
//          unaligned frame; past either end 0).  Group g is stored at
//          fir_swz(g) = g ^ ((g >> 3) & (R/4 - 1)): lanes R words apart then
//          hit 32 banks in each 8-lane phase of a 16-byte access.
//   FIR    taps in chunks of 4 (k0 = 4c): output o0 + lane*R + r reads
//          window words r - j + 4 of groups g0 .. g0 + R/4, g0 = KP/4 +
//          lane*R/4 - 1 - c; the R/4 + 1 groups sit in a register ring whose
//          slots rotate at compile time (R/4 + 1 chunks unrolled), so a chunk
//          is one 16-byte window load, one 16-byte tap broadcast and 4R
//          FMAs.  The last chunk takes K mod 4 taps behind compile-time
//          guards (no zero taps: 0 * inf would differ).
//   store  the sums go to shared memory (the window's words, after a
//          barrier) as R/4 16-byte stores a lane; then each warp writes 128
//          contiguous bytes a store, ragged end masked.
// Shared memory 4 * (2 KP + 4096) B (plus the swizzle's rounding): 29.3 KB
// at K = 1601; 4 blocks an SM (at most 64 registers).
//
// Bound on the H100: per output 4 B read and 4 B written per component and
// K FMAs.  At 49 taps and 2 x 2^21 outputs the bytes bound it (0.0100 ms);
// at 241 and 1601 taps the FP32 cores (0.0302 and 0.2004 ms at 67 TFLOP/s).
// fir_reg_kernel issues 4R FMAs per two shared loads and about four integer
// operations, so it is bound by FP32 issue at large K; the staging of the
// K-1 halo is re-read from L2 by each block (tools/fir_ab.py splits its time
// by stage).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fft_core.cuh"

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

// ---- fir_reg_kernel --------------------------------------------------------

// a timing probe's build (-DFIR_STOP_AFTER=1 or 2) stops each block after
// the staging, or after the FIR and its sums' shared-memory stores; the
// library never sets it
#ifndef FIR_STOP_AFTER
#define FIR_STOP_AFTER 3
#endif
constexpr int kFirR = 16;                    // outputs a lane owns
constexpr int kFirS = kFirR / 4;             // 16-byte groups of a lane's outputs
constexpr int kFirThreads = 256;
constexpr int kFirOuts = kFirThreads * kFirR;  // outputs of a block
constexpr int kFirStageUnroll = 4;           // staging vectors in flight a thread
constexpr int kFirStopAfter = FIR_STOP_AFTER;

__host__ __device__ constexpr int fir_kpad(int ntaps) { return (ntaps + 3) / 4 * 4; }

// window floats: KP + kFirOuts rounded up to whole 32-word swizzle blocks
__host__ __device__ inline long long fir_reg_win_floats(int ntaps) {
  return ((long long)fir_kpad(ntaps) + kFirOuts + 31) / 32 * 32;
}

__host__ __device__ inline long long fir_reg_smem_bytes(int ntaps) {
  return 4LL * (fir_kpad(ntaps) + fir_reg_win_floats(ntaps));
}

// the stored group of window group g (a permutation of each 8-group block)
__device__ __forceinline__ int fir_swz(int g) { return g ^ ((g >> 3) & (kFirS - 1)); }

__global__ void __launch_bounds__(kFirThreads, 4)
fir_reg_kernel(const float* __restrict__ h0, const float* __restrict__ x0,
               float* __restrict__ y0, const float* __restrict__ h1,
               const float* __restrict__ x1, float* __restrict__ y1,
               const float* __restrict__ taps, int ntaps, int n) {
  constexpr int R = kFirR, S = kFirS, G = S + 1;
  extern __shared__ float smem[];
  const int kp = fir_kpad(ntaps);
  float* s_taps = smem;                        // [KP], zero past K
  float* win = smem + kp;                      // [fir_reg_win_floats] swizzled
  const float* hist = blockIdx.y ? h1 : h0;
  const float* x = blockIdx.y ? x1 : x0;
  float* y = blockIdx.y ? y1 : y0;
  const int hl = ntaps - 1;
  const long long o0 = (long long)blockIdx.x * kFirOuts;
  const long long fbase = o0 - kp;             // frame index of window word 0
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  for (int k = threadIdx.x; k < kp; k += kFirThreads)
    s_taps[k] = k < ntaps ? taps[k] : 0.f;
  {
    const int groups = (kp + kFirOuts) / 4;
    for (int i0 = threadIdx.x; i0 < groups; i0 += kFirStageUnroll * kFirThreads) {
      float4 v[kFirStageUnroll];
      fftcore::static_for<kFirStageUnroll>([&](auto u) {
        const int i = i0 + u * kFirThreads;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < groups) {
          const long long f = fbase + 4LL * i;
          if (vec && f >= 0 && f + 4 <= n) {
            v[u] = __ldg(reinterpret_cast<const float4*>(x + f));
          } else {
            float s[4];
            fftcore::static_for<4>([&](auto q) {
              const long long fq = f + decltype(q)::value;
              s[q] = fq < -hl || fq >= n ? 0.f : fq < 0 ? hist[hl + fq] : x[fq];
            });
            v[u] = make_float4(s[0], s[1], s[2], s[3]);
          }
        }
      });
      fftcore::static_for<kFirStageUnroll>([&](auto u) {
        const int i = i0 + u * kFirThreads;
        if (i < groups) reinterpret_cast<float4*>(win)[fir_swz(i)] = v[u];
      });
    }
  }
  __syncthreads();
  if constexpr (kFirStopAfter < 2) return;

  // the lane's ring: window group gw - c + i (i <= S) of chunk c sits in
  // slot (i - c) mod G; chunk c first loads group gw - c into slot -c mod G
  const float4* wg = reinterpret_cast<const float4*>(win);
  const float4* tg = reinterpret_cast<const float4*>(s_taps);
  const int gw = kp / 4 + threadIdx.x * S - 1;
  float ring[G][4];
  float acc[R];
  fftcore::static_for<S>([&](auto i) {
    constexpr int ii = decltype(i)::value + 1;
    const float4 a = wg[fir_swz(gw + ii)];
    ring[ii][0] = a.x; ring[ii][1] = a.y; ring[ii][2] = a.z; ring[ii][3] = a.w;
  });
  fftcore::static_for<R>([&](auto r) { acc[r] = 0.f; });

  // chunk ci (ci mod G = CC): taps 4ci .. 4ci + 3, those below `left` only
  auto chunk = [&](auto cc, int ci, int left, auto partial) {
    constexpr int CC = decltype(cc)::value;
    constexpr int NEW = (G - CC) % G;
    const float4 a = wg[fir_swz(gw - ci)];
    ring[NEW][0] = a.x; ring[NEW][1] = a.y; ring[NEW][2] = a.z; ring[NEW][3] = a.w;
    const float4 t4 = tg[ci];
    const float t[4] = {t4.x, t4.y, t4.z, t4.w};
    fftcore::static_for<4>([&](auto j) {
      constexpr int jj = decltype(j)::value;
      if (!decltype(partial)::value || jj < left) {
        fftcore::static_for<R>([&](auto r) {
          constexpr int w = decltype(r)::value - jj + 4;
          constexpr int slot = (w / 4 - CC + G) % G;
          acc[r] = fmaf(t[jj], ring[slot][w % 4], acc[r]);
        });
      }
    });
  };
  using Full = std::integral_constant<bool, false>;
  using Part = std::integral_constant<bool, true>;
  const int nfull = ntaps / 4, left = ntaps % 4;
  int c = 0;
  for (; c + G <= nfull; c += G) {
    fftcore::static_for<G>([&](auto cc) { chunk(cc, c + decltype(cc)::value, 4, Full{}); });
  }
  fftcore::static_for<G>([&](auto cc) {
    const int ci = c + decltype(cc)::value;
    if (ci < nfull) {
      chunk(cc, ci, 4, Full{});
    } else if (ci == nfull && left) {
      chunk(cc, ci, left, Part{});
    }
  });

  // the sums through shared memory (the window's words), then coalesced
  __syncthreads();
  float4* og = reinterpret_cast<float4*>(win);
  fftcore::static_for<S>([&](auto i) {
    constexpr int b = 4 * decltype(i)::value;
    og[fir_swz(threadIdx.x * S + decltype(i)::value)] =
        make_float4(acc[b], acc[b + 1], acc[b + 2], acc[b + 3]);
  });
  if constexpr (kFirStopAfter < 3) return;
  __syncthreads();
  const long long valid = min((long long)kFirOuts, (long long)n - o0);
  fftcore::static_for<R>([&](auto m) {
    const int o = threadIdx.x + decltype(m)::value * kFirThreads;
    if (o < valid) y[o0 + o] = win[4 * fir_swz(o >> 2) + (o & 3)];
  });
}

int optin_smem(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace

// One or two components (ncomp); h1/x1/y1 are ignored for one.  n is the
// frame length per component (a multiple of decim).  body 0:
// fir_direct_kernel (any decim; its block halved until the window fits the
// card's opt-in shared memory); body 1: fir_reg_kernel (decim 1 only).
// Returns a cudaError_t; cudaErrorInvalidValue when the sizes are
// inconsistent or the block cannot fit in shared memory.
extern "C" int clen_fir_direct(const void* h0, const void* x0, void* y0,
                               const void* h1, const void* x1, void* y1,
                               int ncomp, const void* taps, int ntaps, int n,
                               int decim, int body, void* stream) {
  if (ncomp < 1 || ncomp > 2 || ntaps < 1 || decim < 1 || n < decim || n % decim ||
      body < 0 || body > 1 || (body == 1 && decim != 1))
    return cudaErrorInvalidValue;
  const float* fh0 = static_cast<const float*>(h0);
  const float* fx0 = static_cast<const float*>(x0);
  const float* fh1 = static_cast<const float*>(h1);
  const float* fx1 = static_cast<const float*>(x1);
  const float* ftaps = static_cast<const float*>(taps);
  float* fy0 = static_cast<float*>(y0);
  float* fy1 = static_cast<float*>(y1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    const long long bytes = fir_reg_smem_bytes(ntaps);
    cudaError_t err = fftcore::set_smem(fir_reg_kernel, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((n + kFirOuts - 1) / kFirOuts, ncomp);
    fir_reg_kernel<<<grid, kFirThreads, bytes, st>>>(fh0, fx0, fy0, fh1, fx1, fy1,
                                                     ftaps, ntaps, n);
    return cudaGetLastError();
  }
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
  fir_direct_kernel<<<grid, threads, bytes, st>>>(fh0, fx0, fy0, fh1, fx1, fy1, ftaps,
                                                  ntaps, n, decim, nout);
  return cudaGetLastError();
}

// Shared memory the body's launch would ask for (fir_direct_kernel: the
// smallest block's when even that does not fit; -1 when the card cannot be
// queried).
extern "C" long long clen_fir_smem_bytes(int ntaps, int decim, int body) {
  if (body == 1) return fir_reg_smem_bytes(ntaps);
  int optin = 0;
  if (optin_smem(&optin) != cudaSuccess) return -1;
  const int threads = fir_threads(ntaps, decim, optin);
  const int tile = (threads ? threads : 32) * kPerThread;
  return fir_smem_floats(ntaps, decim, tile) * (long long)sizeof(float);
}

// The current card's opt-in shared memory per block in bytes; a negative
// cudaError_t when the card cannot be asked.
extern "C" int clen_fir_smem_optin() {
  int optin = 0;
  const int err = optin_smem(&optin);
  return err != cudaSuccess ? -err : optin;
}
