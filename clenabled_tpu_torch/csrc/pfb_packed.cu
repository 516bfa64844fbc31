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
// The TPU kernel applies the DFT as a [G*m, G*m] block matrix on its matrix
// unit; neither body here does (TF32 would break the 1e-4 gate).
//
// Three bodies (hopper_kernels.pfb_packed_body names the one a call runs):
//
// pfb_packed_reg_kernel<M>, M in {2, 4, 8, 16}: 256 threads; a block owns
// kPkRows = 32 output rows of one chunk of
// C = min(A - a0, 64/M) antennas a0.. (blockIdx.y), always as 128 window
// columns: 64 re lanes (columns a0*M..) then 64 im lanes ((A+a0)*M..), of
// which C*M each are real and the rest idle, so that every warp access has
// one geometry whatever A is (A = 1 and odd A leave a chunk part-filled).
//   stage  window rows [i0, i0 + 32 + W) of the chunk's columns into
//          [32 + W][128] floats, and the W tap rows of its columns into
//          [W][128], with 16-byte cp.async copies, all of a thread's in
//          flight at once, when y, hr and out are 16-byte aligned and every
//          segment is a whole number of 16-byte groups (M >= 4, or even A);
//          else word by word.  Rows past the valid outputs' reach
//          (tvalid + W - 1) are zero-filled, never read from y.
//   FIR    lane = (strip of S = 16 rows, column): S sums and an S-value
//          window in registers, the slots rotating at compile time
//          (fftcore::static_for), one tap load and one window load from
//          shared memory per S FMAs (the last W mod S taps loaded ahead of
//          their FMAs).  Each sum is an fmaf chain over ascending taps from
//          0.f on the same operands as pfb_packed_kernel's (the numpy replay
//          in tests/test_torch_kernels.py holds its schedule to that chain).
//          A warp reads 32 consecutive words of a row: no
//          bank conflict.  The sums go to two planes [32][64] (re, im) at
//          pk_swz(r*64 + c).
//   DFT    lane = 16 consecutive sums of a plane row (16/M groups), read as
//          four float4 from each plane, fftcore::dft<M, s*M, true> in
//          registers (unscaled inverse), written back in place.
//   store  after a barrier, each warp copies one output row's re and im
//          segments with 16-byte stores (coalesced 256-byte runs).
//   pk_swz XORs a 16-byte group's bits 2-3 with bits 5-6 of its word index:
//          every FIR store, DFT float4 load and store and copy-out load hits
//          32 distinct banks (checked in tests/test_torch_kernels.py).
// pfb_packed_wide_kernel<M>, M in {32, 64, 128} (a third body, not a
// widening of pfb_packed_reg_kernel, whose DFT lanes hold whole groups):
// 256 threads; a block owns RB = 4096/M output rows of one antenna a
// (blockIdx.y), as 2M window columns: its M re lanes (y's columns a*M..)
// then its M im lanes ((A+a)*M..).
//   stage  window rows [i0, i0 + RB + W) into [RB + W][2M] floats and the
//          W tap rows of the same columns into [W][2M], with 16-byte
//          cp.async copies, all of a thread's in flight at once, when y, hr
//          and out are 16-byte aligned (every segment is a whole number of
//          16-byte groups at M >= 32); else word by word.  Rows past the
//          valid outputs' reach (tvalid + W - 1) are zero-filled, never read
//          from y.  The taps are staged for the block's own re and im
//          columns, so any hr is taken, lane-tiled or not.
//   FIR    one job a thread: (strip of S = kPwStrip rows, column j), j
//          fastest, both components a lane: 2S sums and a 2S-value window
//          in registers, the slots rotating at compile time, two tap and
//          two window loads per 2S FMAs (a warp reads 32 consecutive words
//          of a row: no bank conflict).  Each sum is an fmaf chain over
//          ascending taps from 0.f on pfb_packed_kernel's operands.  After
//          a barrier the complex sums overlay the window as float2 slots
//          of each warp's tile of 512 (widedft::fir_slot: point j of row g
//          at row j / Q, column Q ((g mod GW) ^ (row mod GW)) + j mod Q,
//          Q = M/16, GW = 32/Q rows a tile), so a block holds the window,
//          the taps and a table, and three blocks fit an SM at M <= 64.
//   DFT    warp w transforms the GW rows of tile w (RB M / 512 = 8 tiles,
//          one a warp), each on Q lanes: widedft::transform (wide_dft.cuh,
//          shared with pfb_oversampled.cu and fx_correlate.cu), pass 1
//          fftcore::dft<16> times exp(+2 pi i q k1 / M), pass 2
//          fftcore::dft<Q>, then bin k to slot widedft::out_slot<M>(g, k).
//   store  each warp copies its own tile's valid rows out: two 16-byte
//          loads of (re, im) pairs and two 16-byte stores a lane per 4
//          bins (runs of 4M bytes a row and component).
//   tests/test_torch_kernels.py replays the staging, the FIR schedule, the
//   transform and the copy-out in numpy and checks every warp access's
//   banks.
// pfb_packed_kernel, any m (the first design): each block stages whole rows
//   [i0, i0 + tile + W - 1) of y in shared memory one float at a time, forms
//   the branch sums into shared memory (a tap load from device memory and a
//   window load a multiply-add), then applies the DFT from a twiddle table,
//   one thread per (row, antenna, channel).
//
// Bound on the H100: per output lane 4 B read (plus the W-1 halo rows of
// each block) and 4 B written, W multiply-adds and the M-point transform
// (5 M log2 M flops a group): memory bound at the planar step's shape (4
// antennas, 16 channels, W = 25), 2.5 us at 2^17 samples, where launch and
// tail latencies weigh, and 0.160 ms at 4 x 2^23.  pfb_packed_reg_kernel
// runs its stages in series behind barriers; three resident blocks an SM
// (at most 85 registers a thread) overlap one's staging with another's
// arithmetic (tools/pfb_ab.py splits the time by stage).  64 rows a block
// took 11-18% longer at 2^17 samples and were within 2.2% at 4 x 2^23; there,
// taps read through the read-only cache took 4% longer, and 96 registers
// with two blocks an SM 14-19% longer.  At M = 32, 64 and 128 (the planar
// step's full width: 4 antennas x 2^23, W = 25) the same bytes bound it,
// 0.160 ms, where pfb_packed_kernel's dense DFTs alone are 8 M^2 flops a
// group (0.128, 0.256, 0.513 ms of FP32) and its blocks of 4096/(2AM) rows
// stage the W - 1 halo rows 4-7 times over; pfb_packed_wide_kernel stages
// each halo once per RB rows and runs the transforms as FFTs.  There it
// took 0.255, 0.257 and 0.315 ms on an H100 (700 W), about half of it the
// staging and the FIR; at M = 64, 8-row strips (two jobs a thread) took 6%
// longer and two blocks an SM 11% longer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_core.cuh"
#include "wide_dft.cuh"

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

// ---- pfb_packed_reg_kernel -------------------------------------------------

constexpr int kPkThreads = 256;
constexpr int kPkRows = 32;    // output rows a block
constexpr int kPkCols = 128;   // window columns a block: 64 re, then 64 im
constexpr int kPkHalf = 64;    // columns a component, C*M of them real
constexpr int kPkStrip = 16;   // rows a FIR lane sums over
static_assert(kPkRows % kPkStrip == 0, "a block's rows are whole strips");
// a timing probe's build (-DPFB_STOP_AFTER=1 or 2) stops each block after
// the staging or the FIR; the library never sets it
#ifndef PFB_STOP_AFTER
#define PFB_STOP_AFTER 3
#endif
constexpr int kPkStopAfter = PFB_STOP_AFTER;

// window of kPkRows + W rows (a strip's last refill reads row kPkRows + W -
// 1), the two sums planes of kPkRows rows and W tap rows
__host__ __device__ inline long long pk_reg_smem_bytes(int w) {
  return 4LL * kPkCols * (2LL * kPkRows + 2LL * w);
}

// the shared-memory word of logical float x of a sums plane; it keeps each
// 16-byte group whole: pk_swz(16 t + 4 k) = pk_swz(16 t) ^ 4 k
__device__ __forceinline__ int pk_swz(int x) { return x ^ ((x >> 3) & 12); }

__device__ __forceinline__ void pk_cp_async16(float* dst, const float* src,
                                              int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

template <int M>
__global__ void __launch_bounds__(kPkThreads, 3)
pfb_packed_reg_kernel(const float* __restrict__ y, const float* __restrict__ hr,
                      float* __restrict__ out, int nout, int w, int a,
                      int vec) {
  static_assert(M == 2 || M == 4 || M == 8 || M == 16, "M must be 2, 4, 8 or 16");
  constexpr int S = kPkStrip;
  constexpr int VPL = 16 / M;           // groups a DFT lane holds
  constexpr int tile = kPkRows;
  extern __shared__ float smem[];
  const int rows = tile + w;
  float* win = smem;                                   // [rows][128]
  float* sre = smem + (long long)rows * kPkCols;       // [tile * 64], pk_swz
  float* sim = sre + tile * kPkHalf;                   // [tile * 64], pk_swz
  float* tsm = sim + tile * kPkHalf;                   // [w][128] taps

  const int gm = 2 * a * M;
  const int a0 = blockIdx.y * (kPkHalf / M);
  const int cm = min(kPkHalf / M, a - a0) * M;         // real columns a component
  const int off_re = a0 * M, off_im = (a + a0) * M;   // y's column of each
  const long long i0 = (long long)blockIdx.x * tile;
  const int tvalid = (int)min((long long)tile, (long long)nout - i0);
  const int rvalid = tvalid + w - 1;
  const float* src = y + i0 * gm;

  // stage: item e = (row u, column); rows at or past rvalid are zeros;
  // then the taps, item e = (tap row u, column)
  if (vec) {
    for (int e = threadIdx.x; e < rows * (kPkCols / 4); e += kPkThreads) {
      const int u = e >> 5;
      const int p = (e >> 4) & 1;
      const int c = 4 * (e & 15);
      if (c < cm) {
        const bool in = u < rvalid;
        pk_cp_async16(win + u * kPkCols + p * kPkHalf + c,
                      in ? src + (long long)u * gm + (p ? off_im : off_re) + c : y, in ? 16 : 0);
      }
    }
    for (int e = threadIdx.x; e < w * (kPkCols / 4); e += kPkThreads) {
      const int u = e >> 5;
      const int p = (e >> 4) & 1;
      const int c = 4 * (e & 15);
      if (c < cm)
        pk_cp_async16(tsm + u * kPkCols + p * kPkHalf + c,
                      hr + (long long)u * gm + (p ? off_im : off_re) + c, 16);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int e = threadIdx.x; e < rows * kPkCols; e += kPkThreads) {
      const int u = e >> 7;
      const int p = (e >> 6) & 1;
      const int c = e & 63;
      if (c < cm) win[e] = u < rvalid ? src[(long long)u * gm + (p ? off_im : off_re) + c] : 0.f;
    }
    for (int e = threadIdx.x; e < w * kPkCols; e += kPkThreads) {
      const int u = e >> 7;
      const int p = (e >> 6) & 1;
      const int c = e & 63;
      if (c < cm) tsm[e] = hr[(long long)u * gm + (p ? off_im : off_re) + c];
    }
  }
  __syncthreads();
  if constexpr (kPkStopAfter < 2) return;

  // branch FIR: job e = (strip q, column), column fastest; strips past the
  // valid rows skip
  const int nq = (tvalid + S - 1) / S;
  for (int e = threadIdx.x; e < nq * kPkCols; e += kPkThreads) {
    const int q = e >> 7;
    const int col = e & 127;
    const int p = col >> 6;
    const int c = col & 63;
    if (c >= cm) continue;
    const float* tp = tsm + col;
    const float* wp = win + q * S * kPkCols + col;
    float wv[S], acc[S];
    fftcore::static_for<S>([&](auto k) {
      constexpr int kk = decltype(k)::value;
      wv[kk] = wp[kk * kPkCols];
      acc[kk] = 0.f;
    });
    wp += S * kPkCols;
    int d0 = 0;
    for (; d0 + S <= w; d0 += S) {
      fftcore::static_for<S>([&](auto r) {
        constexpr int rr = decltype(r)::value;
        const float tap = tp[rr * kPkCols];
        fftcore::static_for<S>([&](auto s) {
          acc[s] = fmaf(tap, wv[(decltype(s)::value + rr) % S], acc[s]);
        });
        wv[rr] = wp[rr * kPkCols];
      });
      wp += S * kPkCols;
      tp += S * kPkCols;
    }
    const int left = w - d0;
    float tl[S];
    fftcore::static_for<S>([&](auto r) {
      constexpr int rr = decltype(r)::value;
      tl[rr] = rr < left ? tp[rr * kPkCols] : 0.f;
    });
    fftcore::static_for<S>([&](auto r) {
      constexpr int rr = decltype(r)::value;
      if (rr < left) {
        fftcore::static_for<S>([&](auto s) {
          acc[s] = fmaf(tl[rr], wv[(decltype(s)::value + rr) % S], acc[s]);
        });
        wv[rr] = wp[rr * kPkCols];
      }
    });
    float* dst = p ? sim : sre;
    fftcore::static_for<S>([&](auto s) {
      dst[pk_swz((q * S + decltype(s)::value) * kPkHalf + c)] = acc[s];
    });
  }
  __syncthreads();
  if constexpr (kPkStopAfter < 3) return;

  // unscaled inverse DFT: lane t holds plane words 16t .. 16t+15 of both
  // planes (row t/4, columns 16 (t%4) ..), 16/M groups
  for (int t = threadIdx.x; t < tile * 4; t += kPkThreads) {
    if ((t >> 2) >= tvalid || 16 * (t & 3) >= cm) continue;
    const int b = pk_swz(16 * t);
    float2 v[fftcore::kPts];
    fftcore::static_for<4>([&](auto k) {
      const int o = b ^ (4 * decltype(k)::value);
      const float4 r4 = *reinterpret_cast<const float4*>(sre + o);
      const float4 i4 = *reinterpret_cast<const float4*>(sim + o);
      v[4 * k] = make_float2(r4.x, i4.x);
      v[4 * k + 1] = make_float2(r4.y, i4.y);
      v[4 * k + 2] = make_float2(r4.z, i4.z);
      v[4 * k + 3] = make_float2(r4.w, i4.w);
    });
    fftcore::static_for<VPL>([&](auto s) {
      fftcore::dft<M, decltype(s)::value * M, true>(v);
    });
    fftcore::static_for<4>([&](auto k) {
      const int o = b ^ (4 * decltype(k)::value);
      *reinterpret_cast<float4*>(sre + o) =
          make_float4(v[4 * k].x, v[4 * k + 1].x, v[4 * k + 2].x, v[4 * k + 3].x);
      *reinterpret_cast<float4*>(sim + o) =
          make_float4(v[4 * k].y, v[4 * k + 1].y, v[4 * k + 2].y, v[4 * k + 3].y);
    });
  }
  __syncthreads();

  // copy-out: item e = (row, column) of the valid rows, as the staging
  float* dst = out + i0 * gm;
  if (vec) {
    for (int e = threadIdx.x; e < tvalid * (kPkCols / 4); e += kPkThreads) {
      const int r = e >> 5;
      const int p = (e >> 4) & 1;
      const int c = 4 * (e & 15);
      if (c < cm) {
        const float* pl = p ? sim : sre;
        *reinterpret_cast<float4*>(dst + (long long)r * gm + (p ? off_im : off_re) + c) =
            *reinterpret_cast<const float4*>(pl + pk_swz(r * kPkHalf + c));
      }
    }
  } else {
    for (int e = threadIdx.x; e < tvalid * kPkCols; e += kPkThreads) {
      const int r = e >> 7;
      const int p = (e >> 6) & 1;
      const int c = e & 63;
      if (c < cm) dst[(long long)r * gm + (p ? off_im : off_re) + c] = (p ? sim : sre)[pk_swz(r * kPkHalf + c)];
    }
  }
}

template <int M>
cudaError_t launch_pk_reg(const float* y, const float* hr, float* out, int nout,
                          int w, int a, cudaStream_t stream) {
  const long long bytes = pk_reg_smem_bytes(w);
  const cudaError_t err = fftcore::set_smem(pfb_packed_reg_kernel<M>, bytes);
  if (err != cudaSuccess) return err;
  const int vec = (M % 4 == 0 || a % 2 == 0) &&
                  ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(hr) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const dim3 grid((nout + kPkRows - 1) / kPkRows,
                  (a + kPkHalf / M - 1) / (kPkHalf / M));
  pfb_packed_reg_kernel<M><<<grid, kPkThreads, bytes, stream>>>(
      y, hr, out, nout, w, a, vec);
  return cudaGetLastError();
}

// ---- pfb_packed_wide_kernel ------------------------------------------------

constexpr int kPwThreads = 256;
constexpr int kPwOuts = 4096;   // outputs of each component a block: 4096 / M rows
constexpr int kPwStrip = 16;    // rows a FIR job sums over
static_assert(kPwOuts == kPwStrip * kPwThreads, "one FIR job a thread");

// output rows a block
__host__ __device__ constexpr int pw_rows(int m) { return kPwOuts / m; }

// resident blocks an SM the launch bounds ask for: three where three blocks'
// shared memory fits an SM at the step's W = 25 (M = 32, 64: 80 registers),
// else two (M = 128: 83 KB a block)
__host__ __device__ constexpr int pw_blocks(int m) { return m == 128 ? 2 : 3; }

// the window of RB + W rows of 2M columns (the complex sums overlay it
// after the FIR: 2M RB floats hold 4096 float2), W tap rows of 2M columns
// and the pass-1 table of M float2
__host__ __device__ inline long long pw_smem_bytes(int m, int w) {
  return 8LL * m * (pw_rows(m) + w) + 8LL * m * w + 8LL * m;
}

// rows [0, nrows) of a block's 2M columns (re lanes at off_re, im lanes at
// off_im of rows gm floats apart) into dst [nrows][2M]; rows at or past
// `valid` are zero-filled and not read.  With vec, one 16-byte cp.async a
// group of 4 (a warp: 512 contiguous bytes of dst), left in flight.
template <int M>
__device__ __forceinline__ void pw_stage(float* dst, const float* src, int nrows,
                                         int valid, int gm, int off_re,
                                         int off_im, int vec) {
  constexpr int C2 = 2 * M;
  if (vec) {
    constexpr int G = C2 / 4;
    for (int e = threadIdx.x; e < nrows * G; e += kPwThreads) {
      const int u = e / G;
      const int col = 4 * (e % G);
      const int c = col < M ? off_re + col : off_im + col - M;
      const bool in = u < valid;
      pk_cp_async16(dst + 4 * e, in ? src + (long long)u * gm + c : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * C2; e += kPwThreads) {
      const int u = e / C2;
      const int col = e % C2;
      const int c = col < M ? off_re + col : off_im + col - M;
      dst[e] = u < valid ? src[(long long)u * gm + c] : 0.f;
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kPwThreads, pw_blocks(M))
pfb_packed_wide_kernel(const float* __restrict__ y, const float* __restrict__ hr,
                       float* __restrict__ out, int nout, int w, int a, int vec) {
  static_assert(M == 32 || M == 64 || M == 128, "M must be 32, 64 or 128");
  constexpr int Q = M / 16;            // lanes a row's transform spans
  constexpr int GW = 32 / Q;           // rows a warp tile holds
  constexpr int RB = pw_rows(M);
  constexpr int C2 = 2 * M;            // window columns: M re, then M im
  constexpr int S = kPwStrip;
  static_assert(RB * M == 512 * (kPwThreads / 32), "one tile a warp");
  extern __shared__ float smem[];
  const int rows = RB + w;
  float* win = smem;                                      // [rows][2M]
  float2* sums = reinterpret_cast<float2*>(smem);         // [4096], after the FIR
  float* tsm = smem + (long long)rows * C2;               // [w][2M] taps
  float2* tw1 = reinterpret_cast<float2*>(tsm + (long long)w * C2);  // [M]
  widedft::twiddles<M>(tw1, threadIdx.x, kPwThreads);

  const int gm = 2 * a * M;
  const int off_re = blockIdx.y * M, off_im = (a + blockIdx.y) * M;
  const long long i0 = (long long)blockIdx.x * RB;
  const int tvalid = (int)min((long long)RB, (long long)nout - i0);
  pw_stage<M>(win, y + i0 * gm, rows, tvalid + w - 1, gm, off_re, off_im, vec);
  pw_stage<M>(tsm, hr, w, w, gm, off_re, off_im, vec);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if constexpr (kPkStopAfter < 2) return;

  // branch FIR: job t = (strip of S rows, column j), j fastest (a warp:
  // 32 consecutive columns of one strip), both components: acc[s] =
  // sum_d tap[d][j] * window[strip row s + d][j].  Every strip runs, those
  // past the valid rows on zeros, so every sum slot is written.
  const int t = threadIdx.x;
  const int j = t % M;
  const int g0 = t / M * S;            // the strip's first row
  float ar[S], ai[S];
  {
    const float* wp = win + g0 * C2 + j;
    const float* tp = tsm + j;
    float vr[S], vi[S];
    fftcore::static_for<S>([&](auto k) {
      constexpr int kk = decltype(k)::value;
      vr[kk] = wp[kk * C2];
      vi[kk] = wp[kk * C2 + M];
      ar[kk] = 0.f;
      ai[kk] = 0.f;
    });
    wp += S * C2;
    // tap step d (RR = d mod S): sum s takes window row s + d, in slot
    // (s + RR) mod S; then row d + S goes into the slot row d leaves
    auto step = [&](auto r) {
      constexpr int rr = decltype(r)::value;
      const float tr = tp[rr * C2], ti = tp[rr * C2 + M];
      fftcore::static_for<S>([&](auto s) {
        constexpr int ss = decltype(s)::value;
        ar[ss] = fmaf(tr, vr[(ss + rr) % S], ar[ss]);
        ai[ss] = fmaf(ti, vi[(ss + rr) % S], ai[ss]);
      });
      vr[rr] = wp[rr * C2];
      vi[rr] = wp[rr * C2 + M];
    };
    int d0 = 0;
    for (; d0 + S <= w; d0 += S) {
      fftcore::static_for<S>(step);
      wp += S * C2;
      tp += S * C2;
    }
    const int left = w - d0;
    fftcore::static_for<S>([&](auto r) {
      constexpr int rr = decltype(r)::value;
      if (rr < left) step(r);
    });
  }
  __syncthreads();                     // every lane is done with the window
  fftcore::static_for<S>([&](auto s) {
    constexpr int ss = decltype(s)::value;
    sums[widedft::fir_slot<Q>(g0 + ss, j)] = make_float2(ar[ss], ai[ss]);
  });
  __syncthreads();
  if constexpr (kPkStopAfter < 3) return;

  // the M = 16 Q point unscaled inverse DFT of each row, in the warp's own
  // tile (rows warp GW ..), then the bins at their out_slot
  const int lane = t & 31;
  const int warp = t >> 5;
  const int q = lane % Q;
  const int g = warp * GW + lane / Q;
  {
    float2 v[fftcore::kPts];
    fftcore::static_for<16>([&](auto m) {
      v[m] = sums[widedft::fir_slot<Q>(g, q + Q * decltype(m)::value)];
    });
    widedft::transform<Q>(v, sums, tw1, g, q);
    const int zo = widedft::out_slot<M>(g, 0) ^ q;
    fftcore::static_for<16>([&](auto i) {
      sums[zo ^ widedft::kswz(widedft::bin<Q>(decltype(i)::value, 0))] = v[i];
    });
  }
  __syncwarp();

  // copy-out of the tile's valid rows: lane takes bins k .. k+3 of row gg
  const int gw0 = warp * GW;
  const int valid = min(GW, tvalid - gw0) * M;
  for (int x = 4 * lane; x < valid; x += 128) {
    const int gg = gw0 + x / M;
    const int k = x % M;
    const float4 p0 = *reinterpret_cast<const float4*>(sums + widedft::out_slot<M>(gg, k));
    const float4 p1 = *reinterpret_cast<const float4*>(sums + widedft::out_slot<M>(gg, k + 2));
    float* dst = out + (i0 + gg) * gm + k;
    if (vec) {
      *reinterpret_cast<float4*>(dst + off_re) = make_float4(p0.x, p0.z, p1.x, p1.z);
      *reinterpret_cast<float4*>(dst + off_im) = make_float4(p0.y, p0.w, p1.y, p1.w);
    } else {
      dst[off_re] = p0.x;
      dst[off_re + 1] = p0.z;
      dst[off_re + 2] = p1.x;
      dst[off_re + 3] = p1.z;
      dst[off_im] = p0.y;
      dst[off_im + 1] = p0.w;
      dst[off_im + 2] = p1.y;
      dst[off_im + 3] = p1.w;
    }
  }
}

template <int M>
cudaError_t launch_pk_wide(const float* y, const float* hr, float* out, int nout,
                           int w, int a, cudaStream_t stream) {
  const long long bytes = pw_smem_bytes(M, w);
  const cudaError_t err = fftcore::set_smem(pfb_packed_wide_kernel<M>, bytes);
  if (err != cudaSuccess) return err;
  const int vec = ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(hr) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const dim3 grid((nout + pw_rows(M) - 1) / pw_rows(M), a);
  pfb_packed_wide_kernel<M><<<grid, kPwThreads, bytes, stream>>>(
      y, hr, out, nout, w, a, vec);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one block of the given body: pfb_packed_kernel's of
// `tile` rows of all 2*a*m lanes, pfb_packed_reg_kernel's of its 32 rows
// and the taps of one 128-column chunk (independent of a, m and tile), or
// pfb_packed_wide_kernel's of its 4096/m rows of one antenna (independent
// of a and tile).
extern "C" long long clen_pfb_smem_bytes(int a, int m, int w, int tile, int body) {
  if (body == 1) return pk_reg_smem_bytes(w);
  if (body == 2) return pw_smem_bytes(m, w);
  return pfb_smem_floats(a, m, w, tile) * (long long)sizeof(float);
}

// Output rows a block of body 1 (kPkRows) or of body 2 at m in {32, 64,
// 128} (4096/m), the only tile each takes; 0 for body 0, whose rows the
// caller chooses, and for a body that cannot take m.
extern "C" int clen_pfb_block_rows(int m, int body) {
  if (body == 1) return (m == 2 || m == 4 || m == 8 || m == 16) ? kPkRows : 0;
  if (body == 2) return (m == 32 || m == 64 || m == 128) ? pw_rows(m) : 0;
  return 0;
}

// y: [nout + w - 1, 2*a*m], hr: [w, 2*a*m], out: [nout, 2*a*m], all float32
// row-major; tw: [2, m] cos and sin of 2 pi q / m (pfb_packed_kernel's
// table).  tile: output rows a block.  body 0: pfb_packed_kernel (any m);
// body 1: pfb_packed_reg_kernel (m in {2, 4, 8, 16}; tile must be its 32);
// body 2: pfb_packed_wide_kernel (m in {32, 64, 128}, a <= 65535; tile must
// be its 4096/m).  Returns a cudaError_t; cudaErrorInvalidValue when the
// sizes are inconsistent or the block does not fit the card's opt-in
// shared memory.
extern "C" int clen_pfb_packed(const void* y, const void* hr, const void* tw,
                               void* out, int nout, int w, int a, int m,
                               int tile, int body, void* stream) {
  if (nout < 1 || w < 1 || a < 1 || m < 1 || tile < 1 || body < 0 || body > 2)
    return cudaErrorInvalidValue;
  const float* fy = static_cast<const float*>(y);
  const float* fhr = static_cast<const float*>(hr);
  float* fout = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (tile != kPkRows) return cudaErrorInvalidValue;
    switch (m) {
      case 2: return launch_pk_reg<2>(fy, fhr, fout, nout, w, a, st);
      case 4: return launch_pk_reg<4>(fy, fhr, fout, nout, w, a, st);
      case 8: return launch_pk_reg<8>(fy, fhr, fout, nout, w, a, st);
      case 16: return launch_pk_reg<16>(fy, fhr, fout, nout, w, a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (body == 2) {
    if (tile != clen_pfb_block_rows(m, 2) || a > 65535) return cudaErrorInvalidValue;
    switch (m) {
      case 32: return launch_pk_wide<32>(fy, fhr, fout, nout, w, a, st);
      case 64: return launch_pk_wide<64>(fy, fhr, fout, nout, w, a, st);
      case 128: return launch_pk_wide<128>(fy, fhr, fout, nout, w, a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  const long long bytes = clen_pfb_smem_bytes(a, m, w, tile, 0);
  const cudaError_t err = fftcore::set_smem(pfb_packed_kernel, bytes);
  if (err != cudaSuccess) return err;
  const int nblk = (nout + tile - 1) / tile;
  pfb_packed_kernel<<<nblk, 256, bytes, st>>>(
      fy, fhr, static_cast<const float*>(tw), fout, nout, w, a, m, tile);
  return cudaGetLastError();
}
