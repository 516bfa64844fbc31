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
// DFT (clPolyphaseChannelizer_impl.cc:156-167, :208-225).
// Replaces clenabled_tpu/dsp/pallas_kernels.py: pfb_oversampled_fused
// (_pfb_os_kernel, _pfb_os_constants).  The TPU kernel folds branch sums,
// rotation and DFT into banded matrices for its matrix unit; neither body
// here does.
//
// Three bodies (hopper_kernels.os_body names the one a call runs: a pure
// rule on M, L = M/R and whether the block fits the card's shared memory):
//
// pfb_os_reg_kernel<M, L>, M in {2, 4, 8, 16}: 128 threads, a block owns
// 2048/M output groups (2048 outputs a component) on U = 2048/(M L) window
// rows of M samples.  With i = L u + p (phase p < L) and x = p R + M-1-j,
//   acc[i, j] = sum_d taps[(W-1-d) M + j] * V[u + d + (x >= M), x mod M],
// V the virtual stream as rows of M: a column FIR down the rows, one per
// (phase, branch), the row shift 0 or 1.  And since s_i = R ((i + i_offset)
// (L-1) mod L), the rotated DFT is the plain one times an L-th root:
//   z[i, k] = DFT(acc[i, :])[k] * exp(-2 pi i ((i + i_offset) k mod L) / L).
//   stage  tail ++ frame in 4-sample groups, 4 in flight a thread, each one
//          16-byte load (__ldg) when the streams are 16-byte aligned, else
//          sample by sample; only the rows the valid outputs need.  The
//          window rows are padded by 2 rows of M words after every strip of
//          S rows, so each quarter-warp store phase hits 32 banks.
//   FIR    lane = (component, strip of S = 16 rows u, phase p, branch j; S
//          = 8 at L = 16): S sums and an S-value window of column x in
//          registers, one tap load (read-only cache) and one window load per
//          S FMAs, the slots rotating at compile time (static_for).  Row
//          shift 1 is the same column one word further (x < 2M); only a
//          strip's last row then lies past the pad.  The sums go to shared
//          memory at zswz(g M) ^ j (g = L u + p), bank-conflict free.
//   DFT    lane = 16 consecutive sums of both components (16/M groups),
//          float2 loads, fftcore::dft<M, s M, true> in registers, then the
//          phase twiddle: a sign at L = 2, swaps and signs at L = 4, one
//          product by an entry of a float64-built table of the L roots in
//          shared memory at L = 8, 16 (a warp's 16 entries hit distinct
//          banks).  The results go back in place; after a barrier each warp
//          writes 512 contiguous bytes a component a store (coalesced: from
//          registers, at 64-byte strides, the stores took 27% longer).
// pfb_os_wide_kernel<M, L>, M in {32, 64, 128}, L in {2, 4, 8, 16} (a
// third __global__ body beside the other two, not a widening of
// pfb_os_reg_kernel, whose DFT lanes hold whole groups): the same column
// FIR and L-th-root twiddle, with each M = 16 Q point transform split over
// Q lanes.  256 threads, three blocks an SM (at most 85 registers); a
// chunk is 4096 outputs a component (4096/M groups on CU = 4096/(M L)
// window rows), and a block runs kOsWideChunks = 2 chunks behind one
// window (1 where three blocks of two chunks do not fit an SM's shared
// memory: os_wide_chunks), so that the W + 1 halo rows, which the next
// block stages again, are staged half as often and the second chunk's
// staging lands while the first computes.
//   stage  tail ++ frame, unpadded rows of M, in 4-sample groups: one
//          16-byte cp.async each (zero-filled past the span) when the
//          streams are 16-byte aligned, else sample by sample; chunk 0's
//          rows in one commit group, the rest in a second that lands while
//          chunk 0 computes.  Each quarter-warp store phase hits 32 banks.
//   FIR    per chunk, lane = (strip of S = min(CU, 8) rows, phase p,
//          branch j) over both components (2 S sums, 2 S window values),
//          j fastest, so a warp reads 32 consecutive window words; one tap
//          load (read-only cache) and two window loads per 2 S FMAs.  The
//          complex sums go to float2 slots of each warp's tile (32 rows of
//          16 slots, the banks of a half-warp 64-bit access): group g's
//          point j = q + Q m at row m, column Q ((g mod GW) ^ (m mod GW)) +
//          q (GW = 32/Q groups a tile), conflict free for the FIR's
//          consecutive j and for pass 1's lanes (g, q).
//   DFT    (widedft::transform, wide_dft.cuh, shared with fx_correlate.cu)
//          group g on Q lanes of one warp; lane q: the 16 points q + Q m,
//          fftcore::dft<16> over m, times exp(+2 pi i q k1 / M) (a
//          float64-built table of M entries, [k1][q]), back into the tile
//          at row k1, column Q (g mod GW) + (q ^ (k1 mod Q)); __syncwarp;
//          lane q' takes bins k1 = a Q + q' of every q (conflict free: the
//          column's low bits q ^ q'), fftcore::dft<Q> over q gives X[k1 +
//          16 k2] in registers, then the phase twiddle (swaps and signs at
//          L <= 4, the table of L roots at L >= 8), and the outputs go to
//          slot g M + (k ^ Q (g mod GW) ^ 2 (bit 4 of k)) of the tile.
//          Each warp then copies its own tile out (GW M contiguous outputs)
//          with two 16-byte loads and two 16-byte stores a lane per 4
//          outputs; one block barrier a chunk after the FIR and one before
//          the next chunk's FIR overwrites the sums.
//   tests/test_torch_channelizer.py replays the three layouts, the staging
//   and the transform in numpy and checks every warp access's banks.
// pfb_os_kernel (the first design), every other (M, L, W): each block
//   stages the window v[i0*R, (i0+G-1)*R + W*M) of G groups one float at a
//   time, one thread per (group, subfilter) forms the branch sums from
//   shared memory, then one thread per (group, channel) the M-point DFT
//   from the sums and a twiddle table (float64 cos/sin cast to float32);
//   (j + s) k mod M is a mask.
//
// Bound on the H100: per input sample 8 B read and, per output group, 8*M B
// written (L = M/R times the input bytes): memory bound at the 16-channel,
// R = 8 path (2^23 samples: 64 MiB in, 128 MiB out, about 60 us at 3.35
// TB/s) where the 2*W FIR flops per output value are about 10 us of FP32
// and the M-point transforms a few hundred flops a group.
// pfb_os_reg_kernel runs its stages one after another behind three block
// barriers; up to 8 resident blocks an SM overlap one block's staging with
// another's arithmetic (tools/os_ab.py splits its time by stage).  At M =
// 64, R = 16 the output is 4x the input (2^23 samples: 256 MiB written,
// about 100 us); the FIR's 2 W FMAs an output value (1600 taps: W = 25,
// about 50 us of FP32 FMA on the card) and the two-pass transforms are
// issue-bound instruction streams that pfb_os_wide_kernel overlaps across
// three blocks an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_core.cuh"
#include "wide_dft.cuh"

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

// ---- pfb_os_reg_kernel -----------------------------------------------------

constexpr int kOsThreads = 128;
constexpr int kOsOuts = 16 * kOsThreads;  // outputs of each component a block
constexpr int kOsStrip = 16;        // window rows a FIR lane sums over
constexpr int kOsPadRows = 2;       // pad rows after each strip's rows
constexpr int kOsStageUnroll = 4;   // staging vectors in flight per thread
// a timing probe's build (-DOS_STOP_AFTER=1 or 2) stops each block after
// the staging or the FIR; the library never sets it
#ifndef OS_STOP_AFTER
#define OS_STOP_AFTER 3
#endif
constexpr int kOsStopAfter = OS_STOP_AFTER;

// window rows U of a block's 2048/M output groups, and the FIR strip S
__host__ __device__ constexpr int os_rows(int m, int l) { return kOsOuts / (m * l); }
__host__ __device__ constexpr int os_strip(int m, int l) {
  return os_rows(m, l) < kOsStrip ? os_rows(m, l) : kOsStrip;
}

// padded window floats of one component: U + W + 1 rows (a strip's last
// refill reads row U + W), 2 pad rows after every S
__host__ __device__ inline long long os_reg_wpad(int m, int l, int w) {
  const int s = os_strip(m, l);
  const long long rows = (long long)os_rows(m, l) + w + 1;
  return (rows + s - 1) / s * (s + kOsPadRows) * m;
}

__host__ __device__ inline long long os_reg_smem_bytes(int m, int r, int w) {
  return 4LL * (2 * os_reg_wpad(m, m / r, w) + 2LL * kOsOuts);
}

// the shared-memory word of logical float x of a component's sums.  For
// x = g*M + k, k < M <= 16, zswz(x) = zswz(g*M) ^ k
__device__ __forceinline__ int zswz(int x) { return x ^ (((x >> 5) & 15) << 1); }

// a * exp(-2 pi i q / L), q < L <= 4, exactly: at L = 2 a sign, at L = 4
// q quarter turns as swaps and signs
template <int L>
__device__ __forceinline__ float2 os_quarter_turns(float2 a, int q) {
  static_assert(L == 2 || L == 4, "L must be 2 or 4");
  if constexpr (L == 2) q *= 2;
  if (q & 1) a = make_float2(a.y, -a.x);  // times -i
  if (q & 2) a = make_float2(-a.x, -a.y);
  return a;
}

template <int M, int L>
__global__ void __launch_bounds__(kOsThreads, 8)
pfb_os_reg_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float* __restrict__ tr, const float* __restrict__ ti,
                  const float* __restrict__ taps, float* __restrict__ zr,
                  float* __restrict__ zi, int n, int h, int w, int i_offset,
                  int nout, int vec) {
  static_assert(M == 2 || M == 4 || M == 8 || M == 16, "M must be 2, 4, 8 or 16");
  static_assert(L >= 2 && L <= M && (L & (L - 1)) == 0, "L must divide M");
  constexpr int R = M / L;
  constexpr int G = kOsOuts / M;       // output groups a block
  constexpr int U = os_rows(M, L);     // their window rows (L groups a row)
  constexpr int S = os_strip(M, L);
  constexpr int NQ = U / S;            // FIR strips a component
  constexpr int CH = S * M;            // window samples a strip
  constexpr int PAD = kOsPadRows * M;  // pad words after each
  constexpr int VPL = 16 / M;          // groups a DFT lane holds
  extern __shared__ float smem[];
  const int wpad = (int)os_reg_wpad(M, L, w);
  float* win = smem;                   // [2][wpad] padded window
  float* sums = smem + 2 * wpad;       // [2][kOsOuts] branch sums, swizzled
  __shared__ float2 tw[L >= 8 ? L : 1];  // exp(-2 pi i q / L), float64-built
  if (L >= 8 && threadIdx.x < L) {
    double sn, cs;
    sincospi(-2.0 * threadIdx.x / L, &sn, &cs);
    tw[threadIdx.x] = make_float2((float)cs, (float)sn);
  }

  const long long i0 = (long long)blockIdx.x * G;
  const int gcount = (int)min((long long)G, (long long)nout - i0);
  const int ucount = gcount / L;       // nout and i0 are multiples of L
  const long long base = (long long)blockIdx.x * U * M;  // v index of sample 0
  const int span = (ucount + w) * M - R;                 // samples needed

  // stage tail ++ frame: 4-sample group i of component c holds window
  // samples k = 4i .. 4i+3 at word k + (k / CH) * PAD.  h is a multiple of
  // 128 and base of 4, so with aligned streams a group inside the tail or
  // the frame is one aligned vector; the frame's last group at n = 2 mod 4,
  // and every group of unaligned streams, loads sample by sample.  Samples
  // at or past span are 0.  A component's groups are counted up to whole
  // store phases (8 lanes), the extra ones idle, so that each phase stores
  // 32 consecutive words of one strip.
  {
    const int groups = (span + 3) / 4;
    const int per_c = (groups + 7) / 8 * 8;
    const int total = 2 * per_c;
    for (int e0 = threadIdx.x; e0 < total; e0 += kOsStageUnroll * kOsThreads) {
      float v[kOsStageUnroll][4];
      fftcore::static_for<kOsStageUnroll>([&](auto u) {
        const int e = e0 + u * kOsThreads;
        const int c = e >= per_c;
        const int k = 4 * (e - c * per_c);
        fftcore::static_for<4>([&](auto x) { v[u][x] = 0.f; });
        if (e < total && k < span) {
          const float* tp = c ? ti : tr;
          const float* fp = c ? xi : xr;
          const long long q = base + k;
          const long long f = q - h;
          if (vec && (f < 0 || f + 4 <= n)) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(f < 0 ? tp + q : fp + f));
            v[u][0] = a.x; v[u][1] = a.y; v[u][2] = a.z; v[u][3] = a.w;
            fftcore::static_for<4>([&](auto x) {
              if (k + decltype(x)::value >= span) v[u][x] = 0.f;
            });
          } else {
            fftcore::static_for<4>([&](auto x) {
              const long long qx = q + decltype(x)::value;
              if (k + decltype(x)::value < span) v[u][x] = qx < h ? tp[qx] : fp[qx - h];
            });
          }
        }
      });
      fftcore::static_for<kOsStageUnroll>([&](auto u) {
        const int e = e0 + u * kOsThreads;
        const int c = e >= per_c;
        const int k = 4 * (e - c * per_c);
        if (e < total && k < span) {
          *reinterpret_cast<float4*>(win + c * wpad + k + k / CH * PAD) =
              make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
        }
      });
    }
  }
  __syncthreads();
  if constexpr (kOsStopAfter < 2) return;

  // branch FIR: job e = (component c, strip q, phase p, branch j), j
  // fastest; acc[s] = sum_d taps[(W-1-d) M + j] * (window sample (q S + s
  // + d) M + x), x = p R + M-1-j < 2M.  Sample (q S + a) M + x sits at word
  // (q (S + 2) + a) M + x, plus PAD when a M + x reaches the next strip
  // (a = S-1 and x >= M).  Strips past the valid groups skip.
  {
    constexpr int JOBS = 2 * NQ * L * M;
    for (int e = threadIdx.x; e < JOBS; e += kOsThreads) {
      const int c = e / (NQ * L * M);
      const int rem = e - c * (NQ * L * M);
      const int q = rem / (L * M);
      const int p = rem / M % L;
      const int j = rem % M;
      if (q * S >= ucount) continue;
      const int x = p * R + M - 1 - j;
      const int hop = x >= M ? PAD : 0;
      const float* wp = win + c * wpad + q * (S + kOsPadRows) * M + x;
      float wv[S], acc[S];
      fftcore::static_for<S>([&](auto k) {
        constexpr int kk = decltype(k)::value;
        wv[kk] = wp[kk * M + (kk == S - 1 ? hop : 0)];
        acc[kk] = 0.f;
      });
      wp += (S + kOsPadRows) * M;
      const float* tp = taps + (w - 1) * M + j;
      int d0 = 0;
      for (; d0 + S <= w; d0 += S) {
        fftcore::static_for<S>([&](auto r) {
          constexpr int rr = decltype(r)::value;
          const float tap = __ldg(tp - rr * M);
          fftcore::static_for<S>([&](auto s) {
            acc[s] = fmaf(tap, wv[(decltype(s)::value + rr) % S], acc[s]);
          });
          wv[rr] = wp[rr * M + (rr == S - 1 ? hop : 0)];
        });
        wp += (S + kOsPadRows) * M;
        tp -= S * M;
      }
      const int left = w - d0;
      fftcore::static_for<S>([&](auto r) {
        constexpr int rr = decltype(r)::value;
        if (rr < left) {
          const float tap = __ldg(tp - rr * M);
          fftcore::static_for<S>([&](auto s) {
            acc[s] = fmaf(tap, wv[(decltype(s)::value + rr) % S], acc[s]);
          });
          wv[rr] = wp[rr * M + (rr == S - 1 ? hop : 0)];
        }
      });
      float* out = sums + c * kOsOuts;
      fftcore::static_for<S>([&](auto s) {
        out[zswz((L * (q * S + decltype(s)::value) + p) * M) ^ j] = acc[s];
      });
    }
  }
  __syncthreads();
  if constexpr (kOsStopAfter < 3) return;

  // unscaled inverse DFT and phase twiddle: lane t holds sums 16t .. 16t+15
  // of both components, groups g = VPL t .. VPL t + VPL-1
  {
    const int t = threadIdx.x;
    float* re = sums;
    float* im = sums + kOsOuts;
    float2 v[fftcore::kPts];
    const int b = zswz(16 * t);
    fftcore::static_for<8>([&](auto k) {
      const int o = b ^ (2 * decltype(k)::value);
      const float2 r2 = *reinterpret_cast<const float2*>(re + o);
      const float2 i2 = *reinterpret_cast<const float2*>(im + o);
      v[2 * k] = make_float2(r2.x, i2.x);
      v[2 * k + 1] = make_float2(r2.y, i2.y);
    });
    fftcore::static_for<VPL>([&](auto s) {
      constexpr int ss = decltype(s)::value;
      fftcore::dft<M, ss * M, true>(v);
      const int ph = (VPL * t + ss + i_offset) & (L - 1);
      fftcore::static_for<M>([&](auto k) {
        constexpr int kk = decltype(k)::value;
        if constexpr (kk % L != 0) {
          const int q = (ph * kk) & (L - 1);
          if constexpr (L >= 8) {
            v[ss * M + kk] = fftcore::cmul(v[ss * M + kk], tw[q]);
          } else {
            v[ss * M + kk] = os_quarter_turns<L>(v[ss * M + kk], q);
          }
        }
      });
    });
    fftcore::static_for<8>([&](auto k) {
      const int o = b ^ (2 * decltype(k)::value);
      *reinterpret_cast<float2*>(re + o) = make_float2(v[2 * k].x, v[2 * k + 1].x);
      *reinterpret_cast<float2*>(im + o) = make_float2(v[2 * k].y, v[2 * k + 1].y);
    });
    __syncthreads();
    const int valid = gcount * M;
    for (int a = 4 * t; a < valid; a += 4 * kOsThreads) {
      const int o0 = zswz(a), o1 = zswz(a + 2);
      const float2 r0 = *reinterpret_cast<const float2*>(re + o0);
      const float2 r1 = *reinterpret_cast<const float2*>(re + o1);
      const float2 m0 = *reinterpret_cast<const float2*>(im + o0);
      const float2 m1 = *reinterpret_cast<const float2*>(im + o1);
      *reinterpret_cast<float4*>(zr + i0 * M + a) = make_float4(r0.x, r0.y, r1.x, r1.y);
      *reinterpret_cast<float4*>(zi + i0 * M + a) = make_float4(m0.x, m0.y, m1.x, m1.y);
    }
  }
}

// ---- pfb_os_wide_kernel ----------------------------------------------------

constexpr int kOsWideThreads = 256;
constexpr int kOsWideOuts = 16 * kOsWideThreads;  // outputs of each component a chunk
constexpr int kOsWideChunks = 2;     // chunks a block (os_wide_chunks)
constexpr int kOsWideStrip = 8;      // window rows a FIR lane sums over

// window rows CU of a chunk's 4096/M output groups, and the FIR strip S
__host__ __device__ constexpr int os_wide_rows(int m, int l) { return kOsWideOuts / (m * l); }
__host__ __device__ constexpr int os_wide_strip(int m, int l) {
  return os_wide_rows(m, l) < kOsWideStrip ? os_wide_rows(m, l) : kOsWideStrip;
}

// window floats of one component: U + W + 1 rows of M, U = chunks * CU
__host__ __device__ inline long long os_wide_win(int m, int l, int w, int chunks) {
  return ((long long)chunks * os_wide_rows(m, l) + w + 1) * m;
}

// the window, one chunk's complex sums and the two twiddle tables ([M]
// and [16] float2)
__host__ __device__ inline long long os_wide_smem_bytes(int m, int r, int w, int chunks) {
  return 4LL * (2 * os_wide_win(m, m / r, w, chunks) + 2LL * kOsWideOuts) + 8LL * (m + 16);
}

// The sums are complex (float2) slots in each warp's tile of 512, in the
// layouts of wide_dft.cuh: widedft::fir_slot as the FIR stores them,
// widedft::out_slot for the outputs.

__device__ __forceinline__ void osw_cp_async16(float* dst, const float* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// window samples [k0, min(k1, span)) of both components (4-sample
// groups, a component's groups counted up to whole store phases): with
// 16-byte aligned streams one cp.async a group (zero-filled past span),
// else sample by sample from registers; one commit group a call, not
// waited for here
__device__ __forceinline__ void osw_stage(float* win, int wlen, const float* xr,
                                          const float* xi, const float* tr,
                                          const float* ti, long long base, int h,
                                          int span, int k0, int k1, int vec) {
  const int g0 = k0 / 4;
  const int groups = max(0, (min(k1, span) - k0 + 3) / 4);
  const int per_c = (groups + 7) / 8 * 8;
  for (int e = threadIdx.x; e < 2 * per_c; e += kOsWideThreads) {
    const int c = e >= per_c;
    const int k = 4 * (g0 + e - c * per_c);
    if (k >= span || k >= k1) continue;
    const float* tp = c ? ti : tr;
    const float* fp = c ? xi : xr;
    const long long q = base + k;
    const long long f = q - h;
    float* dst = win + c * wlen + k;
    if (vec) {
      osw_cp_async16(dst, f < 0 ? tp + q : fp + f, 4 * min(4, span - k));
    } else {
      float v[4];
      fftcore::static_for<4>([&](auto x) {
        const long long qx = q + decltype(x)::value;
        v[x] = k + decltype(x)::value < span ? (qx < h ? tp[qx] : fp[qx - h]) : 0.f;
      });
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int M, int L>
__global__ void __launch_bounds__(kOsWideThreads, 3)
pfb_os_wide_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const float* __restrict__ tr, const float* __restrict__ ti,
                   const float* __restrict__ taps, float* __restrict__ zr,
                   float* __restrict__ zi, int h, int w, int i_offset, int nout,
                   int chunks, int vec) {
  static_assert(M == 32 || M == 64 || M == 128, "M must be 32, 64 or 128");
  static_assert(L >= 2 && L <= 16 && (L & (L - 1)) == 0, "L must be 2, 4, 8 or 16");
  constexpr int T = kOsWideThreads;
  constexpr int R = M / L;
  constexpr int Q = M / 16;            // lanes a group's transform spans
  constexpr int GW = 32 / Q;           // groups a warp transforms
  constexpr int CU = os_wide_rows(M, L);
  constexpr int GC = CU * L;           // output groups a chunk
  constexpr int S = os_wide_strip(M, L);
  constexpr int NQ = CU / S;           // FIR strips a chunk
  extern __shared__ float smem[];
  const int wlen = (int)os_wide_win(M, L, w, chunks);
  float* win = smem;                                  // [2][wlen] window
  float2* sums = reinterpret_cast<float2*>(smem + 2 * wlen);  // [4096]
  float2* tw1 = sums + kOsWideOuts;                   // [16][Q]
  float2* twl = tw1 + M;                              // [L]
  widedft::twiddles<M>(tw1, threadIdx.x, T);
  if (L >= 8 && threadIdx.x < L) {
    double sn, cs;
    sincospi(-2.0 * threadIdx.x / L, &sn, &cs);
    twl[threadIdx.x] = make_float2((float)cs, (float)sn);
  }

  const int U = chunks * CU;
  const long long i0 = (long long)blockIdx.x * U * L;
  const int gcount = (int)min((long long)U * L, (long long)nout - i0);
  const int ucount = gcount / L;       // nout and i0 are multiples of L
  const long long base = (long long)blockIdx.x * U * M;  // v index of sample 0
  const int span = (ucount + w) * M - R;                 // samples needed

  // stage: chunk 0's rows, then the rest in flight behind chunk 0
  const int first = (CU + w) * M;
  osw_stage(win, wlen, xr, xi, tr, ti, base, h, span, 0, first, vec);
  osw_stage(win, wlen, xr, xi, tr, ti, base, h, span, first, span, vec);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  if constexpr (kOsStopAfter < 2) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int gl = lane / Q;             // the lane's group in its warp
  const int q = lane % Q;
  const int g = (t >> 5) * GW + gl;    // its chunk group
  for (int ch = 0; ch < chunks; ++ch) {
    const int u0 = ch * CU;
    if (u0 >= ucount) break;
    if (ch > 0) __syncthreads();       // every warp is done with chunk ch-1's sums

    // branch FIR of both components: job e = (strip s, phase p, branch
    // j), j fastest (a warp: one (s, p), 32 consecutive columns x = p R +
    // M-1-j < 2M); acc[a] = sum_d taps[(W-1-d) M + j] * (window sample
    // (u0 + s S + a + d) M + x).  Strips past the valid rows skip.
    {
      constexpr int JOBS = NQ * L * M;
      for (int e = t; e < JOBS; e += T) {
        const int s0 = e / (L * M) * S;
        const int p = e / M % L;
        const int j = e % M;
        if (u0 + s0 >= ucount) continue;
        const float* wr = win + (u0 + s0) * M + p * R + M - 1 - j;
        const float* wi = wr + wlen;
        float vr[S], vi[S], ar[S], ai[S];
        fftcore::static_for<S>([&](auto k) {
          vr[k] = wr[decltype(k)::value * M];
          vi[k] = wi[decltype(k)::value * M];
          ar[k] = 0.f;
          ai[k] = 0.f;
        });
        wr += S * M;
        wi += S * M;
        const float* tp = taps + (w - 1) * M + j;
        int d0 = 0;
        for (; d0 + S <= w; d0 += S) {
          fftcore::static_for<S>([&](auto r) {
            constexpr int rr = decltype(r)::value;
            const float tap = __ldg(tp - rr * M);
            fftcore::static_for<S>([&](auto s) {
              ar[s] = fmaf(tap, vr[(decltype(s)::value + rr) % S], ar[s]);
              ai[s] = fmaf(tap, vi[(decltype(s)::value + rr) % S], ai[s]);
            });
            vr[rr] = wr[rr * M];
            vi[rr] = wi[rr * M];
          });
          wr += S * M;
          wi += S * M;
          tp -= S * M;
        }
        const int left = w - d0;
        fftcore::static_for<S>([&](auto r) {
          constexpr int rr = decltype(r)::value;
          if (rr < left) {
            const float tap = __ldg(tp - rr * M);
            fftcore::static_for<S>([&](auto s) {
              ar[s] = fmaf(tap, vr[(decltype(s)::value + rr) % S], ar[s]);
              ai[s] = fmaf(tap, vi[(decltype(s)::value + rr) % S], ai[s]);
            });
            vr[rr] = wr[rr * M];
            vi[rr] = wi[rr * M];
          }
        });
        fftcore::static_for<S>([&](auto s) {
          constexpr int ss = decltype(s)::value;
          sums[widedft::fir_slot<Q>(L * (s0 + ss) + p, j)] = make_float2(ar[ss], ai[ss]);
        });
      }
    }
    if (ch == 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();                   // the rest of the window too, after chunk 0
    if constexpr (kOsStopAfter < 3) continue;

    // the M = 16 Q point unscaled inverse DFT in two passes, each group on
    // Q lanes of one warp: lane q takes points j = q + Q m, a 16-point DFT
    // over m, then exp(+2 pi i q k1 / M); through the warp's tile, lane q'
    // takes bins k1 = a Q + q' of every q, Q-point DFTs over q give
    // X[k1 + 16 k2]; then the phase twiddle exp(-2 pi i ((g + i_offset) k
    // mod L) / L), and the outputs in natural order; each warp then
    // copies its own tile's groups out (GW M contiguous outputs)
    {
      float2 v[fftcore::kPts];
      fftcore::static_for<16>([&](auto m) {
        v[m] = sums[widedft::fir_slot<Q>(g, q + Q * decltype(m)::value)];
      });
      widedft::transform<Q>(v, sums, tw1, g, q);
      const int ph = (g + i_offset) & (L - 1);
      fftcore::static_for<16>([&](auto i) {
        constexpr int ii = decltype(i)::value;
        const int k = widedft::bin<Q>(ii, q);
        const int tq = (ph * k) & (L - 1);
        if constexpr (L >= 8) {
          v[ii] = fftcore::cmul(v[ii], twl[tq]);
        } else {
          v[ii] = os_quarter_turns<L>(v[ii], tq);
        }
        sums[widedft::out_slot<M>(g, k)] = v[ii];
      });
      __syncwarp();
      const int gw0 = (t >> 5) * GW;   // the tile's first group
      const int valid = min(GW, min(GC, gcount - u0 * L) - gw0) * M;
      const long long z0 = (i0 + (long long)u0 * L + gw0) * M;
      for (int a = 4 * lane; a < valid; a += 128) {
        const int gg = gw0 + a / M, k = a % M;
        const float4 p0 = *reinterpret_cast<const float4*>(sums + widedft::out_slot<M>(gg, k));
        const float4 p1 = *reinterpret_cast<const float4*>(sums + widedft::out_slot<M>(gg, k + 2));
        *reinterpret_cast<float4*>(zr + z0 + a) = make_float4(p0.x, p0.z, p1.x, p1.z);
        *reinterpret_cast<float4*>(zi + z0 + a) = make_float4(p0.y, p0.w, p1.y, p1.w);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int M, int L>
cudaError_t launch_os_wide(const float* xr, const float* xi, const float* tr,
                           const float* ti, const float* taps, float* zr,
                           float* zi, int n, int h, int w, int i_offset,
                           int chunks, cudaStream_t stream) {
  const long long bytes = os_wide_smem_bytes(M, M / L, w, chunks);
  cudaError_t err = fftcore::set_smem(pfb_os_wide_kernel<M, L>, bytes);
  if (err != cudaSuccess) return err;
  const int nout = n / (M / L);
  const int g = chunks * os_wide_rows(M, L) * L;    // output groups a block
  const int vec = ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(xi) |
                    reinterpret_cast<uintptr_t>(tr) | reinterpret_cast<uintptr_t>(ti)) & 15) == 0;
  pfb_os_wide_kernel<M, L><<<(nout + g - 1) / g, kOsWideThreads, bytes, stream>>>(
      xr, xi, tr, ti, taps, zr, zi, h, w, i_offset, nout, chunks, vec);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_os_wide_m(int l, const float* xr, const float* xi,
                             const float* tr, const float* ti, const float* taps,
                             float* zr, float* zi, int n, int h, int w,
                             int i_offset, int chunks, cudaStream_t stream) {
  switch (l) {
    case 2: return launch_os_wide<M, 2>(xr, xi, tr, ti, taps, zr, zi, n, h, w, i_offset, chunks, stream);
    case 4: return launch_os_wide<M, 4>(xr, xi, tr, ti, taps, zr, zi, n, h, w, i_offset, chunks, stream);
    case 8: return launch_os_wide<M, 8>(xr, xi, tr, ti, taps, zr, zi, n, h, w, i_offset, chunks, stream);
    case 16: return launch_os_wide<M, 16>(xr, xi, tr, ti, taps, zr, zi, n, h, w, i_offset, chunks, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int M, int L>
cudaError_t launch_os_reg(const float* xr, const float* xi, const float* tr,
                          const float* ti, const float* taps, float* zr,
                          float* zi, int n, int h, int w, int i_offset,
                          cudaStream_t stream) {
  const long long bytes = os_reg_smem_bytes(M, M / L, w);
  cudaError_t err = fftcore::set_smem(pfb_os_reg_kernel<M, L>, bytes);
  if (err != cudaSuccess) return err;
  const int nout = n / (M / L);
  const int g = kOsOuts / M;
  const int vec = ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(xi) |
                    reinterpret_cast<uintptr_t>(tr) | reinterpret_cast<uintptr_t>(ti)) & 15) == 0;
  pfb_os_reg_kernel<M, L><<<(nout + g - 1) / g, kOsThreads, bytes, stream>>>(
      xr, xi, tr, ti, taps, zr, zi, n, h, w, i_offset, nout, vec);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_os_reg_m(int l, const float* xr, const float* xi,
                            const float* tr, const float* ti, const float* taps,
                            float* zr, float* zi, int n, int h, int w,
                            int i_offset, cudaStream_t stream) {
  switch (l) {
    case 2: return launch_os_reg<M, 2>(xr, xi, tr, ti, taps, zr, zi, n, h, w, i_offset, stream);
    case 4: if constexpr (M >= 4) return launch_os_reg<M, 4>(xr, xi, tr, ti, taps, zr, zi, n, h, w, i_offset, stream);
            break;
    case 8: if constexpr (M >= 8) return launch_os_reg<M, 8>(xr, xi, tr, ti, taps, zr, zi, n, h, w, i_offset, stream);
            break;
    case 16: if constexpr (M >= 16) return launch_os_reg<M, 16>(xr, xi, tr, ti, taps, zr, zi, n, h, w, i_offset, stream);
             break;
    default: break;
  }
  return cudaErrorInvalidValue;
}

// The current card's opt-in shared memory per block, in *optin.
cudaError_t smem_optin(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The chunks a pfb_os_wide_kernel block runs on the current card, in
// *chunks: kOsWideChunks where three such blocks (each with the shared
// memory the card reserves for a block) fit an SM, else 1.
cudaError_t os_wide_chunks(int m, int r, int w, int* chunks) {
  int dev = 0, sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  *chunks = 3 * (os_wide_smem_bytes(m, r, w, kOsWideChunks) + reserved) <= sm
                ? kOsWideChunks : 1;
  return cudaSuccess;
}

}  // namespace

// Shared memory of one block of the given body (see clen_pfb_oversampled):
// `groups` output groups of pfb_os_kernel, pfb_os_reg_kernel's block, or
// pfb_os_wide_kernel's block of `groups` chunks.  hopper_kernels.os_body
// asks for the last with one chunk.
extern "C" long long clen_os_smem_bytes(int m, int r, int w, int groups, int body) {
  if (body == 1) return os_reg_smem_bytes(m, r, w);
  if (body == 2) return os_wide_smem_bytes(m, r, w, groups);
  return os_smem_bytes(m, r, w, groups);
}

// 1 when the body's smallest block (one output group for pfb_os_kernel,
// its fixed block for pfb_os_reg_kernel, one chunk for pfb_os_wide_kernel)
// fits the current card's opt-in shared memory, 0 when it does not; a
// negative cudaError_t when the card cannot be asked.
extern "C" int clen_os_fits(int m, int r, int w, int body) {
  int optin = 0;
  const cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return -(int)err;
  return clen_os_smem_bytes(m, r, w, 1, body) <= optin ? 1 : 0;
}

// taps: [W*M] branch-major (taps[c*M + j]); tw: [2, M] cos and sin of
// 2 pi q / M (pfb_os_kernel's table).  n: frame samples (a multiple of M);
// h: tail samples, at least the reach W*M - R (a multiple of 4 for bodies
// 1 and 2); i_offset in [0, M).  body 0: pfb_os_kernel, groups = output
// groups per block, at most, halved until the block fits the card's opt-in
// shared memory; body 1: pfb_os_reg_kernel (M in {2, 4, 8, 16}; groups
// unused), 16-byte loads where all four streams are 16-byte aligned; body
// 2: pfb_os_wide_kernel (M in {32, 64, 128}, L in {2, 4, 8, 16}; groups
// unused, os_wide_chunks chunks a block), cp.async staging where all four
// streams are 16-byte aligned.  Returns a cudaError_t; cudaErrorInvalidValue when the
// sizes are inconsistent or the block does not fit.
extern "C" int clen_pfb_oversampled(const void* xr, const void* xi,
                                    const void* tr, const void* ti,
                                    const void* taps, const void* tw, void* zr,
                                    void* zi, int n, int h, int m, int r, int w,
                                    int i_offset, int groups, int body,
                                    void* stream) {
  if (m < 2 || m > 128 || (m & (m - 1)) || r < 1 || m % r || r == m ||
      w < 1 || groups < 1 || n < m || n % m || h < w * m - r ||
      i_offset < 0 || i_offset >= m)
    return cudaErrorInvalidValue;
  const float* fxr = static_cast<const float*>(xr);
  const float* fxi = static_cast<const float*>(xi);
  const float* ftr = static_cast<const float*>(tr);
  const float* fti = static_cast<const float*>(ti);
  const float* ftaps = static_cast<const float*>(taps);
  float* fzr = static_cast<float*>(zr);
  float* fzi = static_cast<float*>(zi);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (h % 4) return cudaErrorInvalidValue;
    const int l = m / r;
    switch (m) {
      case 2: return launch_os_reg_m<2>(l, fxr, fxi, ftr, fti, ftaps, fzr, fzi, n, h, w, i_offset, st);
      case 4: return launch_os_reg_m<4>(l, fxr, fxi, ftr, fti, ftaps, fzr, fzi, n, h, w, i_offset, st);
      case 8: return launch_os_reg_m<8>(l, fxr, fxi, ftr, fti, ftaps, fzr, fzi, n, h, w, i_offset, st);
      case 16: return launch_os_reg_m<16>(l, fxr, fxi, ftr, fti, ftaps, fzr, fzi, n, h, w, i_offset, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (body == 2) {
    if (h % 4) return cudaErrorInvalidValue;
    int chunks = 1;
    const cudaError_t err = os_wide_chunks(m, r, w, &chunks);
    if (err != cudaSuccess) return err;
    const int l = m / r;
    switch (m) {
      case 32: return launch_os_wide_m<32>(l, fxr, fxi, ftr, fti, ftaps, fzr, fzi, n, h, w, i_offset, chunks, st);
      case 64: return launch_os_wide_m<64>(l, fxr, fxi, ftr, fti, ftaps, fzr, fzi, n, h, w, i_offset, chunks, st);
      case 128: return launch_os_wide_m<128>(l, fxr, fxi, ftr, fti, ftaps, fzr, fzi, n, h, w, i_offset, chunks, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (body != 0) return cudaErrorInvalidValue;
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
  pfb_os_kernel<<<blocks, 256, bytes, st>>>(
      fxr, fxi, ftr, fti, ftaps, static_cast<const float*>(tw), fzr, fzi, n, h,
      m, r, w, i_offset, groups, nout);
  return cudaGetLastError();
}
