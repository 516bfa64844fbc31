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
// Design.  Each block owns a tile of `tile` output vectors.  It reads its
// window of v for all 2A components (index arithmetic picks the tail or the
// frame, so no host concat; int8/bf16 widen to f32 after the load and int8
// stays unscaled), computes the branch sums, the stage-1 DFT,
// the per-pair lag DFT and sqrtf, and reduces over its t in fixed order into
// a per-block partial row.  A second launch sums the partial rows in fixed
// block order, so the output is deterministic and no atomics are used.  (On
// the TPU the sums ride a sequential grid in VMEM scratch; Hopper blocks run
// in no order, hence the two passes.)
//
// Three bodies (hopper_kernels.fx_body names the one a call runs: a pure
// rule on M and whether the block fits the card's shared memory):
//
// fx_reg_kernel<T, M>, M in {2, 4, 8, 16}, tile = 1024/M, 256 threads, 4
// blocks an SM (3 at M = 2, and for int8 at M = 4 and 8).  Every
// multiply-add takes its operands from registers; shared memory only hands
// data between the stages, in layouts that put each warp access on 32
// distinct banks.
//   stage  tail ++ frame in 4- (M = 2: 2-) sample groups, 4 in flight a
//          thread, each group's frame samples one aligned vector load;
//          only the samples valid outputs need.
//   FIR    one warp per component, two passes of 512/M vectors; lane =
//          (strip q of 16 consecutive output vectors, branch j).  16 sums
//          and a 16-value window of column M-1-j in registers: one tap load
//          (read-only cache) and one window load per 16 FMAs, the window's
//          slots rotating at compile time (static_for).  The window rows are
//          padded by M floats every 16 rows (row u at (u + u/16)*M), so the
//          strips of a warp fall on distinct banks.
//   DFT    one warp per (antenna, 512 sums); lane = 16 consecutive sums =
//          16/M vectors, fftcore::dft<M, s*M, true> in registers, in place.
//   lag    one warp per fd pair, then one per baseline; lane = the t that
//          are lane mod 32, 16/M at a time.  z_p conj(z_q), the same dft and
//          |.| in registers, M (lag) or 2M (Gram) sums per lane, folded over
//          the warp by a fixed shuffle tree: no barrier after the DFT stage.
//   The FIR warp of component c overwrites the start of c's window row with
//   its sums, which the DFT stage turns into z in place: logical x = t*M + k
//   lives at x ^ (((x >> 5) & 15) << 1) (float2 accesses, half-warp phases).
// fx_wide_kernel<T, M>, M in {32, 64, 128} (a third __global__ body, not
// a widening of fx_reg_kernel, whose DFT lanes hold whole vectors): each
// M = 16 Q point transform, stage 1 and the lag, split over Q lanes in two
// in-register passes (widedft::transform, wide_dft.cuh, as in
// pfb_oversampled.cu's pfb_os_wide_kernel).  256 threads, two blocks an SM
// (at most 128 registers).  A block owns 4096 samples a component (4096/M
// vectors) in kWideChunks = 2 chunks of CU = 2048/M vectors; per chunk:
//   FIR    from device memory, no staging: lane = (antenna, strip of 16
//          vectors, branch j) over both components, j fastest, so a warp
//          reads 32 consecutive words of one row of M (a 128-byte line for
//          f32); 16 sums and a 16-row window of each component in
//          registers, the slots rotating with the tap step: one tap load
//          and two window loads per 32 FMAs.  A strip reads 16 + W rows for
//          16 vectors (2.6x at W = 25, through L1 and L2; once from DRAM);
//          a strip wholly in the frame reads it by pointer, others (the
//          tail/frame seam, the frame's end) pick tail or frame a sample.
//          The complex sums go to float2 slots of the chunk's z area
//          (widedft::fir_slot; group g = antenna CU + vector, warp tile
//          g / GW, GW = 32/Q vectors a tile).
//   DFT    each warp transforms its tiles in place (fir_slot in, out_slot
//          out): z of all antennas for the chunk's vectors stays in shared
//          memory.
//   jobs   job j on warp j mod 8, the same in every chunk.  Lag jobs (FD
//          pair f, half of the chunk's vectors): lane (gl, q) takes vector
//          GW r + gl of each round r, z_p conj(z_q) at bins q + Q m (loaded
//          from out_slot, conflict free), the same two-pass transform
//          through the warp's exchange tile, |.| of its 16 bins added over
//          its vectors in registers; then a halving fold over the tile's GW
//          group lanes (log2 GW shuffle steps a chunk) leaves each lag bin on
//          one lane.  Gram jobs (baseline b): lane takes bins lane + 32 i (i
//          < M/32) of every vector, 2 M/32 sums in registers.  Each job's
//          sums go to its own words of the block's partial row (stored in
//          chunk 0, added to in chunk 1), the two halves of a pair's lag as
//          two runs that fx_reduce_kernel adds in fixed order.
//   Shared memory: a * 2048 float2 (the chunk's sums / z), 8 x 512 float2
//   (the lag exchange tiles), M float2 (the pass-1 table): 8 (2048 a +
//   4096 + M) bytes, 98,816 at a = 4, M = 64; two blocks fit an H100 SM
//   up to a = 5, one up to a = 12 (the opt-in 227 KB); past that the rule
//   keeps fx_tile_kernel.  The partial rows are (2 nfd + 2 nb) M floats a
//   block: 13.6 MB at 4 x 2^23, M = 64 (fx_tile_kernel's 96 MB).
//   tests/test_torch_kernels.py replays the FIR schedule, the reads, the
//   transforms, the fold and the jobs in numpy against the plain form, and
//   checks every warp access's banks.
// fx_tile_kernel<T>, every other M (1, and 32-128 where the wide block does
//   not fit): the first design, each multiply-add reading its operands from
//   shared memory.
//
// Bound on the H100: 256 MiB read for f32 ingest at 4 x 2^23 against about
// 5.5 GFLOP when the M-point transforms are counted as FFTs at M = 16
// (6.0 at 64): level, about 0.08-0.09 ms each (chip_smoke.py reports the
// bound it counts).  fx_reg_kernel is neither: it runs its stages one after
// another behind block barriers, and only the other resident blocks overlap
// one block's staging with arithmetic (tools/fx_ab.py splits its time by
// stage); fx_wide_kernel too, three barriers a chunk, its FIR's loads
// overlapped by its own FMAs and the other block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "fft_core.cuh"
#include "wide_dft.cuh"

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

// out[o] = sum over blocks of partial[blk][o], in a fixed order: a block of
// 8 x 32 threads takes 8 consecutive outputs, thread (x, y) sums rows y +
// 32 i of output x into four sums by i mod 4 (a warp reads 32-byte runs of
// 4 rows; four loads in flight), adds them in a fixed order, then a fixed
// tree folds the 32 threads of each output.  A partial row holds each FD
// pair's lag sums as ls consecutive runs of m (fx_wide_kernel's lag jobs,
// one run each, added in run order) and then the Gram sums; ls = 1 for the
// other bodies.  lag = nfd * m; nout = lag + 2 nb m outputs.
constexpr int kReduceCols = 8;
constexpr int kReduceRows = 32;

__global__ void __launch_bounds__(kReduceCols * kReduceRows)
fx_reduce_kernel(const float* __restrict__ partial, int nblk, int width, int lag,
                 int m, int ls, int nout, float* __restrict__ out) {
  __shared__ float red[kReduceRows][kReduceCols];
  const int x = threadIdx.x % kReduceCols;
  const int y = threadIdx.x / kReduceCols;
  const int o = blockIdx.x * kReduceCols + x;
  float s = 0.f;
  if (o < nout) {
    const bool in_lag = o < lag;
    const int col = in_lag ? o / m * ls * m + o % m : o + lag * (ls - 1);
    const int runs = in_lag ? ls : 1;
    for (int r = 0; r < runs; ++r) {
      const float* p = partial + col + r * m;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      int b = y;
      for (; b + 3 * kReduceRows < nblk; b += 4 * kReduceRows) {
        fftcore::static_for<4>([&](auto i) {
          acc[i] += p[(long long)(b + decltype(i)::value * kReduceRows) * width];
        });
      }
      for (int i = 0; b < nblk; b += kReduceRows, ++i) acc[i] += p[(long long)b * width];
      s += (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
  red[y][x] = s;
  __syncthreads();
  for (int stride = kReduceRows / 2; stride > 0; stride >>= 1) {
    if (y < stride) red[y][x] += red[y + stride][x];
    __syncthreads();
  }
  if (y == 0 && o < nout) out[o] = red[0][x];
}

// ---- fx_reg_kernel ---------------------------------------------------------

constexpr int kRegThreads = 256;
constexpr int kRegWarps = kRegThreads / 32;
constexpr int kStrip = 16;              // output vectors a FIR lane sums
constexpr int kTileSamples = 1024;      // tile * M
constexpr int kSubSamples = 512;       // a FIR warp's pass: 32/M strips of 16 vectors
// blocks an SM the register budget is set for: 4 (64 registers) where
// ptxas fits the body without a spill, else 3 (80): M = 2 (16 t a lane in
// the lag and Gram stages) and int8 at M = 4 and 8 spill at 64
template <typename T>
constexpr int reg_blocks(int m) {
  return m == 2 || (sizeof(T) == 1 && m < 16) ? 3 : 4;
}
constexpr int kStageUnroll = 4;         // staging vectors in flight per thread
// a timing probe's build (-DFX_STOP_AFTER=1, 2 or 3) stops each block after
// the staging, the FIR or the DFT stage; the library never sets it
#ifndef FX_STOP_AFTER
#define FX_STOP_AFTER 4
#endif
constexpr int kStopAfter = FX_STOP_AFTER;

// padded window floats per component: rows tile + w (the FIR's last window
// load of a strip reads row t0 + 15 + w, t0 <= tile - 16), one pad row
// after every 16, and 4 floats of slack for the staging's shift
__host__ __device__ inline long long fx_reg_wpad(int m, int w, int tile) {
  const long long rows = (long long)tile + w;
  return (rows + kStrip - 1) / kStrip * (kStrip + 1) * m + 4;
}

__host__ __device__ inline long long fx_reg_smem_floats(int a, int m, int w, int tile) {
  return 2LL * a * fx_reg_wpad(m, w, tile);
}

// the shared-memory word of logical float x of a component row of sums / z.
// For x = t*M + k, k < M <= 16, zswz(x) = zswz(t*M) ^ k: one swizzled base a
// vector, then one XOR with a constant an access
__device__ __forceinline__ int zswz(int x) { return x ^ (((x >> 5) & 15) << 1); }

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// fold s[0 .. CNT) over the warp by a fixed butterfly: halving steps on lane
// bits MASK, MASK/2, ... (a lane keeps the upper half when its bit is set),
// then full adds.  Lane L ends with the warp's sum of entry L >> (5 - log2
// CNT) in s[0]; partner lanes add the same two values, so every lane of a
// pair holds the same bits.
template <int N, int CNT, int MASK>
__device__ __forceinline__ void warp_fold(float (&s)[N], int lane) {
  if constexpr (CNT > 1) {
    constexpr int H = CNT / 2;
    const bool up = lane & MASK;
    fftcore::static_for<H>([&](auto i) {
      const float send = up ? s[i] : s[i + H];
      const float keep = up ? s[i + H] : s[i];
      s[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
    });
    warp_fold<N, H, MASK / 2>(s, lane);
  } else if constexpr (MASK > 0) {
    s[0] += __shfl_xor_sync(0xffffffffu, s[0], MASK);
    warp_fold<N, 1, MASK / 2>(s, lane);
  }
}

// lane L's s[0] to out[L >> SH] from the lanes whose low SH bits are zero,
// SH = 5 - log2 CNT (the layout warp_fold<., CNT, 16> leaves)
template <int CNT, int N>
__device__ __forceinline__ void warp_store(const float (&s)[N], int lane, float* out) {
  constexpr int SH = CNT == 2 ? 4 : CNT == 4 ? 3 : CNT == 8 ? 2 : CNT == 16 ? 1 : 0;
  if ((lane & ((1 << SH) - 1)) == 0) out[lane >> SH] = s[0];
}

// |y| as x·rsqrt(x), x = |y|²: MUFU's rsqrt (2 ulp) in place of the IEEE
// square root's fix-up sequence; 0 where x is 0
__device__ __forceinline__ float mag(float2 y) {
  const float x = fmaf(y.x, y.x, y.y * y.y);
  return x > 0.f ? x * rsqrtf(x) : 0.f;
}

// VW samples at p (VW-aligned) widened to float by one load of
// VW·sizeof(T) bytes, unpacked with shifts (bf16 is the top half of a
// float, int8 stays unscaled)
template <typename T, int VW>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[VW]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (VW == 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p));
      o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
    } else {
      const float2 f = __ldg(reinterpret_cast<const float2*>(p));
      o[0] = f.x; o[1] = f.y;
    }
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    unsigned wd[VW / 2];
    if constexpr (VW == 4) {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
      wd[0] = r.x; wd[1] = r.y;
    } else {
      wd[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    }
    fftcore::static_for<VW>([&](auto x) {
      constexpr int X = decltype(x)::value;
      const unsigned w = wd[X / 2];
      o[X] = __uint_as_float(X % 2 ? w & 0xffff0000u : w << 16);
    });
  } else {
    static_assert(std::is_same_v<T, int8_t>, "float, bfloat16 or int8");
    unsigned r;
    if constexpr (VW == 4) {
      r = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      r = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
    fftcore::static_for<VW>([&](auto x) {
      o[decltype(x)::value] =
          static_cast<float>(static_cast<int8_t>(r >> (8 * decltype(x)::value)));
    });
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kRegThreads, reg_blocks<T>(M))
fx_reg_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
              const T* __restrict__ tr, const T* __restrict__ ti,
              const float* __restrict__ taps,
              const int* __restrict__ fd_pairs, int nfd,
              const int* __restrict__ xe_pairs, int nb,
              int a, int w, int n, int h, float* __restrict__ partial) {
  static_assert(M == 2 || M == 4 || M == 8 || M == 16, "M must be 2, 4, 8 or 16");
  constexpr int TILE = kTileSamples / M;   // output vectors per block
  constexpr int VPL = kStrip / M;          // vectors a lane holds in the DFT stages
  constexpr int NSUB = kTileSamples / kSubSamples;
  constexpr int SUBT = kSubSamples / M;    // output vectors of a FIR pass
  constexpr int VW = M >= 4 ? 4 : 2;       // samples a staging group
  extern __shared__ float smem[];
  const int g = 2 * a;
  const int wpad = (int)fx_reg_wpad(M, w, TILE);
  // [g][wpad] padded window; component c's FIR warp then overwrites the
  // start of its own row c with its 512 sums, which become z in place
  float* win = smem;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int nout = n / M;
  const long long t0 = (long long)blockIdx.x * TILE;
  const int tvalid = min(TILE, (int)(nout - t0));
  const int span_valid = tvalid * M + w * M - 1;
  const long long base = t0 * M;       // index in v of window row 0, column 0

  // stage tail ++ frame: window chunk ch (rows 16 ch .. 16 ch + 15, the
  // samples k = 16 ch M ..) goes to physical row 17 ch, so a pad row of M
  // floats follows every 16 rows, and the whole window sits delta floats
  // into its row (delta = -h mod VW < VW, the row's slack).  Only
  // k < span_valid is staged: the rows past it feed no valid output.  A
  // thread fills VW-sample groups, kStageUnroll of them in flight; group i
  // holds k = VW i - delta .., so its frame samples start on a VW-aligned
  // frame index (the block's start and n are multiples of VW, M >= VW) and
  // load as one vector, inside the frame (the last sample used is frame
  // n - 1 at most, and the vector holding it ends there), to a VW-aligned
  // word.  Groups reaching into the tail load sample by sample; a group
  // that a pad row splits (delta > 0) stores sample by sample.  A
  // component's groups are counted up to a multiple of the lanes of one
  // store phase (32 / VW), the extra ones idle, so that no phase spans two
  // rows or a pad row.
  const int delta = (VW - h % VW) % VW;
  {
    constexpr int CH = kStrip * M;
    const int groups = (span_valid + delta + VW - 1) / VW;
    const int per_c = (groups + 32 / VW - 1) / (32 / VW) * (32 / VW);
    const int total = g * per_c;
    for (int e0 = threadIdx.x; e0 < total; e0 += kStageUnroll * kRegThreads) {
      float v[kStageUnroll][VW];
      fftcore::static_for<kStageUnroll>([&](auto u) {
        const int e = e0 + u * kRegThreads;
        const int c = e / per_c;
        const int i = e - c * per_c;
        const int k = VW * i - delta;      // window index of sample 0
        fftcore::static_for<VW>([&](auto x) { v[u][x] = 0.f; });
        if (e < total && i < groups) {
          const int ant = c < a ? c : c - a;
          const T* tp = (c < a ? tr : ti) + (long long)ant * h;
          const T* fr = (c < a ? xr : xi) + (long long)ant * n;
          const long long f = base + k - h;      // its frame index, VW-aligned
          if (f >= 0) {
            load_vec<T, VW>(fr + f, v[u]);
            fftcore::static_for<VW>([&](auto x) {
              constexpr int xx = decltype(x)::value;
              if (k + xx >= span_valid) v[u][x] = 0.f;
            });
          } else {
            fftcore::static_for<VW>([&](auto x) {
              const int kx = k + decltype(x)::value;
              const long long sx = base + kx;
              if (kx >= 0 && kx < span_valid) v[u][x] = widen(sx < h ? tp[sx] : fr[sx - h]);
            });
          }
        }
      });
      fftcore::static_for<kStageUnroll>([&](auto u) {
        const int e = e0 + u * kRegThreads;
        const int c = e / per_c;
        const int i = e - c * per_c;
        if (e < total && i < groups) {
          const int k = VW * i - delta;
          float* row = win + c * wpad + delta;
          if (delta == 0 || k < 0 || (k + delta) % CH != 0) {
            store_vec<VW>(row + k + k / CH * M, v[u]);    // k / CH: 0 for k < 0
          } else {
            fftcore::static_for<VW>([&](auto x) {
              const int kx = k + decltype(x)::value;
              row[kx + kx / CH * M] = v[u][x];
            });
          }
        }
      });
    }
  }
  __syncthreads();
  if constexpr (kStopAfter < 2) return;

  // branch FIR: acc[t, j] = sum_d taps[w-1-d, j] * v[(t + d) * M + M - 1 - j],
  // taps through the read-only cache (the same 4·W·M bytes for every block).
  // One warp per component, its NSUB passes in turn: a pass reads window
  // rows from its first vector on and writes its sums below that, at the
  // start of the row, after the warp's reads (so no other warp's rows and
  // no rows this warp reads later are touched).
  {
    const int j = lane & (M - 1);
    const int q = lane / M;                // strip: t = SUBT sub + 16 q + s
    for (int c = warp; c < g; c += kRegWarps) {
      float* row = win + c * wpad;
      for (int sub = 0; sub < NSUB; ++sub) {
        const float* p =
            row + delta + (kStrip + 1) * (sub * SUBT / kStrip + q) * M + (M - 1 - j);
        float wv[kStrip], acc[kStrip];
        fftcore::static_for<kStrip>([&](auto k) {
          wv[k] = p[k * M];
          acc[k] = 0.f;
        });
        p += (kStrip + 1) * M;             // window row t0 + 16
        const float* tp = taps + (w - 1) * M + j;
        int d0 = 0;
        for (; d0 + kStrip <= w; d0 += kStrip) {
          fftcore::static_for<kStrip>([&](auto r) {
            const float tap = __ldg(tp - r * M);
            fftcore::static_for<kStrip>([&](auto s) {
              acc[s] = fmaf(tap, wv[(decltype(s)::value + decltype(r)::value) % kStrip],
                            acc[s]);
            });
            wv[r] = p[r * M];              // row t0 + d + 16 into the freed slot
          });
          p += (kStrip + 1) * M;
          tp -= kStrip * M;
        }
        const int rem = w - d0;
        fftcore::static_for<kStrip>([&](auto r) {
          constexpr int rr = decltype(r)::value;
          if (rr < rem) {
            const float tap = __ldg(tp - r * M);
            fftcore::static_for<kStrip>([&](auto s) {
              acc[s] = fmaf(tap, wv[(decltype(s)::value + decltype(r)::value) % kStrip],
                            acc[s]);
            });
            wv[r] = p[r * M];
          }
        });
        __syncwarp();                      // the pass's window reads are done
        fftcore::static_for<kStrip>([&](auto s) {
          row[zswz((sub * SUBT + kStrip * q + decltype(s)::value) * M) ^ j] = acc[s];
        });
      }
    }
  }
  __syncthreads();
  if constexpr (kStopAfter < 3) return;

  // stage-1 unscaled inverse DFT, in place: lane holds sums 16 lane .. +15
  // of a 512-sum half
  for (int job = warp; job < a * NSUB; job += kRegWarps) {
    const int ai = job / NSUB;
    const int off = (job - ai * NSUB) * kSubSamples;
    float* re = win + ai * wpad + off;
    float* im = win + (a + ai) * wpad + off;
    float2 v[fftcore::kPts];
    const int b = zswz(kStrip * lane);     // 16 lane is a multiple of M
    fftcore::static_for<kStrip / 2>([&](auto k) {
      const int o = b ^ (2 * decltype(k)::value);
      const float2 r2 = ld2(re + o), i2 = ld2(im + o);
      v[2 * k] = make_float2(r2.x, i2.x);
      v[2 * k + 1] = make_float2(r2.y, i2.y);
    });
    fftcore::static_for<VPL>([&](auto s) {
      fftcore::dft<M, decltype(s)::value * M, true>(v);
    });
    fftcore::static_for<kStrip / 2>([&](auto k) {
      const int o = b ^ (2 * decltype(k)::value);
      *reinterpret_cast<float2*>(re + o) = make_float2(v[2 * k].x, v[2 * k + 1].x);
      *reinterpret_cast<float2*>(im + o) = make_float2(v[2 * k].y, v[2 * k + 1].y);
    });
  }
  __syncthreads();
  if constexpr (kStopAfter < 4) return;

  // FD lag sums (jobs < nfd), then Gram sums; lane takes the t = lane + 32 s,
  // VPL of them at a time in registers
  const int width = nfd * M + 2 * nb * M;
  float* out = partial + (long long)blockIdx.x * width;
  for (int job = warp; job < nfd + nb; job += kRegWarps) {
    const bool lag = job < nfd;
    const int* pr = lag ? fd_pairs + 2 * job : xe_pairs + 2 * (job - nfd);
    const int p = pr[0], q = pr[1];
    const float* pre = win + p * wpad;
    const float* pim = win + (a + p) * wpad;
    const float* qre = win + q * wpad;
    const float* qim = win + (a + q) * wpad;
    if (lag) {
      // each group of VPL vectors is folded over the warp on its own, so
      // no sums stay live through the next group's DFT; the groups' folds
      // add in a fixed order
      float total = 0.f;
      fftcore::static_for<NSUB>([&](auto grp) {
      float2 v[fftcore::kPts];
      fftcore::static_for<VPL>([&](auto s) {
        const int t = lane + 32 * (decltype(grp)::value * VPL + decltype(s)::value);
        const int b = zswz(t * M);
        fftcore::static_for<M / 2>([&](auto k) {
          const int o = b ^ (2 * decltype(k)::value);
          const float2 a_r = ld2(pre + o), a_i = ld2(pim + o);
          const float2 b_r = ld2(qre + o), b_i = ld2(qim + o);
          constexpr int i0 = decltype(s)::value * M + 2 * decltype(k)::value;
          v[i0] = fftcore::cmulc(make_float2(a_r.x, a_i.x), make_float2(b_r.x, b_i.x));
          v[i0 + 1] = fftcore::cmulc(make_float2(a_r.y, a_i.y), make_float2(b_r.y, b_i.y));
        });
        fftcore::dft<M, decltype(s)::value * M, true>(v);
      });
      float sums[M];
      fftcore::static_for<M>([&](auto l) { sums[l] = 0.f; });
      fftcore::static_for<VPL>([&](auto s) {
        constexpr int ss = decltype(grp)::value * VPL + decltype(s)::value;
        if (lane + 32 * ss < tvalid) {
          fftcore::static_for<M>([&](auto l) {
            const float2 y = v[decltype(s)::value * M + l];
            sums[l] += mag(y);
          });
        }
      });
      warp_fold<M, M, 16>(sums, lane);
      total += sums[0];
      });
      float folded[1] = {total};
      warp_store<M>(folded, lane, out + job * M);
    } else {
      float sums[2 * M];                   // [gram re k | gram im k]
      fftcore::static_for<2 * M>([&](auto l) { sums[l] = 0.f; });
      fftcore::static_for<NSUB * VPL>([&](auto s) {
        const int t = lane + 32 * decltype(s)::value;
        if (t < tvalid) {
          const int b = zswz(t * M);
          fftcore::static_for<M / 2>([&](auto k) {
            const int o = b ^ (2 * decltype(k)::value);
            const float2 r1 = ld2(pre + o), i1 = ld2(pim + o);
            const float2 r2 = ld2(qre + o), i2 = ld2(qim + o);
            constexpr int k0 = 2 * decltype(k)::value;
            sums[k0] += r1.x * r2.x + i1.x * i2.x;
            sums[k0 + 1] += r1.y * r2.y + i1.y * i2.y;
            sums[M + k0] += i1.x * r2.x - r1.x * i2.x;
            sums[M + k0 + 1] += i1.y * r2.y - r1.y * i2.y;
          });
        }
      });
      warp_fold<2 * M, 2 * M, 16>(sums, lane);
      warp_store<2 * M>(sums, lane, out + nfd * M + 2 * (job - nfd) * M);
    }
  }
}

// ---- fx_wide_kernel --------------------------------------------------------

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideChunk = 2048;        // samples a component a chunk: CU = 2048 / M vectors
constexpr int kWideChunks = 2;          // chunks a block: 4096 samples a component
constexpr int kWideStrip = 16;          // output vectors a FIR lane sums
constexpr int kWideTile = 512;          // float2 slots of a warp's tile (wide_dft.cuh)
constexpr int kWideLagSplits = 2;       // lag jobs a pair a chunk, each half its vectors

// shared-memory bytes of a block: a chunk's sums / z of all a antennas
// (a * 2048 float2), the warps' lag exchange tiles and the pass-1 table
__host__ __device__ inline long long fx_wide_smem_bytes(int a, int m) {
  return 8LL * ((long long)a * kWideChunk + kWideWarps * kWideTile + m);
}

// fold s[0 .. CNT) over the lanes that differ in lane bits MASK, MASK / 2,
// ... STOP by halving steps (a lane keeps the upper half where its bit is
// set): with MASK = 16 and STOP = Q, lane (gl, q) ends holding in s[v] the
// warp's sum over gl of entry gl * CNT Q / 32 + v, v < CNT Q / 32
template <int CNT, int MASK, int STOP, int N>
__device__ __forceinline__ void halve_fold(float (&s)[N], int lane) {
  if constexpr (MASK >= STOP) {
    constexpr int H = CNT / 2;
    const bool up = lane & MASK;
    fftcore::static_for<H>([&](auto i) {
      const float send = up ? s[i] : s[i + H];
      const float keep = up ? s[i + H] : s[i];
      s[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
    });
    halve_fold<H, MASK / 2, STOP>(s, lane);
  }
}

// tap step d of a FIR strip (RR = d mod S): the S sums of both components
// take tap * window row d + s, whose value sits in slot (s + RR) mod S;
// then row d + S goes into the slot row d leaves
template <int RR, int S, class Load>
__device__ __forceinline__ void fir_tap(float (&vr)[S], float (&vi)[S], float (&ar)[S],
                                        float (&ai)[S], float tap, const Load& ld, int d) {
  fftcore::static_for<S>([&](auto s) {
    ar[s] = fmaf(tap, vr[(decltype(s)::value + RR) % S], ar[s]);
    ai[s] = fmaf(tap, vi[(decltype(s)::value + RR) % S], ai[s]);
  });
  const float2 x = ld(d + S);
  vr[RR] = x.x;
  vi[RR] = x.y;
}

// one FIR strip: ar[s] + i ai[s] = sum_{d < w} tp[-d M] * ld(s + d), both
// components, from 0.f in ascending d; ld(r) gives window row r of the
// strip's column (rows 0 .. S + w - 1 are read), tp points at the branch's
// tap in row W - 1
template <int S, int M, class Load>
__device__ __forceinline__ void fir_strip(float (&ar)[S], float (&ai)[S],
                                          const float* tp, int w, const Load& ld) {
  float vr[S], vi[S];
  fftcore::static_for<S>([&](auto k) {
    const float2 x = ld(decltype(k)::value);
    vr[k] = x.x;
    vi[k] = x.y;
    ar[k] = 0.f;
    ai[k] = 0.f;
  });
  int d0 = 0;
  for (; d0 + S <= w; d0 += S) {
    fftcore::static_for<S>([&](auto r) {
      constexpr int rr = decltype(r)::value;
      fir_tap<rr>(vr, vi, ar, ai, __ldg(tp - (d0 + rr) * M), ld, d0 + rr);
    });
  }
  const int left = w - d0;
  fftcore::static_for<S>([&](auto r) {
    constexpr int rr = decltype(r)::value;
    if (rr < left) fir_tap<rr>(vr, vi, ar, ai, __ldg(tp - (d0 + rr) * M), ld, d0 + rr);
  });
}

template <typename T, int M>
__global__ void __launch_bounds__(kWideThreads, 2)
fx_wide_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
               const T* __restrict__ tr, const T* __restrict__ ti,
               const float* __restrict__ taps,
               const int* __restrict__ fd_pairs, int nfd,
               const int* __restrict__ xe_pairs, int nb,
               int a, int w, int n, int h, float* __restrict__ partial) {
  static_assert(M == 32 || M == 64 || M == 128, "M must be 32, 64 or 128");
  constexpr int Q = M / 16;                // lanes a group's transform spans
  constexpr int GW = 32 / Q;               // groups a warp tile holds
  constexpr int CU = kWideChunk / M;       // output vectors a chunk
  constexpr int S = kWideStrip;
  constexpr int NQ = CU / S;               // FIR strips a chunk
  constexpr int RPJ = CU / GW / kWideLagSplits;  // lag rounds a job
  constexpr int KL = M / 32;               // Gram bins a lane
  constexpr int V = 16 / GW;               // lag sums a lane keeps after the fold
  constexpr int LS = kWideLagSplits;
  extern __shared__ float smem[];
  // [a * CU groups][M] float2: a chunk's FIR sums (fir_slot), then z
  // (out_slot); group g = antenna * CU + vector, tile g / GW
  float2* z = reinterpret_cast<float2*>(smem);
  float2* scratch = z + (long long)a * kWideChunk;   // [warps][512] lag exchange
  float2* tw1 = scratch + kWideWarps * kWideTile;    // [M] pass-1 twiddles
  widedft::twiddles<M>(tw1, threadIdx.x, kWideThreads);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane / Q;                 // the lane's group in its tile
  const int q = lane % Q;
  const int nout = n / M;
  const long long t0 = (long long)blockIdx.x * (kWideChunks * CU);
  const int tvalid = (int)min((long long)(kWideChunks * CU), nout - t0);
  const int jobs = nfd * LS + nb;
  const int width = (nfd * LS + 2 * nb) * M;
  float* out = partial + (long long)blockIdx.x * width;

  for (int ch = 0; ch < kWideChunks; ++ch) {
    const int tc = ch * CU;                // the chunk's first vector in the block
    if (tc >= tvalid) break;
    if (ch > 0) __syncthreads();           // every warp is done with chunk ch-1's z

    // branch FIR of both components of an antenna from device memory: job e
    // = (antenna, strip of S vectors, branch j), j fastest (a warp: 32
    // consecutive columns M-1-j of one row, one 128-byte line for f32);
    // acc[s] = sum_d taps[(W-1-d) M + j] * v[(t + s + d) M + M-1-j], t the
    // strip's first vector.  S sums and an S-row window of each component
    // in registers, the slots rotating with the tap step; one tap load and
    // two window loads per 2 S FMAs.  A strip whose rows (through row S +
    // W - 1, the last refill's) all lie in the frame reads it by pointer;
    // any other (the tail/frame seam, the frame's end) picks tail or frame
    // a sample, 0 past the frame.  Strips past the valid vectors skip.
    if constexpr (kStopAfter >= 2) {
      for (int e = threadIdx.x; e < a * NQ * M; e += kWideThreads) {
        const int j = e % M;
        const int s0 = e / M % NQ * S;
        const int ant = e / (NQ * M);
        if (tc + s0 >= tvalid) continue;
        const long long rb = (t0 + tc + s0) * M;   // v index of the strip's row 0
        const int col = M - 1 - j;
        const T* fr = xr + (long long)ant * n;
        const T* fi = xi + (long long)ant * n;
        const T* hr = tr + (long long)ant * h;
        const T* hi = ti + (long long)ant * h;
        const float* tp = taps + (w - 1) * M + j;
        float ar[S], ai[S];
        if (rb >= h && rb + (long long)(S + w) * M <= (long long)h + n) {
          const T* pr = fr + (rb - h) + col;
          const T* pi = fi + (rb - h) + col;
          fir_strip<S, M>(ar, ai, tp, w, [&](int d) {
            return make_float2(widen(pr[(long long)d * M]), widen(pi[(long long)d * M]));
          });
        } else {
          fir_strip<S, M>(ar, ai, tp, w, [&](int d) {
            const long long x = rb + (long long)d * M + col;
            float re = 0.f, im = 0.f;
            if (x < h) {
              re = widen(hr[x]);
              im = widen(hi[x]);
            } else if (x - h < n) {
              re = widen(fr[x - h]);
              im = widen(fi[x - h]);
            }
            return make_float2(re, im);
          });
        }
        fftcore::static_for<S>([&](auto s) {
          constexpr int ss = decltype(s)::value;
          z[widedft::fir_slot<Q>(ant * CU + s0 + ss, j)] = make_float2(ar[ss], ai[ss]);
        });
      }
    }
    __syncthreads();
    if constexpr (kStopAfter < 3) continue;

    // stage-1 unscaled inverse DFT of every (antenna, vector) group, in
    // place: warp tiles in turn, each group on Q lanes (widedft::transform)
    for (int tile = warp; tile < a * CU / GW; tile += kWideWarps) {
      const int g = tile * GW + gl;
      float2 v[fftcore::kPts];
      fftcore::static_for<16>([&](auto m) {
        v[m] = z[widedft::fir_slot<Q>(g, q + Q * decltype(m)::value)];
      });
      widedft::transform<Q>(v, z, tw1, g, q);
      const int zo = widedft::out_slot<M>(g, 0) ^ q;
      fftcore::static_for<16>([&](auto i) {
        z[zo ^ widedft::kswz(widedft::bin<Q>(decltype(i)::value, 0))] = v[i];
      });
    }
    __syncthreads();
    if constexpr (kStopAfter < 4) continue;

    // the chunk's jobs, job j on warp j mod 8, the same in every chunk:
    // lag jobs (pair f, half h of the chunk's vectors) first, then Gram jobs
    // (baseline b).  Each job's sums go to its own words of the block's
    // partial row (stored by chunk 0, added to after), so no two warps
    // write one word and the order of every sum is fixed.
    for (int job = warp; job < jobs; job += kWideWarps) {
      if (job < nfd * LS) {
        // lane (gl, q) takes vector t = GW rd + gl of each round rd:
        // z_p conj(z_q) at bins q + Q m, the same transform through the
        // warp's exchange tile, |.| of its 16 bins added over its vectors
        // in registers; then one fold over the tile's groups
        const int f = job / LS, part = job % LS;
        const int p = fd_pairs[2 * f], pq = fd_pairs[2 * f + 1];
        float2* tile = scratch + warp * kWideTile;
        float sums[16];
        fftcore::static_for<16>([&](auto i) { sums[i] = 0.f; });
        for (int rd = part * RPJ; rd < (part + 1) * RPJ; ++rd) {
          const int t = rd * GW + gl;
          const int zp = widedft::out_slot<M>(p * CU + t, 0) ^ q;
          const int zq = widedft::out_slot<M>(pq * CU + t, 0) ^ q;
          float2 v[fftcore::kPts];
          fftcore::static_for<16>([&](auto m) {
            constexpr int kc = widedft::kswz(Q * decltype(m)::value);
            v[m] = fftcore::cmulc(z[zp ^ kc], z[zq ^ kc]);
          });
          widedft::transform<Q>(v, tile, tw1, gl, q);
          if (tc + t < tvalid) {
            fftcore::static_for<16>([&](auto i) { sums[i] += mag(v[i]); });
          }
        }
        halve_fold<16, 16, Q>(sums, lane);
        float* dst = out + (f * LS + part) * M;
        fftcore::static_for<V>([&](auto u) {
          const int k = widedft::bin<Q>(gl * V + decltype(u)::value, q);
          dst[k] = ch == 0 ? sums[u] : dst[k] + sums[u];
        });
      } else {
        // lane takes bins k = lane + 32 i of every valid vector
        const int b = job - nfd * LS;
        const int s1 = xe_pairs[2 * b], s2 = xe_pairs[2 * b + 1];
        const int tn = min(CU, tvalid - tc);
        float gr[KL], gi[KL];
        fftcore::static_for<KL>([&](auto i) { gr[i] = 0.f; gi[i] = 0.f; });
        const int kl = widedft::kswz(lane);
        for (int t = 0; t < tn; ++t) {
          const int z1 = widedft::out_slot<M>(s1 * CU + t, 0) ^ kl;
          const int z2 = widedft::out_slot<M>(s2 * CU + t, 0) ^ kl;
          fftcore::static_for<KL>([&](auto i) {
            const float2 u = z[z1 ^ (32 * decltype(i)::value)];
            const float2 y = z[z2 ^ (32 * decltype(i)::value)];
            gr[i] += u.x * y.x + u.y * y.y;
            gi[i] += u.y * y.x - u.x * y.y;
          });
        }
        float* dst = out + nfd * LS * M + 2 * b * M;
        fftcore::static_for<KL>([&](auto i) {
          const int k = lane + 32 * decltype(i)::value;
          dst[k] = ch == 0 ? gr[i] : dst[k] + gr[i];
          dst[M + k] = ch == 0 ? gi[i] : dst[M + k] + gi[i];
        });
      }
    }
  }
}

template <typename T, int M>
cudaError_t launch_wide(const void* xr, const void* xi, const void* tr,
                        const void* ti, const float* taps, const int* fd_pairs,
                        int nfd, const int* xe_pairs, int nb, int a, int w, int n,
                        int h, float* partial, int nblk, cudaStream_t stream) {
  const long long bytes = fx_wide_smem_bytes(a, M);
  cudaError_t err = fftcore::set_smem(fx_wide_kernel<T, M>, bytes);
  if (err != cudaSuccess) return err;
  fx_wide_kernel<T, M><<<nblk, kWideThreads, bytes, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<const T*>(tr), static_cast<const T*>(ti), taps, fd_pairs, nfd,
      xe_pairs, nb, a, w, n, h, partial);
  return cudaGetLastError();
}

template <typename T, int M>
cudaError_t launch_reg(const void* xr, const void* xi, const void* tr,
                       const void* ti, const float* taps, const int* fd_pairs,
                       int nfd, const int* xe_pairs, int nb, int a, int w, int n,
                       int h, float* partial, int nblk, cudaStream_t stream) {
  const long long bytes =
      fx_reg_smem_floats(a, M, w, kTileSamples / M) * (long long)sizeof(float);
  cudaError_t err = fftcore::set_smem(fx_reg_kernel<T, M>, bytes);
  if (err != cudaSuccess) return err;
  fx_reg_kernel<T, M><<<nblk, kRegThreads, bytes, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<const T*>(tr), static_cast<const T*>(ti), taps, fd_pairs, nfd,
      xe_pairs, nb, a, w, n, h, partial);
  return cudaGetLastError();
}

// lag runs a pair of a partial row of the body (fx_reduce_kernel's ls)
inline int lag_runs(int body) { return body == 2 ? kWideLagSplits : 1; }

// body 0: fx_tile_kernel (any M dividing 128); body 1: fx_reg_kernel (M in
// {2, 4, 8, 16}, tile = 1024 / M); body 2: fx_wide_kernel (M in {32, 64,
// 128}, tile = 4096 / M)
template <typename T>
cudaError_t launch_fx(const void* xr, const void* xi, const void* tr,
                      const void* ti, const float* taps, const float* tw,
                      const int* fd_pairs, int nfd, const int* xe_pairs, int nb,
                      int a, int m, int w, int n, int h, int tile, int body,
                      float* partial, float* out, cudaStream_t stream) {
  const int nout = n / m;
  const int nblk = (nout + tile - 1) / tile;
  cudaError_t err = cudaSuccess;
  if (body == 2) {
    if (tile * m != kWideChunks * kWideChunk) return cudaErrorInvalidValue;
    switch (m) {
      case 32: err = launch_wide<T, 32>(xr, xi, tr, ti, taps, fd_pairs, nfd, xe_pairs,
                                        nb, a, w, n, h, partial, nblk, stream); break;
      case 64: err = launch_wide<T, 64>(xr, xi, tr, ti, taps, fd_pairs, nfd, xe_pairs,
                                        nb, a, w, n, h, partial, nblk, stream); break;
      case 128: err = launch_wide<T, 128>(xr, xi, tr, ti, taps, fd_pairs, nfd,
                                          xe_pairs, nb, a, w, n, h, partial, nblk,
                                          stream); break;
      default: return cudaErrorInvalidValue;
    }
  } else if (body == 1) {
    if (tile * m != kTileSamples) return cudaErrorInvalidValue;
    switch (m) {
      case 2: err = launch_reg<T, 2>(xr, xi, tr, ti, taps, fd_pairs, nfd, xe_pairs,
                                     nb, a, w, n, h, partial, nblk, stream); break;
      case 4: err = launch_reg<T, 4>(xr, xi, tr, ti, taps, fd_pairs, nfd, xe_pairs,
                                     nb, a, w, n, h, partial, nblk, stream); break;
      case 8: err = launch_reg<T, 8>(xr, xi, tr, ti, taps, fd_pairs, nfd, xe_pairs,
                                     nb, a, w, n, h, partial, nblk, stream); break;
      case 16: err = launch_reg<T, 16>(xr, xi, tr, ti, taps, fd_pairs, nfd, xe_pairs,
                                       nb, a, w, n, h, partial, nblk, stream); break;
      default: return cudaErrorInvalidValue;
    }
  } else if (body == 0) {
    const long long bytes = fx_smem_floats(a, m, w, tile) * (long long)sizeof(float);
    err = fftcore::set_smem(fx_tile_kernel<T>, bytes);
    if (err != cudaSuccess) return err;
    fx_tile_kernel<T><<<nblk, 256, bytes, stream>>>(
        static_cast<const T*>(xr), static_cast<const T*>(xi),
        static_cast<const T*>(tr), static_cast<const T*>(ti), taps, tw,
        fd_pairs, nfd, xe_pairs, nb, a, m, w, n, h, tile, partial);
    err = cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int width = nfd * m + 2 * nb * m;
  if (width > 0) {
    const int ls = lag_runs(body);
    fx_reduce_kernel<<<(width + kReduceCols - 1) / kReduceCols,
                       kReduceCols * kReduceRows, 0, stream>>>(
        partial, nblk, width + nfd * m * (ls - 1), nfd * m, m, ls, width, out);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8; body: 0 = fx_tile_kernel,
// 1 = fx_reg_kernel, 2 = fx_wide_kernel.  partial: ceil((n / m) / tile)
// rows of clen_fx_partial_width floats.  Returns a cudaError_t.
extern "C" int clen_fx_correlate(const void* xr, const void* xi, const void* tr,
                                 const void* ti, int dtype, const void* taps,
                                 const void* tw, const void* fd_pairs, int nfd,
                                 const void* xe_pairs, int nb, int a, int m,
                                 int w, int n, int h, int tile, int body,
                                 void* partial, void* out, void* stream) {
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
                              w, n, h, tile, body, pp, op, st);
    case 1:
      return launch_fx<__nv_bfloat16>(xr, xi, tr, ti, tp, twp, fdp, nfd, xep, nb,
                                      a, m, w, n, h, tile, body, pp, op, st);
    case 2:
      return launch_fx<int8_t>(xr, xi, tr, ti, tp, twp, fdp, nfd, xep, nb, a, m,
                               w, n, h, tile, body, pp, op, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// shared-memory bytes per block of the given body (see launch_fx); w and
// tile do not enter fx_wide_kernel's
extern "C" long long clen_fx_smem_bytes(int a, int m, int w, int tile, int body) {
  if (body == 2) return fx_wide_smem_bytes(a, m);
  const long long floats =
      body == 1 ? fx_reg_smem_floats(a, m, w, tile) : fx_smem_floats(a, m, w, tile);
  return floats * (long long)sizeof(float);
}

// floats a block writes to its partial row: each FD pair's lag sums
// (lag_runs runs of m) and each baseline's 2 m Gram sums
extern "C" int clen_fx_partial_width(int m, int nfd, int nb, int body) {
  return (nfd * lag_runs(body) + 2 * nb) * m;
}
