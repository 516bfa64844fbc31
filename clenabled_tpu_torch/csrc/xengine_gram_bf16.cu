// X-Engine stacked Gram, bfloat16 operands on the tensor cores: per channel,
// over all T integration frames,
//
//   a  = zr zr^T + zi zi^T      lower block-triangle of 128 x 128 blocks
//   b  = zi zr^T                the full kb x kb block grid, or, with emit_gi,
//   gi = b - b^T                its lower block-triangle
//
// for zr/zi [F, T, S*P] bfloat16 with float32 sums, S*P = 128*kb, T % 16 == 0.
// Replaces the bfloat16 path of clenabled_tpu/dsp/pallas_kernels.py:2142
// (_xengine_gram_stacked_call, kernel body _xengine_gram_kernel :1955), which
// puts the same products on the TPU's matrix unit; the int8 path is
// xengine_gram_int8.cu, of the same structure, and xengine_gram.cu's C entry
// clen_xengine_gram launches these kernels for dtype 1.  Output layouts as
// there: a_blk [F, nbt, 128, 128], gi_blk [F, nbt, 128, 128] in tri_blocks
// order, b_blk [F, kb, kb, 128, 128].
//
// Bound on the H100 at the reference configuration (F = 256, T = 8192,
// S*P = 128): 1.07 GB of operands and 67 MB of outputs at 3.35 TB/s is
// 0.33 ms; the 4 products of 128 x 128 x 8192 a channel are 2.75e11 flop,
// of which the function needs 1.37e11 (a's lower triangle and all of b, as
// chip_smoke.py counts them), 0.14-0.28 ms at 989 TFLOP/s.
// So the kernel is bound by bytes once the products run on the tensor cores.
// mma.sync reaches only about half of that rate, so the design reads each
// operand byte from device memory once and skips the products that a
// diagonal block repeats.
//
// Design.  Every warp owns 32 x 32 pieces of an output block and walks T in
// tiles staged in shared memory: per 16 frames it loads its fragments with
// ldmatrix.x4.trans from the frame-major tiles (A = rows x frames, B = frames
// x cols) and runs mma.sync.m16n8k16.row.col with float32 accumulators
// (bf16 products are exact in float32) for up to three of a = zr_I zr_J^T +
// zi_I zi_J^T, ir = zi_I zr_J^T and ri = zr_I zi_J^T: 2 x 4 m16n8 tiles
// each, 96 registers a thread.
//
// - Diagonal blocks (all of them at kb = 1): one thread block of 12 warps per
//   (block, channel) stages zr and zi of the block's 128 columns once, 64
//   frames a tile.  a is symmetric and ri = ir^T there, so only the lower
//   pieces (R >= C) of the 4 x 4 grid of 32 x 32 pieces are computed: 36 of
//   the 64 piece-products of a full block, 3 for each warp, so each of the
//   SM's four schedulers (warp % 4) carries 9.  Warps 0-3 own a diagonal
//   piece (a and ir; gi = ir - ir^T through shared memory), warps 4-9 a
//   lower piece (a and ir), and warps 10 and 11 the ri of three lower pieces
//   each, handed to the owners through shared memory after the T loop.  The
//   owner of (R, C) writes its transposed partner (C, R) too.
// - Off-diagonal blocks (kb > 1): one thread block of 4 warps per (64 x 64
//   quadrant, block, channel), 32 frames a tile, the quadrant fastest, so the
//   four blocks of a channel's block share its columns through L2.  It writes
//   b(i, j) = ir and b(j, i) = ri^T, so the upper blocks cost no second pass.
//
// Every output has one owner and no atomics: the result is deterministic.
// Tiles pass through a 3-stage ring filled by cp.async.cg, 16 bytes a
// thread, with one __syncthreads a tile; frames past T are zero-filled
// (src-size 0).  A tile is frame-major, one row a frame, and its 16-byte
// chunk c of row r sits at c ^ (r % 8): every cp.async store phase and every
// 8-address phase of ldmatrix then hits 32 distinct banks.
//
// Accumulation.  The tensor cores add into float32 with truncation, and a
// diagonal entry of a sums 2T positive products, so the mma accumulators
// restart from zero every 2048 frames after being added, in round-to-nearest
// float32, into a per-thread running sum in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;             // block edge of the JAX layout
constexpr int kQuad = 64;               // quadrant edge (off-diagonal blocks)
constexpr int kFlushFrames = 2048;      // frames between running-sum adds
constexpr int kAcc = 3 * 2 * 4 * 4;     // a, ir, ri x 2 m16 x 4 n8 x 4

// diagonal blocks: 12 warps, a 3-stage ring of zr and zi [64 x 128]; the
// running sums of a and ir (or of two ri pieces) for every thread, and of a
// third ri piece for the two ri warps
constexpr int kDiagThreads = 384;
constexpr int kRiThreads = 64;
constexpr int kDiagFrames = 64;
constexpr int kDiagStages = 3;
constexpr int kDiagTile = kDiagFrames * kLanes * 2;            // 16 KB
constexpr int kDiagRing = kDiagStages * 2 * kDiagTile;
constexpr int kDiagSmem = kDiagRing + (64 * kDiagThreads + 32 * kRiThreads) * 4;
// (R, C) of the pieces of warps 0-9, one hex digit a warp: the diagonal
// pieces on warps 0-3, the lower ones on 4-9 in slot order R (R - 1) / 2 + C
constexpr unsigned long long kRoleR = 0x3332213210ULL;
constexpr unsigned long long kRoleC = 0x2101003210ULL;
constexpr int kXs = 32 * 33;            // one transposed piece, padded

// off-diagonal quadrants: 4 warps, a 3-stage ring of 4 tiles [32 x 64]
constexpr int kQuadThreads = 128;
constexpr int kQuadFrames = 32;
constexpr int kQuadStages = 3;
constexpr int kQuadTile = kQuadFrames * kQuad * 2;             // 4 KB
constexpr int kQuadSmem = kQuadStages * 4 * kQuadTile + kAcc * kQuadThreads * 4;

// byte offset of 16-byte chunk `chunk` of frame `row` in a tile of kChunks
// chunks a row
template <int kChunks>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * kChunks * 16 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy kFrames frames from t0 of kTiles column spans of kCols columns into
// consecutive swizzled tiles at dst: span s reads (s even ? zr : zi) at
// columns (s < 2 ? c_row : c_col).  kThreads threads, 16 bytes a copy.
template <int kCols, int kFrames, int kTiles, int kThreads>
__device__ __forceinline__ void stage(uint32_t dst, const uint16_t* zr,
                                      const uint16_t* zi, int T, int sp,
                                      int t0, int c_row, int c_col) {
  constexpr int kChunks = kCols / 8;
  constexpr int kPerTile = kFrames * kChunks;
#pragma unroll
  for (int e = threadIdx.x; e < kTiles * kPerTile; e += kThreads) {
    const int s = e / kPerTile, rem = e % kPerTile;
    const int row = rem / kChunks, chunk = rem % kChunks;
    const int t = t0 + row;
    const bool in = t < T;
    const uint16_t* chan = (s & 1) ? zi : zr;
    const int c0 = (s >> 1) ? c_col : c_row;
    const uint16_t* src = in ? chan + (long long)t * sp + c0 + 8 * chunk : chan;
    cp_async16(dst + s * kFrames * kCols * 2 + swz<kChunks>(row, chunk), src,
               in ? 16 : 0);
  }
}

// A warp's A fragments (rows x frames, one x4 per m16 tile) of the 32 rows
// from 16-byte chunk a_chunk for frames [16 ks, 16 ks + 16): lane l gives
// row a_row = l % 8 + 8 (l / 16) at chunk + (l / 8) % 2, so the matrices are
// (k 0-7 | 8-15) x (m 0-7 | 8-15) in fragment order a0..a3.
template <int kChunks>
__device__ __forceinline__ void frag_a(uint32_t (&f)[2][4], uint32_t tile,
                                       int ks, int a_row, int a_chunk) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    ldsm_x4_trans(tile + swz<kChunks>(ks * 16 + a_row, a_chunk + 2 * mi), f[mi]);
  }
}

// B fragments (frames x cols, one x4 per pair of n8 tiles) of the 32 cols
// from chunk b_chunk: lane l gives row b_row = l % 8 + 8 ((l / 8) % 2) at
// chunk + l / 16, so the matrices are (k 0-7, n 0-7), (k 8-15, n 0-7),
// (k 0-7, n 8-15), (k 8-15, n 8-15): b0 b1 of two n8 tiles.
template <int kChunks>
__device__ __forceinline__ void frag_b(uint32_t (&f)[2][4], uint32_t tile,
                                       int ks, int b_row, int b_chunk) {
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    ldsm_x4_trans(tile + swz<kChunks>(ks * 16 + b_row, b_chunk + 2 * np), f[np]);
  }
}

// acc += A B over 16 frames for a 32 x 32 piece
__device__ __forceinline__ void mma_piece(float (&acc)[2][4][4],
                                          const uint32_t (&a)[2][4],
                                          const uint32_t (&b)[2][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int np = ni >> 1, h = 2 * (ni & 1);
      mma_bf16(acc[mi][ni], a[mi], b[np][h], b[np][h + 1]);
    }
}

// One staged tile into a piece's a, ir and, with kRi, ri: rows from the
// tiles at s_ri / s_ii (chunk a_chunk), cols from s_rj / s_ij (b_chunk)
template <int kChunks, int kFrames, bool kRi>
__device__ __forceinline__ void warp_tile(float (&acc)[3][2][4][4],
                                          uint32_t s_ri, uint32_t s_ii,
                                          uint32_t s_rj, uint32_t s_ij,
                                          int a_row, int a_chunk, int b_row,
                                          int b_chunk) {
#pragma unroll
  for (int ks = 0; ks < kFrames / 16; ++ks) {
    uint32_t ar[2][4], ai[2][4], br[2][4], bim[2][4];
    frag_a<kChunks>(ar, s_ri, ks, a_row, a_chunk);
    frag_a<kChunks>(ai, s_ii, ks, a_row, a_chunk);
    frag_b<kChunks>(br, s_rj, ks, b_row, b_chunk);
    frag_b<kChunks>(bim, s_ij, ks, b_row, b_chunk);
    mma_piece(acc[0], ar, br);
    mma_piece(acc[0], ai, bim);
    mma_piece(acc[1], ai, br);
    if (kRi) mma_piece(acc[2], ar, bim);
  }
}

// One staged tile into ri = zr_R zi_C^T of three lower pieces of a diagonal
// block: (1, 0), (2, 0), (2, 1), or with kLast (3, 0), (3, 1), (3, 2).
// a_lane / b_lane are the lane's part of the fragment chunk.
template <bool kLast>
__device__ __forceinline__ void ri_tile(float (&acc)[3][2][4][4], uint32_t s_r,
                                        uint32_t s_i, int a_row, int a_lane,
                                        int b_row, int b_lane) {
  constexpr int kC = kLanes / 8;
#pragma unroll
  for (int ks = 0; ks < kDiagFrames / 16; ++ks) {
    // rows 1 (or 3) and cols 0, 1; then rows 2, or with kLast cols 2
    uint32_t a0[2][4], b0[2][4], b1[2][4], x[2][4];
    frag_a<kC>(a0, s_r, ks, a_row, (kLast ? 3 : 1) * 4 + a_lane);
    frag_b<kC>(b0, s_i, ks, b_row, b_lane);
    frag_b<kC>(b1, s_i, ks, b_row, 4 + b_lane);
    if (kLast) {
      frag_b<kC>(x, s_i, ks, b_row, 8 + b_lane);
      mma_piece(acc[0], a0, b0);
      mma_piece(acc[1], a0, b1);
      mma_piece(acc[2], a0, x);
    } else {
      frag_a<kC>(x, s_r, ks, a_row, 8 + a_lane);
      mma_piece(acc[0], a0, b0);
      mma_piece(acc[1], x, b0);
      mma_piece(acc[2], x, b1);
    }
  }
}

// acc into running sums sums[j * stride], j = (mi * 4 + ni) * 4 + e; acc = 0
__device__ __forceinline__ void flush(float (&acc)[2][4][4], float* sums,
                                      int stride) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sums[((mi * 4 + ni) * 4 + e) * stride] += acc[mi][ni][e];
        acc[mi][ni][e] = 0.f;
      }
}

__device__ __forceinline__ float summed(const float* sums, int stride, int mi,
                                        int ni, int e) {
  return sums[((mi * 4 + ni) * 4 + e) * stride];
}

__device__ __forceinline__ void zero(float (&acc)[3][2][4][4]) {
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[x][mi][ni][e] = 0.f;
}

__device__ __forceinline__ void zero_sums(float* sums, int n, int stride) {
#pragma unroll 8
  for (int v = 0; v < n; ++v) sums[v * stride] = 0.f;
}

template <bool kEmitGi>
__global__ void __launch_bounds__(kDiagThreads, 1)
gram_bf16_diag_kernel(const uint16_t* __restrict__ zr,
                      const uint16_t* __restrict__ zi, int T, int sp, int kb,
                      float* __restrict__ a_out, float* __restrict__ b_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool ri_warp = warp >= 10;
  // a / ir (ri pieces 0 / 1 in an ri warp), and an ri warp's piece 2
  float* lo = reinterpret_cast<float*>(smem + kDiagRing) + tid;
  float* hi = reinterpret_cast<float*>(smem + kDiagRing) + 64 * kDiagThreads +
              (ri_warp ? tid - (kDiagThreads - kRiThreads) : 0);

  const int bi = blockIdx.x;              // diagonal block (bi, bi)
  const int c0 = bi * kLanes;
  const long long chan = (long long)blockIdx.y * T * sp;
  const uint16_t* zr_f = zr + chan;
  const uint16_t* zi_f = zi + chan;
  const int R = ri_warp ? 0 : (int)((kRoleR >> (4 * warp)) & 15);
  const int C = ri_warp ? 0 : (int)((kRoleC >> (4 * warp)) & 15);
  const int lr = lane & 7, lq = lane >> 3;
  const int a_row = lr + 8 * (lq >> 1), a_lane = lq & 1;
  const int b_row = lr + 8 * (lq & 1), b_lane = lq >> 1;

  float acc[3][2][4][4];
  zero(acc);
  zero_sums(lo, 64, kDiagThreads);
  if (ri_warp) zero_sums(hi, 32, kRiThreads);
  auto load = [&](int slot, int t0) {
    stage<kLanes, kDiagFrames, 2, kDiagThreads>(ring + slot * 2 * kDiagTile,
                                                zr_f, zi_f, T, sp, t0, c0, c0);
    cp_async_commit();
  };
  const int nk = (T + kDiagFrames - 1) / kDiagFrames;
#pragma unroll
  for (int s = 0; s < kDiagStages - 1; ++s) {
    if (s < nk) load(s, s * kDiagFrames);
    else cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kDiagStages - 2>();
    __syncthreads();     // tile kt is in; every warp is done with tile kt - 1
    const int next = kt + kDiagStages - 1;
    if (next < nk) load(next % kDiagStages, next * kDiagFrames);
    else cp_async_commit();
    const uint32_t s_r = ring + (kt % kDiagStages) * 2 * kDiagTile;
    const uint32_t s_i = s_r + kDiagTile;
    if (!ri_warp) {
      warp_tile<kLanes / 8, kDiagFrames, false>(acc, s_r, s_i, s_r, s_i, a_row,
                                                R * 4 + a_lane, b_row,
                                                C * 4 + b_lane);
    } else if (warp == 10) {
      ri_tile<false>(acc, s_r, s_i, a_row, a_lane, b_row, b_lane);
    } else {
      ri_tile<true>(acc, s_r, s_i, a_row, a_lane, b_row, b_lane);
    }
    if ((kt + 1) % (kFlushFrames / kDiagFrames) == 0 || kt + 1 == nk) {
      flush(acc[0], lo, kDiagThreads);
      flush(acc[1], lo + 32 * kDiagThreads, kDiagThreads);
      if (ri_warp) flush(acc[2], hi, kRiThreads);
    }
  }
  __syncthreads();       // the ring is free for the piece exchange

  // xs[slot]: ri of lower slots 0-5, then (emit_gi) ir of diagonal pieces
  float* xs = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, tq = lane & 3;
  if (ri_warp || (kEmitGi && R == C)) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (!ri_warp && p > 0) break;
      const int slot = ri_warp ? 3 * (warp - 10) + p : 6 + R;
      const float* src = ri_warp ? (p < 2 ? lo + p * 32 * kDiagThreads : hi)
                                 : lo + 32 * kDiagThreads;
      const int stride = ri_warp && p == 2 ? kRiThreads : kDiagThreads;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pr = mi * 16 + g + 8 * (e >> 1), pc = ni * 8 + 2 * tq + (e & 1);
            xs[slot * kXs + pr * 33 + pc] = summed(src, stride, mi, ni, e);
          }
    }
  }
  __syncthreads();
  if (ri_warp) return;

  const long long blk = (long long)kLanes * kLanes;
  const long long nbt = (long long)kb * (kb + 1) / 2;
  const long long f = blockIdx.y;
  const int n = bi * (bi + 1) / 2 + bi;   // (bi, bi) in tri_blocks order
  float* a_dst = a_out + (f * nbt + n) * blk;
  float* b_dst = kEmitGi ? b_out + (f * nbt + n) * blk
                         : b_out + ((f * kb + bi) * kb + bi) * blk;
  const float* xs_ri = xs + (warp - 4) * kXs;   // lower pieces
  const float* xs_ir = xs + (6 + R) * kXs;      // diagonal pieces
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int pr = mi * 16 + g + 8 * hr, pc = ni * 8 + 2 * tq;
        const int r = R * 32 + pr, c = C * 32 + pc;
        const float a0 = summed(lo, kDiagThreads, mi, ni, 2 * hr);
        const float a1 = summed(lo, kDiagThreads, mi, ni, 2 * hr + 1);
        const float ir0 = summed(lo + 32 * kDiagThreads, kDiagThreads, mi, ni, 2 * hr);
        const float ir1 = summed(lo + 32 * kDiagThreads, kDiagThreads, mi, ni,
                                 2 * hr + 1);
        *reinterpret_cast<float2*>(a_dst + r * kLanes + c) = make_float2(a0, a1);
        if (R == C) {
          *reinterpret_cast<float2*>(b_dst + r * kLanes + c) =
              kEmitGi ? make_float2(ir0 - xs_ir[pc * 33 + pr],
                                    ir1 - xs_ir[(pc + 1) * 33 + pr])
                      : make_float2(ir0, ir1);
          continue;
        }
        const float ri0 = xs_ri[pr * 33 + pc], ri1 = xs_ri[pr * 33 + pc + 1];
        a_dst[c * kLanes + r] = a0;
        a_dst[(c + 1) * kLanes + r] = a1;
        if (kEmitGi) {
          const float g0 = ir0 - ri0, g1 = ir1 - ri1;
          *reinterpret_cast<float2*>(b_dst + r * kLanes + c) = make_float2(g0, g1);
          b_dst[c * kLanes + r] = -g0;
          b_dst[(c + 1) * kLanes + r] = -g1;
        } else {
          *reinterpret_cast<float2*>(b_dst + r * kLanes + c) = make_float2(ir0, ir1);
          b_dst[c * kLanes + r] = ri0;
          b_dst[(c + 1) * kLanes + r] = ri1;
        }
      }
}

template <bool kEmitGi>
__global__ void __launch_bounds__(kQuadThreads)
gram_bf16_quad_kernel(const uint16_t* __restrict__ zr,
                      const uint16_t* __restrict__ zi, int T, int sp, int kb,
                      float* __restrict__ a_out, float* __restrict__ b_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* sums = reinterpret_cast<float*>(smem + kQuadStages * 4 * kQuadTile) + tid;

  const int m = blockIdx.y;               // strictly lower block (bi > bj)
  int bi = 1;
  while ((bi + 1) * bi / 2 <= m) ++bi;
  const int bj = m - bi * (bi - 1) / 2;
  const int n = bi * (bi + 1) / 2 + bj;   // tri_blocks order
  const int qr = blockIdx.x >> 1, qc = blockIdx.x & 1;
  const int row0 = bi * kLanes + qr * kQuad;
  const int col0 = bj * kLanes + qc * kQuad;
  const long long chan = (long long)blockIdx.z * T * sp;
  const uint16_t* zr_f = zr + chan;
  const uint16_t* zi_f = zi + chan;
  const int wm = warp >> 1, wn = warp & 1;
  const int lr = lane & 7, lq = lane >> 3;
  const int a_row = lr + 8 * (lq >> 1), a_chunk = wm * 4 + (lq & 1);
  const int b_row = lr + 8 * (lq & 1), b_chunk = wn * 4 + (lq >> 1);

  float acc[3][2][4][4];
  zero(acc);
  zero_sums(sums, kAcc, kQuadThreads);
  auto load = [&](int slot, int t0) {
    stage<kQuad, kQuadFrames, 4, kQuadThreads>(ring + slot * 4 * kQuadTile,
                                               zr_f, zi_f, T, sp, t0, row0,
                                               col0);
    cp_async_commit();
  };
  const int nk = (T + kQuadFrames - 1) / kQuadFrames;
#pragma unroll
  for (int s = 0; s < kQuadStages - 1; ++s) {
    if (s < nk) load(s, s * kQuadFrames);
    else cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kQuadStages - 2>();
    __syncthreads();
    const int next = kt + kQuadStages - 1;
    if (next < nk) load(next % kQuadStages, next * kQuadFrames);
    else cp_async_commit();
    const uint32_t s = ring + (kt % kQuadStages) * 4 * kQuadTile;
    warp_tile<kQuad / 8, kQuadFrames, true>(acc, s, s + kQuadTile,
                                            s + 2 * kQuadTile, s + 3 * kQuadTile,
                                            a_row, a_chunk, b_row, b_chunk);
    if ((kt + 1) % (kFlushFrames / kQuadFrames) == 0 || kt + 1 == nk) {
#pragma unroll
      for (int x = 0; x < 3; ++x) flush(acc[x], sums + x * 32 * kQuadThreads, kQuadThreads);
    }
  }

  const long long blk = (long long)kLanes * kLanes;
  const long long nbt = (long long)kb * (kb + 1) / 2;
  const long long f = blockIdx.z;
  float* a_dst = a_out + (f * nbt + n) * blk;
  float* b_ij = kEmitGi ? b_out + (f * nbt + n) * blk
                        : b_out + ((f * kb + bi) * kb + bj) * blk;
  float* b_ji = b_out + ((f * kb + bj) * kb + bi) * blk;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = qr * kQuad + wm * 32 + mi * 16 + g + 8 * hr;
        const int c = qc * kQuad + wn * 32 + ni * 8 + 2 * tq;
        float v[3][2];
#pragma unroll
        for (int x = 0; x < 3; ++x)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[x][e] = summed(sums + x * 32 * kQuadThreads, kQuadThreads, mi, ni,
                             2 * hr + e);
          }
        *reinterpret_cast<float2*>(a_dst + r * kLanes + c) =
            make_float2(v[0][0], v[0][1]);
        if (kEmitGi) {
          *reinterpret_cast<float2*>(b_ij + r * kLanes + c) =
              make_float2(v[1][0] - v[2][0], v[1][1] - v[2][1]);
        } else {
          *reinterpret_cast<float2*>(b_ij + r * kLanes + c) =
              make_float2(v[1][0], v[1][1]);
          b_ji[c * kLanes + r] = v[2][0];
          b_ji[(c + 1) * kLanes + r] = v[2][1];
        }
      }
}

template <class K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <bool kEmitGi>
cudaError_t launch(const uint16_t* zr, const uint16_t* zi, int F, int T,
                   int sp, float* a_out, float* b_out, cudaStream_t stream) {
  const int kb = sp / kLanes;
  cudaError_t err = set_smem(gram_bf16_diag_kernel<kEmitGi>, kDiagSmem);
  if (err != cudaSuccess) return err;
  gram_bf16_diag_kernel<kEmitGi><<<dim3(kb, F), kDiagThreads, kDiagSmem, stream>>>(
      zr, zi, T, sp, kb, a_out, b_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || kb == 1) return err;
  err = set_smem(gram_bf16_quad_kernel<kEmitGi>, kQuadSmem);
  if (err != cudaSuccess) return err;
  gram_bf16_quad_kernel<kEmitGi>
      <<<dim3(4, kb * (kb - 1) / 2, F), kQuadThreads, kQuadSmem, stream>>>(
          zr, zi, T, sp, kb, a_out, b_out);
  return cudaGetLastError();
}

}  // namespace

// The bfloat16 launch behind clen_xengine_gram (dtype 1), which checks the
// sizes; needs T % 16 == 0 and 16-byte aligned operands.
int clen_gram_bf16_launch(const void* zr, const void* zi, int F, int T,
                          int sp, int emit_gi, void* a_out, void* b_out,
                          cudaStream_t stream) {
  if (T % 16) return cudaErrorInvalidValue;
  const uint16_t* r = static_cast<const uint16_t*>(zr);
  const uint16_t* i = static_cast<const uint16_t*>(zi);
  float* a = static_cast<float*>(a_out);
  float* b = static_cast<float*>(b_out);
  return emit_gi ? launch<true>(r, i, F, T, sp, a, b, stream)
                 : launch<false>(r, i, F, T, sp, a, b, stream);
}

// the larger of the two kernels' dynamic shared memory
extern "C" long long clen_gram_bf16_smem_bytes() {
  return kDiagSmem > kQuadSmem ? kDiagSmem : kQuadSmem;
}
