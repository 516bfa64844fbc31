// X-Engine stacked Gram, int8 operands on the tensor cores: per channel,
// over all T integration frames,
//
//   a  = zr zr^T + zi zi^T      lower block-triangle of 128 x 128 blocks
//   b  = zi zr^T                the full kb x kb block grid, or, with emit_gi,
//   gi = b - b^T                its lower block-triangle
//
// for zr/zi [F, T, S*P] int8 with int32 sums, S*P = 128*kb, any T >= 1.
// Replaces the int8 path of clenabled_tpu/dsp/pallas_kernels.py:2142
// (_xengine_gram_stacked_call, kernel body _xengine_gram_kernel :1955), which
// puts the same products on the TPU's matrix unit; xengine_gram.cu's C entry
// clen_xengine_gram launches these kernels for dtype 0.  Output layouts as
// there: a_blk [F, nbt, 128, 128], gi_blk [F, nbt, 128, 128] in tri_blocks
// order, b_blk [F, kb, kb, 128, 128].
//
// Bound on the H100 at the reference configuration (F = 256, T = 8192,
// S*P = 128): 512 MiB of operands and 32 MiB of outputs at 3.35 TB/s is
// 0.17 ms; the products the function needs (a's lower triangle and gi's,
// which takes all of b: 1.37e11 operations as chip_smoke.py counts them)
// take 0.069 ms at 1,979 TOP/s.  So bytes bound the function.  mma.sync does not
// reach that rate: on an H100 at 700 W this kernel's products alone (the
// GRAM_I8_MMA_ONLY probe of tools/gram_ab.py) take 0.20 ms, about 37% of it,
// as long as its staging alone (0.20 ms).  So the design reads each operand
// byte from device memory once and skips the products that a diagonal block
// repeats.
//
// Fragments.  sm_90 has no transposing ldmatrix for 8-bit types, and the
// tiles are frame-major (one row a frame, as the operands lie).  So each warp
// reads a 16-column chunk over 32 frames with one ldmatrix.x4.trans.b16,
// which takes a pair of adjacent columns for one b16 element: register q of
// lane (g, t) = (l / 4, l % 4) holds columns (2g, 2g+1) x frames (8q + 2t,
// 8q + 2t + 1), column fastest.  Two prmts a pair of registers (selectors
// 0x6420 and 0x7531) regroup the bytes by column, and the four results are at
// once the A fragment of mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (fragment
// row g is column 2g of the chunk, row g + 8 is column 2g + 1) and the B
// fragments of the chunk's even and of its odd columns.  K slot 4t + j of
// each 16-frame half is frame 2t + j (j < 2) or 2t + 6 + j: the same
// permutation on both sides, so every product sums the same 32 frames.  The
// accumulators of a 16 x 16 chunk product put rows 2g, 2g+1 and columns 4t to
// 4t + 3 in one lane, which the epilogue writes as 16-byte stores.  (The
// alternative, a byte transpose while staging into K-major tiles, needs the
// bytes in registers and gives up the cp.async ring.)
//
// - Diagonal blocks (all of them at kb = 1): one thread block of 12 warps per
//   (block, channel) stages zr and zi of the block's 128 columns once.  a is
//   symmetric and ri = ir^T there, so only the lower pieces (R >= C) of the
//   4 x 4 grid of 32 x 32 pieces are computed, 3 piece-products a warp, so
//   each of the SM's four schedulers (warp % 4) carries about 9.  Warps 0-3
//   own a diagonal piece (ir, and a of its lower chunk pairs only; its
//   fragments serve both sides; gi = ir - ir^T through shared memory),
//   warps 4-9 a lower piece (a and ir), and warps 10 and 11 the ri of three
//   lower pieces each, handed to the owners through shared memory after the
//   T loop.  The owner of (R, C) writes its transposed partner (C, R) too.
// - Off-diagonal blocks (kb > 1): one thread block of 4 warps per (64 x 64
//   quadrant, block, channel), the quadrant fastest, so the four blocks of a
//   channel's block share its columns through L2.  It writes b(i, j) = ir and
//   b(j, i) = ri^T, so the upper blocks cost no second pass.
//
// Every output has one owner and no atomics: the result is deterministic.
// Tiles pass through a ring filled by cp.async.cg, 16 bytes a thread, with
// one __syncthreads a tile: 3 stages of 256 frames for the diagonal kernel
// (one block an SM by registers), 3 of 64 for the quadrant kernel (3 blocks
// an SM); frames past T are zero-filled (src-size 0).  Chunk c of frame r
// sits at c ^ (r % 8) in a 128-column tile and at c ^ ((r / 2) % 4) in a
// 64-column one: every cp.async store phase and every 8-address phase of
// ldmatrix then hits 32 distinct banks.
//
// Exactness.  The int32 sums are exact while no sum leaves int32: |x| <= 128,
// so an entry of a is at most 2 T 2^14 in magnitude and one of b at most
// T 2^14, exact for T < 65536.  Beyond, the mma wraps (no .satfinite), as the
// dp4a kernel it replaces did.  Integer sums modulo 2^32 do not depend on
// order, so the kernel is bit for bit the plain form.
//
// Timing probes (wrong outputs): GRAM_I8_STAGE_ONLY stages every tile and
// computes nothing, so its time is the ring's alone; GRAM_I8_COMPUTE_ONLY
// (diagonal kernel) copies nothing and computes on whatever shared memory
// holds, so its time is the arithmetic's and the barriers'; with it,
// GRAM_I8_MMA_ONLY also takes fragments from the addresses in place of
// shared memory, leaving the mma and the barriers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;             // block edge of the JAX layout
constexpr int kQuad = 64;               // quadrant edge (off-diagonal blocks)
// diagonal blocks: 12 warps, a ring of zr and zi [kDiagFrames x 128] bytes,
// reused after the T loop for the exchange of ten int32 32 x 32 pieces
constexpr int kDiagThreads = 384;
constexpr int kDiagFrames = 256;
constexpr int kDiagStages = 3;
constexpr int kDiagTile = kDiagFrames * kLanes;
constexpr int kXs = 32 * 33;            // one transposed piece, padded
constexpr int kDiagRing = kDiagStages * 2 * kDiagTile;
constexpr int kDiagXs = 10 * kXs * 4;
constexpr int kDiagSmem = kDiagRing > kDiagXs ? kDiagRing : kDiagXs;
// (R, C) of the pieces of warps 0-9, one hex digit a warp: the diagonal
// pieces on warps 0-3, the lower ones on 4-9 in slot order R (R - 1) / 2 + C
constexpr unsigned long long kRoleR = 0x3332213210ULL;
constexpr unsigned long long kRoleC = 0x2101003210ULL;

// off-diagonal quadrants: 4 warps, a ring of 4 tiles [kQuadFrames x 64]
// bytes, small enough for 3 blocks an SM
constexpr int kQuadThreads = 128;
constexpr int kQuadFrames = 64;
constexpr int kQuadStages = 3;
constexpr int kQuadTile = kQuadFrames * kQuad;
constexpr int kQuadSmem = kQuadStages * 4 * kQuadTile;
static_assert(kDiagFrames % 32 == 0 && kQuadFrames % 32 == 0,
              "a tile is whole 32-frame mma steps");
static_assert(kDiagStages >= 2 && kQuadStages >= 2, "a ring has two stages");

// byte offset of 16-byte chunk `chunk` of frame `row` in a tile of kChunks
// (8 or 4) chunks a row: the chunk's key runs through kChunks values over 8
// rows, so 8 consecutive rows of one chunk cover all 32 banks
template <int kChunks>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * kChunks * 16 +
                    ((chunk ^ ((row / (8 / kChunks)) % kChunks)) << 4));
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

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy kFrames frames from t0 of kTiles column spans of kCols columns into
// consecutive swizzled tiles at dst: span s reads (s even ? zr : zi) at
// columns (s < 2 ? c_row : c_col).  kThreads threads, 16 bytes a copy.
template <int kCols, int kFrames, int kTiles, int kThreads>
__device__ __forceinline__ void stage(uint32_t dst, const int8_t* zr,
                                      const int8_t* zi, int T, int sp, int t0,
                                      int c_row, int c_col) {
  constexpr int kChunks = kCols / 16;
  constexpr int kPerTile = kFrames * kChunks;
#pragma unroll
  for (int e = threadIdx.x; e < kTiles * kPerTile; e += kThreads) {
    const int s = e / kPerTile, rem = e % kPerTile;
    const int row = rem / kChunks, chunk = rem % kChunks;
    const int t = t0 + row;
    const bool in = t < T;
    const int8_t* chan = (s & 1) ? zi : zr;
    const int c0 = (s >> 1) ? c_col : c_row;
    const int8_t* src = in ? chan + (long long)t * sp + c0 + 16 * chunk : chan;
    cp_async16(dst + s * kFrames * kCols + swz<kChunks>(row, chunk), src,
               in ? 16 : 0);
  }
}

// The fragments of one 16-column chunk over 32 frames (the head note): the
// lane gives the address of its frame's chunk; f is the A fragment, {f[0],
// f[2]} and {f[1], f[3]} the B fragments of the even and odd columns
__device__ __forceinline__ void frag(uint32_t (&f)[4], uint32_t addr) {
#ifdef GRAM_I8_MMA_ONLY
  f[0] = addr, f[1] = addr + 1, f[2] = addr + 2, f[3] = addr + 3;
  return;
#endif
  uint32_t r[4];
  ldsm_x4_trans(addr, r);
  f[0] = __byte_perm(r[0], r[1], 0x6420);
  f[1] = __byte_perm(r[0], r[1], 0x7531);
  f[2] = __byte_perm(r[2], r[3], 0x6420);
  f[3] = __byte_perm(r[2], r[3], 0x7531);
}

// the fragments of the two chunks of a 32-column piece; off[h] is the lane's
// offset of chunk h of the piece in a tile (step included)
__device__ __forceinline__ void frag_piece(uint32_t (&f)[2][4], uint32_t tile,
                                           const uint32_t (&off)[2]) {
  frag(f[0], tile + off[0]);
  frag(f[1], tile + off[1]);
}

// acc += A B^T over 32 frames for a 32 x 32 piece, rows from the chunk
// fragments a, columns from b: acc[mi][2 yj + p] is the m16n8 tile of row
// chunk mi and of the columns of parity p in column chunk yj, so element e
// of lane (g, t) is piece entry (16 mi + 2g + e / 2, 16 yj + 4t + 2 (e % 2)
// + p)
__device__ __forceinline__ void mma_piece(int (&acc)[2][4][4],
                                          const uint32_t (&a)[2][4],
                                          const uint32_t (&b)[2][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int yj = 0; yj < 2; ++yj)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        mma_s8(acc[mi][2 * yj + p], a[mi], b[yj][p], b[yj][p + 2]);
      }
}

// piece entry (16 mi + 2g + hr, 16 yj + 4t + j) of lane (g, t)
__device__ __forceinline__ int at(const int (&acc)[2][4][4], int mi, int yj,
                                  int hr, int j) {
  return acc[mi][2 * yj + (j & 1)][2 * hr + (j >> 1)];
}

// acc += A A^T over 32 frames for a diagonal piece's a, its lower chunk
// pairs (0, 0), (1, 0) and (1, 1) only: a is symmetric, and the owner writes
// pair (1, 0) transposed in place of (0, 1)
__device__ __forceinline__ void mma_piece_lower(int (&acc)[2][4][4],
                                                const uint32_t (&a)[2][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int yj = 0; yj <= mi; ++yj)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        mma_s8(acc[mi][2 * yj + p], a[mi], a[yj][p], a[yj][p + 2]);
      }
}

// One staged tile of kFrames frames into a 32 x 32 piece's a and ir and,
// with kRi, ri: rows from the tiles at s_ri / s_ii (lane offsets ro), cols
// from s_rj / s_ij (co).  kSame: the rows are the columns (a diagonal
// piece), and the row fragments serve both sides.
template <int kChunks, int kFrames, bool kSame, bool kRi>
__device__ __forceinline__ void piece_tile(int (&acc)[3][2][4][4],
                                           uint32_t s_ri, uint32_t s_ii,
                                           uint32_t s_rj, uint32_t s_ij,
                                           const uint32_t (&ro)[2],
                                           const uint32_t (&co)[2]) {
#pragma unroll 1       // two steps at once spill at 168 registers
  for (int ks = 0; ks < kFrames / 32; ++ks) {
    const uint32_t step = ks * 32 * kChunks * 16;
    uint32_t ar[2][4], ai[2][4];
    frag_piece(ar, s_ri + step, ro);
    frag_piece(ai, s_ii + step, ro);
    if (kSame) {
      mma_piece_lower(acc[0], ar);
      mma_piece_lower(acc[0], ai);
      mma_piece(acc[1], ai, ar);
    } else {
      uint32_t br[2][4], bim[2][4];
      frag_piece(br, s_rj + step, co);
      frag_piece(bim, s_ij + step, co);
      mma_piece(acc[0], ar, br);
      mma_piece(acc[0], ai, bim);
      mma_piece(acc[1], ai, br);
      if (kRi) mma_piece(acc[2], ar, bim);
    }
  }
}

// One staged tile into ri = zr_R zi_C^T of three lower pieces of a diagonal
// block: (1, 0), (2, 0), (2, 1), or with kLast (3, 0), (3, 1), (3, 2).
template <bool kLast>
__device__ __forceinline__ void ri_tile(int (&acc)[3][2][4][4], uint32_t s_r,
                                        uint32_t s_i, int lane) {
#pragma unroll 1
  for (int ks = 0; ks < kDiagFrames / 32; ++ks) {
    // oP: the lane's offsets of piece P's two chunks.  Rows 1 (or 3) and
    // cols 0, 1; then rows 2, or with kLast cols 2
    const uint32_t step = ks * 32 * kLanes;
    const uint32_t o0[2] = {step + swz<8>(lane, 0), step + swz<8>(lane, 1)};
    const uint32_t o1[2] = {step + swz<8>(lane, 2), step + swz<8>(lane, 3)};
    const uint32_t o2[2] = {step + swz<8>(lane, 4), step + swz<8>(lane, 5)};
    const uint32_t o3[2] = {step + swz<8>(lane, 6), step + swz<8>(lane, 7)};
    // each fragment loaded just before its first product, so at most
    // three pieces' fragments are live
    uint32_t a0[2][4], b0[2][4], b1[2][4], x[2][4];
    frag_piece(b0, s_i, o0);
    if (kLast) {
      frag_piece(a0, s_r, o3);
      mma_piece(acc[0], a0, b0);
      frag_piece(b1, s_i, o1);
      mma_piece(acc[1], a0, b1);
      frag_piece(x, s_i, o2);
      mma_piece(acc[2], a0, x);
    } else {
      frag_piece(a0, s_r, o1);
      mma_piece(acc[0], a0, b0);
      frag_piece(x, s_r, o2);
      mma_piece(acc[1], x, b0);
      frag_piece(b1, s_i, o1);
      mma_piece(acc[2], x, b1);
    }
  }
}

__device__ __forceinline__ void zero(int (&acc)[3][2][4][4]) {
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[x][mi][ni][e] = 0;
}

// a lane's part of a piece into a padded [32][33] exchange slot
__device__ __forceinline__ void put_piece(int* xs, const int (&acc)[2][4][4],
                                          int g, int tq) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int yj = 0; yj < 2; ++yj)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pr = 16 * mi + 2 * g + hr, pc = 16 * yj + 4 * tq + j;
          xs[pr * 33 + pc] = at(acc, mi, yj, hr, j);
        }
}

__device__ __forceinline__ void store4(int* dst, const int (&v)[4]) {
  *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
}

template <bool kEmitGi>
__global__ void __launch_bounds__(kDiagThreads, 1)
gram_int8_diag_kernel(const int8_t* __restrict__ zr,
                      const int8_t* __restrict__ zi, int T, int sp, int kb,
                      int* __restrict__ a_out, int* __restrict__ b_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool ri_warp = warp >= 10;

  const int bi = blockIdx.x;              // diagonal block (bi, bi)
  const int c0 = bi * kLanes;
  const long long chan = (long long)blockIdx.y * T * sp;
  const int8_t* zr_f = zr + chan;
  const int8_t* zi_f = zi + chan;
  const int R = ri_warp ? 0 : (int)((kRoleR >> (4 * warp)) & 15);
  const int C = ri_warp ? 0 : (int)((kRoleC >> (4 * warp)) & 15);
  const uint32_t ro[2] = {swz<8>(lane, 2 * R), swz<8>(lane, 2 * R + 1)};
  const uint32_t co[2] = {swz<8>(lane, 2 * C), swz<8>(lane, 2 * C + 1)};

  int acc[3][2][4][4];
  zero(acc);
  auto load = [&](int slot, int t0) {
#ifndef GRAM_I8_COMPUTE_ONLY
    stage<kLanes, kDiagFrames, 2, kDiagThreads>(ring + slot * 2 * kDiagTile,
                                                zr_f, zi_f, T, sp, t0, c0, c0);
#endif
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
#ifndef GRAM_I8_STAGE_ONLY
    const uint32_t s_r = ring + (kt % kDiagStages) * 2 * kDiagTile;
    const uint32_t s_i = s_r + kDiagTile;
    if (warp < 4) {
      piece_tile<8, kDiagFrames, true, false>(acc, s_r, s_i, s_r, s_i, ro, co);
    } else if (!ri_warp) {
      piece_tile<8, kDiagFrames, false, false>(acc, s_r, s_i, s_r, s_i, ro, co);
    } else if (warp == 10) {
      ri_tile<false>(acc, s_r, s_i, lane);
    } else {
      ri_tile<true>(acc, s_r, s_i, lane);
    }
#endif
  }
  __syncthreads();       // every real copy is in; the ring is free

  // xs[slot]: ri of lower slots 0-5, then (emit_gi) ir of diagonal pieces
  int* xs = reinterpret_cast<int*>(smem);
  const int g = lane >> 2, tq = lane & 3;
  if (ri_warp) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      put_piece(xs + (3 * (warp - 10) + p) * kXs, acc[p], g, tq);
    }
  } else if (kEmitGi && warp < 4) {
    put_piece(xs + (6 + R) * kXs, acc[1], g, tq);
  }
  __syncthreads();
  if (ri_warp) return;

  const long long blk = (long long)kLanes * kLanes;
  const long long nbt = (long long)kb * (kb + 1) / 2;
  const long long f = blockIdx.y;
  const int n = bi * (bi + 1) / 2 + bi;   // (bi, bi) in tri_blocks order
  int* a_dst = a_out + (f * nbt + n) * blk;
  int* b_dst = kEmitGi ? b_out + (f * nbt + n) * blk
                       : b_out + ((f * kb + bi) * kb + bi) * blk;
  const int* xs_ri = xs + (warp - 4) * kXs;   // lower pieces
  const int* xs_ir = xs + (6 + R) * kXs;      // diagonal pieces
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int yj = 0; yj < 2; ++yj)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int pr = 16 * mi + 2 * g + hr, pc = 16 * yj + 4 * tq;
        const int r = R * 32 + pr, c = C * 32 + pc;
        int va[4], vb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          va[j] = at(acc[0], mi, yj, hr, j);
          vb[j] = at(acc[1], mi, yj, hr, j);
        }
        if (warp < 4) {                       // R == C
          if (mi == 1 && yj == 0) {           // and (0, 1), its mirror
#pragma unroll
            for (int j = 0; j < 4; ++j) a_dst[(c + j) * kLanes + r] = va[j];
          }
          if (mi >= yj) store4(a_dst + r * kLanes + c, va);
          if (kEmitGi) {
#pragma unroll
            for (int j = 0; j < 4; ++j) vb[j] -= xs_ir[(pc + j) * 33 + pr];
          }
          store4(b_dst + r * kLanes + c, vb);
          continue;
        }
        store4(a_dst + r * kLanes + c, va);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ri = xs_ri[pr * 33 + pc + j];
          a_dst[(c + j) * kLanes + r] = va[j];
          if (kEmitGi) {
            vb[j] -= ri;
            b_dst[(c + j) * kLanes + r] = -vb[j];
          } else {
            b_dst[(c + j) * kLanes + r] = ri;
          }
        }
        store4(b_dst + r * kLanes + c, vb);
      }
}

template <bool kEmitGi>
__global__ void __launch_bounds__(kQuadThreads)
gram_int8_quad_kernel(const int8_t* __restrict__ zr,
                      const int8_t* __restrict__ zi, int T, int sp, int kb,
                      int* __restrict__ a_out, int* __restrict__ b_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int m = blockIdx.y;               // strictly lower block (bi > bj)
  int bi = 1;
  while ((bi + 1) * bi / 2 <= m) ++bi;
  const int bj = m - bi * (bi - 1) / 2;
  const int n = bi * (bi + 1) / 2 + bj;   // tri_blocks order
  const int qr = blockIdx.x >> 1, qc = blockIdx.x & 1;
  const int row0 = bi * kLanes + qr * kQuad;
  const int col0 = bj * kLanes + qc * kQuad;
  const long long chan = (long long)blockIdx.z * T * sp;
  const int8_t* zr_f = zr + chan;
  const int8_t* zi_f = zi + chan;
  const int wm = warp >> 1, wn = warp & 1;
  const uint32_t ro[2] = {swz<4>(lane, 2 * wm), swz<4>(lane, 2 * wm + 1)};
  const uint32_t co[2] = {swz<4>(lane, 2 * wn), swz<4>(lane, 2 * wn + 1)};

  int acc[3][2][4][4];
  zero(acc);
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
#ifndef GRAM_I8_STAGE_ONLY
    const uint32_t s = ring + (kt % kQuadStages) * 4 * kQuadTile;
    piece_tile<kQuad / 16, kQuadFrames, false, true>(
        acc, s, s + kQuadTile, s + 2 * kQuadTile, s + 3 * kQuadTile, ro, co);
#endif
  }

  const long long blk = (long long)kLanes * kLanes;
  const long long nbt = (long long)kb * (kb + 1) / 2;
  const long long f = blockIdx.z;
  int* a_dst = a_out + (f * nbt + n) * blk;
  int* b_ij = kEmitGi ? b_out + (f * nbt + n) * blk
                      : b_out + ((f * kb + bi) * kb + bj) * blk;
  int* b_ji = b_out + ((f * kb + bj) * kb + bi) * blk;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int yj = 0; yj < 2; ++yj)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = qr * kQuad + wm * 32 + 16 * mi + 2 * g + hr;
        const int c = qc * kQuad + wn * 32 + 16 * yj + 4 * tq;
        int va[4], vb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          va[j] = at(acc[0], mi, yj, hr, j);
          vb[j] = at(acc[1], mi, yj, hr, j);
          const int ri = at(acc[2], mi, yj, hr, j);
          if (kEmitGi) vb[j] -= ri;
          else b_ji[(c + j) * kLanes + r] = ri;
        }
        store4(a_dst + r * kLanes + c, va);
        store4(b_ij + r * kLanes + c, vb);
      }
}

template <class K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <bool kEmitGi>
cudaError_t launch(const int8_t* zr, const int8_t* zi, int F, int T, int sp,
                   int* a_out, int* b_out, cudaStream_t stream) {
  const int kb = sp / kLanes;
  cudaError_t err = set_smem(gram_int8_diag_kernel<kEmitGi>, kDiagSmem);
  if (err != cudaSuccess) return err;
  gram_int8_diag_kernel<kEmitGi><<<dim3(kb, F), kDiagThreads, kDiagSmem, stream>>>(
      zr, zi, T, sp, kb, a_out, b_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || kb == 1) return err;
  err = set_smem(gram_int8_quad_kernel<kEmitGi>, kQuadSmem);
  if (err != cudaSuccess) return err;
  gram_int8_quad_kernel<kEmitGi>
      <<<dim3(4, kb * (kb - 1) / 2, F), kQuadThreads, kQuadSmem, stream>>>(
          zr, zi, T, sp, kb, a_out, b_out);
  return cudaGetLastError();
}

}  // namespace

// The int8 launch behind clen_xengine_gram (dtype 0), which checks the sizes
// and the operands' 16-byte alignment; any T >= 1.
int clen_gram_int8_launch(const void* zr, const void* zi, int F, int T,
                          int sp, int emit_gi, void* a_out, void* b_out,
                          cudaStream_t stream) {
  const int8_t* r = static_cast<const int8_t*>(zr);
  const int8_t* i = static_cast<const int8_t*>(zi);
  int* a = static_cast<int*>(a_out);
  int* b = static_cast<int*>(b_out);
  return emit_gi ? launch<true>(r, i, F, T, sp, a, b, stream)
                 : launch<false>(r, i, F, T, sp, a, b, stream);
}

// the larger of the two kernels' dynamic shared memory
extern "C" long long clen_gram_int8_smem_bytes() {
  return kDiagSmem > kQuadSmem ? kDiagSmem : kQuadSmem;
}
