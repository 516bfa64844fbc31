// X-Engine stacked Gram: per channel, over all T integration frames,
//
//   a  = zr zr^T + zi zi^T      lower block-triangle of 128 x 128 blocks
//   b  = zi zr^T                the full kb x kb block grid, or, with emit_gi,
//   gi = b - b^T                its lower block-triangle
//
// for zr/zi [F, T, S*P] int8 (int32 sums, exact) or bfloat16 (float32 sums),
// S*P = 128*kb.  Replaces clenabled_tpu/dsp/pallas_kernels.py:
// xengine_gram_stacked, xengine_gram_stacked_blocks and
// xengine_gram_stacked_tri (kernel body _xengine_gram_kernel, launcher
// _xengine_gram_stacked_call).  The outputs keep that kernel's block layouts:
// a_blk [F, nbt, 128, 128] and gi_blk [F, nbt, 128, 128] in tri_blocks order
// ((i, j) for i < kb for j <= i), b_blk [F, kb, kb, 128, 128].
//
// Design.  One thread block per (channel, lower block (i, j), 64 x 64
// quadrant of it).  It walks T in tiles: each tile stages the quadrant's 64
// row-columns and 64 col-columns of zr and zi in shared memory, then each of
// its 256 threads updates a 4 x 4 micro-tile of three accumulators held in
// registers: a, ir = zi_I zr_J and ri = zr_I zi_J.  The block that owns
// (i, j) therefore has both halves of gi = ir - ri (the TPU kernel reads the
// transposed (j, i) block from VMEM instead), and in b mode it writes
// b(i, j) = ir and b(j, i) = ri^T, so the upper blocks cost no second pass
// over device memory.  Every output has one owner and no atomics are used:
// the result is deterministic and int8 is exact.  int8 tiles are transposed
// while staged (byte permutes) so that each 32-bit word holds 4 frames of one
// column, and __dp4a does 4 multiply-adds per instruction; bfloat16 widens
// to float32 on staging and uses fmaf.  (The TPU kernel's VMEM double
// buffering, slot parity and t_tile clamp have no counterpart: a block walks
// its own T loop.)
//
// Bound on the H100: at the reference configuration (F = 256, T = 8192,
// S*P = 128) the kernel does 4 multiply-adds per output per frame, 1.4e11 in
// all, against 512 MiB of operands, so it is bound by the CUDA cores'
// integer (dp4a) or FP32 rate, not by bytes.  mma.sync / wgmma on the
// tensor cores is the lever for a later PR.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;   // block edge of the JAX layout
constexpr int kQuad = 64;     // quadrant edge owned by one thread block
constexpr int kThreads = 256; // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kWords = 32;    // 32-bit words per column in one staged tile

// int8: each word packs 4 frames of one column; 128 frames per tile.
struct Int8Gram {
  using W = int;
  static constexpr int kFrames = 4 * kWords;
  __device__ static int mac(int a, int b, int c) { return __dp4a(a, b, c); }

  // rows [t0, t0 + 128) x cols [c0, c0 + 64) of one channel -> dst[w][col];
  // T % 4 == 0, so a 4-frame group is wholly inside or past the end.
  __device__ static void stage(const void* chan, int T, int sp, int t0,
                               int c0, int* dst) {
    const int8_t* src = static_cast<const int8_t*>(chan);
    for (int e = threadIdx.x; e < kWords * (kQuad / 4); e += kThreads) {
      const int w = e / (kQuad / 4);
      const int q = e - w * (kQuad / 4);
      const int t = t0 + 4 * w;
      uint32_t x0 = 0, x1 = 0, x2 = 0, x3 = 0;
      if (t < T) {
        const int8_t* p = src + (long long)t * sp + c0 + 4 * q;
        x0 = *reinterpret_cast<const uint32_t*>(p);
        x1 = *reinterpret_cast<const uint32_t*>(p + sp);
        x2 = *reinterpret_cast<const uint32_t*>(p + 2 * sp);
        x3 = *reinterpret_cast<const uint32_t*>(p + 3 * sp);
      }
      // 4 x 4 byte transpose: word c of the result holds column c of the
      // four frames, frame 0 in the low byte
      const uint32_t lo01 = __byte_perm(x0, x1, 0x5140);
      const uint32_t hi01 = __byte_perm(x0, x1, 0x7362);
      const uint32_t lo23 = __byte_perm(x2, x3, 0x5140);
      const uint32_t hi23 = __byte_perm(x2, x3, 0x7362);
      *reinterpret_cast<int4*>(dst + w * kQuad + 4 * q) = make_int4(
          (int)__byte_perm(lo01, lo23, 0x5410), (int)__byte_perm(lo01, lo23, 0x7632),
          (int)__byte_perm(hi01, hi23, 0x5410), (int)__byte_perm(hi01, hi23, 0x7632));
    }
  }
};

// bfloat16: each word is one frame widened to float32; 32 frames per tile.
struct Bf16Gram {
  using W = float;
  static constexpr int kFrames = kWords;
  __device__ static float mac(float a, float b, float c) { return fmaf(a, b, c); }

  __device__ static void stage(const void* chan, int T, int sp, int t0,
                               int c0, float* dst) {
    const uint16_t* src = static_cast<const uint16_t*>(chan);
    for (int e = threadIdx.x; e < kWords * (kQuad / 8); e += kThreads) {
      const int r = e / (kQuad / 8);
      const int q = e - r * (kQuad / 8);
      const int t = t0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t < T) v = *reinterpret_cast<const uint4*>(src + (long long)t * sp + c0 + 8 * q);
      // a bfloat16 is the high half of the float32 with the same value
      float* d = dst + r * kQuad + 8 * q;
      *reinterpret_cast<float4*>(d) = make_float4(
          __uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
          __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
      *reinterpret_cast<float4*>(d + 4) = make_float4(
          __uint_as_float(v.z << 16), __uint_as_float(v.z & 0xffff0000u),
          __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xffff0000u));
    }
  }
};

template <class G, bool kEmitGi>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const void* __restrict__ zr, const void* __restrict__ zi, int T,
            int sp, int kb, int elem_bytes, typename G::W* __restrict__ a_out,
            typename G::W* __restrict__ b_out) {
  using W = typename G::W;
  __shared__ __align__(16) W s_ri[kWords * kQuad];  // zr, row columns
  __shared__ __align__(16) W s_ii[kWords * kQuad];  // zi, row columns
  __shared__ __align__(16) W s_rj[kWords * kQuad];  // zr, col columns
  __shared__ __align__(16) W s_ij[kWords * kQuad];  // zi, col columns

  const int n = blockIdx.y;               // lower block, tri_blocks order
  int bi = 0;
  while ((bi + 1) * (bi + 2) / 2 <= n) ++bi;
  const int bj = n - bi * (bi + 1) / 2;
  const int qr = blockIdx.x >> 1, qc = blockIdx.x & 1;
  const int row0 = bi * kLanes + qr * kQuad;
  const int col0 = bj * kLanes + qc * kQuad;
  const long long chan = (long long)blockIdx.z * T * sp * elem_bytes;
  const char* zr_f = static_cast<const char*>(zr) + chan;
  const char* zi_f = static_cast<const char*>(zi) + chan;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  W acc_a[4][4], acc_ir[4][4], acc_ri[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc_a[x][y] = acc_ir[x][y] = acc_ri[x][y] = W(0);

  for (int t0 = 0; t0 < T; t0 += G::kFrames) {
    __syncthreads();
    G::stage(zr_f, T, sp, t0, row0, s_ri);
    G::stage(zi_f, T, sp, t0, row0, s_ii);
    G::stage(zr_f, T, sp, t0, col0, s_rj);
    G::stage(zi_f, T, sp, t0, col0, s_ij);
    __syncthreads();
#pragma unroll 4
    for (int w = 0; w < kWords; ++w) {
      W ar[4], ai[4], br[4], bim[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        ar[x] = s_ri[w * kQuad + ty + 16 * x];
        ai[x] = s_ii[w * kQuad + ty + 16 * x];
        br[x] = s_rj[w * kQuad + tx + 16 * x];
        bim[x] = s_ij[w * kQuad + tx + 16 * x];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          acc_a[x][y] = G::mac(ai[x], bim[y], G::mac(ar[x], br[y], acc_a[x][y]));
          acc_ir[x][y] = G::mac(ai[x], br[y], acc_ir[x][y]);
          acc_ri[x][y] = G::mac(ar[x], bim[y], acc_ri[x][y]);
        }
    }
  }

  const long long blk = (long long)kLanes * kLanes;
  const long long nbt = (long long)kb * (kb + 1) / 2;
  const long long f = blockIdx.z;
  W* a_dst = a_out + (f * nbt + n) * blk;
  W* b_ij = kEmitGi ? b_out + (f * nbt + n) * blk
                    : b_out + ((f * kb + bi) * kb + bj) * blk;
  W* b_ji = b_out + ((f * kb + bj) * kb + bi) * blk;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int r = qr * kQuad + ty + 16 * x;
      const int c = qc * kQuad + tx + 16 * y;
      a_dst[r * kLanes + c] = acc_a[x][y];
      if (kEmitGi) {
        b_ij[r * kLanes + c] = acc_ir[x][y] - acc_ri[x][y];
      } else {
        b_ij[r * kLanes + c] = acc_ir[x][y];
        if (bi != bj) b_ji[c * kLanes + r] = acc_ri[x][y];
      }
    }
}

template <class G>
int launch_gram(const void* zr, const void* zi, int F, int T, int sp,
                int emit_gi, int elem_bytes, void* a_out, void* b_out,
                cudaStream_t stream) {
  const int kb = sp / kLanes;
  const dim3 grid(4, kb * (kb + 1) / 2, F);
  using W = typename G::W;
  if (emit_gi) {
    gram_kernel<G, true><<<grid, kThreads, 0, stream>>>(
        zr, zi, T, sp, kb, elem_bytes, static_cast<W*>(a_out), static_cast<W*>(b_out));
  } else {
    gram_kernel<G, false><<<grid, kThreads, 0, stream>>>(
        zr, zi, T, sp, kb, elem_bytes, static_cast<W*>(a_out), static_cast<W*>(b_out));
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = int8 (int32 outputs), 1 = bfloat16 (float32 outputs).
// Needs sp % 128 == 0, T % 4 == 0 for int8, 16-byte aligned operands and
// F <= 65535.  Returns a cudaError_t.
extern "C" int clen_xengine_gram(const void* zr, const void* zi, int dtype,
                                 int F, int T, int sp, int emit_gi,
                                 void* a_out, void* b_out, void* stream) {
  if (sp % kLanes || F < 1 || F > 65535 || T < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (T % 4) return cudaErrorInvalidValue;
      return launch_gram<Int8Gram>(zr, zi, F, T, sp, emit_gi, 1, a_out, b_out, st);
    case 1:
      return launch_gram<Bf16Gram>(zr, zi, F, T, sp, emit_gi, 2, a_out, b_out, st);
    default:
      return cudaErrorInvalidValue;
  }
}
