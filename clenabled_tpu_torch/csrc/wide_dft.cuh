// The M = 16 Q point unscaled inverse DFT (Q in {2, 4, 8}: M = 32, 64, 128)
// in two in-register passes over Q lanes of a warp, shared by the wide
// bodies of pfb_oversampled.cu and fx_correlate.cu.
//
// A warp owns a tile of 512 complex (float2) slots in shared memory, 32
// rows of 16 (the 16 slot banks of a half-warp 64-bit access), and
// transforms the GW = 32/Q groups of M points that the tile holds, lane
// (gl, q) = (lane / Q, lane mod Q) for group gl of the tile:
//   pass 1  lane q takes points j = q + Q m (m < 16), fftcore::dft<16> over
//           m, times exp(+2 pi i q k1 / M) (a float64-built table of M
//           entries, [k1][q]), into the tile at row k1, column Q (g mod GW)
//           + (q ^ (k1 mod Q)); __syncwarp;
//   pass 2  lane q' takes bins k1 = a Q + q' of every q (conflict free: the
//           column's low bits q ^ q'), fftcore::dft<Q> over q gives bin
//           k = k1 + 16 k2 in registers.
// Three slot layouts of a group's M points in the tile, each conflict free
// for the accesses that use it (tests/test_torch_channelizer.py and
// tests/test_torch_kernels.py check every warp access's banks in numpy):
//   fir_slot    point j of group g at row j / Q, column Q ((g mod GW) ^
//               (row mod GW)) + j mod Q: a warp storing 32 consecutive j of
//               one group, and pass 1's lanes (g, q) loading point q + Q m;
//   pass1_slot  the exchange between the passes;
//   out_slot    bin k of group g at g M + (k ^ Q (g mod GW) ^ 2 (bit 4 of
//               k)): pass 2's lanes storing, a warp reading 32 consecutive
//               k of one group, and lanes (gl, q) reading bins q + Q m.

#pragma once

#include <cuda_runtime.h>

#include "fft_core.cuh"

namespace widedft {

template <int Q>
__device__ __forceinline__ int fir_slot(int g, int j) {
  constexpr int GW = 32 / Q;
  const int m = j / Q;
  return (g / GW) * 512 + m * 32 + Q * ((g % GW) ^ (m % GW)) + j % Q;
}

template <int Q>
__device__ __forceinline__ int pass1_slot(int g, int q, int k1) {
  constexpr int GW = 32 / Q;
  return (g / GW) * 512 + k1 * 32 + Q * (g % GW) + (q ^ (k1 % Q));
}

template <int M>
__device__ __forceinline__ int out_slot(int g, int k) {
  constexpr int Q = M / 16;
  return g * M + (k ^ (Q * (g % (32 / Q))) ^ (((k >> 4) & 1) << 1));
}

// out_slot's swizzle of bin k: out_slot<M>(g, k) = out_slot<M>(g, 0) ^
// kswz(k) (the XOR stays below M), and kswz(q | c) = q ^ kswz(c) for q < 16,
// so a lane's slots are one lane-dependent base XOR compile-time constants
__host__ __device__ constexpr int kswz(int k) { return k ^ (((k >> 4) & 1) << 1); }

// the bin lane q holds in v[i] after transform: i = a Q + b is bin
// a Q + q + 16 b
template <int Q>
__host__ __device__ constexpr int bin(int i, int q) {
  return (i / Q) * Q + q + 16 * (i % Q);
}

// tw1[k1 Q + q] = exp(+2 pi i q k1 / M), from float64; threads t, t +
// threads, ... of the block fill it
template <int M>
__device__ __forceinline__ void twiddles(float2* tw1, int t, int threads) {
  constexpr int Q = M / 16;
  for (int e = t; e < M; e += threads) {
    double sn, cs;
    sincospi(2.0 * ((e / Q) * (e % Q)) / M, &sn, &cs);
    tw1[e] = make_float2((float)cs, (float)sn);
  }
}

// Group g's transform on its Q lanes: on entry lane q holds point q + Q m
// in v[m]; on return v[i] holds bin<Q>(i, q).  The exchange goes through
// the pass1 slots of g's tile in `tile` (slot 0 of tile 0 at tile[0]).
// It opens with a __syncwarp, so the warp's lanes may have read the tile
// just before (pass 1 overwrites it), and closes with one, so they may
// write the tile just after.
template <int Q>
__device__ __forceinline__ void transform(float2 (&v)[fftcore::kPts], float2* tile,
                                          const float2* tw1, int g, int q) {
  __syncwarp();
  fftcore::dft<16, 0, true>(v);
  fftcore::static_for<15>([&](auto k) {
    constexpr int k1 = decltype(k)::value + 1;
    v[k1] = fftcore::cmul(v[k1], tw1[k1 * Q + q]);
  });
  fftcore::static_for<16>([&](auto k) {
    tile[pass1_slot<Q>(g, q, decltype(k)::value)] = v[k];
  });
  __syncwarp();
  fftcore::static_for<16 / Q>([&](auto a) {
    constexpr int aa = decltype(a)::value;
    fftcore::static_for<Q>([&](auto b) {
      v[aa * Q + b] = tile[pass1_slot<Q>(g, decltype(b)::value, aa * Q + q)];
    });
  });
  __syncwarp();
  fftcore::static_for<16 / Q>([&](auto a) {
    fftcore::dft<Q, decltype(a)::value * Q, true>(v);
  });
}

}  // namespace widedft
