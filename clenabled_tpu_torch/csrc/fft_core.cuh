// Register-resident mixed-radix Stockham FFT core for one NVIDIA Hopper
// block, shared by fft_batched.cu and ofs_filter.cu.
//
// An N-point vector (N = 2^LOGN, 256 <= N <= 16384) is held by T = N/16
// threads, 16 points each in registers.  N is factored into radix-16 passes
// and at most one radix-2/4/8 pass: forward order 16, ..., 16, rem (for
// example 2048 = 16*16*8, 16384 = 16*16*16*4), or that order reversed.  Pass
// p has radix R and follows NS = R_0 * ... * R_{p-1} points (self-sorting,
// Stockham): work item j < N/R reads its R inputs at j + r*N/R, multiplies
// input r by exp(sign 2 pi i r k / (NS*R)), k = j mod NS, runs the R-point DFT
// in registers (radix-2 butterflies unrolled, constant twiddles, no barrier)
// and leaves output r at (j / NS)*NS*R + r*NS + k.  A thread runs the 16/R
// items j = t + s*T, s < 16/R, so it always holds 16 points.  The first pass
// takes its inputs from the caller's registers (loaded from device memory at
// j + r*N/R_0, natural order) and the last pass leaves natural order in
// registers (bin j + r*N/R_last at v[s*R_last + r]), so no bit-reversed
// index and no permutation pass exist.
//
// Between passes the points go once through shared memory: write, barrier,
// read (and a barrier before the next write: one buffer of N floats per
// component, no second buffer, no twiddle table in shared memory).  Pass
// twiddles come from a float64-built float32 table in device memory read
// through the read-only cache, [R_p][NS_p] for passes p >= 1 in order,
// neighbouring k on neighbouring words (hopper_kernels.fft_passes builds it;
// the launch checks its length).  The exchange address of logical index a is
// swizzled, a ^ ((a / (NS*R)) * NS mod 32) for NS < 32, and XORed with
// (vector * T) mod 32 when a warp holds two vectors (N = 256), so that every
// shared-memory store and load of every pass hits 32 distinct banks.
//
// A block of max(T, 128) threads carries V = max(1, 128/T) vectors at a
// time; the caller masks the ragged last group's device-memory loads and
// stores, while its threads still take part in the barriers.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace fftcore {

constexpr int kPts = 16;        // points a thread holds
constexpr int kMinThreads = 128;

template <int LOGN, bool REV>
struct Sched {
  static constexpr int N = 1 << LOGN;
  static constexpr int T = N / kPts;                       // threads per vector
  static constexpr int V = T >= kMinThreads ? 1 : kMinThreads / T;
  static constexpr int THREADS = V * T;
  static constexpr int REM = LOGN % 4;
  static constexpr int NPASS = LOGN / 4 + (REM ? 1 : 0);

  __host__ __device__ static constexpr int radix(int p) {
    if (REM == 0) return 16;
    return (REV ? NPASS - 1 - p : p) == NPASS - 1 ? (1 << REM) : 16;
  }
  __host__ __device__ static constexpr int ns(int p) {
    int s = 1;
    for (int q = 0; q < p; ++q) s *= radix(q);
    return s;
  }
  __host__ __device__ static constexpr int tw_off(int p) {
    int o = 0;
    for (int q = 1; q < p; ++q) o += radix(q) * ns(q);
    return o;
  }
  __host__ __device__ static constexpr int tw_len() { return tw_off(NPASS); }
};

// bytes of shared memory per block: V vectors of N points, both components
__host__ __device__ inline long long smem_bytes(int n) {
  constexpr int least = kMinThreads * kPts;
  return (long long)(n > least ? n : least) * 8;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {   // a * conj(b)
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// a * exp(sign 2 pi i m / 16), m < 8 a constant once unrolled
template <bool INV>
__device__ __forceinline__ float2 rot16(float2 a, int m) {
  constexpr float c1 = 0.92387953251128674f, s1 = 0.38268343236508978f,
                  h = 0.70710678118654752f;
  float c, s;
  switch (m) {
    case 0: return a;
    case 4: return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
    case 1: c = c1; s = s1; break;
    case 2: c = h; s = h; break;
    case 3: c = s1; s = c1; break;
    case 5: c = -s1; s = c1; break;
    case 6: c = -h; s = h; break;
    default: c = -c1; s = s1; break;         // m = 7
  }
  return cmul(a, make_float2(c, INV ? s : -s));
}

__host__ __device__ constexpr int brev(int k, int r) {
  int o = 0;
  for (int b = 1; b < r; b <<= 1, k >>= 1) o = (o << 1) | (k & 1);
  return o;
}

// a compile-time index usable as an int in device code
template <int I>
struct Idx {
  static constexpr int value = I;
  __host__ __device__ constexpr operator int() const { return I; }
};

// f(Idx<i>{}) for i < n: every register index is a compile-time constant
// without relying on the loop unroller, so the thread's points never leave
// registers
template <class F, int... I>
__device__ __forceinline__ void static_for_(F&& f, std::integer_sequence<int, I...>) {
  (f(Idx<I>{}), ...);
}
template <int n, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_(f, std::make_integer_sequence<int, n>{});
}

// radix-2 decimation-in-frequency stages of span HALF .. 1 on v[B .. B+R)
template <int R, int HALF, int B, bool INV>
__device__ __forceinline__ void dif_stages(float2 (&v)[kPts]) {
  static_for<R / (2 * HALF)>([&](auto blk) {
    static_for<HALF>([&](auto p) {
      constexpr int i = B + 2 * HALF * decltype(blk)::value + decltype(p)::value;
      const float2 a = v[i], c = v[i + HALF];
      v[i] = cadd(a, c);
      v[i + HALF] = rot16<INV>(csub(a, c), decltype(p)::value * (8 / HALF));
    });
  });
  if constexpr (HALF > 1) dif_stages<R, HALF / 2, B, INV>(v);
}

// in-place R-point DFT of v[B .. B+R): radix-2 decimation in frequency
// (output bin k at position brev(k)), then renamed to natural order
template <int R, int B, bool INV>
__device__ __forceinline__ void dft(float2 (&v)[kPts]) {
  dif_stages<R, R / 2, B, INV>(v);
  float2 t[R];
  static_for<R>([&](auto k) { t[k] = v[B + brev(decltype(k)::value, R)]; });
  static_for<R>([&](auto k) { v[B + k] = t[k]; });
}

// one pass's twiddles and DFTs on the thread's 16/R work items
template <int R, int NS, int T, bool INV>
__device__ __forceinline__ void pass(float2 (&v)[kPts], int t,
                                     const float2* __restrict__ tw) {
  static_for<kPts / R>([&](auto s) {
    constexpr int b = decltype(s)::value * R;
    if constexpr (NS > 1) {
      const float2* w = tw + ((t + decltype(s)::value * T) & (NS - 1));
      static_for<R - 1>([&](auto r) {
        constexpr int i = decltype(r)::value + 1;
        const float2 x = __ldg(w + i * NS);
        v[b + i] = INV ? cmulc(v[b + i], x) : cmul(v[b + i], x);
      });
    }
    dft<R, b, INV>(v);
  });
}

// the exchange address of logical index a written by a pass (R, NS)
template <int NS, int R>
__device__ __forceinline__ int swz(int a) {
  if constexpr (NS >= 32) {
    return a;
  } else {
    return a ^ (((a / (NS * R)) * NS) & 31);
  }
}

// the points of a pass (R, NS) through shared memory to the next pass's
// (radix R2) inputs; SYNC0: a barrier first, when the buffer was read since
// its last barrier
template <int N, int R, int NS, int R2, bool SYNC0>
__device__ __forceinline__ void exchange(float2 (&v)[kPts], float* sre,
                                         float* sim, int t, int vx) {
  constexpr int T = N / kPts;
  if (SYNC0) __syncthreads();
  static_for<kPts / R>([&](auto s) {
    const int j = t + decltype(s)::value * T;
    const int base = (j / NS) * NS * R + (j & (NS - 1));
    static_for<R>([&](auto r) {
      const int a = swz<NS, R>(base + decltype(r)::value * NS) ^ vx;
      sre[a] = v[decltype(s)::value * R + r].x;
      sim[a] = v[decltype(s)::value * R + r].y;
    });
  });
  __syncthreads();
  static_for<kPts / R2>([&](auto s) {
    static_for<R2>([&](auto r) {
      const int a = swz<NS, R>(t + decltype(s)::value * T +
                               decltype(r)::value * (N / R2)) ^ vx;
      v[decltype(s)::value * R2 + r] = make_float2(sre[a], sim[a]);
    });
  });
}

// passes P .. NPASS-1 of the schedule; the first exchange opens with a
// barrier when SYNC0
template <int LOGN, bool REV, bool INV, bool SYNC0, int P = 0>
__device__ __forceinline__ void run(float2 (&v)[kPts], float* sre, float* sim,
                                    int t, int vx,
                                    const float2* __restrict__ tw) {
  using S = Sched<LOGN, REV>;
  constexpr int R = S::radix(P), NS = S::ns(P);
  pass<R, NS, S::T, INV>(v, t, tw + S::tw_off(P));
  if constexpr (P + 1 < S::NPASS) {
    exchange<S::N, R, NS, S::radix(P + 1), (SYNC0 || P > 0)>(v, sre, sim,
                                                           t, vx);
    run<LOGN, REV, INV, SYNC0, P + 1>(v, sre, sim, t, vx, tw);
  }
}

// f(std::integral_constant<int, log2 n>{}); false unless n is a power of two
// in [256, 16384]
template <class Fn>
inline bool dispatch(int n, Fn&& f) {
  switch (n) {
    case 256: f(std::integral_constant<int, 8>{}); return true;
    case 512: f(std::integral_constant<int, 9>{}); return true;
    case 1024: f(std::integral_constant<int, 10>{}); return true;
    case 2048: f(std::integral_constant<int, 11>{}); return true;
    case 4096: f(std::integral_constant<int, 12>{}); return true;
    case 8192: f(std::integral_constant<int, 13>{}); return true;
    case 16384: f(std::integral_constant<int, 14>{}); return true;
    default: return false;
  }
}

// set a kernel's dynamic shared memory (above the 48 KB default when asked)
// after checking it against the card's opt-in limit
template <class K>
inline cudaError_t set_smem(K kernel, long long bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace fftcore
