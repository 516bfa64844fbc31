// Batched unscaled FFT over a planar float32 stream chopped into N-point
// vectors (N a power of two, 256 <= N <= 16384):
//
//   y[b, k] = sum_{t<N} win[t] * x[b, t] * exp(sign * 2 pi i t k / N),
//
// sign -1 forward, +1 inverse, no scaling, natural order.  The Fft block's
// shift is index arithmetic: forward, out[b, k] = y[b, (k + N/2) mod N] (an
// fftshift); inverse, x[b, t] is read at (t + N/2) mod N before the window
// (the halves swapped on load, lib/clFFT_impl.cc:544-607).  Replaces
// clenabled_tpu/dsp/pallas_kernels.py: fft_batched_fused (_fft_batched_kernel).
//
// Design.  The TPU kernel splits N = n2*128 into two DFT matmuls for its
// matrix unit and reorders the output in VMEM.  Here the register-resident
// Stockham core of fft_core.cuh runs the transform: 16 points a thread,
// radix-16 passes and one radix-2/4/8 pass (2048 = 16*16*8), two
// conflict-free shared-memory exchanges at N = 2048 instead of eleven
// barriered radix-2 stages.  The first pass loads straight from device
// memory, windowed in registers (neighbouring threads on neighbouring words:
// the Stockham input order is j + r*N/16), and the last pass stores natural
// order straight to device memory, the shift folded into both indices.  Small
// vectors share a block (8 of 256 points), so blocks have at least 128
// threads.  A 2^21-sample frame is one wave of 16-point threads, so the
// launch is persistent and prefetches (below).
//
// Bound on the H100: 8 B read and 8 B written per sample (16 MiB each way
// for a 2^21-sample frame: about 10 us at 3.35 TB/s) against 5*log2(N)
// flops per sample (about 1.6 us of FP32 at N = 2048).  What the core pays
// on top: 2(passes - 1) shared-memory sweeps and 2 barriers per exchange.

#include <atomic>

#include "fft_core.cuh"

namespace {

// Below 1024 threads a block the launch is persistent: each block walks
// groups of V vectors and loads the next group's points into registers
// before transforming the current one, so that the card's single wave of
// blocks overlaps device-memory traffic with the passes.  128-thread blocks
// (N <= 2048) are held to 128 registers a thread, four to an SM; at 256
// threads (N = 4096) that cap spills, so the block takes what it needs.
// At 1024 threads (N = 16384) 64 registers a thread leave no room: one
// group a block, and the first exchange needs no opening barrier.
__host__ __device__ constexpr bool ahead(int threads) { return threads < 1024; }
constexpr int kMaxDevices = 64;

// blocks of a persistent launch: as many as the card holds at once (from
// the kernel's occupancy, asked once per kernel and device: `most` caches
// it), at most one per group of vectors
template <class K>
cudaError_t grid_blocks(K kernel, int threads, long long bytes, long long groups,
                        std::atomic<long long> (&most)[kMaxDevices],
                        unsigned* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  long long fit = dev < kMaxDevices ? most[dev].load() : 0;
  if (fit == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                        (size_t)bytes);
    if (err != cudaSuccess) return err;
    fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) most[dev].store(fit);
  }
  *blocks = (unsigned)(groups < fit ? groups : fit);
  return cudaSuccess;
}

template <int LOGN, bool INV>
__global__ void __launch_bounds__(fftcore::Sched<LOGN, false>::THREADS,
                                  fftcore::Sched<LOGN, false>::THREADS == 128 ? 4 : 1)
fft_batched_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const float* __restrict__ win,
                   const float2* __restrict__ tw, float* __restrict__ yr,
                   float* __restrict__ yi, long long nvec, int shift) {
  using S = fftcore::Sched<LOGN, false>;
  constexpr int N = S::N, T = S::T, R0 = S::radix(0),
                RL = S::radix(S::NPASS - 1);
  constexpr bool AHEAD = ahead(S::THREADS);
  extern __shared__ float smem[];
  const int lv = threadIdx.x / T, t = threadIdx.x % T;
  const long long groups = (nvec + S::V - 1) / S::V;
  const int in_rot = (INV && shift) ? N / 2 : 0;
  const int out_rot = (!INV && shift) ? N / 2 : 0;

  // the raw points of a group's vector lv, in the first pass's order
  float nre[fftcore::kPts], nim[fftcore::kPts];
  auto fetch = [&](long long grp) {
    const long long vec = grp * S::V + lv;
    fftcore::static_for<fftcore::kPts>([&](auto e) {
      constexpr int E = decltype(e)::value;
      constexpr int i0 = (E / R0) * T + (E % R0) * (N / R0);   // s*T + r*N/R0
      const long long src = vec * N + ((t + i0 + in_rot) & (N - 1));
      nre[e] = vec < nvec ? xr[src] : 0.f;
      nim[e] = vec < nvec ? xi[src] : 0.f;
    });
  };

  long long g = blockIdx.x;         // the grid never exceeds the groups
  fetch(g);
  for (;;) {
    const long long vec = g * S::V + lv;
    float2 v[fftcore::kPts];
    fftcore::static_for<fftcore::kPts>([&](auto e) {
      constexpr int E = decltype(e)::value;
      constexpr int i0 = (E / R0) * T + (E % R0) * (N / R0);
      const float w = win != nullptr ? __ldg(win + t + i0) : 1.f;
      v[e] = make_float2(nre[e] * w, nim[e] * w);
    });
    const bool more = AHEAD && g + gridDim.x < groups;
    if (more) fetch(g + gridDim.x);
    fftcore::run<LOGN, false, INV, AHEAD>(v, smem + lv * N,
                                          smem + S::V * N + lv * N, t,
                                          (lv * T) & 31, tw);
    if (vec < nvec) {
      fftcore::static_for<fftcore::kPts>([&](auto e) {
        constexpr int E = decltype(e)::value;
        constexpr int q0 = (E / RL) * T + (E % RL) * (N / RL);   // s*T + r*N/RL
        const long long dst = vec * N + ((t + q0 + out_rot) & (N - 1));
        yr[dst] = v[e].x;
        yi[dst] = v[e].y;
      });
    }
    if (!more) break;
    g += gridDim.x;
  }
}

template <int LOGN, bool INV>
cudaError_t launch(const void* xr, const void* xi, const void* win,
                   const void* tw, void* yr, void* yi, long long nvec,
                   int shift, cudaStream_t stream) {
  using S = fftcore::Sched<LOGN, false>;
  const auto kernel = fft_batched_kernel<LOGN, INV>;
  const long long bytes = fftcore::smem_bytes(S::N);
  cudaError_t err = fftcore::set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const long long groups = (nvec + S::V - 1) / S::V;
  unsigned blocks = (unsigned)groups;
  if (ahead(S::THREADS)) {
    static std::atomic<long long> most[kMaxDevices];
    err = grid_blocks(kernel, S::THREADS, bytes, groups, most, &blocks);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, S::THREADS, bytes, stream>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(win), static_cast<const float2*>(tw),
      static_cast<float*>(yr), static_cast<float*>(yi), nvec, shift);
  return cudaGetLastError();
}

}  // namespace

// win: [N] or null; tw: the forward schedule's pass twiddles
// (hopper_kernels.fft_passes(N)), tw_len complex64 values.  total: stream
// samples, a multiple of N.  Returns a cudaError_t; cudaErrorInvalidValue
// when N is not a power of two in [256, 16384], the sizes disagree, the
// table's length is not the schedule's or the block does not fit the card's
// opt-in shared memory.
extern "C" int clen_fft_batched(const void* xr, const void* xi, const void* win,
                                const void* tw, void* yr, void* yi,
                                long long total, int n, int inverse, int shift,
                                int tw_len, void* stream) {
  if (n < 256 || total < n || total % n || total / n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long nvec = total / n;
  cudaError_t err = cudaErrorInvalidValue;
  const bool ok = fftcore::dispatch(n, [&](auto c) {
    constexpr int L = decltype(c)::value;
    if (tw_len != fftcore::Sched<L, false>::tw_len()) return;
    const auto s = static_cast<cudaStream_t>(stream);
    err = inverse ? launch<L, true>(xr, xi, win, tw, yr, yi, nvec, shift, s)
                  : launch<L, false>(xr, xi, win, tw, yr, yi, nvec, shift, s);
  });
  return ok ? err : cudaErrorInvalidValue;
}

extern "C" long long clen_fft_smem_bytes(int n) { return fftcore::smem_bytes(n); }
