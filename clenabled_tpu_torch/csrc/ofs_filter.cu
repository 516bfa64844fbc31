// Overlap-save FFT filter with complex taps over a planar float32 stream:
//
//   y[p] = sum_{k<K} taps[k] * v[T + p - k],   v = tail ++ x,  T >= K-1
//
// for p < n, where the tail holds the previous frame's last T samples, written
// at every D-th sample (y[p] at out[p/D] for p % D == 0).  Replaces
// clenabled_tpu/dsp/pallas_kernels.py: ofs_filter_planar (_ofs_kernel,
// OfsPlan), whose samples equal the overlap-add path's.
//
// Design.  The transform size P is a power of two chosen by the host
// (hopper_kernels.OfsPlan: P >= 4(K-1), at least 256, at most 16384); each
// chunk of L = P - (K-1) outputs is one vector of the register-resident
// Stockham core (fft_core.cuh), and small chunks share a block (8 of 256
// points).  The first pass loads v[T + c*L - (K-1) + i] straight from device
// memory (the tail/frame seam is index arithmetic, so the caller never
// concatenates).  The forward transform (radices 16, ..., 16, rem) leaves the
// spectrum in natural order in registers; it is multiplied there by the tap
// spectrum (computed once per plan on the host in float64, 1/P folded in,
// natural order, read from device memory through the read-only cache), and
// the inverse runs the reversed schedule (rem, 16, ..., 16), whose first pass
// takes exactly the bins the forward's last pass holds, so no exchange
// happens at the product.  The inverse's last pass holds natural-order
// samples; only the kept, decimated outputs are stored.
//
// Bound on the H100: per output it reads 8 B (times P/L for the overlap) and
// writes 8 B / D; the two transforms cost about 10*log2(P) flops per sample.
// At the 49-tap path (P = 256) the bytes are the floor; what the core pays on
// top is two shared-memory exchanges (four from P = 512 to 4096, six at 8192
// and 16384) and the chunk's K-1 overlap.  One block takes one group of
// chunks: unlike fft_batched.cu the launch is not persistent, since the two
// transforms leave less device-memory time to hide behind them.

#include "fft_core.cuh"

namespace {

template <int LOGP>
__global__ void __launch_bounds__(fftcore::Sched<LOGP, false>::THREADS)
ofs_filter_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float* __restrict__ tr, const float* __restrict__ ti,
                  const float2* __restrict__ hspec,
                  const float2* __restrict__ tw, float* __restrict__ yr,
                  float* __restrict__ yi, int n, int tail_len, int ntaps,
                  int decim, int nchunks) {
  using F = fftcore::Sched<LOGP, false>;
  using I = fftcore::Sched<LOGP, true>;
  constexpr int P = F::N, T = F::T, R0 = F::radix(0),
                RL = F::radix(F::NPASS - 1), RI = I::radix(I::NPASS - 1);
  static_assert(I::radix(0) == RL, "the inverse opens with the forward's last radix");
  extern __shared__ float smem[];
  const int lv = threadIdx.x / T, t = threadIdx.x % T;
  const int valid = P - (ntaps - 1);
  const long long vend = (long long)tail_len + n;
  float* sre = smem + lv * P;
  float* sim = smem + F::V * P + lv * P;
  const int vx = (lv * T) & 31;

  // the chunk's P samples v[T + c*L - (K-1) + i], in the first pass's
  // order; the tail/frame seam is index arithmetic
  const int chunk = blockIdx.x * F::V + lv;
  const long long g0 = (long long)tail_len + (long long)chunk * valid - (ntaps - 1);
  float2 v[fftcore::kPts];
  fftcore::static_for<fftcore::kPts>([&](auto e) {
    constexpr int E = decltype(e)::value;
    const long long g = g0 + t + (E / R0) * T + (E % R0) * (P / R0);
    float2 u = make_float2(0.f, 0.f);
    if (chunk < nchunks) {
      if (g < tail_len) {
        u = make_float2(tr[g], ti[g]);
      } else if (g < vend) {
        u = make_float2(xr[g - tail_len], xi[g - tail_len]);
      }
    }
    v[e] = u;
  });

  fftcore::run<LOGP, false, false, false>(v, sre, sim, t, vx, tw);
  fftcore::static_for<fftcore::kPts>([&](auto e) {
    constexpr int E = decltype(e)::value;
    const float2 h = __ldg(hspec + t + (E / RL) * T + (E % RL) * (P / RL));
    v[e] = fftcore::cmul(v[e], h);
  });
  fftcore::run<LOGP, true, true, true>(v, sre, sim, t, vx, tw + F::tw_len());

  // kept outputs: chunk sample i >= K-1 is output q = c0 + i - (K-1), stored
  // when q < n and q % decim == 0
  if (chunk >= nchunks) return;
  const long long c0 = (long long)chunk * valid;
  fftcore::static_for<fftcore::kPts>([&](auto e) {
    constexpr int E = decltype(e)::value;
    const int i = t + (E / RI) * T + (E % RI) * (P / RI);
    const long long q = c0 + i - (ntaps - 1);
    if (i >= ntaps - 1 && q < n) {
      const int qi = (int)q;
      if (decim == 1) {
        yr[qi] = v[e].x;
        yi[qi] = v[e].y;
      } else if (qi % decim == 0) {
        yr[qi / decim] = v[e].x;
        yi[qi / decim] = v[e].y;
      }
    }
  });
}

template <int LOGP>
cudaError_t launch(const void* xr, const void* xi, const void* tr,
                   const void* ti, const void* hspec, const void* tw, void* yr,
                   void* yi, int n, int tail_len, int ntaps, int decim,
                   cudaStream_t stream) {
  using S = fftcore::Sched<LOGP, false>;
  const auto kernel = ofs_filter_kernel<LOGP>;
  const long long bytes = fftcore::smem_bytes(S::N);
  cudaError_t err = fftcore::set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int valid = S::N - (ntaps - 1);
  const int nchunks = (n + valid - 1) / valid;
  kernel<<<(nchunks + S::V - 1) / S::V, S::THREADS, bytes, stream>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(tr), static_cast<const float*>(ti),
      static_cast<const float2*>(hspec), static_cast<const float2*>(tw),
      static_cast<float*>(yr), static_cast<float*>(yi), n, tail_len, ntaps,
      decim, nchunks);
  return cudaGetLastError();
}

}  // namespace

// hspec: [P] float2, the tap spectrum / P in natural order; tw: the forward
// schedule's pass twiddles followed by the reversed schedule's
// (hopper_kernels.fft_passes(P) and fft_passes(P, reverse=True)), tw_len
// complex64 values in all.  n is the frame length (a multiple of decim),
// tail_len >= K-1.  Returns a cudaError_t; cudaErrorInvalidValue when P is not
// a power of two in [256, 16384], the table's length is not the schedules',
// the sizes are inconsistent or the block does not fit the card's opt-in
// shared memory.
extern "C" int clen_ofs_filter(const void* xr, const void* xi, const void* tr,
                               const void* ti, const void* hspec, const void* tw,
                               void* yr, void* yi, int n, int tail_len,
                               int ntaps, int p, int decim, int tw_len,
                               void* stream) {
  if (ntaps < 1 || ntaps - 1 >= p || tail_len < ntaps - 1 || decim < 1 ||
      n < decim || n % decim || (long long)n + p > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  const bool ok = fftcore::dispatch(p, [&](auto c) {
    constexpr int L = decltype(c)::value;
    if (tw_len != fftcore::Sched<L, false>::tw_len() +
                      fftcore::Sched<L, true>::tw_len())
      return;
    err = launch<L>(xr, xi, tr, ti, hspec, tw, yr, yi, n, tail_len, ntaps,
                    decim, static_cast<cudaStream_t>(stream));
  });
  return ok ? err : cudaErrorInvalidValue;
}

extern "C" long long clen_ofs_smem_bytes(int p) { return fftcore::smem_bytes(p); }
