// High-rate host-side unpack & marshalling.
//
// The reference unpacks packed-4-bit / signed-byte I/Q on the GPU
// (CharToComplex, lib/clXEngine_impl.cc:831-858 of gr-clenabled) and
// marshals antenna streams into [time][station][chan][pol] on the host in
// C++ (:982-1061).  Here the unpack targets PLANAR float pairs (the
// device-side format — see clenabled_tpu_torch/dsp/planar.py) and runs on
// the host ingest path where the bytes arrive.  Plain loops; g++ -O3
// autovectorizes them.

#include <cstddef>
#include <cstdint>

namespace {

// Two's-complement 4-bit LUT, scale 1/7 (clXEngine_impl.cc:835-837): each
// entry is the code times the float 1/7, rounded to float, as the device
// unpack (dsp/xengine.py unpack_packed_4bit_planar) computes it, so that the
// host and device unpacks agree bit for bit (k / 7 would differ in the last
// bit at k = ±3, ±6).
constexpr float kS = 1.0f / 7.0f;
const float kLut4[16] = {0.f,       1.f * kS,  2.f * kS,  3.f * kS,
                         4.f * kS,  5.f * kS,  6.f * kS,  7.f * kS,
                         0.f,       -7.f * kS, -6.f * kS, -5.f * kS,
                         -4.f * kS, -3.f * kS, -2.f * kS, -1.f * kS};

constexpr float kInvSchar = 1.0f / 127.0f;

}  // namespace

extern "C" {

// n bytes in → n planar complex samples (high nibble = I, low = Q).
void unpack_4bit_planar(const uint8_t* in, float* re, float* im, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint8_t b = in[i];
    re[i] = kLut4[b >> 4];
    im[i] = kLut4[b & 0x0F];
  }
}

// 2n interleaved signed bytes (I,Q) → n planar complex samples, scale 1/127.
void unpack_i8_planar(const int8_t* in, float* re, float* im, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    re[i] = (float)in[2 * i] * kInvSchar;
    im[i] = (float)in[2 * i + 1] * kInvSchar;
  }
}

// Interleaved complex64 (r,i pairs) → planar floats.
void deinterleave_c64(const float* in, float* re, float* im, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    re[i] = in[2 * i];
    im[i] = in[2 * i + 1];
  }
}

// Planar floats → interleaved complex64.
void interleave_c64(const float* re, const float* im, float* out, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    out[2 * i] = re[i];
    out[2 * i + 1] = im[i];
  }
}

// X-Engine input marshal: per-station contiguous planar blocks
// [station][time*chan*pol] → [time][station][chan][pol]
// (clXEngine_impl.cc:982-1061's layout, planar).
void marshal_xengine_planar(const float* const* station_data, float* out,
                            size_t n_stations, size_t n_time,
                            size_t chan_pol) {
  for (size_t t = 0; t < n_time; ++t) {
    for (size_t s = 0; s < n_stations; ++s) {
      const float* src = station_data[s] + t * chan_pol;
      float* dst = out + (t * n_stations + s) * chan_pol;
      for (size_t k = 0; k < chan_pol; ++k) dst[k] = src[k];
    }
  }
}

}  // extern "C"
