// X-Engine stacked Gram, the C entry: per channel, over all T integration
// frames,
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
// Both dtypes run on the tensor cores, each in a file of its own:
// xengine_gram_int8.cu (mma.sync m16n8k32 s8, int32 sums) and
// xengine_gram_bf16.cu (mma.sync m16n8k16 bf16, float32 sums).  Each has a
// kernel for the diagonal blocks (all of them at kb = 1) and one for the
// 64 x 64 quadrants of the others.  This file checks the sizes and hands the
// call on.

#include <cuda_runtime.h>
#include <stdint.h>

// xengine_gram_int8.cu, xengine_gram_bf16.cu
int clen_gram_int8_launch(const void* zr, const void* zi, int F, int T,
                          int sp, int emit_gi, void* a_out, void* b_out,
                          cudaStream_t stream);
int clen_gram_bf16_launch(const void* zr, const void* zi, int F, int T,
                          int sp, int emit_gi, void* a_out, void* b_out,
                          cudaStream_t stream);

// dtype: 0 = int8 (int32 outputs), 1 = bfloat16 (float32 outputs).
// Needs sp % 128 == 0, T >= 1 (T % 16 == 0 for bfloat16), 16-byte aligned
// operands and F <= 65535.  Returns a cudaError_t.
extern "C" int clen_xengine_gram(const void* zr, const void* zi, int dtype,
                                 int F, int T, int sp, int emit_gi,
                                 void* a_out, void* b_out, void* stream) {
  if (sp % 128 || F < 1 || F > 65535 || T < 1) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(zr) | reinterpret_cast<uintptr_t>(zi)) % 16) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return clen_gram_int8_launch(zr, zi, F, T, sp, emit_gi, a_out, b_out, st);
    case 1:
      return clen_gram_bf16_launch(zr, zi, F, T, sp, emit_gi, a_out, b_out, st);
    default:
      return cudaErrorInvalidValue;
  }
}
