"""The plain reference the benchmark holds the program to.

Plain NumPy and torch, written from the published descriptions of the
blocks (GNU Radio's windowed-sinc designer, the critically sampled
polyphase channelizer of clPolyphaseChannelizer, the FD correlator of
clxcorrelate_fft_vcf, the xGPU-order X-Engine of clXEngine).  It imports
neither ``jax``, the JAX package nor anything of ``clenabled_tpu_torch``,
and takes nothing the program made: its taps, tables and tail rule are
frozen copies kept here.  Float32 matmuls run with TF32 off.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest, ties
    to even): the operand precision of the tensor cores' TF32 mode."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)
