"""Block-size / alignment policy.

The port of ``clenabled_tpu.runtime.config``.  The reference sizes device
buffers per GR call and grows them on demand (lib/clMathOp_impl.cc:371-373)
and rounds work sizes to the kernel's preferred workgroup multiple
(lib/clMathOp_impl.cc:90-97).  The flowgraph fixes the frame size instead,
so every step runs the same shapes; host input is padded or bucketed up to
it with ``round_up``.
"""

from __future__ import annotations

# Frames that are multiples of 1024 keep every elementwise kernel and FFT
# layout aligned (the JAX package's TPU tile; the port keeps the policy).
ALIGN = 1024

# Default samples per scheduler step: the reference's default correlator
# analysis window (grc/clenabled_clXCorrelate.block.yml).
DEFAULT_FRAME_SIZE = 8192


def round_up(n: int, multiple: int = ALIGN) -> int:
    """Round ``n`` up to a multiple (the shape-bucketing policy)."""
    return -(-n // multiple) * multiple


def validate_frame_size(n: int) -> int:
    if n <= 0:
        raise ValueError(f"frame size must be positive, got {n}")
    return n
