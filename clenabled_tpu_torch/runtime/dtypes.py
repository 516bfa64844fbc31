"""Stream data-type registry.

The port of ``clenabled_tpu.runtime.dtypes``: the reference's data-type
codes (GRCLBase.h:57-62: ``DTYPE_COMPLEX/FLOAT/INT/SHORT/BYTE/PACKEDXY``),
so block constructors accept the same integer codes, mapped onto torch
dtypes.

- ``DTYPE_COMPLEX``  — complex64 sample stream (gr_complex)
- ``DTYPE_FLOAT``    — float32
- ``DTYPE_INT``      — int32
- ``DTYPE_SHORT``    — int16
- ``DTYPE_BYTE``     — int8 (interleaved I/Q bytes for the X-Engine "IChar"
                       input, lib/clXEngine_impl.cc:843-855)
- ``DTYPE_PACKEDXY`` — packed 4-bit I/Q pairs, two pols per byte-pair
                       (lib/clXEngine_impl.cc:831-858); stored as uint8 and
                       unpacked on the device (dsp.xengine.unpack_packed_4bit)
"""

from __future__ import annotations

import torch

DTYPE_COMPLEX = 1
DTYPE_FLOAT = 2
DTYPE_INT = 3
DTYPE_SHORT = 4
DTYPE_BYTE = 5
DTYPE_PACKEDXY = 6

_TORCH_DTYPES = {
    DTYPE_COMPLEX: torch.complex64,
    DTYPE_FLOAT: torch.float32,
    DTYPE_INT: torch.int32,
    DTYPE_SHORT: torch.int16,
    DTYPE_BYTE: torch.int8,
    DTYPE_PACKEDXY: torch.uint8,
}


def dtype_of(code: int) -> torch.dtype:
    """The torch dtype of a reference data-type code."""
    try:
        return _TORCH_DTYPES[code]
    except KeyError:
        raise ValueError(f"unknown dtype code {code!r}") from None


def itemsize_of(code: int) -> int:
    """Bytes an item for a reference data-type code."""
    return dtype_of(code).itemsize
