"""Shared handling of the reference's legacy OpenCL device-selection kwargs.

The port of ``clenabled_tpu.blocks._legacy``, unchanged in behaviour."""

from __future__ import annotations

# Device-selector constants, parity with include/clenabled/GRCLBase.h:64-70.
OCLTYPE_GPU = 1
OCLTYPE_ACCELERATOR = 2
OCLTYPE_CPU = 3
OCLTYPE_ANY = 4
OCLDEVICESELECTOR_FIRST = 1
OCLDEVICESELECTOR_SPECIFIC = 2

_LEGACY_KWARGS = (
    "openCLPlatformType",
    "openclPlatform",
    "devSelector",
    "platformId",
    "devId",
    "setDebug",
    "nthreads",
    "idataType",
    "iDataSize",
)


def strip_legacy_kwargs(kwargs: dict, block=None) -> dict:
    """Accept the reference's per-block device tuple (ignored — the
    Runner's one device replaces per-block OpenCL contexts) and raise on
    anything else unexpected.  ``setDebug`` is NOT ignored: when a block
    is given it enables the per-block debug surface (Block.set_debug — the
    reference's setDebug param, lib/GRCLBase.cpp:15)."""
    popped = {}
    for k in _LEGACY_KWARGS:
        if k in kwargs:
            popped[k] = kwargs.pop(k)
    if kwargs:
        raise TypeError(f"unexpected keyword arguments: {sorted(kwargs)}")
    if block is not None and popped.get("setDebug"):
        block.debug = True
    return popped
