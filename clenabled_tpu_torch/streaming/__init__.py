"""Streaming runtime: the block protocol, the flowgraph and its Runner,
and the host ingest driver.  ``SynchronizedIngest`` (``sync.py``) is not
ported yet (ROADMAP.md A.10)."""

from clenabled_tpu_torch.streaming.block import Block, FunctionBlock  # noqa: F401
from clenabled_tpu_torch.streaming.graph import Flowgraph, Runner  # noqa: F401
from clenabled_tpu_torch.streaming.ingest import (  # noqa: F401
    HostIngest,
    HostIngestStats,
)
