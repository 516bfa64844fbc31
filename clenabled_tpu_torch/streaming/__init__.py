"""Streaming runtime: the host ingest driver.  The flowgraph runtime is not
ported yet (ROADMAP.md A.10)."""

from clenabled_tpu_torch.streaming.ingest import (  # noqa: F401
    HostIngest,
    HostIngestStats,
)
