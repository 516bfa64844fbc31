"""Streaming runtime: the block protocol, the flowgraph and its Runner,
the host ingest driver and the multi-stream synchronizer
(``SynchronizedIngest``, which aligns tagged capture streams upstream of
``Runner.run``)."""

from clenabled_tpu_torch.streaming.block import Block, FunctionBlock  # noqa: F401
from clenabled_tpu_torch.streaming.graph import Flowgraph, Runner  # noqa: F401
from clenabled_tpu_torch.streaming.ingest import (  # noqa: F401
    HostIngest,
    HostIngestStats,
)
from clenabled_tpu_torch.streaming.sync import (  # noqa: F401
    StreamSynchronizer,
    SynchronizedIngest,
    SyncPlan,
    TaggedFrame,
)
