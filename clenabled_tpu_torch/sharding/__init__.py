"""Sharding layer: multi-card execution over a ``torch.distributed`` mesh.

The port of ``clenabled_tpu.sharding`` so far: the data shard across the
ranks of a ``DeviceMesh`` (one process a rank, NCCL on the cards or gloo on
the CPU) and the reference's sequential carried state becomes
communication:

- ``mesh``: ``initialize_distributed`` and ``make_mesh``;
- ``collectives``: ``ring_forward`` (JAX's ``ppermute`` on the forward
  ring), ``all_to_all`` (JAX's tiled ``all_to_all``), ``psum``,
  ``pmean``, ``broadcast``, ``axis_index``, ``axis_size``;
- ``halo``: the time-sharded FIR, overlap-add filter and PFB channelizer,
  a ring halo each, bit-compatible with the sequential filters;
- ``planar_halo``: the planar overlap-add and overlap-save filters, the
  planar and fused oversampled channelizers, each with its ring halo, the
  channel-parallel chunked Costas loops, with no collective, and the
  planar station-sharded X-Engine;
- ``xengine_sharded``: the station-sharded X-Engines (one-shot,
  streaming and stacked-Gram), one ``all_to_all`` from station to channel
  sharding, the Gram kernel on every rank;
- ``chain``: ``ShardedChain``, a linear receive chain of the halo stages,
  with the 1-sample-halo quadrature demod;
- ``xcorr_sharded``: the TD and FD correlators, window-parallel with no
  collective;
- ``launch``: ``spawn``, which starts the ranks of a run, from this
  process or from several launcher processes.

The sharded FX steps are ``pipelines.make_sharded_fx_pipeline[_fused]``.
"""

from clenabled_tpu_torch.sharding.chain import (  # noqa: F401
    ShardedChain,
    make_sharded_quadrature_demod,
)
from clenabled_tpu_torch.sharding.collectives import (  # noqa: F401
    all_to_all,
    axis_index,
    axis_size,
    broadcast,
    pmean,
    psum,
    ring_forward,
)
from clenabled_tpu_torch.sharding.halo import (  # noqa: F401
    make_sharded_channelizer,
    make_sharded_fft_filter,
    make_sharded_fir_filter,
)
from clenabled_tpu_torch.sharding.launch import spawn  # noqa: F401
from clenabled_tpu_torch.sharding.planar_halo import (  # noqa: F401
    make_sharded_channelizer_fused_oversampled,
    make_sharded_channelizer_planar,
    make_sharded_costas_channels,
    make_sharded_fft_filter_planar,
    sharded_xengine_planar,
)
from clenabled_tpu_torch.sharding.mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
)
from clenabled_tpu_torch.sharding.xcorr_sharded import (  # noqa: F401
    make_sharded_fd_xcorr,
    make_sharded_td_xcorr,
)
from clenabled_tpu_torch.sharding.xengine_sharded import (  # noqa: F401
    make_sharded_xengine,
    make_sharded_xengine_stacked,
    sharded_xengine,
)
