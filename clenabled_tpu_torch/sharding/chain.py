"""ShardedChain: a multi-rank streaming receive chain as one object.

The port of ``clenabled_tpu.sharding.chain``.  It composes the halo
factories of ``halo.py`` into a linear chain over one mesh axis, the
distributed analogue of ``Flowgraph`` for the source → filter →
channelize → demod topologies.  Each stage keeps its own carried state and
ring halo; elementwise stages run on this rank's block.

    chain = ShardedChain(mesh)
    chain.add_fft_filter(taps)           # time-sharded OFA with halo
    chain.add_map(lambda x: x * 0.5)     # elementwise, on this rank's block
    chain.add_quadrature_demod(1.0)      # 1-sample halo
    init, step = chain.compile()
    state = init()
    state, y = step(state, x_local)      # this rank's block of L samples

Every rank passes its own time block and gets back its own output block;
the state is a tuple of per-stage states for this rank (``()`` for a
map).  Sequential blocks (Costas) cannot be time-sharded: run them
downstream of a ``Flowgraph`` or on the gathered result.
"""

from __future__ import annotations

from typing import Callable

import torch

from clenabled_tpu_torch.dsp import demod
from clenabled_tpu_torch.runtime.device import mesh_device
from clenabled_tpu_torch.sharding.collectives import axis_index, ring_forward
from clenabled_tpu_torch.sharding.halo import (
    _carry,
    _local,
    make_sharded_channelizer,
    make_sharded_fft_filter,
    make_sharded_fir_filter,
)


def make_sharded_quadrature_demod(gain: float, mesh, axis: str = "shard"):
    """Time-sharded quadrature demod with a 1-sample ring halo (the block's
    set_history(2) across rank boundaries): (init_state, apply).  The state
    is this rank's [1, 1] complex64 row; rank 0 consumes it and keeps the
    last sample of the last rank, which the ring delivers.  The arithmetic
    is ``dsp.demod.quadrature_demod``'s: gain · atan2 of x · conj(prev) in
    float32."""
    dev = mesh_device(mesh)
    idx = axis_index(mesh, axis)

    def init_state():
        return torch.zeros((1, 1), dtype=torch.complex64, device=dev)

    def apply(state, x):
        x = _local(x, dev, 1)
        recv = ring_forward(x[x.shape[-1] - 1:], mesh, axis)
        last, new_state = _carry(state, recv, idx)
        y, _ = demod.quadrature_demod(x, gain, last_sample=last)
        return new_state, y

    return init_state, apply


class ShardedChain:
    """Linear multi-rank streaming chain over one mesh axis."""

    def __init__(self, mesh, axis: str = "shard"):
        self.mesh = mesh
        self.axis = axis
        self._steps: list[tuple[Callable, Callable | None]] = []

    def add_fir_filter(self, taps, decimation: int = 1) -> "ShardedChain":
        init, apply = make_sharded_fir_filter(taps, self.mesh, self.axis,
                                              decimation)
        self._steps.append((apply, init))
        return self

    def add_fft_filter(self, taps, decimation: int = 1) -> "ShardedChain":
        init, apply, _plan = make_sharded_fft_filter(taps, self.mesh,
                                                     self.axis, decimation)
        self._steps.append((apply, init))
        return self

    def add_channelizer(self, taps, num_channels: int, ninputs_per_iter: int,
                        ch_map) -> "ShardedChain":
        init, apply = make_sharded_channelizer(taps, num_channels,
                                               ninputs_per_iter, ch_map,
                                               self.mesh, self.axis)
        self._steps.append((apply, init))
        return self

    def add_quadrature_demod(self, gain: float) -> "ShardedChain":
        init, apply = make_sharded_quadrature_demod(gain, self.mesh,
                                                    self.axis)
        self._steps.append((apply, init))
        return self

    def add_map(self, fn: Callable) -> "ShardedChain":
        """Stateless elementwise stage: a torch callable on this rank's
        block."""
        self._steps.append((lambda state, x: (state, fn(x)), None))
        return self

    def compile(self):
        steps = list(self._steps)

        def init_state():
            return tuple(init() if init is not None else ()
                         for _, init in steps)

        def step(states, x):
            new_states = []
            for (apply, _), st in zip(steps, states):
                st, x = apply(st, x)
                new_states.append(st)
            return tuple(new_states), x

        return init_state, step
