"""Demodulator blocks: QuadratureDemod and CostasLoop.

The port of ``clenabled_tpu.blocks.demod``.  ``CostasLoop`` runs the exact
sequential recurrence on the hand-written kernel
(``hopper_kernels.costas_scalar``); its chunked and multi-stream shapes
are not ported yet (ROADMAP.md A.9).
"""

from __future__ import annotations

import torch

from clenabled_tpu_torch.blocks._legacy import strip_legacy_kwargs
from clenabled_tpu_torch.dsp import demod as dsp_demod
from clenabled_tpu_torch.dsp import planar as pl_mod
from clenabled_tpu_torch.streaming.block import Block


class QuadratureDemod(Block):
    """clQuadratureDemod (lib/clQuadratureDemod_impl.cc): c→f FM/FSK
    discriminator, gain baked, 1-sample carried history.
    planar=True streams planar.PC frames; on a CUDA Runner they go through
    the hand-written kernel (``hopper_kernels.qdemod_fused``)."""

    out_kinds = ("f",)

    def __init__(self, gain: float, planar: bool = False, name: str = "",
                 **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.gain = gain
        self.planar = planar

    def init_state(self):
        if self.planar:
            z = torch.zeros(1)
            return pl_mod.PC(z, z.clone())
        return torch.zeros(1, dtype=torch.complex64)

    def apply(self, state, inputs):
        if self.planar:
            y, last = dsp_demod.quadrature_demod_planar(
                inputs[0], self.gain, last_sample=state)
        else:
            y, last = dsp_demod.quadrature_demod(inputs[0], self.gain,
                                                 last_sample=state)
        return last, (y,), {}


class CostasLoop(Block):
    """clCostasLoop (lib/clCostasLoop_impl.cc): 2nd/4th-order carrier
    recovery.  planar=True streams planar.PC frames.

    The default, ``planar`` and ``scalar=True`` (planar only) shapes all run
    the same exact sequential recurrence, on one kernel on a CUDA Runner.
    ``chunked=True`` (the speculative chunk-parallel form) and
    ``num_streams > 1`` (vmapped loops) raise NotImplementedError: they are
    queued in ROADMAP.md A.9.  The flag conflicts raise the JAX block's
    ValueErrors first."""

    msg_ports = ("lock",)

    def __init__(self, loop_bw: float, order: int, planar: bool = False,
                 chunked: bool = False, chunk: int = 8192,
                 warmup: int = 1024, num_streams: int = 1,
                 scalar: bool = False, name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        del chunk, warmup
        self.name = name
        self.loop_bw = loop_bw
        self.order = order
        self.planar = planar
        self.chunked = chunked
        self.scalar = scalar
        self.num_streams = num_streams
        if chunked and scalar:
            raise ValueError("chunked and scalar are exclusive execution "
                             "shapes — pick one")
        queued = None
        if num_streams > 1:
            if chunked:
                raise ValueError("chunked and num_streams are exclusive")
            if scalar:
                raise ValueError(
                    "scalar and num_streams are exclusive (the sequential "
                    "kernel is single-stream)")
            queued = "CostasLoop(num_streams > 1)"
        elif chunked:
            if not planar:
                raise ValueError("chunked CostasLoop requires planar=True")
            queued = "CostasLoop(chunked=True)"
        elif scalar and not planar:
            raise ValueError("scalar CostasLoop requires planar=True")
        if queued:
            raise NotImplementedError(
                f"{queued} is not ported yet (ROADMAP.md A.9); the exact "
                f"sequential loop (planar and/or scalar) is")
        if planar:
            self._run = dsp_demod.make_costas_loop_planar(loop_bw, order)
        else:
            self._run = dsp_demod.make_costas_loop(loop_bw, order)

    def init_state(self):
        """Zero (phase, freq, error) on the CPU; the Runner moves them."""
        return dsp_demod.costas_init(device="cpu")

    def apply(self, state, inputs):
        state, out = self._run(state, inputs[0])
        return state, (out,), {}
