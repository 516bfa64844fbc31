"""Demodulator blocks: QuadratureDemod and CostasLoop.

The port of ``clenabled_tpu.blocks.demod``.  ``CostasLoop`` runs the exact
sequential recurrence on the hand-written kernel
(``hopper_kernels.costas_scalar``); its chunked and multi-stream shapes run
independent chains of the same kernel body through its batched entry
(``hopper_kernels.costas_batched``).
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

    Execution shapes, each on a hand-written kernel on a CUDA Runner:

    * default, ``planar`` and ``scalar=True`` (planar only): the exact
      sequential recurrence, one chain (``make_costas_loop_planar``);
    * ``chunked=True`` (planar only): the speculative chunk-parallel form
      with seam certificates and exact branch correction
      (``make_costas_loop_chunked``, three batched launches a frame;
      quantum = ``chunk``); publishes each frame's diagnostics on the
      "lock" message port;
    * ``num_streams=N``: N independent loops, one port each, in one
      batched launch a frame (per-channel carrier recovery); planar.PC or
      complex64 frames, the state a ``CostasState`` of [N] tensors.

    The flag conflicts raise the JAX block's ValueErrors, in its order."""

    msg_ports = ("lock",)

    def __init__(self, loop_bw: float, order: int, planar: bool = False,
                 chunked: bool = False, chunk: int = 8192,
                 warmup: int = 1024, num_streams: int = 1,
                 scalar: bool = False, name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.loop_bw = loop_bw
        self.order = order
        self.planar = planar
        self.chunked = chunked
        self.chunk = chunk
        self.warmup = warmup
        self.scalar = scalar
        self.num_streams = num_streams
        if chunked and scalar:
            raise ValueError("chunked and scalar are exclusive execution "
                             "shapes — pick one")
        if num_streams > 1:
            self.n_inputs = self.n_outputs = num_streams
            if chunked:
                raise ValueError("chunked and num_streams are exclusive")
            if scalar:
                raise ValueError(
                    "scalar and num_streams are exclusive (the sequential "
                    "kernel is single-stream; N loops run as N chains of "
                    "the batched kernel)")
            self._run = dsp_demod._make_costas_loop_streams(loop_bw, order,
                                                            planar)
        elif chunked:
            if not planar:
                raise ValueError("chunked CostasLoop requires planar=True")
            self._run = dsp_demod.make_costas_loop_chunked(
                loop_bw, order, chunk=chunk, warmup=warmup)
            self.quantum = chunk
        elif scalar and not planar:
            raise ValueError("scalar CostasLoop requires planar=True")
        elif planar:
            self._run = dsp_demod.make_costas_loop_planar(loop_bw, order)
        else:
            self._run = dsp_demod.make_costas_loop(loop_bw, order)

    def init_state(self):
        """Zeros on the CPU; the Runner moves them: (phase, freq, error),
        of [N] tensors for N streams, with the tail of ``warmup`` zeros
        for the chunked shape."""
        if self.num_streams > 1:
            return dsp_demod.CostasState(
                *(torch.zeros(self.num_streams) for _ in range(3)))
        if self.chunked:
            return self._run.init_state(device="cpu")
        return dsp_demod.costas_init(device="cpu")

    def apply(self, state, inputs):
        if self.num_streams > 1:
            if isinstance(inputs[0], pl_mod.PC):
                fr = pl_mod.PC(torch.stack([x.re for x in inputs]),
                               torch.stack([x.im for x in inputs]))
                state, out = self._run(state, fr)
                outs = tuple(pl_mod.PC(out.re[i], out.im[i])
                             for i in range(self.num_streams))
            else:
                state, out = self._run(state, torch.stack(inputs))
                outs = tuple(out[i] for i in range(self.num_streams))
            return state, outs, {}
        if self.chunked:
            state, out, diag = self._run(state, inputs[0])
            return state, (out,), {"lock": diag}
        state, out = self._run(state, inputs[0])
        return state, (out,), {}
