"""Demodulator blocks: QuadratureDemod.

The port of ``clenabled_tpu.blocks.demod``; ``CostasLoop`` waits for its
kernel (ROADMAP.md B.9).
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
