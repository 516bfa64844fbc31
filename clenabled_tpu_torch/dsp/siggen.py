"""Signal source — sin/cos generator with carried phase.

The port of ``clenabled_tpu.dsp.siggen`` (reference clSignalSource,
lib/clSignalSource_impl.cc).  The per-index phase ramp (inc·index) mod 2π
is computed once on the host in float64 and kept as float32, so in-frame
error stays at float32 epsilon; the carried phase advances and wraps once
per frame, as the reference's step() does (:280-303).

Waveform codes: SIGSOURCE_COS=1, SIGSOURCE_SIN=2
(lib/clSignalSource_impl.h:27-28).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from clenabled_tpu_torch.dsp import planar as pl_mod
from clenabled_tpu_torch.runtime.device import get_device, per_device

SIGSOURCE_COS = 1
SIGSOURCE_SIN = 2

TWO_PI = 2.0 * math.pi


class SigGenState(NamedTuple):
    """Carried phase (radians, wrapped to ±2π): a 0-d float32 tensor."""
    phase: torch.Tensor


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def make_signal_source(sampling_freq: float, waveform: int, frequency: float,
                       amplitude: float, frame_size: int,
                       dtype=torch.complex64, planar: bool = False,
                       device=None):
    """Build (init_state, generate) for a fixed-shape frame generator.

    generate(state) -> (state', frame) where frame is [frame_size] of
    ``dtype`` (complex64 → cos + j·sin; float32/int32 → the selected
    waveform) on the state's device.  With ``planar=True`` the frame is a
    planar.PC(cos, sin) pair.  init_state() puts the phase on ``device``
    (None: ``cuda:0``, raising when no card is visible)."""
    angle_rate = TWO_PI * frequency / sampling_freq
    # per-index ramp, wrapped in float64 on the host, then cast
    ramp = np.mod(angle_rate * np.arange(frame_size, dtype=np.float64),
                  TWO_PI).astype(np.float32)
    ramp_on = per_device(ramp)
    frame_advance = float(np.float32(math.fmod(angle_rate * frame_size,
                                               TWO_PI)))
    ampl = float(np.float32(amplitude))
    out_dtype = _torch_dtype(dtype)
    dev = get_device("cuda") if device is None else torch.device(device)

    def init_state() -> SigGenState:
        return SigGenState(phase=torch.zeros((), device=dev))

    def generate(state: SigGenState):
        angles = state.phase + ramp_on(state.phase.device)
        if planar:
            frame = pl_mod.PC(ampl * torch.cos(angles), ampl * torch.sin(angles))
        elif out_dtype.is_complex:
            frame = torch.complex(ampl * torch.cos(angles),
                                  ampl * torch.sin(angles)).to(out_dtype)
        else:
            wave = (torch.cos(angles) if waveform == SIGSOURCE_COS
                    else torch.sin(angles))
            frame = (ampl * wave).to(out_dtype)
        new = state.phase + frame_advance
        # wrap to ±2π like the reference's step() loop (:286-296)
        new = torch.where(new > TWO_PI, new - TWO_PI, new)
        new = torch.where(new < -TWO_PI, new + TWO_PI, new)
        return SigGenState(phase=new), frame

    return init_state, generate
