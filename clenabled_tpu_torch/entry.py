"""Entry points, the port's twins of the JAX package's ``__graft_entry__``.

- ``entry()``: the planar flagship step (4 antennas × 2^17 samples, 16
  channels) on the card, as ``(fn, example_args)``.
- ``dryrun_multichip(n)``: starts n ranks (``sharding.spawn``) and runs one
  step of each sharded leg ported so far, at the JAX dry run's shapes:
  leg 1, the complex64 sharded step (4 antennas, 512 samples a rank);
  leg 1b, the fused sharded step on the hand-written FX kernel for each
  ingest dtype (2 antennas, ``fx_tail_len(dtype)`` samples a rank: 1024,
  2048, 4096); leg 2, the time-sharded overlap-add filter (one chunk of
  ones a rank); leg 3e, the window-parallel correlators (the TD lag scan,
  max_shift 32, over magnitudes of ones [3, 2D, 512]; the FD correlator
  over vectors of ones [3, 2D, 256] with ``perform_fft_first``).  The JAX
  dry run's legs 2b-3d (the planar OFS halo, the station-sharded and
  stacked X-Engines, the sharded oversampled PFB, the sharded Costas
  channels) wait for ``planar_halo``, ``xengine_sharded`` and the chunked
  Costas loop, and leg 4 (two processes over ``jax.distributed``) for the
  multi-host tool (ROADMAP.md A.9, A.12, A.14).
"""

from __future__ import annotations

import torch

from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import firdes, hopper_kernels, planar
from clenabled_tpu_torch.runtime.device import get_context
from clenabled_tpu_torch.sharding import launch
from clenabled_tpu_torch.sharding.collectives import axis_size
from clenabled_tpu_torch.sharding.halo import make_sharded_fft_filter
from clenabled_tpu_torch.sharding.xcorr_sharded import (
    make_sharded_fd_xcorr, make_sharded_td_xcorr)


def entry(device=None):
    """The planar step at 4 × 2^17 (``pipelines.make_fx_pipeline_planar``)
    on ``device`` (None: ``cuda:0``, raising when no card is visible)."""
    cfg = P.FxPipelineConfig(num_antennas=4, num_channels=16,
                             samples_per_step=1 << 17)
    return P.make_fx_pipeline_planar(cfg, device=device)


def _dryrun_rank() -> dict:
    """One step of each ported leg on this rank; its outputs by leg."""
    mesh = get_context().mesh
    out = {}
    cfg = P.FxPipelineConfig(num_antennas=4, num_channels=16,
                             samples_per_step=512)
    fn, args = P.make_sharded_fx_pipeline(mesh, cfg=cfg)
    out["1"] = fn(*args)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        cfg_f = P.FxPipelineConfig(
            num_antennas=2, num_channels=16,
            samples_per_step=hopper_kernels.fx_tail_len(dtype))
        fnf, argsf = P.make_sharded_fx_pipeline_fused(mesh, cfg=cfg_f,
                                                      in_dtype=dtype)
        out[f"1b {hopper_kernels._dtype_name(dtype)}"] = fnf(*argsf)
    taps = firdes.low_pass(1.0, 1e6, 100e3, 20e3)
    init_f, apply_f, plan = make_sharded_fft_filter(taps, mesh)
    out["2"] = apply_f(init_f(), torch.ones(plan.nsamples,
                                            dtype=torch.complex64))
    b = 2 * axis_size(mesh)
    res = make_sharded_td_xcorr(mesh, max_shift=32)(torch.ones((3, b, 512)))
    out["3e td"] = tuple(res)
    fdx = make_sharded_fd_xcorr(mesh, perform_fft_first=True)
    out["3e fd"] = (fdx(planar.PC(torch.ones((3, b, 256)),
                                  torch.zeros((3, b, 256)))),)
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list[dict]:
    """Run the sharded legs once on ``n_devices`` ranks: NCCL on as many
    cards (raises when fewer are visible), or gloo with
    ``device="cpu"``.  Returns each rank's outputs by leg, as numpy."""
    return launch.spawn(_dryrun_rank, n_devices, device)
