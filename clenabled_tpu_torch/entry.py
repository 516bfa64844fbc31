"""Entry points, the port's twins of the JAX package's ``__graft_entry__``.

- ``entry()``: the planar flagship step (4 antennas × 2^17 samples, 16
  channels) on the card, as ``(fn, example_args)``.
- ``dryrun_multichip(n)``: starts n ranks (``sharding.spawn``) and runs one
  step of each sharded leg, at the JAX dry run's shapes:
  leg 1, the complex64 sharded step (4 antennas, 512 samples a rank);
  leg 1b, the fused sharded step on the hand-written FX kernel for each
  ingest dtype (2 antennas, ``fx_tail_len(dtype)`` samples a rank: 1024,
  2048, 4096); leg 2, the time-sharded overlap-add filter (one chunk of
  ones a rank); leg 2b, the planar overlap-save filter on its kernel with
  the input-tail halo (one frame quantum of ones a rank); leg 3, the
  station-sharded X-Engine (2·D stations, 4·D channels, 2 pols, 4 frames
  of complex ones, 2 stations a rank); leg 3b, the stacked X-Engine on
  int8 lanes (8 frames of ones, 4 lanes a rank, scale 1/127²; the Gram
  kernel where the lanes reach 128, else its plain form); leg 3c, the
  fused oversampled channelizer (the 155-tap ``low_pass(1.0, 16.0, 0.5,
  0.25)`` padded to 160, M = 16, R = 8, 1024 samples of ones a rank); leg
  3d, the channel-parallel chunked Costas loops (bandwidth 0.02, order 2,
  chunk 512, warm-up 256) over 2·D channels of a 0.003 rad/sample tone,
  1024 samples; leg 3e, the window-parallel correlators (the TD lag scan,
  max_shift 32, over magnitudes of ones [3, 2D, 512]; the FD correlator
  over vectors of ones [3, 2D, 256] with ``perform_fft_first``).  The JAX
  dry run's leg 4 (two processes over ``jax.distributed``) waits for the
  multi-host tool (ROADMAP.md A.14).
"""

from __future__ import annotations

import numpy as np
import torch

from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import fft_filter, firdes, hopper_kernels, planar
from clenabled_tpu_torch.runtime.device import get_context
from clenabled_tpu_torch.sharding import launch
from clenabled_tpu_torch.sharding.collectives import axis_size
from clenabled_tpu_torch.sharding.halo import make_sharded_fft_filter
from clenabled_tpu_torch.sharding.planar_halo import (
    make_sharded_channelizer_fused_oversampled, make_sharded_costas_channels,
    make_sharded_fft_filter_planar)
from clenabled_tpu_torch.sharding.xcorr_sharded import (
    make_sharded_fd_xcorr, make_sharded_td_xcorr)
from clenabled_tpu_torch.sharding.xengine_sharded import (
    make_sharded_xengine, make_sharded_xengine_stacked)


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
    oplan = hopper_kernels.OfsPlan(taps)
    local_o = fft_filter.frame_quantum(oplan)
    local_o *= max(1, 2048 // local_o)   # a couple of OFS chunks a rank
    init_o, apply_o = make_sharded_fft_filter_planar(taps, mesh,
                                                     use_pallas=True)
    out["2b"] = tuple(apply_o(init_o(), planar.PC(torch.ones(local_o),
                                                   torch.zeros(local_o)))[1])
    d = axis_size(mesh)
    s, f = 2 * d, 4 * d        # multiples of the mesh: any D works
    init_x, apply_x = make_sharded_xengine(
        num_inputs=s, num_channels=f, npol=2, integration_time=4, mesh=mesh)
    _, (out_x, ready_x) = apply_x(init_x(), torch.ones(
        (4, s // d, f, 2), dtype=torch.complex64))
    out["3"] = (out_x, ready_x)
    init_k, apply_k = make_sharded_xengine_stacked(
        num_inputs=s, num_channels=f, npol=2, integration_time=8, mesh=mesh,
        scale=1.0 / 127.0 ** 2)
    lanes = torch.ones((f, 8, 2 * s // d), dtype=torch.int8)
    _, (out_k, ready_k) = apply_k(init_k(), (lanes, lanes))
    out["3b"] = (out_k.re, out_k.im, ready_k)
    proto = firdes.low_pass(1.0, 16.0, 0.5, 0.25)
    proto = np.concatenate([proto, np.zeros((-len(proto)) % 16, np.float32)])
    init_os, apply_os = make_sharded_channelizer_fused_oversampled(
        proto, 16, 8, mesh)
    out["3c"] = tuple(apply_os(init_os(), planar.PC(torch.ones(1024),
                                                     torch.zeros(1024)))[1])
    init_c, apply_c = make_sharded_costas_channels(0.02, 2, mesh, chunk=512,
                                                   warmup=256)
    ph = 0.003 * np.arange(1024, dtype=np.float32)
    xc = planar.PC(torch.from_numpy(np.tile(np.cos(ph), (2 * d, 1))),
                   torch.from_numpy(np.tile(np.sin(ph), (2 * d, 1))))
    _, out_c, diag_c = apply_c(init_c(2 * d), xc)
    out["3d"] = (*out_c, diag_c["residual"])
    b = 2 * d
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
