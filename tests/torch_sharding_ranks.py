"""Rank functions of tests/test_torch_sharding.py.

``sharding.spawn`` pickles a rank function by its import path and every
child process imports its module, so these live apart from the test module
(which imports JAX): this module imports only torch, numpy and the port.

``run_cases(shape, cases)`` runs on every rank of a gloo group.  ``cases``
maps a name to (kind, params, frames), each frame the GLOBAL input of one
step (numpy, time on the last axis); each rank takes its block along the
``"shard"`` axis and returns, per case, its outputs of every chained step
and its carried state (planar cases: (re, im) pairs).  The
channel-parallel Costas loops (``costas_ch``) take each frame's GLOBAL
[C, n] channels and return this rank's channels beside the chunked loop
run on each of them alone.  The window-parallel correlators (``td_xcorr``,
``fd_xcorr``) take each frame's GLOBAL window batch [nsig, B, n], as JAX's
caller passes it, and return this rank's windows' results beside the
unsharded planar function's on the same windows.
"""

from __future__ import annotations

import numpy as np
import torch

from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import demod, planar, xcorr
from clenabled_tpu_torch.runtime.device import get_context
from clenabled_tpu_torch.sharding import (
    axis_index, axis_size, make_sharded_channelizer,
    make_sharded_channelizer_fused_oversampled,
    make_sharded_channelizer_planar, make_sharded_costas_channels,
    make_sharded_fd_xcorr, make_sharded_fft_filter,
    make_sharded_fft_filter_planar, make_sharded_fir_filter, make_mesh,
    make_sharded_td_xcorr, ring_forward)

AXIS = "shard"


def _block(x: np.ndarray, mesh) -> np.ndarray:
    """This rank's time block of a global array."""
    d, i = axis_size(mesh, AXIS), axis_index(mesh, AXIS)
    n = x.shape[-1] // d
    return np.ascontiguousarray(x[..., i * n:(i + 1) * n])


def _stream(init, apply, frames, mesh):
    state = init()
    ys = []
    for x in frames:
        state, y = apply(state, torch.from_numpy(_block(x, mesh)))
        ys.append(y)
    return ys, state


def _stream_planar(init, apply, frames, mesh):
    """Like ``_stream`` for planar frames (re, im): per step (y.re, y.im),
    and the carried (re, im) state."""
    state = init()
    ys = []
    for xr, xi in frames:
        state, y = apply(state, planar.PC(
            *(torch.from_numpy(_block(v, mesh)) for v in (xr, xi))))
        ys.append((y.re, y.im))
    return ys, tuple(state)


def _planar_filter(kind: str, params: dict, frames, mesh):
    if kind == "fft_planar":
        fns = make_sharded_fft_filter_planar(
            params["taps"], mesh, AXIS, params["decimation"],
            use_pallas=params["use_pallas"])
    elif kind == "chan_planar":
        fns = make_sharded_channelizer_planar(
            params["taps"], params["m"], params["r"], list(range(params["m"])),
            mesh, AXIS)
    else:
        fns = make_sharded_channelizer_fused_oversampled(
            params["taps"], params["m"], params["r"], mesh, AXIS)
    return _stream_planar(*fns, frames, mesh)


def _costas_channels(params: dict, frames, mesh):
    """Per frame: ((out.re, out.im), diag, [the chunked loop on each of
    this rank's channels alone]); the carried state; and the error of a
    channel count that the axis size does not divide."""
    kw = dict(chunk=params["chunk"], warmup=params["warmup"])
    init, apply = make_sharded_costas_channels(params["bw"], 2, mesh, AXIS,
                                               **kw)
    one = demod.make_costas_loop_chunked(params["bw"], 2, **kw)
    c = frames[0][0].shape[0]
    k = c // axis_size(mesh, AXIS)
    first = axis_index(mesh, AXIS) * k
    state = init(c)
    singles = [one.init_state(device="cpu") for _ in range(k)]
    outs = []
    for xr, xi in frames:
        state, o, diag = apply(state, planar.PC(torch.from_numpy(xr),
                                                torch.from_numpy(xi)))
        ref = []
        for j in range(k):
            singles[j], oj, dj = one(singles[j], planar.PC(
                torch.from_numpy(xr[first + j]),
                torch.from_numpy(xi[first + j])))
            ref.append((oj.re, oj.im, dj))
        outs.append(((o.re, o.im), diag, ref))
    try:
        init(c + 1)
        refused = None
    except ValueError as e:
        refused = str(e)
    return outs, (tuple(state[0]), tuple(state[1])), refused


def _fx(params, frames, mesh):
    cfg = P.FxPipelineConfig(**params["cfg"])
    fn, (_, hist) = P.make_sharded_fx_pipeline(mesh, cfg=cfg)
    outs = []
    for x in frames:
        o = fn(torch.from_numpy(_block(x, mesh)), hist)
        outs.append(o)
        hist = o[2]
    return outs


def _fused(params, frames, mesh):
    cfg = P.FxPipelineConfig(**params["cfg"])
    dtype = getattr(torch, params["dtype"])
    fn, (_, _, tr, ti) = P.make_sharded_fx_pipeline_fused(mesh, cfg=cfg,
                                                          in_dtype=dtype)
    outs = []
    for xr, xi in frames:
        o = fn(*(torch.from_numpy(_block(x, mesh)).to(dtype)
                 for x in (xr, xi)), tr, ti)
        outs.append(o)
        tr, ti = o[3], o[4]
    return outs


def _xcorr(kind: str, params: dict, frames, mesh):
    """Per frame: (this rank's result, the unsharded planar function's on
    this rank's windows of the global batch)."""
    d, i = axis_size(mesh, AXIS), axis_index(mesh, AXIS)
    outs = []
    for x in frames:
        k = np.shape(x)[-2] // d
        mine = [torch.from_numpy(np.ascontiguousarray(c[:, i * k:(i + 1) * k]))
                for c in (x if kind == "fd_xcorr" else (x,))]
        if kind == "td_xcorr":
            fn = make_sharded_td_xcorr(mesh, params["max_shift"], AXIS)
            outs.append((tuple(fn(x)), tuple(xcorr.td_xcorr_planar_batched(
                mine[0], params["max_shift"]))))
        else:
            fn = make_sharded_fd_xcorr(mesh, AXIS, params["fft_first"])
            v = planar.PC(*(torch.from_numpy(c) for c in x))
            outs.append((fn(v), xcorr.fd_xcorr_planar(planar.PC(*mine),
                                                      params["fft_first"])))
    return outs


def _refused(frames, mesh) -> list:
    """The errors of both correlators given a window batch that the axis
    size does not divide (each frame: mags [nsig, B, n])."""
    msgs = []
    for x in frames:
        for fn, arg in ((make_sharded_td_xcorr(mesh, 8, AXIS), x),
                        (make_sharded_fd_xcorr(mesh, AXIS),
                         planar.PC(torch.from_numpy(x), torch.from_numpy(x)))):
            try:
                fn(arg)
            except ValueError as e:
                msgs.append(str(e))
            else:
                msgs.append(None)
    return msgs


def run_case(kind: str, params: dict, frames, mesh):
    if kind == "ring":
        return [ring_forward(torch.from_numpy(_block(x, mesh)), mesh, AXIS)
                for x in frames]
    if kind == "fir":
        return _stream(*make_sharded_fir_filter(
            params["taps"], mesh, AXIS, params["decimation"]), frames, mesh)
    if kind == "ofa":
        init, apply, _ = make_sharded_fft_filter(params["taps"], mesh, AXIS)
        return _stream(init, apply, frames, mesh)
    if kind == "chan":
        return _stream(*make_sharded_channelizer(
            params["taps"], params["m"], params["r"], list(range(params["m"])),
            mesh, AXIS), frames, mesh)
    if kind in ("fft_planar", "chan_planar", "os_fused"):
        return _planar_filter(kind, params, frames, mesh)
    if kind == "costas_ch":
        return _costas_channels(params, frames, mesh)
    if kind == "fx":
        return _fx(params, frames, mesh)
    if kind == "fused":
        return _fused(params, frames, mesh)
    if kind in ("td_xcorr", "fd_xcorr"):
        return _xcorr(kind, params, frames, mesh)
    if kind == "xcorr_refused":
        return _refused(frames, mesh)
    raise ValueError(f"unknown case kind {kind!r}")


def run_cases(shape, cases: dict) -> dict:
    torch.set_num_threads(1)              # the ranks share the host's cores
    mesh = get_context().mesh if shape is None else make_mesh(shape, "cpu")
    return {"index": axis_index(mesh, AXIS),
            "cases": {name: run_case(kind, params, frames, mesh)
                      for name, (kind, params, frames) in cases.items()}}
