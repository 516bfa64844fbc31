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

The X-Engine cases take each frame's GLOBAL stations (time-major
[T, S, F, P]) or lanes (channel-major [F, T, S·P]) and return this rank's
channel slice; the ``all_to_all`` cases take a global array sharded on
dim 0 and return this rank's result; the chain cases take time blocks, as
the halo cases do.  The hand-over cases start from a JAX state the parent
computed, and take this rank's part of it.
"""

from __future__ import annotations

import numpy as np
import torch

from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import demod, planar, xcorr
from clenabled_tpu_torch.runtime.device import get_context
from clenabled_tpu_torch.sharding import (
    ShardedChain, all_to_all, axis_index, axis_size, make_sharded_channelizer,
    make_sharded_channelizer_fused_oversampled,
    make_sharded_channelizer_planar, make_sharded_costas_channels,
    make_sharded_fd_xcorr, make_sharded_fft_filter,
    make_sharded_fft_filter_planar, make_sharded_fir_filter, make_mesh,
    make_sharded_td_xcorr, make_sharded_xengine,
    make_sharded_xengine_stacked, ring_forward, sharded_xengine,
    sharded_xengine_planar)

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


def _rows(x: np.ndarray, mesh, dim: int) -> np.ndarray:
    """This rank's block of a global array along ``dim``."""
    d, i = axis_size(mesh, AXIS), axis_index(mesh, AXIS)
    n = x.shape[dim] // d
    return np.ascontiguousarray(np.take(x, range(i * n, (i + 1) * n), dim))


def _a2a(params: dict, frames, mesh):
    """all_to_all of this rank's dim-0 block of each frame (bfloat16 frames
    come as the float32 that holds them)."""
    dt = getattr(torch, params["dtype"])
    return [all_to_all(torch.from_numpy(_rows(x, mesh, 0)).to(dt), mesh,
                       params["split"], params["concat"], AXIS)
            for x in frames]


def _xengine(params: dict, frames, mesh):
    """The time-major X-Engines on this rank's stations: the one-shot and
    planar forms on frame 0, and the streaming form over every frame (its
    outputs, ready flags and carried count)."""
    s, f, p, t = (params[k] for k in "sfpt")
    mine = [torch.from_numpy(_rows(z, mesh, 1)) for z in frames]
    one = sharded_xengine(mine[0], mesh, AXIS, npol=p)
    pl = sharded_xengine_planar(planar.PC(mine[0].real.contiguous(),
                                          mine[0].imag.contiguous()), mesh,
                                AXIS, npol=p)
    init, apply = make_sharded_xengine(s, f, p, t, mesh, AXIS,
                                       pipeline_integration=2)
    state, steps = init(), []
    for z in mine:
        state, (out, ready) = apply(state, z)
        steps.append((out, ready))
    return one, (pl.re, pl.im), steps, state.count


def _stacked(params: dict, frames, mesh, state=None):
    """The stacked X-Engine on this rank's lanes over every frame: per call
    (out.re, out.im, ready), then the carried (accum.re, accum.im,
    count).  ``state`` (a JAX state's hand-over) replaces init_state()."""
    dt = getattr(torch, params["dtype"])
    init, apply = make_sharded_xengine_stacked(
        params["s"], params["f"], params["p"], params["t"], mesh, AXIS,
        pipeline_integration=params["pipe"], scale=params["scale"],
        use_kernel=params["use_kernel"])
    if state is None:
        state = init()
    outs = []
    for zr, zi in frames:
        state, (out, ready) = apply(state, tuple(
            torch.from_numpy(_rows(z, mesh, 2)).to(dt) for z in (zr, zi)))
        outs.append((out.re, out.im, ready))
    return outs, (state.accum.re, state.accum.im, state.count)


def _chain(params: dict, mesh) -> ShardedChain:
    chain = ShardedChain(mesh, AXIS)
    if params["kind"] == "ofa":
        chain.add_fft_filter(params["taps"]).add_map(lambda x: x * 2.0)
        return chain.add_quadrature_demod(0.7)
    if params["kind"] == "chan":
        return chain.add_channelizer(params["taps"], params["m"],
                                     params["m"], list(range(params["m"])))
    return chain.add_fir_filter(params["taps"], 4).add_quadrature_demod(0.7)


def _chain_run(params: dict, frames, mesh, states=None):
    """The chain over every frame from init_state() (or a JAX state's
    hand-over): per frame this rank's output block, then its states."""
    init, step = _chain(params, mesh).compile()
    if states is None:
        states = init()
    else:
        states = P.sharded_chain_state_from_reference(states, mesh, AXIS)
    ys = []
    for x in frames:
        states, y = step(states, torch.from_numpy(_block(x, mesh)))
        ys.append(y)
    return ys, states


def _xe_refused(mesh) -> list:
    """The divisibility errors of the X-Engine factories and functions (at
    an axis size above 1)."""
    d = axis_size(mesh, AXIS)
    msgs = []
    for call in (
            lambda: make_sharded_xengine(2 * d + 1, 4 * d, 2, 4, mesh, AXIS),
            lambda: make_sharded_xengine(2 * d, 4 * d + 1, 2, 4, mesh, AXIS),
            lambda: make_sharded_xengine_stacked(2 * d, 4 * d + 1, 2, 4, mesh,
                                                 AXIS),
            lambda: make_sharded_xengine_stacked(d + 1, 4 * d, 1, 4, mesh,
                                                 AXIS),
            lambda: sharded_xengine(torch.zeros((4, 2, 4 * d + 1, 2),
                                                dtype=torch.complex64), mesh,
                                    AXIS)):
        try:
            call()
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
    if kind == "a2a":
        return _a2a(params, frames, mesh)
    if kind == "xengine":
        return _xengine(params, frames, mesh)
    if kind == "stacked":
        return _stacked(params, frames, mesh)
    if kind == "stacked_handover":
        re, im, count = params["state"]
        state = P.sharded_xengine_state_from_reference(re, im, count, mesh,
                                                       AXIS)
        return _stacked(params, frames, mesh, state)
    if kind == "chain":
        return _chain_run(params, frames, mesh)
    if kind == "chain_handover":
        return _chain_run(params, frames, mesh, params["states"])
    if kind == "xengine_refused":
        return _xe_refused(mesh)
    raise ValueError(f"unknown case kind {kind!r}")


def run_cases(shape, cases: dict) -> dict:
    torch.set_num_threads(1)              # the ranks share the host's cores
    mesh = get_context().mesh if shape is None else make_mesh(shape, "cpu")
    return {"index": axis_index(mesh, AXIS),
            "cases": {name: run_case(kind, params, frames, mesh)
                      for name, (kind, params, frames) in cases.items()}}
