"""Port parity: the sharded steps over ``torch.distributed`` against JAX's.

Three runs of gloo ranks on the CPU (``sharding.spawn``): world sizes 2
and 4 on a 1-D ``"shard"`` mesh, and a 2-D ``{"host": 2, "shard": 2}``
mesh whose ring and sums run over ``"shard"`` (each host row computes the
same stream).  Each run does all of its cases at once
(``torch_sharding_ranks.run_cases``) on the same numpy inputs, made from a
seed, that JAX's sharded functions take on a mesh of as many CPU devices.
Outputs are held to 1e-4 × max|ref| (``tests/test_sharding.py``'s
tolerance), carried tails and ring hops bit for bit, over chained steps.

The fused step with bfloat16 or int8 ingest: the port multiplies in
float32 and JAX's sharded step in bfloat16 (its MXU operands), which
moves its sums past 1e-3 × max|ref|; so the sums are held at 1e-4 to
JAX's unsharded fused step over the joined stream (``mxu_dtype=float32``,
as ``tests/test_torch_pipelines.py`` does), and the carried tails to that
step and to JAX's own sharded step bit for bit.

The window-parallel correlators run in the same spawns: each rank's
result equals the port's unsharded planar function on the same windows bit
for bit, and the ranks' results joined equal JAX's
``make_sharded_{td,fd}_xcorr`` within 1e-4 × max|ref|, lags exactly.  (The
planar DFT matmuls round differently at another batch size, so the
joined result and one call over the whole batch agree within tolerance,
not bit for bit.)

The X-Engines, ``all_to_all`` and ``ShardedChain`` ride the same three
spawns (inputs from their own seed).  ``all_to_all`` equals
``jax.lax.all_to_all(tiled=True)`` bit for bit in every dtype; the int8
stacked X-Engine equals JAX's bit for bit, the other X-Engine forms hold
1e-4 × max|ref|; the chains hold the JAX test's 1e-3 on the demodulated
output, their input-tail states bit for bit.  JAX states handed over
after one call (``pipelines.sharded_{xengine,chain}_state_from_reference``)
continue in the port to JAX's next outputs.

In-process cases run a gloo group of world size 1: there the sharded
steps and filters equal the unsharded ones bit for bit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

try:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from clenabled_tpu import pipelines as J
    from clenabled_tpu import sharding as JS
    from clenabled_tpu.dsp import planar as j_planar
except ImportError:  # a card machine without JAX runs the card tests only
    jax = None

import torch_sharding_ranks as R
from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch import sharding as S
from clenabled_tpu_torch.dsp import channelizer as t_chan
from clenabled_tpu_torch.dsp import demod as t_demod
from clenabled_tpu_torch.dsp import fft_filter as t_ofa
from clenabled_tpu_torch.dsp import fir_filter as t_fir
from clenabled_tpu_torch.dsp import firdes
from clenabled_tpu_torch.dsp import planar as t_planar
from clenabled_tpu_torch.dsp import xcorr as t_xcorr
from clenabled_tpu_torch.entry import dryrun_multichip, entry
from clenabled_tpu_torch.runtime import device as t_device

REL = 1e-4
# world size, mesh shape (None: 1-D "shard" over the world), shard-axis size
SPECS = {"2": (2, None, 2), "4": (4, None, 4),
         "2x2": (4, {"host": 2, "shard": 2}, 2)}
FX_CFG = dict(num_antennas=4, num_channels=16, samples_per_step=512)
FUSED_N = {"float32": 1024, "bfloat16": 2048, "int8": 4096}   # fx_tail_len
# tests/test_sharding.py's channel-parallel Costas loops, 2 frames of n
COSTAS = dict(bw=0.02, chunk=512, warmup=256, n=2048)
LOCKED = 1e-3          # the JAX test's residual bound for a locked frame


def close(got, want, rel=REL):
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


def equal(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want, np.float32))


def _cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _real(rng, dt: str, shape):
    if dt == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    x = rng.standard_normal(shape).astype(np.float32)
    # bfloat16 values, handed over as the float32 that holds them exactly
    return torch.from_numpy(x).to(getattr(torch, dt)).float().numpy()


def _fir_taps(decimation: int):
    if decimation == 1:
        return firdes.low_pass(1.0, 1e6, 100e3, 50e3)
    return firdes.low_pass(1.0, 1e6, 50e3, 25e3)


def _ofa_taps():
    return firdes.root_raised_cosine(1.0, 10e6, 1e6, 0.22, 241)


def _chan_taps(m: int):
    return firdes.low_pass(1.0, float(m), 0.5, 0.25)


def _tone_channels(c: int, n: int, rng):
    """tests/test_sharding.py's Costas channels: a 0.004 rad/sample tone
    at a random phase a channel, planar float32 [c, n]."""
    ph = 0.004 * np.arange(n)[None, :] + rng.uniform(0, 6, (c, 1))
    return np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)


def _planar_cases(spec: str) -> dict:
    """The planar_halo cases (their own seed, so the other cases keep
    their inputs): the channel-parallel Costas loops on every mesh, the
    time-sharded planar filters on the 1-D ones."""
    d = SPECS[spec][2]
    rng = np.random.default_rng(90 + d)
    tones = _tone_channels(2 * d, 2 * COSTAS["n"], rng)
    n = COSTAS["n"]
    cases = {"costas_ch": ("costas_ch", COSTAS, [
        tuple(np.ascontiguousarray(v[:, k * n:(k + 1) * n]) for v in tones)
        for k in range(2)])}
    if spec == "2x2":
        return cases

    def pc(length):
        return (_real(rng, "float32", (length,)),
                _real(rng, "float32", (length,)))

    plan_n = t_ofa.plan_fft_filter(_ofa_taps()).nsamples
    quantum = t_ofa.frame_quantum(_ofs_plan())
    cases["ofa_planar"] = ("fft_planar", {"taps": _ofa_taps(),
                                          "decimation": 1,
                                          "use_pallas": False},
                           [pc(4 * plan_n * d) for _ in range(2)])
    cases["ofs_planar"] = ("fft_planar", {"taps": _fir_taps(1),
                                          "decimation": 1,
                                          "use_pallas": True},
                           [pc(quantum * d) for _ in range(2)])
    cases["chan_planar"] = ("chan_planar", {"taps": _chan_taps(8), "m": 8,
                                            "r": 4},
                            [pc(16 * 8 * d) for _ in range(2)])
    cases["os_fused"] = ("os_fused", {"taps": _os_taps(), "m": 16, "r": 8},
                         [pc(2048 * d) for _ in range(2)])
    return cases


def _ofs_plan():
    from clenabled_tpu_torch.dsp import hopper_kernels

    plan = hopper_kernels.OfsPlan(_fir_taps(1))
    plan.decimation = 1
    return plan


def _os_taps():
    """The fused oversampled channelizer's 155-tap prototype, padded to
    160."""
    proto = _chan_taps(16)
    return np.concatenate([proto, np.zeros((-len(proto)) % 16, np.float32)])


# (split, concat) of the all_to_all cases, and their dtypes
A2A_DIMS = [(0, 2), (2, 1), (2, 0)]
A2A_DTYPES = ["float32", "int8", "bfloat16", "complex64"]
# the time-major X-Engine: frames, stations (a multiple of D), pols
XE_T, XE_P = 8, 2
# the stacked engine's route case: JAX's test_sharded_xengine_stacked_pallas_route
KERNEL_CASE = dict(s=64, p=2, f=4, t=128)


def _a2a_frame(rng, dt: str, d: int):
    shape = (2 * d * d, 3, 2 * d)           # a [2D, 3, 2D] block a rank
    if dt == "complex64":
        return _cplx(rng, *shape)
    return _real(rng, dt, shape)


def _stacked_frames(rng, dt: str, f: int, t: int, sp: int, n: int,
                    span: int = 127):
    def one():
        if dt == "int8":
            return rng.integers(-span, span + 1, (f, t, sp)).astype(np.int8)
        return _real(rng, dt, (f, t, sp))
    return [(one(), one()) for _ in range(n)]


def _chain_params(kind: str) -> dict:
    if kind == "ofa":
        return {"kind": kind, "taps": firdes.low_pass(1.0, 1e6, 100e3, 20e3)}
    if kind == "chan":
        return {"kind": kind, "taps": _chan_taps(8), "m": 8}
    return {"kind": kind, "taps": _fir_taps(4)}


# a rank's block of each chain: 2 OFA chunks, 128 (channelizer), 256 (FIR)
CHAIN_LOCAL = {"ofa": 272, "chan": 128, "fir4": 256}


def _xengine_cases(spec: str) -> dict:
    """The X-Engine, all_to_all and chain cases (their own seed)."""
    d = SPECS[spec][2]
    rng = np.random.default_rng(120 + d + len(spec))
    cases = {}
    for dt in A2A_DTYPES:
        for split, concat in A2A_DIMS:
            cases[f"a2a_{dt}_{split}{concat}"] = (
                "a2a", {"dtype": dt, "split": split, "concat": concat},
                [_a2a_frame(rng, dt, d)])
    s, f = 2 * d, 2 * d
    cases["xengine"] = ("xengine", dict(s=s, f=f, p=XE_P, t=XE_T),
                        [_cplx(rng, XE_T, s, f, XE_P) for _ in range(2)])
    for dt, n in (("int8", 4), ("float32", 4), ("bfloat16", 2)):
        scale = 1.0 / 127.0 ** 2 if dt == "int8" else 1.0
        cases[f"stacked_{dt}"] = ("stacked", dict(
            s=s, f=f, p=2, t=32, dtype=dt, pipe=2, scale=scale,
            use_kernel=None), _stacked_frames(rng, dt, f, 32, 2 * s, n))
    cases["xengine_refused"] = ("xengine_refused", {}, [])
    if spec == "2x2":
        return cases
    k = KERNEL_CASE
    cases["stacked_kernel"] = ("stacked", dict(
        k, dtype="int8", pipe=0, scale=1.0, use_kernel=True),
        _stacked_frames(rng, "int8", k["f"], k["t"], k["s"] * k["p"], 1,
                        span=31))
    for kind, local in CHAIN_LOCAL.items():
        cases[f"chain_{kind}"] = ("chain", _chain_params(kind),
                                  [_cplx(rng, local * d) for _ in range(3)])
    return cases


def _handover_cases(spec: str) -> dict:
    """Cases that continue a JAX state after one call: the stacked int8
    X-Engine (pipeline_integration=2) and the OFA chain; each holds, in
    its params, JAX's global state and JAX's outputs of the next calls."""
    d = SPECS[spec][2]
    jmesh = _jmesh(spec)
    rng = np.random.default_rng(150 + d + len(spec))
    s = f = 2 * d
    params = dict(s=s, f=f, p=2, t=32, dtype="int8", pipe=2,
                  scale=1.0 / 127.0 ** 2, use_kernel=None)
    frames = _stacked_frames(rng, "int8", f, 32, 2 * s, 2)
    jinit, japply = JS.make_sharded_xengine_stacked(
        s, f, 2, 32, jmesh, pipeline_integration=2, scale=params["scale"])
    st, _ = japply(jinit(), tuple(jnp.asarray(z) for z in frames[0]))
    (acc, count) = st
    _, (out, ready) = japply(st, tuple(jnp.asarray(z) for z in frames[1]))
    assert bool(ready)
    params["state"] = (np.asarray(acc.re), np.asarray(acc.im),
                       np.asarray(count))
    params["want"] = (np.asarray(out.re), np.asarray(out.im))
    cases = {"stacked_handover": ("stacked_handover", params, frames[1:])}
    if spec == "2x2":
        return cases
    cp = _chain_params("ofa")
    xs = [_cplx(rng, CHAIN_LOCAL["ofa"] * d) for _ in range(3)]
    jinit, jstep = _jchain(cp, jmesh).compile()
    jst, _ = jstep(jinit(), jnp.asarray(xs[0]))
    cp["states"] = _np_states(jst)
    cp["first"] = xs[0]
    wants = []
    for x in xs[1:]:
        jst, y = jstep(jst, jnp.asarray(x))
        wants.append(np.asarray(y))
    cp["want"] = (wants, _np_states(jst))
    cases["chain_handover"] = ("chain_handover", cp, xs[1:])
    return cases


def _np_states(states):
    return tuple(v if isinstance(v, tuple) else np.asarray(v)
                 for v in states)


def _jchain(params: dict, jmesh):
    chain = JS.ShardedChain(jmesh)
    if params["kind"] == "ofa":
        chain.add_fft_filter(params["taps"]).add_map(lambda x: x * 2.0)
        return chain.add_quadrature_demod(0.7)
    if params["kind"] == "chan":
        return chain.add_channelizer(params["taps"], params["m"],
                                     params["m"], list(range(params["m"])))
    return chain.add_fir_filter(params["taps"], 4).add_quadrature_demod(0.7)


def _cases(spec: str) -> dict:
    """name → (kind, params, global frames) of one run."""
    d = SPECS[spec][2]
    rng = np.random.default_rng(40 + len(spec) + d)
    cases = {
        "ring_float32": ("ring", {}, [rng.standard_normal(
            (3, 5 * d)).astype(np.float32)]),
        "ring_int8": ("ring", {}, [_real(rng, "int8", (2, 7 * d))]),
        "fir_1": ("fir", {"taps": _fir_taps(1), "decimation": 1},
                  [_cplx(rng, 512 * d) for _ in range(3)]),
        "fx": ("fx", {"cfg": FX_CFG},
               [_cplx(rng, 4, 512 * d) for _ in range(2)]),
        "fused_float32": ("fused", {"dtype": "float32", "cfg": dict(
            num_antennas=2, num_channels=16, samples_per_step=1024)},
            [(_real(rng, "float32", (2, 1024 * d)),
              _real(rng, "float32", (2, 1024 * d))) for _ in range(2)]),
    }
    cases["td_xcorr"] = ("td_xcorr", {"max_shift": 16},
                         [np.abs(_cplx(rng, 3, 2 * d, 256))])
    cases["fd_xcorr"] = ("fd_xcorr", {"fft_first": True},
                         [(_real(rng, "float32", (3, 2 * d, 128)),
                           _real(rng, "float32", (3, 2 * d, 128)))])
    cases["xcorr_refused"] = ("xcorr_refused", {},
                              [_real(rng, "float32", (2, 2 * d + 1, 64))])
    cases.update(_planar_cases(spec))
    cases.update(_xengine_cases(spec))
    if spec == "2x2":
        return cases
    cases["fir_4"] = ("fir", {"taps": _fir_taps(4), "decimation": 4},
                      [_cplx(rng, 1024 * d) for _ in range(2)])
    plan_n = t_ofa.plan_fft_filter(_ofa_taps()).nsamples
    cases["ofa"] = ("ofa", {"taps": _ofa_taps()},
                    [_cplx(rng, 4 * plan_n * d) for _ in range(3)])
    for r in (8, 4):
        cases[f"chan_8_{r}"] = ("chan", {"taps": _chan_taps(8), "m": 8, "r": r},
                                [_cplx(rng, 16 * 8 * d) for _ in range(2)])
    for dt in ("bfloat16", "int8"):
        n = FUSED_N[dt]
        cases[f"fused_{dt}"] = ("fused", {"dtype": dt, "cfg": dict(
            num_antennas=2, num_channels=16, samples_per_step=n)},
            [(_real(rng, dt, (2, n * d)), _real(rng, dt, (2, n * d)))
             for _ in range(2)])
    return cases


@pytest.fixture(scope="module")
def runs():
    """spec → (cases, rows): the ranks' results of one spawn, in host rows
    ordered by shard index."""
    if jax is None:
        pytest.skip("needs JAX, the reference")
    done = {}

    def get(spec: str):
        if spec not in done:
            world, shape, d = SPECS[spec]
            cases = _cases(spec)
            cases.update(_handover_cases(spec))
            res = S.spawn(R.run_cases, world, "cpu", shape, cases)
            rows = [res[h * d:(h + 1) * d] for h in range(world // d)]
            for row in rows:
                assert [r["index"] for r in row] == list(range(d))
            done[spec] = cases, [[r["cases"] for r in row] for row in rows]
        return done[spec]

    return get


def _jmesh(spec: str):
    world, shape, _ = SPECS[spec]
    return JS.make_mesh(shape, devices=jax.devices()[:world])


def _joined(row, name: str, pick):
    """A time-sharded output of every step, its rank blocks joined."""
    steps = len(row[0][name][0])
    return [np.concatenate([pick(r[name], k) for r in row], axis=0)
            for k in range(steps)]


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_ring_forward(runs, spec, dt):
    cases, rows = runs(spec)
    (x,) = cases[f"ring_{dt}"][2]
    jmesh = _jmesh(spec)
    d = jmesh.shape["shard"]
    spec_p = PartitionSpec(None, "shard")
    hop = jax.jit(jax.shard_map(
        lambda v: jax.lax.ppermute(v, "shard",
                                   [(j, (j + 1) % d) for j in range(d)]),
        mesh=jmesh, in_specs=spec_p, out_specs=spec_p))
    want = np.asarray(hop(jnp.asarray(x)))
    for row in rows:
        got = np.concatenate([r[f"ring_{dt}"][0] for r in row], axis=-1)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _check_stream(row, name, frames, jinit, japply, exact_state=True):
    """Chained frames through JAX's sharded filter: outputs joined over
    the ranks within 1e-4, the [D, K-1] state row by row bit for bit (an
    input tail) or within 1e-4 (the overlap-add's output tail)."""
    got = _joined(row, name, lambda c, k: c[0][k])
    state = jinit()
    for k, x in enumerate(frames):
        state, want = japply(state, x)
        close(got[k], want)
    mine = np.concatenate([r[name][1] for r in row])
    if exact_state:
        equal(mine.view(np.float32), np.asarray(state).view(np.float32))
    else:
        close(mine, state)


@pytest.mark.parametrize("spec,decimation",
                         [("2", 1), ("2", 4), ("4", 1), ("4", 4), ("2x2", 1)])
def test_sharded_fir(runs, spec, decimation):
    cases, rows = runs(spec)
    name = f"fir_{decimation}"
    jinit, japply = JS.make_sharded_fir_filter(
        _fir_taps(decimation), _jmesh(spec), decimation=decimation)
    for row in rows:
        _check_stream(row, name, cases[name][2], jinit, japply)


@pytest.mark.parametrize("spec", ["2", "4"])
def test_sharded_ofa(runs, spec):
    cases, rows = runs(spec)
    jinit, japply, _ = JS.make_sharded_fft_filter(_ofa_taps(), _jmesh(spec))
    _check_stream(rows[0], "ofa", cases["ofa"][2], jinit, japply,
                  exact_state=False)


@pytest.mark.parametrize("spec", ["2", "4"])
@pytest.mark.parametrize("r", [8, 4])
def test_sharded_channelizer(runs, spec, r):
    cases, rows = runs(spec)
    jinit, japply = JS.make_sharded_channelizer(
        _chan_taps(8), 8, r, list(range(8)), _jmesh(spec))
    _check_stream(rows[0], f"chan_8_{r}", cases[f"chan_8_{r}"][2], jinit,
                  japply)


def _check_planar(row, name, frames, jinit, japply, exact_state=True):
    """``_check_stream`` for planar frames and (re, im) states."""
    got = _joined(row, name, lambda c, k: c[0][k][0] + 1j * c[0][k][1])
    state = jinit()
    for k, (xr, xi) in enumerate(frames):
        state, want = japply(state, j_planar.PC(jnp.asarray(xr),
                                                jnp.asarray(xi)))
        close(got[k], np.asarray(want.re) + 1j * np.asarray(want.im))
    for c in (0, 1):
        mine = np.concatenate([r[name][1][c] for r in row])
        if exact_state:
            equal(mine, np.asarray(state[c]))
        else:
            close(mine, state[c])


@pytest.mark.parametrize("spec", ["2", "4"])
@pytest.mark.parametrize("name", ["ofa_planar", "ofs_planar", "chan_planar",
                                  "os_fused"])
def test_sharded_planar_halo(runs, spec, name):
    """The planar sharded filters against JAX's on as many CPU devices:
    overlap-add (its output tail within 1e-4), overlap-save with JAX's
    ``use_pallas=True`` in interpret mode, the oversampled planar
    channelizer and the fused oversampled channelizer (input tails bit for
    bit)."""
    cases, rows = runs(spec)
    _, params, frames = cases[name]
    jmesh = _jmesh(spec)
    if name in ("ofa_planar", "ofs_planar"):
        jinit, japply = JS.make_sharded_fft_filter_planar(
            params["taps"], jmesh, decimation=params["decimation"],
            use_pallas=params["use_pallas"])
    elif name == "chan_planar":
        jinit, japply = JS.make_sharded_channelizer_planar(
            params["taps"], params["m"], params["r"],
            list(range(params["m"])), jmesh)
    else:
        jinit, japply = JS.make_sharded_channelizer_fused_oversampled(
            params["taps"], params["m"], params["r"], jmesh)
    _check_planar(rows[0], name, frames, jinit, japply,
                  exact_state=name != "ofa_planar")


@pytest.mark.parametrize("spec", list(SPECS))
def test_sharded_costas_channels(runs, spec):
    """The channel-parallel chunked Costas loops against JAX's on as many
    CPU devices (a channel locked on both sides within 1e-4 × max|ref|
    with the same branch hops, else flagged on both; the carried tails bit
    for bit); on every rank each
    channel bit for bit the port's chunked loop run on it alone; a channel
    count the axis does not divide raises."""
    cases, rows = runs(spec)
    _, params, frames = cases["costas_ch"]
    d = SPECS[spec][2]
    jinit, japply = JS.make_sharded_costas_channels(
        params["bw"], 2, _jmesh(spec), chunk=params["chunk"],
        warmup=params["warmup"])
    c = frames[0][0].shape[0]
    jst = jinit(c)
    for k, (xr, xi) in enumerate(frames):
        jst, jo, jd = japply(jst, j_planar.PC(jnp.asarray(xr),
                                              jnp.asarray(xi)))
        want = np.asarray(jo.re) + 1j * np.asarray(jo.im)
        for row in rows:
            got = np.concatenate([r["costas_ch"][0][k][0][0]
                                  + 1j * r["costas_ch"][0][k][0][1]
                                  for r in row])
            diag = {key: np.concatenate([r["costas_ch"][0][k][1][key]
                                         for r in row]) for key in jd}
            j_res = np.asarray(jd["residual"])
            for ch in range(c):        # locked on both sides, or flagged
                if diag["residual"][ch] < LOCKED and j_res[ch] < LOCKED:
                    close(got[ch], want[ch])
                    assert diag["branch_hops"][ch] == np.asarray(
                        jd["branch_hops"])[ch]
                else:
                    assert min(diag["residual"][ch], j_res[ch]) >= LOCKED
            for r in row:
                (o_r, o_i), mine, ref = r["costas_ch"][0][k]
                for j, (rr, ri, dj) in enumerate(ref):
                    equal(o_r[j], rr)
                    equal(o_i[j], ri)
                    for key, v in dj.items():
                        assert mine[key][j] == v, (key, j)
    for row in rows:
        tails = [np.concatenate([r["costas_ch"][1][1][i] for r in row])
                 for i in (0, 1)]
        equal(tails[0], np.asarray(jst[1].re))
        equal(tails[1], np.asarray(jst[1].im))
        freq = np.concatenate([r["costas_ch"][1][0][1] for r in row])
        np.testing.assert_allclose(freq, np.asarray(jst[0].freq), atol=1e-6)
        for r in row:
            assert r["costas_ch"][2] == (f"channels {c + 1} not a multiple "
                                         f"of mesh size {d}")
    with pytest.raises(ValueError, match="not a multiple"):
        jinit(c + 1)


@pytest.mark.parametrize("spec", list(SPECS))
def test_sharded_fx_pipeline(runs, spec):
    cases, rows = runs(spec)
    jfn, (_, hist) = J.make_sharded_fx_pipeline(
        _jmesh(spec), cfg=J.FxPipelineConfig(**FX_CFG))
    for k, x in enumerate(cases["fx"][2]):
        fd, xmat, hist = jfn(x, hist)
        for row in rows:
            for r in row:                  # replicated on every rank
                got = r["fx"][k]
                close(got[0], fd)
                close(got[1], xmat)
                equal(got[2].view(np.float32),
                      np.asarray(hist).view(np.float32))


def _jax_fused_steps(fn, tails, frames, dt):
    tr, ti = tails
    outs = []
    for xr, xi in frames:
        o = fn(jnp.asarray(xr.astype(dt)), jnp.asarray(xi.astype(dt)), tr, ti)
        outs.append([np.asarray(v, np.float32) for v in o])
        tr, ti = o[3], o[4]
    return outs


def _jax_sharded_fused(spec, dt, cfg, frames):
    """JAX's sharded fused step over the frames."""
    fn, (_, _, tr, ti) = J.make_sharded_fx_pipeline_fused(
        _jmesh(spec), cfg=J.FxPipelineConfig(**cfg), in_dtype=jnp.dtype(dt),
        interpret=True)
    return _jax_fused_steps(fn, (tr, ti), frames, dt)


@pytest.mark.parametrize("spec,dt", [("2", "float32"), ("2", "bfloat16"),
                                     ("2", "int8"), ("4", "float32"),
                                     ("4", "bfloat16"), ("4", "int8"),
                                     ("2x2", "float32")])
def test_sharded_fused(runs, spec, dt):
    cases, rows = runs(spec)
    _, params, frames = cases[f"fused_{dt}"]
    cfg = params["cfg"]
    d = SPECS[spec][2]
    sharded = _jax_sharded_fused(spec, dt, cfg, frames)
    if dt == "float32":
        ref = sharded
    else:
        # the unsharded step over the joined stream, float32 operands
        whole = dict(cfg, samples_per_step=cfg["samples_per_step"] * d)
        jfn, (_, _, tr, ti) = J.make_fx_pipeline_fused(
            J.FxPipelineConfig(**whole), in_dtype=jnp.dtype(dt),
            interpret=True, mxu_dtype=jnp.float32)
        ref = _jax_fused_steps(jfn, (tr, ti), frames, dt)
    for k in range(len(frames)):
        for row in rows:
            for r in row:                  # replicated on every rank
                got = r[f"fused_{dt}"][k]
                for g, w in zip(got[:3], ref[k][:3]):
                    close(g, w)
                for i in (3, 4):           # the tails: both references
                    equal(got[i], ref[k][i])
                    equal(got[i], sharded[k][i])


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("kind", ["td_xcorr", "fd_xcorr"])
def test_sharded_xcorr(runs, spec, kind):
    cases, rows = runs(spec)
    _, params, (x,) = cases[kind]
    jmesh = _jmesh(spec)
    if kind == "td_xcorr":
        res = JS.make_sharded_td_xcorr(jmesh, params["max_shift"])(
            jnp.asarray(x))
        want = [np.asarray(v) for v in res]
    else:
        from clenabled_tpu.dsp import planar as j_planar
        want = [np.asarray(JS.make_sharded_fd_xcorr(
            jmesh, perform_fft_first=params["fft_first"])(
                j_planar.PC(jnp.asarray(x[0]), jnp.asarray(x[1]))))]
    def parts(r):
        return [list(v) if kind == "td_xcorr" else [v] for v in r[kind][0]]

    for row in rows:
        for r in row:                    # (sharded, unsharded) on a block
            sharded, unsharded = parts(r)
            for g, u in zip(sharded, unsharded):
                assert g.dtype == u.dtype
                np.testing.assert_array_equal(g, u)
        for j, w in enumerate(want):
            got = np.concatenate([parts(r)[0][j] for r in row], axis=1)
            assert got.dtype == w.dtype and got.shape == w.shape
            if got.dtype == np.int32:
                np.testing.assert_array_equal(got, w)
            else:
                close(got, w)


@pytest.mark.parametrize("spec", list(SPECS))
def test_sharded_xcorr_batch_must_divide(runs, spec):
    """A window batch B that the axis size D does not divide raises on
    every rank, for both correlators, as JAX's checked functions do."""
    cases, rows = runs(spec)
    d = SPECS[spec][2]
    (x,) = cases["xcorr_refused"][2]
    with pytest.raises(ValueError, match="multiple of the mesh axis size"):
        JS.make_sharded_td_xcorr(_jmesh(spec), 8)(jnp.asarray(x))
    want = (f"window batch {2 * d + 1} must be a multiple of the mesh axis "
            f"size {d}")
    for row in rows:
        for r in row:
            assert r["xcorr_refused"] == [want, want]


def _jax_a2a(jmesh, x, split: int, concat: int, dt: str):
    spec_p = PartitionSpec("shard")
    fn = jax.jit(jax.shard_map(
        lambda v: jax.lax.all_to_all(v, "shard", split, concat, tiled=True),
        mesh=jmesh, in_specs=spec_p, out_specs=spec_p))
    return np.asarray(fn(jnp.asarray(x, jnp.dtype(dt))).astype(
        jnp.float32 if dt == "bfloat16" else jnp.dtype(dt)))


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("dt", A2A_DTYPES)
@pytest.mark.parametrize("dims", A2A_DIMS, ids=lambda v: f"{v[0]}{v[1]}")
def test_all_to_all(runs, spec, dt, dims):
    """This rank's dim-0 block through ``all_to_all``, the ranks' results
    joined on dim 0, equal ``jax.lax.all_to_all(tiled=True)`` under
    shard_map bit for bit (on the 2 × 2 mesh the exchange runs over
    "shard", in that axis's order)."""
    cases, rows = runs(spec)
    name = f"a2a_{dt}_{dims[0]}{dims[1]}"
    (x,) = cases[name][2]
    want = _jax_a2a(_jmesh(spec), x, *dims, dt)
    for row in rows:
        got = np.concatenate([r[name][0] for r in row], axis=0)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _joined_rows(row, pick):
    """A channel-sharded output, the ranks' slices joined on dim 0."""
    return np.concatenate([pick(r) for r in row], axis=0)


@pytest.mark.parametrize("spec", list(SPECS))
def test_sharded_xengine(runs, spec):
    """The one-shot, planar and streaming (2 calls, ready flags)
    station-sharded X-Engines against JAX's within 1e-4 × max|ref|."""
    cases, rows = runs(spec)
    params, frames = cases["xengine"][1:]
    jmesh = _jmesh(spec)
    z0 = jnp.asarray(frames[0])
    one = np.asarray(JS.sharded_xengine(z0, jmesh, npol=XE_P))
    pl = JS.sharded_xengine_planar(j_planar.PC(z0.real, z0.imag), jmesh,
                                   npol=XE_P)
    jinit, japply = JS.make_sharded_xengine(
        params["s"], params["f"], XE_P, XE_T, jmesh, pipeline_integration=2)
    jst, steps = jinit(), []
    for z in frames:
        jst, (out, ready) = japply(jst, jnp.asarray(z))
        steps.append((np.asarray(out), bool(ready)))
    assert [r for _, r in steps] == [False, True]
    for row in rows:
        close(_joined_rows(row, lambda r: r["xengine"][0]), one)
        close(_joined_rows(row, lambda r: r["xengine"][1][0]
                           + 1j * r["xengine"][1][1]),
              np.asarray(pl.re) + 1j * np.asarray(pl.im))
        for k, (want, ready) in enumerate(steps):
            for r in row:
                assert r["xengine"][2][k][1] is ready
            got = _joined_rows(row, lambda r: r["xengine"][2][k][0])
            if ready:
                close(got, want)
            else:
                assert not got.any() and not want.any()
        assert all(r["xengine"][3] == int(jst[1]) == 0 for r in row)


def _jax_stacked(params: dict, frames, jmesh):
    dt = params["dtype"]
    jinit, japply = JS.make_sharded_xengine_stacked(
        params["s"], params["f"], params["p"], params["t"], jmesh,
        pipeline_integration=params["pipe"], scale=params["scale"],
        use_pallas=params["use_kernel"])
    st, outs = jinit(), []
    for zr, zi in frames:
        st, (out, ready) = japply(st, (jnp.asarray(zr, jnp.dtype(dt)),
                                       jnp.asarray(zi, jnp.dtype(dt))))
        outs.append((np.asarray(out.re), np.asarray(out.im), bool(ready)))
    return outs, st


def _check_stacked(row, name, outs, st, exact: bool):
    same = ((lambda g, w: np.testing.assert_array_equal(g, w)) if exact
            else close)
    for k, (wr, wi, ready) in enumerate(outs):
        for r in row:
            assert r[name][0][k][2] is ready
        same(_joined_rows(row, lambda r: r[name][0][k][0]), wr)
        same(_joined_rows(row, lambda r: r[name][0][k][1]), wi)
    (acc, count) = st
    if np.asarray(acc.re).any():
        same(_joined_rows(row, lambda r: r[name][1][0]), np.asarray(acc.re))
    else:
        assert not any(r[name][1][0].any() for r in row)
    assert all(r[name][1][2] == int(count) for r in row)


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("dt", ["int8", "float32", "bfloat16"])
def test_sharded_xengine_stacked(runs, spec, dt):
    """The stacked X-Engine on each rank's lane block, pipeline_integration
    2: int8 bit for bit against JAX's sharded engine (emissions, flags,
    the carried accumulator and count), float32 and bfloat16 within
    1e-4 × max|ref|."""
    cases, rows = runs(spec)
    name = f"stacked_{dt}"
    params, frames = cases[name][1:]
    outs, st = _jax_stacked(params, frames, _jmesh(spec))
    assert [r for *_, r in outs] == [k % 2 == 1 for k in range(len(frames))]
    for row in rows:
        _check_stacked(row, name, outs, st, exact=dt == "int8")


@pytest.mark.parametrize("spec", ["2", "4"])
def test_sharded_xengine_stacked_kernel_route(runs, spec):
    """S·P = 128 with ``use_kernel=True`` (the Gram kernel's wrapper, its
    plain form on the CPU) against JAX's ``use_pallas=True`` (the Pallas
    Gram in interpret mode), int8, bit for bit
    (``tests/test_sharding.py:497``'s shapes)."""
    cases, rows = runs(spec)
    params, frames = cases["stacked_kernel"][1:]
    outs, st = _jax_stacked(params, frames, _jmesh(spec))
    assert [r for *_, r in outs] == [True]
    for row in rows:
        _check_stacked(row, "stacked_kernel", outs, st, exact=True)


@pytest.mark.parametrize("spec", list(SPECS))
def test_sharded_xengine_state_handover(runs, spec):
    """A JAX sharded stacked X-Engine stopped after one call of
    pipeline_integration=2, its global state handed to each rank
    (``sharded_xengine_state_from_reference``): the port's next call
    emits JAX's matrix bit for bit."""
    cases, rows = runs(spec)
    params = cases["stacked_handover"][1]
    for row in rows:
        for r in row:
            assert r["stacked_handover"][0][0][2] is True
        for c in (0, 1):
            np.testing.assert_array_equal(
                _joined_rows(row, lambda r: r["stacked_handover"][0][0][c]),
                params["want"][c])


# the demodulator's input samples whose angle the audio check reads: a
# sample whose own or predecessor's magnitude is below this fraction of
# the stream's largest is mostly rounding noise, and its angle differs
# between any two FFTs; such samples may lie only in the filter's ramp
# from its zero state (the first tap of firdes.low_pass(1.0, 1e6, 100e3,
# 20e3) is -6e-19), the stream's first DEMOD_RAMP samples
DEMOD_FLOOR = 1e-3
DEMOD_RAMP = 16


def _demod_masks(params: dict, frames, jmesh) -> list:
    """Per frame, where the audio is held: the samples whose demodulator
    input (JAX's chain without its demod stage, over the same frames from
    its zero state) and its predecessor lie above DEMOD_FLOOR × max."""
    if params["kind"] == "chan":
        return [None] * len(frames)
    chain = JS.ShardedChain(jmesh)
    if params["kind"] == "ofa":
        chain.add_fft_filter(params["taps"]).add_map(lambda x: x * 2.0)
    else:
        chain.add_fir_filter(params["taps"], 4)
    init, step = chain.compile()
    st, vs = init(), []
    for x in frames:
        st, v = step(st, jnp.asarray(x))
        vs.append(np.abs(np.asarray(v)))
    v = np.concatenate(vs)
    floor = DEMOD_FLOOR * v.max()
    held = np.minimum(v, np.concatenate([[0.0], v[:-1]])) >= floor
    assert (np.flatnonzero(~held) < DEMOD_RAMP).all()
    return np.split(held, np.cumsum([len(u) for u in vs])[:-1])


def _check_chain(row, name, ys_want, states_want, kind, masks):
    for k, want in enumerate(ys_want):
        got = np.concatenate([r[name][0][k] for r in row], axis=0)
        if masks[k] is None:
            close(got, want)
        else:
            assert got.shape == want.shape
            close(got[masks[k]], want[masks[k]], rel=1e-3)
    for i, want in enumerate(states_want):
        if isinstance(want, tuple):
            assert all(r[name][1][i] == () for r in row)
            continue
        got = np.concatenate([r[name][1][i] for r in row])
        if i == 0 and kind != "ofa":       # an input tail: bit for bit
            equal(got.view(np.float32), np.asarray(want).view(np.float32))
        else:                              # a filter's output sample
            close(got, want)


@pytest.mark.parametrize("spec", ["2", "4"])
@pytest.mark.parametrize("kind", list(CHAIN_LOCAL))
def test_sharded_chain(runs, spec, kind):
    """``ShardedChain`` against JAX's over 3 frames: OFA → ×2 → demod and
    FIR (decimation 4) → demod at the JAX test's 1e-3 on the audio (where
    the demodulator's input is above its rounding noise,
    ``_demod_masks``), the channelizer at 1e-4; the FIR and channelizer
    input tails bit for bit, the states that hold filter outputs within
    1e-4."""
    cases, rows = runs(spec)
    params, frames = cases[f"chain_{kind}"][1:]
    jmesh = _jmesh(spec)
    jinit, jstep = _jchain(params, jmesh).compile()
    jst, wants = jinit(), []
    for x in frames:
        jst, y = jstep(jst, jnp.asarray(x))
        wants.append(np.asarray(y))
    _check_chain(rows[0], f"chain_{kind}", wants, _np_states(jst), kind,
                 _demod_masks(params, frames, jmesh))


@pytest.mark.parametrize("spec", ["2", "4"])
def test_sharded_chain_state_handover(runs, spec):
    """JAX's OFA chain stopped after one frame, its per-stage [D, K]
    states handed to each rank (``sharded_chain_state_from_reference``):
    the port's next two frames and final states are JAX's."""
    cases, rows = runs(spec)
    params, frames = cases["chain_handover"][1:]
    ys_want, states_want = params["want"]
    masks = _demod_masks(params, [params["first"]] + frames, _jmesh(spec))
    _check_chain(rows[0], "chain_handover", ys_want, states_want, "ofa",
                 masks[1:])


@pytest.mark.parametrize("spec", list(SPECS))
def test_sharded_xengine_divisibility(runs, spec):
    """The X-Engine factories' and the one-shot function's divisibility
    errors are JAX's ``ValueError``s, with its messages."""
    cases, rows = runs(spec)
    d = SPECS[spec][2]
    jmesh = _jmesh(spec)
    want = []
    for call in (
            lambda: JS.make_sharded_xengine(2 * d + 1, 4 * d, 2, 4, jmesh),
            lambda: JS.make_sharded_xengine(2 * d, 4 * d + 1, 2, 4, jmesh),
            lambda: JS.make_sharded_xengine_stacked(2 * d, 4 * d + 1, 2, 4,
                                                    jmesh),
            lambda: JS.make_sharded_xengine_stacked(d + 1, 4 * d, 1, 4,
                                                    jmesh),
            lambda: JS.sharded_xengine(jnp.zeros((4, 2 * d, 4 * d + 1, 2),
                                                 jnp.complex64), jmesh)):
        with pytest.raises(ValueError) as e:
            call()
        want.append(str(e.value))
    for row in rows:
        for r in row:
            assert r["xengine_refused"] == want


# --------------------------------------------------------------------------
# In-process: a gloo group of world size 1
# --------------------------------------------------------------------------

@pytest.fixture
def world1():
    """A 1-D CPU mesh over a gloo group of one rank, torn down after."""
    with tempfile.TemporaryDirectory() as workdir:
        S.initialize_distributed("cpu", f"file://{workdir}/store", 1, 0)
        try:
            yield S.make_mesh(device="cpu")
        finally:
            dist.destroy_process_group()


def _gloo_threads() -> int:
    """This process's gloo threads (device loops and process-group
    workers), by their names under /proc."""
    names = []
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                names.append(f.read().strip())
        except OSError:
            pass
    return sum(n.startswith(("gloo", "pt_gloo")) for n in names)


def test_shutdown_distributed_ends_the_gloo_threads():
    """A rank's teardown (``S.shutdown_distributed``, as ``spawn``'s ranks
    end) stops the group's gloo threads, though the shared context had
    cached the mesh and the group: a destroyed group that the context
    still held kept them running into interpreter exit, where a rank whose
    peer had closed its sockets aborted."""
    from clenabled_tpu_torch.runtime.device import get_context

    before = _gloo_threads()
    with tempfile.TemporaryDirectory() as workdir:
        S.initialize_distributed("cpu", f"file://{workdir}/store", 1, 0)
        try:
            assert get_context().num_devices == 1
            assert _gloo_threads() > before
        finally:
            S.shutdown_distributed()
    assert _gloo_threads() == before


def _seeded(dt: str, shape, seed: int, n: int = 2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(_real(rng, dt, shape)).to(getattr(torch, dt))
            for _ in range(n)]


@pytest.mark.parametrize("dt,channels", [
    ("float32", 16), ("bfloat16", 16), ("int8", 16), ("float32", 64),
    ("int8", 64)], ids=["float32", "bfloat16", "int8", "float32_m64",
                        "int8_m64"])
def test_world1_fused_equals_unsharded(world1, dt, channels):
    """One rank's sharded fused step equals the unsharded step bit for bit
    over two chained steps, its tail the unsharded one's: fx_tail_len
    with the prototype, 2048 and 4096 samples at 64 channels (1600 taps,
    fx_wide_kernel's on a card)."""
    n = FUSED_N[dt] if channels == 16 else max(FUSED_N[dt], 2048)
    cfg = P.FxPipelineConfig(num_antennas=2, num_channels=channels,
                             samples_per_step=n)
    sfn, (_, _, str_, sti) = P.make_sharded_fx_pipeline_fused(
        world1, cfg=cfg, in_dtype=getattr(torch, dt))
    ufn, (_, _, utr, uti) = P.make_fx_pipeline_fused(
        cfg, in_dtype=getattr(torch, dt), device="cpu")
    assert str_.shape == utr.shape and str_.dtype == utr.dtype
    if channels == 64:
        assert str_.shape[-1] == {"float32": 2048, "int8": 4096}[dt]
    for step in range(2):
        xr, xi = _seeded(dt, (2, n), 60 + step)
        so = sfn(xr, xi, str_, sti)
        uo = ufn(xr, xi, utr, uti)
        for g, w in zip(so, uo):
            assert g.dtype == w.dtype and torch.equal(g, w)
        str_, sti, utr, uti = so[3], so[4], uo[3], uo[4]


def test_world1_fx_pipeline_equals_unsharded(world1):
    cfg = P.FxPipelineConfig(**FX_CFG)
    sfn, (_, sh) = P.make_sharded_fx_pipeline(world1, cfg=cfg)
    ufn, (_, uh) = P.make_fx_pipeline(cfg, device="cpu")
    rng = np.random.default_rng(61)
    for _ in range(2):
        x = torch.from_numpy(_cplx(rng, 4, 512))
        so, uo = sfn(x, sh), ufn(x, uh)
        for g, w in zip(so, uo):
            assert torch.equal(g, w)
        sh, uh = so[2], uo[2]


def test_world1_xcorr_equals_unsharded(world1):
    """At one rank the sharded correlators are the planar functions over
    the whole batch, bit for bit."""
    rng = np.random.default_rng(72)
    mags = torch.from_numpy(np.abs(_cplx(rng, 3, 4, 512)))
    got = S.make_sharded_td_xcorr(world1, 32)(mags)
    want = t_xcorr.td_xcorr_planar_batched(mags, 32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    v = t_planar.PC(*(torch.from_numpy(_real(rng, "float32", (3, 4, 256)))
                      for _ in range(2)))
    assert torch.equal(S.make_sharded_fd_xcorr(world1,
                                               perform_fft_first=True)(v),
                       t_xcorr.fd_xcorr_planar(v, perform_fft_first=True))


def test_world1_all_to_all_is_identity(world1):
    """At axis size 1 (and with no mesh) ``all_to_all`` returns its input,
    as ``ring_forward`` does."""
    t = torch.arange(24.0).reshape(2, 3, 4)
    assert S.all_to_all(t, world1, 0, 2) is t
    assert S.all_to_all(t, None, 2, 1) is t


def _xengine_world1_inputs(seed: int):
    rng = np.random.default_rng(seed)
    z = [torch.from_numpy(_cplx(rng, 8, 4, 8, 2)) for _ in range(2)]
    lanes = [tuple(torch.from_numpy(v) for v in fr)
             for fr in _stacked_frames(rng, "int8", 8, 32, 8, 3)]
    return z, lanes


def test_world1_xengine_equals_unsharded(world1):
    """At one rank the three sharded X-Engines are the unsharded engines
    bit for bit: outputs, ready flags and carried state."""
    from clenabled_tpu_torch.dsp import xengine as t_xe

    z, lanes = _xengine_world1_inputs(80)
    assert torch.equal(S.sharded_xengine(z[0], world1),
                       t_xe.xengine_correlate(z[0]))
    pz = t_planar.PC(z[0].real.contiguous(), z[0].imag.contiguous())
    got, want = (S.sharded_xengine_planar(pz, world1),
                 t_xe.xengine_correlate_planar(pz))
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    si, sa = S.make_sharded_xengine(4, 8, 2, 8, world1,
                                    pipeline_integration=2)
    ui, ua = t_xe.make_xengine(4, 8, 2, 8, pipeline_integration=2,
                               device="cpu")
    ss, us = si(), ui()
    for x in z:
        ss, (so, sr) = sa(ss, x)
        us, (uo, ur) = ua(us, x)
        assert sr == ur and torch.equal(so, uo)
    assert ss.count == us.count and torch.equal(ss.accum, us.accum)
    scale = 1.0 / 127.0 ** 2
    si, sa = S.make_sharded_xengine_stacked(4, 8, 2, 32, world1,
                                            pipeline_integration=2,
                                            scale=scale)
    ui, ua = t_xe.make_xengine_channel_major(4, 8, 2, 32,
                                             pipeline_integration=2,
                                             scale=scale, device="cpu")
    ss, us = si(), ui()
    for fr in lanes:
        ss, (so, sr) = sa(ss, fr)
        us, (uo, ur) = ua(us, fr)
        assert sr == ur and torch.equal(so.re, uo.re)
        assert torch.equal(so.im, uo.im)
    assert ss.count == us.count == 1
    assert torch.equal(ss.accum.re, us.accum.re)


def test_world1_stacked_frames_checked(world1):
    """The stacked engine checks this rank's lane block's shape."""
    init, apply = S.make_sharded_xengine_stacked(4, 8, 2, 32, world1)
    bad = torch.zeros((8, 32, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="frames shape"):
        apply(init(), (bad, bad))
    init, apply = S.make_sharded_xengine(4, 8, 2, 8, world1)
    with pytest.raises(ValueError, match="frames shape"):
        apply(init(), torch.zeros((8, 4, 8, 1), dtype=torch.complex64))


@pytest.mark.parametrize("kind", list(CHAIN_LOCAL))
def test_world1_chain_equals_sequential(world1, kind):
    """At one rank each ShardedChain is its sequential filters followed by
    ``demod.quadrature_demod`` from a zero sample, bit for bit (outputs
    and every stage's state)."""
    params = _chain_params(kind)
    init, step = R._chain(params, world1).compile()
    taps = params["taps"]
    if kind == "ofa":
        qi, qa, _ = t_ofa.make_fft_filter(taps)
    elif kind == "chan":
        qi, qa = t_chan.make_channelizer(taps, 8, 8, list(range(8)),
                                         device="cpu")
    else:
        qi, qa = t_fir.make_fir_filter(taps, decimation=4)
    rng = np.random.default_rng(81)
    ss, sq, last = init(), qi(), torch.zeros(1, dtype=torch.complex64)
    for _ in range(3):
        x = torch.from_numpy(_cplx(rng, 2 * CHAIN_LOCAL[kind]))
        ss, y = step(ss, x)
        sq, yq = qa(sq, x)
        if kind == "ofa":
            yq = yq * 2.0
        if kind != "chan":
            yq, last = t_demod.quadrature_demod(yq, 0.7, last_sample=last)
            assert torch.equal(ss[-1][0], last)
        assert torch.equal(y, yq)
        assert torch.equal(ss[0][0], sq)
    assert len(ss) == {"ofa": 3, "chan": 1, "fir4": 2}[kind]


def test_world1_state_handover_takes_this_ranks_part(world1):
    """At one rank the hand-overs keep the whole state on the mesh's
    device, the count a host int; a [D, K] state of another D raises."""
    re = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    st = P.sharded_xengine_state_from_reference(re, -re, np.int32(1), world1)
    assert st.count == 1 and isinstance(st.count, int)
    assert torch.equal(st.accum.re, torch.from_numpy(re))
    assert torch.equal(st.accum.im, torch.from_numpy(-re))
    tail = np.arange(5, dtype=np.complex64)[None]
    got = P.sharded_chain_state_from_reference((tail, ()), world1)
    assert torch.equal(got[0], torch.from_numpy(tail)) and got[1] == ()
    with pytest.raises(ValueError, match="expected"):
        P.sharded_chain_state_from_reference((np.zeros((2, 5)),), world1)


def test_no_group_is_one_rank(monkeypatch):
    """mesh=None: one rank, no process group, identity collectives; the
    default context is one rank on cuda:0 and raises without a card."""
    assert not dist.is_initialized()
    t = torch.arange(5.0)
    for op in (S.psum, S.pmean):
        assert torch.equal(op(t, None), t)
    assert S.ring_forward(t, None) is t
    assert S.broadcast(t, None, 0) is t
    assert (S.axis_size(None), S.axis_index(None)) == (1, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_device.get_context()


def test_context_is_the_group_mesh(world1):
    ctx = t_device.get_context()
    assert ctx.mesh.mesh_dim_names == ("shard",)
    assert (ctx.num_devices, ctx.platform, ctx.device.type) == (1, "cpu",
                                                                "cpu")
    assert t_device.get_context() is ctx
    two_d = S.make_mesh({"host": 1, "shard": 1}, device="cpu")
    assert t_device.set_default_mesh(two_d).mesh is two_d
    assert t_device.get_context().mesh is two_d


@pytest.mark.parametrize("kind", ["fir", "ofa", "chan_8", "chan_4"])
def test_world1_halo_equals_sequential(world1, kind):
    rng = np.random.default_rng(62)
    if kind == "fir":
        init_s, apply_s = S.make_sharded_fir_filter(_fir_taps(4), world1,
                                                    decimation=4)
        init_q, apply_q = t_fir.make_fir_filter(_fir_taps(4), decimation=4)
        n = 1024
    elif kind == "ofa":
        init_s, apply_s, plan = S.make_sharded_fft_filter(_ofa_taps(), world1)
        init_q, apply_q, _ = t_ofa.make_fft_filter(_ofa_taps())
        n = 4 * plan.nsamples
    else:
        r = int(kind[-1])
        init_s, apply_s = S.make_sharded_channelizer(
            _chan_taps(8), 8, r, list(range(8)), world1)
        init_q, apply_q = t_chan.make_channelizer(
            _chan_taps(8), 8, r, list(range(8)), device="cpu")
        n = 128
    ss, sq = init_s(), init_q()
    for _ in range(3):
        x = torch.from_numpy(_cplx(rng, n))
        ss, ys = apply_s(ss, x)
        sq, yq = apply_q(sq, x)
        assert torch.equal(ys, yq)
        assert torch.equal(ss[0], sq)


@pytest.mark.parametrize("kind", ["ofa_planar", "ofs_planar", "chan_planar",
                                  "os_fused"])
def test_world1_planar_halo_equals_sequential(world1, kind):
    """At one rank the planar sharded filters are the sequential planar
    forms over chained frames, bit for bit (outputs and state)."""
    rng = np.random.default_rng(65)
    if kind in ("ofa_planar", "ofs_planar"):
        taps = _ofa_taps() if kind == "ofa_planar" else _fir_taps(1)
        fused = kind == "ofs_planar"
        init_s, apply_s = S.make_sharded_fft_filter_planar(
            taps, world1, use_pallas=fused)
        init_q, apply_q, plan = t_ofa.make_fft_filter_planar(taps,
                                                             fused=fused)
        n = t_ofa.frame_quantum(plan) * (1 if fused else 4)
    elif kind == "chan_planar":
        init_s, apply_s = S.make_sharded_channelizer_planar(
            _chan_taps(8), 8, 4, list(range(8)), world1)
        init_q, apply_q = t_chan.make_channelizer(
            _chan_taps(8), 8, 4, list(range(8)), planar=True, device="cpu")
        n = 128
    else:
        init_s, apply_s = S.make_sharded_channelizer_fused_oversampled(
            _os_taps(), 16, 8, world1)
        init_q, apply_q = t_chan.make_channelizer_fused_oversampled(
            _os_taps(), 16, 8, list(range(16)), device="cpu")
        n = 2048
    ss, sq = init_s(), init_q()
    assert ss[0].shape == (1, sq[0].shape[-1])
    for _ in range(3):
        x = t_planar.PC(*torch.from_numpy(
            rng.standard_normal((2, n)).astype(np.float32)))
        ss, ys = apply_s(ss, x)
        sq, yq = apply_q(sq, x)
        assert torch.equal(ys.re, yq.re) and torch.equal(ys.im, yq.im)
        assert torch.equal(ss[0][0], sq[0]) and torch.equal(ss[1][0], sq[1])


def test_world1_costas_channels_equal_chunked_loops(world1):
    """At one rank the channel-parallel Costas loops are the chunked loop
    run on each channel alone, bit for bit (outputs, diagnostics and
    state), in three batched calls a frame for all channels."""
    rng = np.random.default_rng(66)
    c, n = 3, COSTAS["n"]
    kw = dict(chunk=COSTAS["chunk"], warmup=COSTAS["warmup"])
    init, apply = S.make_sharded_costas_channels(COSTAS["bw"], 2, world1,
                                                 **kw)
    one = t_demod.make_costas_loop_chunked(COSTAS["bw"], 2, **kw)
    st, singles = init(c), [one.init_state(device="cpu") for _ in range(c)]
    tones = _tone_channels(c, 2 * n, rng)
    for k in range(2):
        x = t_planar.PC(*(torch.from_numpy(np.ascontiguousarray(
            v[:, k * n:(k + 1) * n])) for v in tones))
        st, o, d = apply(st, x)
        for j in range(c):
            singles[j], oj, dj = one(singles[j], t_planar.PC(x.re[j],
                                                             x.im[j]))
            assert torch.equal(o.re[j], oj.re) and torch.equal(o.im[j], oj.im)
            assert all(torch.equal(d[key][j], dj[key]) for key in dj)
    for j in range(c):
        assert all(torch.equal(a[j], b) for a, b in zip(st[0], singles[j][0]))
        assert torch.equal(st[1].re[j], singles[j][1].re)
    with pytest.raises(ValueError, match="multiple of 512"):
        apply(st, t_planar.PC(torch.zeros(c, 1000), torch.zeros(c, 1000)))


def test_short_blocks_raise(world1):
    """The block-size checks JAX makes, and the halo every block feeds."""
    for dt, tail in (("float32", 1024), ("int8", 4096)):
        cfg = P.FxPipelineConfig(num_antennas=2, samples_per_step=tail - 16)
        with pytest.raises(ValueError, match="carried tail"):
            P.make_sharded_fx_pipeline_fused(world1, cfg=cfg,
                                             in_dtype=getattr(torch, dt))
    with pytest.raises(ValueError, match="multiple of 16"):
        P.make_sharded_fx_pipeline_fused(
            world1, cfg=P.FxPipelineConfig(samples_per_step=1032))
    with pytest.raises(ValueError, match="channelizer halo"):
        P.make_sharded_fx_pipeline(
            world1, cfg=P.FxPipelineConfig(samples_per_step=398))
    x = torch.zeros(40, dtype=torch.complex64)
    init, apply = S.make_sharded_fir_filter(_fir_taps(1), world1)
    with pytest.raises(ValueError, match="halo"):
        apply(init(), x)
    init, apply = S.make_sharded_channelizer(_chan_taps(8), 8, 8,
                                             list(range(8)), world1)
    with pytest.raises(ValueError, match="halo"):
        apply(init(), x)
    init, apply, plan = S.make_sharded_fft_filter(_ofa_taps(), world1)
    with pytest.raises(ValueError, match="nsamples"):
        apply(init(), torch.zeros(plan.nsamples + 1))
    z = t_planar.PC(torch.zeros(40), torch.zeros(40))
    init, apply = S.make_sharded_channelizer_planar(_chan_taps(8), 8, 8,
                                                    list(range(8)), world1)
    with pytest.raises(ValueError, match="halo"):
        apply(init(), z)
    init, apply = S.make_sharded_fft_filter_planar(_fir_taps(1), world1,
                                                   use_pallas=True)
    with pytest.raises(ValueError, match="fused kernel quantum"):
        apply(init(), z)
    init, apply = S.make_sharded_channelizer_fused_oversampled(
        _os_taps(), 16, 8, world1)
    with pytest.raises(ValueError, match="multiple of 1024"):
        apply(init(), t_planar.PC(torch.zeros(1040), torch.zeros(1040)))


def test_short_blocks_raise_in_jax():
    """The same blocks JAX refuses (the reference's checks)."""
    if jax is None:
        pytest.skip("needs JAX, the reference")
    mesh = JS.make_mesh(devices=jax.devices()[:1])
    for dt, tail in ((jnp.float32, 1024), (jnp.int8, 4096)):
        cfg = J.FxPipelineConfig(num_antennas=2, samples_per_step=tail - 16)
        with pytest.raises(ValueError):
            J.make_sharded_fx_pipeline_fused(mesh, cfg=cfg, in_dtype=dt)
    with pytest.raises(ValueError):
        J.make_sharded_fx_pipeline(
            mesh, cfg=J.FxPipelineConfig(samples_per_step=398))


def test_tile_rows_rule_dropped(world1):
    """1152 samples a rank: JAX's sharded step refuses the block (1152/128
    = 9 rows has no power-of-two tile of 8 rows or more, a TPU tiling
    rule); the port takes it and equals its unsharded step."""
    n = 1152
    if jax is not None:
        mesh = JS.make_mesh(devices=jax.devices()[:1])
        with pytest.raises(ValueError, match="too small"):
            J.make_sharded_fx_pipeline_fused(
                mesh, cfg=J.FxPipelineConfig(num_antennas=2,
                                             samples_per_step=n))
    cfg = P.FxPipelineConfig(num_antennas=2, samples_per_step=n)
    sfn, (_, _, tr, ti) = P.make_sharded_fx_pipeline_fused(world1, cfg=cfg)
    ufn, _ = P.make_fx_pipeline_fused(cfg, device="cpu")
    xr, xi = _seeded("float32", (2, n), 63)
    for g, w in zip(sfn(xr, xi, tr, ti), ufn(xr, xi, tr, ti)):
        assert torch.equal(g, w)


def test_make_mesh_checks(world1, monkeypatch):
    with pytest.raises(ValueError, match="mesh shape"):
        S.make_mesh({"shard": 2}, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        S.make_mesh(device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.make_mesh(device="cuda")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        S.make_mesh(device="tpu")


def test_make_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        S.make_mesh(device="cpu")


def test_entry_is_the_planar_step():
    fn, args = entry(device="cpu")
    cfg = P.FxPipelineConfig(num_antennas=4, num_channels=16,
                             samples_per_step=1 << 17)
    ref, ref_args = P.make_fx_pipeline_planar(cfg, device="cpu")
    assert [a.shape for a in args] == [(4, 1 << 17)] * 2 + [(4, 399)] * 2
    rng = np.random.default_rng(64)
    xs = [torch.from_numpy(rng.standard_normal((4, 1 << 17)).astype(
        np.float32)) for _ in range(2)]
    for g, w in zip(fn(*xs, *args[2:]), ref(*xs, *ref_args[2:])):
        assert torch.equal(g, w)


def test_dryrun_multichip_on_cpu():
    res = dryrun_multichip(2, device="cpu")
    assert len(res) == 2
    legs = {"1", "1b float32", "1b bfloat16", "1b int8", "2", "2b", "3",
            "3b", "3c", "3d", "3e td", "3e fd", "4"}
    for r in res:
        assert set(r) == legs
        # leg 4: two launcher processes of one rank each, one sharded step
        assert [v.shape for v in r["4"]] == [(3, 16), (16, 10, 1), (4, 399)]
        corr, lag, vectors = r["3e td"]      # magnitudes of ones: all 1
        assert corr.shape == lag.shape == (2, 2) and (lag == -32).all()
        np.testing.assert_allclose(vectors, np.ones((2, 2, 64)), atol=1e-5)
        assert r["3e fd"][0].shape == (2, 2, 256)
        # leg 2b: one frame quantum a rank; 3c: 1024 samples / R = 8 groups
        # of 16 channels; 3d: this rank's 2 of the 2·D tone channels, locked
        assert [v.shape for v in r["2b"]] == [(32768,)] * 2
        assert [v.shape for v in r["3c"]] == [(128, 16)] * 2
        assert [v.shape for v in r["3d"]] == [(2, 1024)] * 2 + [(2,)]
        assert (r["3d"][2] < 1e-3).all()
        assert all(np.isfinite(np.asarray(v, np.complex64)).all()
                   for leg in r.values() for v in leg)
    for leg in ("1", "1b float32", "1b bfloat16", "1b int8"):
        for g, w in zip(res[0][leg], res[1][leg]):   # replicated outputs
            np.testing.assert_array_equal(g, w)
    plan = t_ofa.plan_fft_filter(firdes.low_pass(1.0, 1e6, 100e3, 20e3))
    assert res[0]["2"][1].shape == (plan.nsamples,)
    # legs 3 and 3b against JAX's sharded X-Engines on two CPU devices at
    # __graft_entry__.py's shapes: each rank's channel slice, joined
    if jax is None:
        return
    jmesh = JS.make_mesh(devices=jax.devices()[:2])
    s, f = 4, 8
    ji, ja = JS.make_sharded_xengine(num_inputs=s, num_channels=f, npol=2,
                                     integration_time=4, mesh=jmesh)
    _, (out, ready) = ja(ji(), jnp.ones((4, s, f, 2), jnp.complex64))
    assert all(r["3"][1] is bool(ready) is True for r in res)
    close(np.concatenate([r["3"][0] for r in res]), np.asarray(out))
    ji, ja = JS.make_sharded_xengine_stacked(
        num_inputs=s, num_channels=f, npol=2, integration_time=8, mesh=jmesh,
        scale=1.0 / 127.0 ** 2)
    lanes = jnp.ones((f, 8, 2 * s), jnp.int8)
    _, (outk, readyk) = ja(ji(), (lanes, lanes))
    assert all(r["3b"][2] is bool(readyk) is True for r in res)
    for c, want in enumerate((outk.re, outk.im)):
        np.testing.assert_array_equal(
            np.concatenate([r["3b"][c] for r in res]), np.asarray(want))


def test_spawn_checks():
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        S.spawn(R.run_cases, 2, "tpu", None, {})
    with pytest.raises(ValueError, match="launchers"):
        S.spawn(R.run_cases, 3, "cpu", None, {}, procs=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cards"):
            S.spawn(R.run_cases, 2, "cuda", None, {})


@pytest.mark.cuda
def test_world1_nccl_fused_equals_unsharded_on_card():
    """World size 1 on NCCL: the sharded fused step on the hand-written
    kernel equals the unsharded step bit for bit on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as workdir:
        S.initialize_distributed("cuda", f"file://{workdir}/store", 1, 0)
        try:
            mesh = S.make_mesh(device="cuda")
            for dt in ("float32", "int8"):
                n = 1 << 16
                cfg = P.FxPipelineConfig(num_antennas=4, num_channels=16,
                                         samples_per_step=n)
                sfn, (_, _, str_, sti) = P.make_sharded_fx_pipeline_fused(
                    mesh, cfg=cfg, in_dtype=getattr(torch, dt))
                ufn, (_, _, utr, uti) = P.make_fx_pipeline_fused(
                    cfg, in_dtype=getattr(torch, dt), device=dev)
                before = P.hopper_kernels.fx_correlate_streams_v2.launches
                for step in range(2):
                    xr, xi = (x.to(dev) for x in _seeded(dt, (4, n),
                                                         70 + step))
                    so = sfn(xr, xi, str_, sti)
                    uo = ufn(xr, xi, utr, uti)
                    for g, w in zip(so, uo):
                        assert torch.equal(g, w)
                    str_, sti, utr, uti = so[3], so[4], uo[3], uo[4]
                assert (P.hopper_kernels.fx_correlate_streams_v2.launches
                        - before) == 4
        finally:
            dist.destroy_process_group()


@pytest.mark.cuda
def test_world1_nccl_xengine_and_chain_on_card():
    """World size 1 on NCCL: the stacked sharded X-Engine on the Gram
    kernels (int8 and bf16, S·P = 128) and the time-major and planar
    forms equal the unsharded engines bit for bit, the int8 Gram kernel
    launched once a call; the three ShardedChains equal their sequential
    filters and ``quadrature_demod`` bit for bit, outputs and states."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from clenabled_tpu_torch.dsp import hopper_kernels as hk
    from clenabled_tpu_torch.dsp import xengine as t_xe

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    with tempfile.TemporaryDirectory() as workdir:
        S.initialize_distributed("cuda", f"file://{workdir}/store", 1, 0)
        try:
            mesh = S.make_mesh(device="cuda")
            for dt, t in ((torch.int8, 256), (torch.bfloat16, 64)):
                kw = dict(pipeline_integration=2, scale=1.0 / 127.0 ** 2)
                si, sa = S.make_sharded_xengine_stacked(64, 16, 2, t, mesh,
                                                        **kw)
                ui, ua = t_xe.make_xengine_channel_major(64, 16, 2, t,
                                                         device=dev, **kw)
                ss, us = si(), ui()
                hk.reset_launch_counts()
                for _ in range(3):
                    if dt == torch.int8:
                        fr = tuple(torch.randint(-128, 128, (16, t, 128),
                                                 generator=gen, device=dev,
                                                 dtype=dt) for _ in range(2))
                    else:
                        fr = tuple(torch.randn((16, t, 128), generator=gen,
                                               device=dev).to(dt)
                                   for _ in range(2))
                    ss, (so, sr) = sa(ss, fr)
                    us, (uo, ur) = ua(us, fr)
                    assert sr == ur
                    assert torch.equal(so.re, uo.re)
                    assert torch.equal(so.im, uo.im)
                assert hk.gram_launches() == 6     # 3 sharded, 3 unsharded
            z = torch.randn((8, 8, 16, 2), generator=gen, device=dev,
                            dtype=torch.complex64)
            assert torch.equal(S.sharded_xengine(z, mesh),
                               t_xe.xengine_correlate(z))
            pz = t_planar.PC(z.real.contiguous(), z.imag.contiguous())
            got, want = (S.sharded_xengine_planar(pz, mesh),
                         t_xe.xengine_correlate_planar(pz))
            assert torch.equal(got.re, want.re)
            assert torch.equal(got.im, want.im)
            for kind, local in CHAIN_LOCAL.items():
                params = _chain_params(kind)
                init, step = R._chain(params, mesh).compile()
                if kind == "ofa":
                    qi, qa, _ = t_ofa.make_fft_filter(params["taps"])
                elif kind == "chan":
                    qi, qa = t_chan.make_channelizer(
                        params["taps"], 8, 8, list(range(8)), device=dev)
                else:
                    qi, qa = t_fir.make_fir_filter(params["taps"],
                                                   decimation=4)
                ss, sq = init(), qi().to(dev)
                last = torch.zeros(1, dtype=torch.complex64, device=dev)
                for _ in range(3):
                    x = torch.randn(64 * local, generator=gen, device=dev,
                                    dtype=torch.complex64)
                    ss, y = step(ss, x)
                    sq, yq = qa(sq, x)
                    if kind == "ofa":
                        yq = yq * 2.0
                    if kind != "chan":
                        yq, last = t_demod.quadrature_demod(yq, 0.7, last)
                        assert torch.equal(ss[-1][0], last)
                    assert torch.equal(y, yq) and torch.equal(ss[0][0], sq)
        finally:
            dist.destroy_process_group()


def test_rank_module_imports_no_jax():
    """The rank functions' module, which every child imports, and the
    sync, chain, sharded X-Engine and example-kernel modules leave JAX and
    the JAX package unimported."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys\n"
            f"sys.path[:0] = [{here!r}, {os.path.dirname(here)!r}]\n"
            "import torch_sharding_ranks\n"
            "import clenabled_tpu_torch.streaming.sync\n"
            "import clenabled_tpu_torch.sharding.chain\n"
            "import clenabled_tpu_torch.sharding.xengine_sharded\n"
            "import clenabled_tpu_torch.examples.kernel1to1_multiply_const_complex\n"
            "import clenabled_tpu_torch.examples.kernel2to1_multiply_complex\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith(('jax.', 'jaxlib', 'clenabled_tpu.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_runtime_imports_nothing_of_sharding():
    """The runtime layer lies under ``sharding``: none of its modules
    imports ``sharding``, at the top or inside a function."""
    import ast

    root = os.path.dirname(t_device.__file__)
    for name in sorted(os.listdir(root)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(root, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            elif isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            else:
                continue
            assert not any(m.startswith("clenabled_tpu_torch.sharding")
                           for m in mods), (name, mods)


def test_device_event_helpers():
    """``is_nccl_kernel`` picks NCCL's kernels out of a trace's names;
    ``host_ms`` times the calls it makes on the CPU."""
    assert t_device.is_nccl_kernel(
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)")
    assert t_device.is_nccl_kernel("void ncclDevKernel_Broadcast_RING_LL()")
    assert not t_device.is_nccl_kernel("void fx_reg_kernel<16>(float*)")
    calls = []
    ms = t_device.host_ms(lambda: calls.append(1), reps=5, device="cpu")
    assert len(calls) == 6 and ms >= 0.0


def test_sharded_scaling_on_cpu(capsys):
    """The scaling tool on two gloo ranks: rank 0 within the tolerance of
    the unsharded step over the joined stream at 4 antennas and 16
    channels, float32 and int8, every call timed."""
    from clenabled_tpu_torch.tools import sharded_scaling as T

    with pytest.raises(SystemExit):            # fixed at the fused cell's
        T.parse_args(["--a", "2"])
    T.main(["--ranks", "2", "--device", "cpu", "--samples", "4096",
            "--steps", "2", "--reps", "1"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["a"], rec["m"], rec["ranks"]) == (4, 16, 2)
    for r in rec["results"]:
        assert sorted(r) == ["float32", "int8"]
        for res in r.values():
            assert sorted(res["ms"]) == ["block", "collectives", "sharded"]
            assert sorted(res["host_ms"]) == ["block", "sharded"]
    for res in rec["results"][0].values():
        assert res["worst_over_tol"] <= 1.0


def test_sharded_scaling_xengine_on_cpu(capsys):
    """The tool's X-Engine leg on two gloo ranks: each rank's 64-lane block
    through the stacked engine, its channel slice bit-equal to the
    unsharded engine (the tool raises otherwise), every call timed."""
    from clenabled_tpu_torch.tools import sharded_scaling as T

    T.main(["--xengine", "--ranks", "2", "--device", "cpu", "--xe-channels",
            "8", "--xe-frames", "32", "--steps", "2", "--reps", "1"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["leg"], rec["ranks"], rec["f"], rec["t"]) == ("xengine", 2,
                                                             8, 32)
    for r in rec["results"]:
        assert sorted(r["ms"]) == ["all_to_all", "sharded", "unsharded"]
        assert r["exchanged_bytes"] == 2 * 8 * 32 * 64
        assert r["transpose_bytes"] == 2 * 4 * 32 * 128
        assert r["complex_worst_over_tol"] <= 1.0
