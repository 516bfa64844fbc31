"""Flowgraph: wire blocks into a DAG, compile it into a Runner on a device.

The port of ``clenabled_tpu.streaming.graph``.  ``Flowgraph`` (``add``,
``connect``, ``external_input``, ``tap``, the toposort and the static
multi-rate frame-size solver) is the JAX package's, unchanged.  The Runner
drives the step eagerly on the device named at ``compile(device=...)``:

- ``jax.jit`` has no counterpart; the step is the blocks' torch calls.
- The K-frame dispatch of an all-stateless graph with external inputs
  is, as JAX's ``jax.vmap``, one ``torch.func.vmap`` of the step over the
  frame axis: each port's K stacked frames go to the device in one copy,
  the plain torch ops batch by themselves, and the hand-written kernel on
  this path (``hopper_kernels.fft_batched_fused``) is an operator whose
  batch rule launches it once for the K frames.  ``vectorize=False`` and
  every other graph take the counterpart of ``lax.scan``: a loop over the
  K frames, threading state exactly as K ``step()`` calls do.  Either way
  tapped outputs come back stacked on a leading K axis and message
  handlers are called once per frame, in frame order, as in JAX.
- ``precision`` and ``lowered_text`` are XLA's and have no counterpart;
  a debug block prints its item counts only.
- ``refresh`` rebuilds the step closure where JAX re-traces and re-jits;
  ``set_taps`` retunes a filter live, migrating its carried state.
- With the program's tracing on (``runtime.trace``) a dispatch is the
  span ``runner.step``, each block's ``apply`` the span
  ``block.<name>``, and the message delivery ``runner.deliver``.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
import time
from fractions import Fraction
from typing import Any, Callable, Sequence

import numpy as np
import torch

from clenabled_tpu_torch import _tree
from clenabled_tpu_torch.runtime import trace
from clenabled_tpu_torch.streaming.block import Block


@dataclasses.dataclass(frozen=True)
class _Edge:
    src: Block
    src_port: int
    dst: Block
    dst_port: int


class Flowgraph:
    """Build with connect(); compile(frame_size, device=...) returns a
    Runner.

    ``frame_size`` is the samples-per-step at rate-1.0 edges driven by
    external inputs; source blocks declare their own ``source_frame``.
    """

    def __init__(self):
        self._blocks: list[Block] = []
        self._edges: list[_Edge] = []
        self._external: list[tuple[Block, int]] = []  # host-fed inputs
        self._taps: list[tuple[Block, int, str]] = []  # exposed outputs

    def add(self, block: Block) -> Block:
        if block not in self._blocks:
            self._blocks.append(block)
        return block

    def connect(self, src: Block, dst: Block, src_port: int = 0,
                dst_port: int = 0) -> None:
        self.add(src)
        self.add(dst)
        if src_port >= src.n_outputs:
            raise ValueError(f"{src} has no output port {src_port}")
        if dst_port >= dst.n_inputs:
            raise ValueError(f"{dst} has no input port {dst_port}")
        for e in self._edges:
            if e.dst is dst and e.dst_port == dst_port:
                raise ValueError(f"{dst} input {dst_port} already connected")
        self._edges.append(_Edge(src, src_port, dst, dst_port))

    def external_input(self, dst: Block, dst_port: int = 0) -> int:
        """Declare a host-fed stream into ``dst``; returns the feed index
        used in Runner.step(feeds)."""
        self.add(dst)
        self._external.append((dst, dst_port))
        return len(self._external) - 1

    def tap(self, src: Block, src_port: int = 0, name: str | None = None) -> str:
        """Expose a stream output from the step (sink analogue)."""
        self.add(src)
        name = name or f"{src.name or type(src).__name__}_{len(self._taps)}"
        self._taps.append((src, src_port, name))
        return name

    # ---- compilation ----

    def _toposort(self) -> list[Block]:
        incoming: dict[int, int] = {id(b): 0 for b in self._blocks}
        for e in self._edges:
            incoming[id(e.dst)] += 1
        ready = [b for b in self._blocks if incoming[id(b)] == 0]
        order: list[Block] = []
        while ready:
            b = ready.pop()
            order.append(b)
            for e in self._edges:
                if e.src is b:
                    incoming[id(e.dst)] -= 1
                    if incoming[id(e.dst)] == 0:
                        ready.append(e.dst)
        if len(order) != len(self._blocks):
            raise ValueError("flowgraph has a cycle")
        return order

    def compile(self, frame_size: int | None = 8192,
                steps_per_dispatch: int | str = "auto",
                vectorize: bool = True, *,
                device: torch.device | str) -> "Runner":
        """Build the Runner on ``device`` (``"cuda"``, ``"cuda:0"`` or
        ``"cpu"``; required — the Runner never picks one itself).  Feeds
        and block state live there.

        steps_per_dispatch: K frames per dispatch.  Tapped outputs of a
        K-frame dispatch gain a leading K axis; messages are delivered per
        frame.  ``"auto"`` picks K as the JAX package does — about 2^21
        base-frame samples per dispatch clamped to [1, 64], or 2^22
        clamped to [1, 512] for an all-stateless graph with external
        inputs and ``vectorize`` — and then ``step()`` keeps per-frame
        semantics for per-frame feeds and takes the K-frame dispatch only
        for stacked [K, ...] feeds or via ``run()``.  An explicit int pins
        K (``step()`` then requires stacked feeds).

        vectorize: an all-stateless graph with external inputs runs its
        K-frame dispatch as one ``torch.func.vmap`` of the step (see
        ``Runner``); ``False`` forces the frame-by-frame loop."""
        order, step, frames, resolved = self._build(frame_size)
        auto = steps_per_dispatch == "auto"
        if auto:
            if (vectorize and self._external
                    and all(getattr(b, "stateless", False) for b in order)):
                steps_per_dispatch = max(1, min(512,
                                                (1 << 22) // max(1, resolved)))
            else:
                steps_per_dispatch = max(1, min(64,
                                                (1 << 21) // max(1, resolved)))
        return Runner(self, order, step, frames, resolved,
                      steps_per_dispatch=steps_per_dispatch,
                      auto_dispatch=auto, vectorize=vectorize, device=device)

    def _resolve_frame_size(self, order, in_edges, ext_ports,
                            frame_size: int | None) -> int:
        """Static multi-rate solver (GR's forecast contract, resolved at
        compile time instead of via inter-block runtime buffering).

        Every externally-fed stream length is B·r for the unknown base
        frame B (r = the rational product of block rates along the path).
        Each block contributes constraints: B·r must be an integer and a
        multiple of its quantum.  The minimal valid B is the lcm of the
        per-constraint minima; ``frame_size=None`` picks it, an explicit
        frame_size is validated against it."""
        scale: dict[tuple[int, int], Fraction] = {}   # B-multiplier per port
        fixed: dict[tuple[int, int], int] = {}        # source-driven ports
        b_min = 1          # B must be a multiple of this
        b_eq: int | None = None   # B pinned by a fixed/scaled meeting point

        def need_multiple(k: int):
            nonlocal b_min
            b_min = math.lcm(b_min, max(1, k))

        for b in order:
            if b.n_inputs == 0:
                out = b.out_frame(0)
                for p in range(b.n_outputs):
                    fixed[(id(b), p)] = out
                continue
            vals = []
            for p in range(b.n_inputs):
                if (id(b), p) in ext_ports:
                    vals.append(("scaled", Fraction(1)))
                elif p in in_edges[id(b)]:
                    e = in_edges[id(b)][p]
                    key = (id(e.src), e.src_port)
                    if key in fixed:
                        vals.append(("fixed", fixed[key]))
                    else:
                        vals.append(("scaled", scale[key]))
                else:
                    raise ValueError(f"{b} input {p} unconnected")
            kinds = {k for k, _ in vals}
            if kinds == {"fixed"}:
                sizes = {v for _, v in vals}
                if len(sizes) != 1:
                    raise ValueError(f"{b} input frames disagree: {sizes}")
                out = b.out_frame(sizes.pop())
                for p in range(b.n_outputs):
                    fixed[(id(b), p)] = out
                continue
            rs = {v for k, v in vals if k == "scaled"}
            if len(rs) != 1:
                raise ValueError(
                    f"{b} input rates disagree: {sorted(rs)} — resample "
                    f"one branch so both arrive at the same rate")
            r = rs.pop()
            if "fixed" in kinds:
                f_sizes = {v for k, v in vals if k == "fixed"}
                if len(f_sizes) != 1:
                    raise ValueError(f"{b} input frames disagree: {f_sizes}")
                pin = Fraction(f_sizes.pop()) / r
                if pin.denominator != 1:
                    raise ValueError(
                        f"{b}: fixed-size input cannot align with the "
                        f"rate-{r} external path")
                if b_eq is not None and b_eq != int(pin):
                    raise ValueError(
                        f"conflicting base frame sizes: {b_eq} vs {int(pin)}")
                b_eq = int(pin)
            # constraints: B·r integral and a multiple of b.quantum, i.e.
            # B a multiple of quantum·rd/gcd(rn, quantum·rd)
            rn, rd = r.numerator, r.denominator
            need_multiple(b.quantum * rd // math.gcd(rn, b.quantum * rd))
            r_out = r * b.rate
            need_multiple(r_out.denominator)   # outputs must be integral
            for p in range(b.n_outputs):
                scale[(id(b), p)] = r_out

        if b_eq is not None:
            if b_eq <= 0 or b_eq % b_min:
                raise ValueError(
                    f"source-pinned base frame {b_eq} violates the rate "
                    f"constraints (must be a positive multiple of {b_min})")
            b_min = b_eq
        if frame_size is None:
            return b_min
        if b_eq is not None and frame_size != b_eq:
            raise ValueError(
                f"frame_size={frame_size} conflicts with the source-pinned "
                f"base frame {b_eq}")
        if frame_size % b_min:
            raise ValueError(
                f"frame_size={frame_size} must be a multiple of {b_min} "
                f"(rate/quantum constraints; pass frame_size=None for the "
                f"minimal valid size)")
        return frame_size

    def _build(self, frame_size: int | None):
        """Topo-sort, propagate frame sizes, and build the step closure."""
        order = self._toposort()
        in_edges: dict[int, dict[int, _Edge]] = {id(b): {} for b in self._blocks}
        for e in self._edges:
            in_edges[id(e.dst)][e.dst_port] = e
        ext_ports = {(id(b), p): i for i, (b, p) in enumerate(self._external)}

        frame_size = self._resolve_frame_size(order, in_edges, ext_ports,
                                              frame_size)

        # frame-size propagation (GR's forecast, statically resolved)
        frames: dict[tuple[int, int], int] = {}
        for b in order:
            if b.n_inputs == 0:
                out = b.out_frame(0)
            else:
                sizes = []
                for p in range(b.n_inputs):
                    if (id(b), p) in ext_ports:
                        sizes.append(frame_size)
                    elif p in in_edges[id(b)]:
                        e = in_edges[id(b)][p]
                        sizes.append(frames[(id(e.src), e.src_port)])
                    else:
                        raise ValueError(f"{b} input {p} unconnected")
                if len(set(sizes)) != 1:
                    raise ValueError(f"{b} input frames disagree: {sizes}")
                out = b.out_frame(sizes[0])
            for p in range(b.n_outputs):
                frames[(id(b), p)] = out

        taps = list(self._taps)
        labels = [f"block.{b.name or type(b).__name__}" for b in order]

        def step(states: tuple, feeds: tuple):
            values: dict[tuple[int, int], Any] = {}
            new_states = list(states)
            messages: dict[str, Any] = {}
            for i, b in enumerate(order):
                ins = []
                for p in range(b.n_inputs):
                    if (id(b), p) in ext_ports:
                        ins.append(feeds[ext_ports[(id(b), p)]])
                    else:
                        e = in_edges[id(b)][p]
                        ins.append(values[(id(e.src), e.src_port)])
                with trace.span(labels[i]):
                    st, outs, msgs = b.apply(states[i], ins)
                new_states[i] = st
                for p, v in enumerate(outs):
                    values[(id(b), p)] = v
                for k, v in msgs.items():
                    messages[f"{b.name or type(b).__name__}.{k}"] = v
            tapped = {name: values[(id(s), p)] for s, p, name in taps}
            return tuple(new_states), tapped, messages

        return order, step, frames, frame_size


def _primary(feed):
    """The tensor whose shape stands for a feed (a planar pair's re)."""
    return feed.re if hasattr(feed, "re") and hasattr(feed, "im") else feed


class Runner:
    """Owns the device state, drives the step, dispatches messages."""

    def __init__(self, graph: Flowgraph, order: Sequence[Block],
                 step_fn: Callable, frames: dict, frame_size: int,
                 steps_per_dispatch: int = 1, auto_dispatch: bool = False,
                 vectorize: bool = True, *, device: torch.device | str):
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        self._graph = graph
        self._order = list(order)
        self._step_fn = step_fn
        self.steps_per_dispatch = steps_per_dispatch
        self.auto_dispatch = auto_dispatch
        # vectorize=False forces the frame-by-frame loop even for
        # all-stateless graphs (the same results; A/B and debugging)
        self.vectorize = vectorize
        self.device = torch.device(device)
        self.frames = frames
        self.frame_size = frame_size
        self.reset()
        self._msg_handlers: dict[str, list[Callable]] = {}
        # observability: the reference's debug prints + benchmark timing
        # loops become per-runner counters (host clock; the device runs
        # asynchronously, so wall_s is a lower bound unless the caller
        # waits on the outputs)
        self.stats = {"steps": 0, "wall_s": 0.0, "samples": 0}

    def _to_device(self, tree):
        """Host arrays and tensors of a feed or state tree on the Runner's
        device; other leaves (ints, flags) as they are."""
        def move(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x).reshape(x.shape))
            if torch.is_tensor(x):
                return x.to(self.device, non_blocking=True)
            return x
        return _tree.tree_map(move, tree)

    def _ext_ranks(self) -> list[int]:
        """Expected per-frame feed rank for each external input (the
        destination block's ``in_rank``; default 1)."""
        ranks = []
        for b, p in self._graph._external:
            r = getattr(b, "in_rank", 1)
            if isinstance(r, dict):
                r = r.get(p, 1)
            ranks.append(int(r))
        return ranks

    def on_message(self, key: str, handler: Callable) -> None:
        """Register a host callback for messages named '<block>.<port>'."""
        self._msg_handlers.setdefault(key, []).append(handler)

    def step(self, *feeds, stacked: bool | None = None) -> dict:
        """Run one dispatch.  ``feeds`` are host arrays or tensors for the
        declared external inputs (planar pairs as ``planar.PC``).

        With an explicit steps_per_dispatch=K > 1, feeds must be stacked
        [K, frame_size] and tapped outputs carry a leading K axis.  In
        auto-dispatch mode per-frame feeds (and no-feed source graphs) run
        one frame; stacked [K, ...] feeds — exactly one axis more than the
        destination's ``in_rank`` — take the K-frame dispatch.  ``stacked=``
        overrides the shape-based detection."""
        if len(feeds) != len(self._graph._external):
            raise ValueError(
                f"expected {len(self._graph._external)} feeds, got {len(feeds)}"
            )
        k = self.steps_per_dispatch
        if stacked is None:
            if k == 1:
                stacked = False
            elif self.auto_dispatch:
                arrs = [_primary(f) for f in feeds]
                stacked = bool(arrs) and all(
                    np.ndim(a) == r + 1 and np.shape(a)[0] == k
                    for a, r in zip(arrs, self._ext_ranks()))
            else:
                stacked = True
        if not stacked:
            return self._dispatch([tuple(feeds)])
        for i, f in enumerate(feeds):
            arr = _primary(f)
            if np.shape(arr)[-1] != self.frame_size:
                raise ValueError(
                    f"feed {i} has {np.shape(arr)[-1]} samples, expected "
                    f"frame_size={self.frame_size}"
                )
            if np.shape(arr)[0] != k:
                raise ValueError(
                    f"feed {i}: steps_per_dispatch={k} needs stacked "
                    f"[{k}, frame_size] feeds, got {np.shape(arr)}")
        if self._vectorized():
            return self._dispatch_vmap(feeds)
        per_frame = [tuple(_tree.tree_map(lambda a, j=j: a[j], f)
                           for f in feeds) for j in range(k)]
        return _stack(self._dispatch(per_frame, collect=True))

    def _vectorized(self) -> bool:
        """Whether a K-frame dispatch runs as one vmapped step: K > 1,
        ``vectorize``, external inputs, and every block stateless (its
        frames independent of each other), as JAX's ``Runner._wrap``
        decides."""
        return (self.vectorize and self.steps_per_dispatch > 1
                and bool(self._graph._external)
                and all(getattr(b, "stateless", False) for b in self._order))

    def _dispatch_vmap(self, feeds: tuple) -> dict:
        """The vectorised K-frame dispatch: the stacked [K, ...] feeds on
        the device in one copy each, the step vmapped over the frame axis
        with the states passed through unchanged (the stateless contract),
        then each frame's messages in frame order.  A block that cannot be
        vmapped raises; ``vectorize=False`` runs the loop instead."""
        t0 = time.perf_counter()
        k = self.steps_per_dispatch
        states, step_fn = self.states, self._step_fn
        with trace.span("runner.step"):
            try:
                tapped, messages = torch.func.vmap(
                    lambda fs: step_fn(states, fs)[1:])(self._to_device(feeds))
            except RuntimeError as e:
                if "vmap" not in str(e):
                    raise
                raise RuntimeError(
                    f"the vectorised {k}-frame dispatch cannot vmap this "
                    f"graph's step ({e}); compile with vectorize=False to run "
                    f"the frames one by one") from e
            for j in range(k):
                self._deliver(_tree.tree_map(lambda a, j=j: a[j], messages))
        self.stats["steps"] += k
        self.stats["wall_s"] += time.perf_counter() - t0
        self.stats["samples"] += self.frame_size * k
        self._debug_report(k)
        return tapped

    def _dispatch(self, frame_feeds: list[tuple], collect: bool = False):
        """Run the frames in order, threading state; then deliver each
        frame's messages in frame order.  Returns the tapped outputs of
        the one frame, or (``collect``) the list of them."""
        t0 = time.perf_counter()
        tapped_all, msgs_all = [], []
        states = self.states
        with trace.span("runner.step"):
            for feeds in frame_feeds:
                states, tapped, messages = self._step_fn(
                    states, self._to_device(feeds))
                tapped_all.append(tapped)
                msgs_all.append(messages)
            self.states = states
            for messages in msgs_all:
                self._deliver(messages)
        n = len(frame_feeds)
        self.stats["steps"] += n
        self.stats["wall_s"] += time.perf_counter() - t0
        self.stats["samples"] += self.frame_size * n
        self._debug_report(n)
        return tapped_all if collect else tapped_all[0]

    def _deliver(self, messages: dict) -> None:
        with trace.span("runner.deliver"):
            for key, val in messages.items():
                for h in self._msg_handlers.get(key, ()):
                    h(val)

    def _debug_report(self, k: int) -> None:
        """Per-block item counts (the reference's setDebug +
        CLPRINT_NITEMS, lib/GRCLBase.cpp:15)."""
        for b in self._order:
            if not b.debug:
                continue
            label = b.name or type(b).__name__
            items = self.frames.get((id(b), 0))
            if items is None and b.n_inputs:   # sink: report consumed items
                items = self.frame_size
            print(f"[clenabled_tpu_torch debug] {label}: {items} items/step "
                  f"× {k} steps (total steps {self.stats['steps']})")

    def throughput_msps(self) -> float:
        """Dispatch-side samples/s since creation (a lower bound unless
        the caller waits on the outputs)."""
        w = self.stats["wall_s"]
        return self.stats["samples"] / w / 1e6 if w else 0.0

    def run(self, feeds_iter, n_steps: int | None = None) -> list[dict]:
        """Drive from an iterator of PER-FRAME feed tuples; collects tapped
        outputs.  With steps_per_dispatch=K frames go K at a time (results
        carry a leading K axis; for the vectorised dispatch each port's K
        frames are stacked on the host first); a remainder of fewer than K
        frames at the end runs frame by frame, so every frame is
        processed."""
        k = self.steps_per_dispatch
        results = []
        group: list[tuple] = []
        for i, feeds in enumerate(feeds_iter):
            if n_steps is not None and i >= n_steps:
                break
            if k == 1:
                results.append(self.step(*feeds))
                continue
            group.append(tuple(feeds))
            if len(group) == k:
                if self._vectorized():
                    stacked = tuple(_tree.tree_map(_stack_host,
                                                   *(g[p] for g in group))
                                    for p in range(len(group[0])))
                    results.append(self._dispatch_vmap(stacked))
                else:
                    results.append(_stack(self._dispatch(group,
                                                         collect=True)))
                group = []
        for feeds in group:          # remainder < K: one frame at a time
            results.append(self._dispatch([feeds]))
        return results

    def reset(self) -> None:
        self.states = self._to_device(
            tuple(b.init_state() for b in self._order))

    # ---- live reconfiguration (the reference's runtime set_taps,
    # lib/clFilter_impl.cc:417-479: kernels/buffers rebuild while the
    # flowgraph keeps running) -------------------------------------------

    def refresh(self) -> None:
        """Rebuild the step after block reconfiguration (e.g. set_taps) and
        migrate every block's carried state into its new configuration
        (Block.migrate_state) — the stream continues without a reset.

        Raises if the new configuration is incompatible with the current
        frame size (quantum/rate checks re-run)."""
        order, step, frames, _ = self._graph._build(self.frame_size)
        if [id(b) for b in order] != [id(b) for b in self._order]:
            raise ValueError("refresh() cannot change the block set; "
                             "build a new flowgraph instead")
        states = tuple(b.migrate_state(st)
                       for b, st in zip(self._order, self.states))
        self._step_fn = step
        self.frames = frames
        self.states = self._to_device(states)

    def set_taps(self, block, taps) -> None:
        """Live filter retune: block.set_taps(taps) + refresh() in one call.
        The filter's carried tail is translated, not reset — where old and
        new taps agree the output stream is identical to an uninterrupted
        run.

        Atomic: if the new taps are incompatible with the running graph
        (quantum/rate validation in refresh()), the block is rolled back to
        its pre-call configuration and the stream keeps running on the old
        taps — no half-applied retune."""
        snapshot = dict(block.__dict__)
        try:
            block.set_taps(taps)
            self.refresh()
        except Exception:
            block.__dict__.clear()
            block.__dict__.update(snapshot)
            raise

    # ---- checkpoint / resume -------------------------------------------
    # The whole flowgraph state is one tree, so streaming state (filter
    # tails, loop phases, integration sums) checkpoints in one call and a
    # restarted process resumes the stream sample-exactly.

    def save_state(self, path: str) -> None:
        def host(x):
            return x.detach().cpu() if torch.is_tensor(x) else x
        with open(path, "wb") as f:
            pickle.dump(_tree.tree_map(host, self.states), f)

    def load_state(self, path: str) -> None:
        """Load a checkpoint written by ``save_state`` (a pickle: load only
        files this program wrote)."""
        with open(path, "rb") as f:
            data = pickle.load(f)
        if _tree.structure(data) != _tree.structure(self.states):
            raise ValueError("checkpoint does not match this flowgraph")
        self.states = self._to_device(data)


def _stack_host(*frames):
    """K per-frame feed leaves → one [K, ...] leaf where they are: numpy
    on the host, tensors on their device."""
    if any(torch.is_tensor(f) for f in frames):
        return torch.stack([torch.as_tensor(f) for f in frames])
    return np.stack(frames)


def _stack(tapped: list[dict]) -> dict:
    """Per-frame tapped outputs → one dict with a leading frame axis."""
    return {name: _tree.tree_map(lambda *xs: torch.stack(xs),
                                 *(t[name] for t in tapped))
            for name in tapped[0]}
