"""The X-Engine flowgraph (``blocks.XEngine`` through ``Flowgraph.compile
(...).step``) as a GNU Radio user runs it, its product copied to the host.

Traffic keys: ``data_type`` (5 IChar, 6 PackedXY), ``ring``
(integrations held on the card), ``in_flight`` (integrations handed over
before the host waits for the oldest product to land), ``signal`` (a sky
signal common to all stations of ``sigma_common`` plus station noise of
``sigma_noise``, in sample units, rounded and clipped to ``clip``),
``sample_stride``, ``samples`` (products kept for the comparison, each in
its own pinned buffer), ``control`` (``int4`` samples or a ``bfloat16``
product), ``warmup_steps``, ``trace_steps``.

Integration k reads ring slot k mod R: one row of raw bytes a station.
Every product the block emits is copied on a side stream into pinned host
memory, and a timing event recorded after the copy.  The dump time of
integration k runs from handing it to ``Runner.step`` (host clock) to
that event (the card's clock, placed on the host's by an event recorded
and waited for at the window's start), so no host thread's wake-up is in
it.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark.drivers import Phases, sampled
from benchmark.reference import xengine as ref_xe

_NULL = contextlib.nullcontext()


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, card):
        self.phases = Phases()
        from clenabled_tpu_torch import blocks
        from clenabled_tpu_torch.streaming import Flowgraph

        self.phases.mark("import")
        self.card, self.seed = card, seed
        s, p, f, t = (config["stations"], config["polarizations"],
                      config["channels"], config["integration"])
        self.s, self.p, self.f, self.t = s, p, f, t
        self.data_type = traffic["data_type"]
        self.control_kind = traffic["control"]
        self.ring_len = traffic["ring"]
        self.in_flight = traffic["in_flight"]
        self.keep = sampled(seed, traffic["sample_stride"])
        nb = s * (s + 1) // 2
        self.params = {"channels": f, "integration": t, "inputs": s * p,
                       "baselines": nb}
        self.xe = blocks.XEngine(
            data_type=self.data_type, polarization=p, num_inputs=s,
            num_channels=f, integration=t,
            output_format=config["output_format"],
            pipeline_integration=config["pipeline_integration"], planar=True)
        self.ring = self._bytes(traffic["signal"])
        card.sync()
        self.phases.mark("inputs")
        self.feeds = [tuple(raw[i] for i in range(s)) for raw in self.ring]
        graph = Flowgraph()
        for i in range(s):
            graph.external_input(self.xe, i)
        self.runner = graph.compile(self.xe.quantum, device=card.device)
        self.runner.on_message(f"{self.xe.name}.xcorr", self._on_product)
        shape = (f, nb, p * p)
        self.slots = [(card.host_empty(shape, torch.float32),
                       card.host_empty(shape, torch.float32))
                      for _ in range(self.in_flight)]
        self.spare = [(card.host_empty(shape, torch.float32),
                       card.host_empty(shape, torch.float32))
                      for _ in range(traffic["samples"])]
        self.side = card.stream()
        self.phases.mark("entry_and_buffers")
        self._reset()
        for k in range(traffic["warmup_steps"]):
            self._k = k
            self.runner.step(*self.feeds[k % self.ring_len])
        card.sync()
        self.phases.mark("warmup")
        self._reset()

    def _reset(self) -> None:
        self._k = 0
        self.done, self.kept, self.missing = {}, {}, 0
        self.free = list(self.spare)

    def _bytes(self, sig: dict) -> list:
        """The ring: R tensors of raw bytes [S, quantum], int8 for IChar,
        uint8 for PackedXY, from a common signal plus station noise."""
        g = self.card.generator(self.seed)
        dev, s = self.card.device, self.s
        cells = self.t * self.f * self.p
        clip = sig["clip"]
        ring = []
        for _ in range(self.ring_len):
            sky = torch.randn((1, cells, 2), generator=g, device=dev)
            x = torch.randn((s, cells, 2), generator=g, device=dev)
            x = x * sig["sigma_noise"] + sky * sig["sigma_common"]
            q = torch.clamp(torch.round(x), -clip, clip).to(torch.int8)
            if self.data_type == 5:
                ring.append(q.reshape(s, cells * 2))
            else:
                b = ((q[..., 0].to(torch.uint8) & 0xF) << 4) | \
                    (q[..., 1].to(torch.uint8) & 0xF)
                ring.append(b)
            del x, q
        return ring

    def _on_product(self, msg: dict) -> None:
        """The ``xcorr`` message of integration ``self._k``: its matrix
        copied on the side stream into host memory (a kept integration's
        into a buffer of its own), a timing event recorded after the
        copy."""
        k = self._k
        if not msg["valid"]:
            self.missing += 1
            return
        m = msg["matrix"]
        if self.keep(k) and self.free:
            dst = self.free.pop()
            self.kept[k] = dst
        else:
            dst = self.slots[k % self.in_flight]
        card = self.card
        card.hand_over(self.side, (m.re, m.im))
        with card.on(self.side):
            dst[0].copy_(m.re, non_blocking=True)
            dst[1].copy_(m.im, non_blocking=True)
            done = card.event(timing=True)
            done.record()
        self.done[k] = done

    def window(self, seconds: float, tracer=None) -> dict:
        runner, feeds, r, d = (self.runner, self.feeds, self.ring_len,
                               self.in_flight)
        span = tracer.span if tracer else (lambda name: _NULL)
        self._reset()
        handed = {}
        # the card's clock on the host's: an event on an idle card
        ref = self.card.event(timing=True)
        ref.record()
        ref.synchronize()
        t_ref = time.perf_counter()
        k = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while (now := time.perf_counter()) < deadline:
            if k >= d and k - d in self.done:
                self.done[k - d].synchronize()
            if tracer:
                deadline += tracer.step(k, now - t0)
            self._k = k
            handed[k] = time.perf_counter()
            with span("bench.xe.step"):
                runner.step(*feeds[k % r])
            k += 1
        if tracer:
            tracer.finish(k)
        self.card.sync()
        landed = {j: t_ref + ref.elapsed_time(ev) / 1e3
                  for j, ev in self.done.items()}
        end = max(landed.values(), default=time.perf_counter())
        lat = [(landed[j] - handed[j]) * 1e3 for j in handed if j in landed]
        self.missing += k - len(lat)
        self.dumps = lat
        return {"attempted": k, "metrics": {
            "xe_msps": len(lat) * self.t * self.f * self.p / (end - t0) / 1e6,
            "xe_dump_p95_ms": float(np.percentile(lat, 95)) if lat else
            float("inf")}}

    def answers(self) -> dict:
        return self.kept

    def release(self) -> None:
        self.runner = None
        self.xe = None
        self.card.free_cache()

    def _reference(self, slot: int, **kw):
        re, im = ref_xe.product(self.ring[slot], self.data_type, self.t,
                                self.f, self.p, **kw)
        return re.cpu(), im.cpu()

    def judge(self, answers: dict):
        """(numbers, failed): products' values that differ from the
        reference's, and products that never came."""
        bad, worst = 0, 0.0
        refs = {}
        for k, (re, im) in answers.items():
            slot = k % self.ring_len
            if slot not in refs:
                refs[slot] = self._reference(slot)
            for got, want in zip((re, im), refs[slot]):
                bad += int((got != want).sum())
                worst = max(worst, float((got - want).abs().nan_to_num(
                    float("inf")).max()))
        return {"mismatched": bad, "max_abs_err": worst,
                "products_missing": self.missing}, self.missing

    def control(self) -> dict:
        """The reference one precision below the configuration's, in the
        program's place: int4 samples, or the product rounded to
        bfloat16; one product a ring slot."""
        kw = ({"quantize": ref_xe.int4} if self.control_kind == "int4"
              else {"out_dtype": torch.bfloat16})
        return {k: self._reference(k, **kw) for k in range(self.ring_len)}
