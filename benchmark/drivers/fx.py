"""The fused FX step (``pipelines.make_fx_pipeline_fused``) over a ring of
distinct frames resident on the card.

Traffic keys: ``ingest`` (float32, bfloat16 or int8), ``ring`` (frames),
``in_flight`` (steps queued before the host waits), ``signal`` (a common
source of ``common_power`` delayed per antenna by up to ``max_delay``
samples, plus independent noise of ``noise_power``; int8 ingest scales by
``int8_scale``), ``sample_stride``, ``warmup_steps``, ``trace_steps``.

Each step hands the previous step's returned tails back, so the tails
chain through the window; the window starts from zero tails.  Step k
reads frame k mod R.  Its answers are the FD average, the two Gram planes
and the new tails; the reference recomputes each kept step from the frame
and the previous frame.
"""

from __future__ import annotations

import contextlib
import math
import random
import time

import torch

from benchmark.drivers import Phases, sampled
from benchmark.reference import firdes, round_tf32
from benchmark.reference import fx as ref_fx

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}
_NULL = contextlib.nullcontext()


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, card):
        self.phases = Phases()
        from clenabled_tpu_torch import pipelines

        self.phases.mark("import")
        self.card, self.seed = card, seed
        dev = card.device
        a, m, n = (config["num_antennas"], config["num_channels"],
                   config["samples_per_step"])
        self.a, self.m, self.n = a, m, n
        self.dtype = _DTYPES[traffic["ingest"]]
        self.fd_pairs = [tuple(p) for p in config["fd_pairs"]]
        self.xe_pairs = [tuple(p) for p in config["xe_pairs"]]
        proto = config["prototype"]
        self.taps = firdes.branch_taps(firdes.low_pass(
            proto["gain"], config["samp_rate"], proto["cutoff_hz"],
            proto["transition_hz"]), m)
        w = self.taps.shape[0]
        self.tail = ref_fx.tail_len(self.dtype.itemsize, m, w * m)
        self.ring_len = traffic["ring"]
        self.in_flight = traffic["in_flight"]
        self.keep = sampled(seed, traffic["sample_stride"])
        self.ring = self._frames(traffic)
        card.sync()
        self.phases.mark("inputs")
        self.params = {"num_antennas": a, "num_channels": m,
                       "samples_per_step": n, "tail_len": self.tail,
                       "tap_rows": w, "ingest_bytes": self.dtype.itemsize,
                       "fd_pairs": len(self.fd_pairs),
                       "xe_pairs": len(self.xe_pairs)}
        self.fn, (_, _, tail, _) = pipelines.make_fx_pipeline_fused(
            pipelines.FxPipelineConfig(num_antennas=a, num_channels=m,
                                       samples_per_step=n),
            samp_rate=config["samp_rate"], in_dtype=self.dtype,
            fd_pairs=self.fd_pairs, xe_pairs=self.xe_pairs, device=dev)
        self.tail0 = torch.zeros_like(tail)
        self.kept = {}
        tr = ti = self.tail0
        for k in range(traffic["warmup_steps"]):
            _, _, _, tr, ti = self.fn(*self.ring[k % self.ring_len], tr, ti)
        card.sync()
        self.phases.mark("entry_and_warmup")

    def _frames(self, traffic: dict) -> list:
        """The ring: R frames of (re, im) [A, N] in the ingest dtype."""
        sig = traffic["signal"]
        dmax = sig["max_delay"]
        rng = random.Random(self.seed)
        delays = [0] + [rng.randint(1, dmax) for _ in range(self.a - 1)]
        g = self.card.generator(self.seed)
        dev, a, n = self.card.device, self.a, self.n
        ring = []
        for _ in range(self.ring_len):
            src = torch.randn((2, n + dmax), generator=g, device=dev)
            x = torch.randn((2, a, n), generator=g, device=dev)
            x *= math.sqrt(sig["noise_power"] / 2)
            src *= math.sqrt(sig["common_power"] / 2)
            for ant, d in enumerate(delays):
                x[:, ant] += src[:, dmax - d:dmax - d + n]
            if self.dtype == torch.int8:
                x = torch.clamp(torch.round(x * sig["int8_scale"]), -127, 127)
            x = x.to(self.dtype)
            ring.append((x[0], x[1]))
        return ring

    def window(self, seconds: float, tracer=None) -> dict:
        fn, ring, r, d = self.fn, self.ring, self.ring_len, self.in_flight
        card, keep = self.card, self.keep
        events = [card.event() for _ in range(d + 1)]
        span = tracer.span if tracer else (lambda name: _NULL)
        kept = {}
        tr = ti = self.tail0
        k = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while (now := time.perf_counter()) < deadline:
            if tracer:
                deadline += tracer.step(k, now - t0)
            xr, xi = ring[k % r]
            with span("bench.fx.forward"):
                out = fn(xr, xi, tr, ti)
            tr, ti = out[3], out[4]
            if k == 0 or keep(k):
                kept[k] = out
            events[k % (d + 1)].record()
            if k >= d:
                events[(k - d) % (d + 1)].synchronize()
            k += 1
        if tracer:
            tracer.finish(k)
        card.sync()
        secs = time.perf_counter() - t0
        self.kept = kept
        return {"attempted": k,
                "metrics": {"fx_msps": k * self.n / secs / 1e6}}

    def answers(self) -> dict:
        return self.kept

    def release(self) -> None:
        self.fn = None
        self.kept = {}
        self.card.free_cache()

    def _case(self, k: int):
        return k % self.ring_len, ((k - 1) % self.ring_len if k else None)

    def _reference(self, case, dtype=torch.float64, rnd=None):
        cur, prev = case
        xr, xi = self.ring[cur]
        pr, pi = self.ring[prev] if prev is not None else (None, None)
        return ref_fx.fx_step(xr, xi, pr, pi, self.taps, self.tail,
                              self.fd_pairs, self.xe_pairs, dtype=dtype,
                              rnd=rnd)

    def judge(self, answers: dict):
        """(numbers, failed): the FD average's and the Gram's largest
        difference from the reference, each over the largest magnitude of
        the reference's; the tail samples that differ from the frame's."""
        cases = {}
        for k in answers:
            cases.setdefault(self._case(k), []).append(k)
        fd_err = gram_err = 0.0
        tail_bad = failed = 0
        for case, ks in cases.items():
            fd, g_re, g_im = self._reference(case)
            want = [t[:, self.n - self.tail:] for t in self.ring[case[0]]]
            fd_scale = float(fd.abs().max())
            g_scale = float(torch.maximum(g_re.abs().max(), g_im.abs().max()))
            for k in ks:
                p_fd, p_re, p_im, p_tr, p_ti = answers[k]
                e_fd = float((p_fd.to(fd.device, fd.dtype) - fd).abs().max())
                e_g = max(float((p.to(g_re.device)[:, :, 0].T.to(g_re.dtype)
                                 - q).abs().max())
                          for p, q in ((p_re, g_re), (p_im, g_im)))
                bad = sum(int((p.to(q.device) != q).sum())
                          for p, q in zip((p_tr, p_ti), want))
                e_fd, e_g = e_fd / fd_scale, e_g / g_scale
                if not (math.isfinite(e_fd) and math.isfinite(e_g)):
                    e_fd = e_g = math.inf
                fd_err, gram_err = max(fd_err, e_fd), max(gram_err, e_g)
                tail_bad += bad
                failed += bool(bad) or not math.isfinite(e_fd)
        return {"fd_err": fd_err, "gram_err": gram_err,
                "tail_mismatch": tail_bad}, failed

    def control(self) -> dict:
        """The reference in float32 with TF32 operands, in the program's
        place, for step 0 and one step of each later case."""
        out = {}
        for k in range(self.ring_len + 1):
            fd, g_re, g_im = self._reference(self._case(k), torch.float32,
                                             round_tf32)
            tails = [t[:, self.n - self.tail:].clone()
                     for t in self.ring[k % self.ring_len]]
            out[k] = (fd, g_re.T[:, :, None], g_im.T[:, :, None], *tails)
        return out
