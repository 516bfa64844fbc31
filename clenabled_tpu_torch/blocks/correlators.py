"""Correlator blocks: XCorrelate (TD), XCorrelateFFTVCF (FD), XEngine (FX).

The port of ``clenabled_tpu.blocks.correlators``.
"""

from __future__ import annotations

import torch

from clenabled_tpu_torch.blocks._legacy import strip_legacy_kwargs
from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.dsp import xcorr as dsp_xcorr
from clenabled_tpu_torch.dsp import xengine as dsp_xengine
from clenabled_tpu_torch.runtime import trace
from clenabled_tpu_torch.streaming.block import Block

# an integer type as wide as one (time, channel) cell of P raw samples
_CELL_TYPES = {1: torch.int8, 2: torch.int16, 4: torch.int32}


class XCorrelate(Block):
    """clXCorrelate (lib/clXCorrelate_impl.cc): N-input time-domain
    reference correlator.  Sink block — results leave via the "corr"
    message port as {corr, corrective_lags, corrvect, valid}, the
    reference's PDU dict {corrvect, corrective_lags} (:1594-1601).

    Every whole window of a frame is correlated (a multi-rate super-frame
    may hold more than ``accumulate_frames`` of them).  ``decim_frames``
    processes 1 in N analysis windows (:1540-1548) by a window counter
    carried as state — a Python int on the host, so the choice to skip
    never waits on the card.  With one window a frame, a skipped window
    costs no correlation and emits zeros with ``valid`` False; with
    several, every window is computed, the window axis leads and ``valid``
    is [nb].  ``valid`` is a host tensor.  The reference's async
    worker-thread mode is unnecessary: the card runs behind the host.
    """

    n_outputs = 0
    msg_ports = ("corr",)

    def __init__(self, num_inputs: int, signal_length: int = 8192,
                 data_type: int = 1, data_size: int = 8,
                 max_search_index: int = 512, decim_frames: int = 1,
                 asynchronous: bool = False, accumulate_frames: int = 1,
                 name: str = "xcorr", **legacy):
        legacy.pop("async", None)
        strip_legacy_kwargs(legacy, self)
        del data_type, data_size, asynchronous  # dtype comes from the stream
        if num_inputs < 2:
            raise ValueError("XCorrelate needs >= 2 inputs")
        self.name = name
        self.n_inputs = num_inputs
        self.signal_length = signal_length
        self.max_shift = max_search_index
        self.decim_frames = max(1, decim_frames)
        # > 1 correlates N analysis windows a call; results gain a leading
        # window axis in the "corr" message
        self.accumulate_frames = max(1, accumulate_frames)
        self.quantum = signal_length * self.accumulate_frames

    def init_state(self):
        return 0  # analysis-window counter

    def apply(self, state, inputs):
        sl = self.signal_length
        is_planar = isinstance(inputs[0], planar.PC)
        first = inputs[0].re if is_planar else torch.as_tensor(inputs[0])
        nb = first.shape[-1] // sl
        state = int(state)
        valid = [(state + k) % self.decim_frames == 0 for k in range(nb)]

        def windows(x):
            """[..., nb·sl] → [nb, sl] windows of one input stream."""
            return x[..., : nb * sl].reshape(nb, sl)

        def correlate():
            if is_planar:
                mags = torch.stack([planar.pabs(planar.PC(windows(x.re),
                                                          windows(x.im)))
                                    for x in inputs])      # [A, nb, sl]
                return dsp_xcorr.td_xcorr_planar_batched(mags, self.max_shift)
            sigs = torch.stack([windows(torch.as_tensor(x)) for x in inputs])
            return dsp_xcorr.td_xcorr_batched(sigs, self.max_shift)

        if nb == 1:
            if valid[0]:
                res = correlate()
                corr, lag, vectors = (res.corr[:, 0], res.lag[:, 0],
                                      res.corr_vectors[:, 0])
            else:   # a skipped window: no correlation, zeros
                na, dev = self.n_inputs - 1, first.device
                corr = torch.zeros(na, device=dev)
                lag = torch.zeros(na, dtype=torch.int32, device=dev)
                vectors = torch.zeros((na, 2 * self.max_shift), device=dev)
            flags = torch.tensor(valid[0])
        else:
            res = correlate()
            # leading window axis: [nb, A-1(, 2·max_shift)]
            corr = res.corr.transpose(0, 1)
            lag = res.lag.transpose(0, 1)
            vectors = res.corr_vectors.transpose(0, 1)
            flags = torch.tensor(valid)
        msg = {"corr": {"corr": corr, "corrective_lags": lag,
                        "corrvect": vectors, "valid": flags}}
        return state + nb, (), msg


class XCorrelateFFTVCF(Block):
    """clxcorrelate_fft_vcf (lib/clxcorrelate_fft_vcf_impl.cc): N complex
    FFT-vector inputs → N-1 float correlation-magnitude vector outputs.
    input_type=1 expects spectra; 2 raw time series (FFT applied first)."""

    stateless = True

    def __init__(self, fft_size: int, num_inputs: int, input_type: int = 1,
                 accumulate_frames: int = 1, name: str = "fd_xcorr",
                 **legacy):
        strip_legacy_kwargs(legacy, self)
        if num_inputs < 2:
            raise ValueError("needs >= 2 inputs")
        self.name = name
        self.fft_size = fft_size
        self.n_inputs = num_inputs
        self.n_outputs = num_inputs - 1
        self.out_kinds = ("f",) * self.n_outputs
        self.perform_fft_first = input_type == 2
        # accumulate_frames raises the frame quantum so each step carries
        # N vectors, all correlated in one batched call
        self.accumulate_frames = max(1, accumulate_frames)
        self.quantum = fft_size * self.accumulate_frames

    def apply(self, state, inputs):
        if isinstance(inputs[0], planar.PC):
            v = planar.PC(
                torch.stack([x.re for x in inputs]).reshape(
                    self.n_inputs, -1, self.fft_size),
                torch.stack([x.im for x in inputs]).reshape(
                    self.n_inputs, -1, self.fft_size))
            out = dsp_xcorr.fd_xcorr_planar(
                v, perform_fft_first=self.perform_fft_first)
        else:
            v = torch.stack([torch.as_tensor(x) for x in inputs]).reshape(
                self.n_inputs, -1, self.fft_size)
            out = dsp_xcorr.fd_xcorr(v,
                                     perform_fft_first=self.perform_fft_first)
        flat = tuple(out[i].reshape(-1) for i in range(self.n_outputs))
        return state, flat, {}


class XEngine(Block):
    """clXEngine (lib/clXEngine_impl.cc): xGPU-style FX correlator sink.

    Each of the N antenna inputs carries one integration window per step:
    ``integration_time × num_channels × npol`` interleaved complex samples in
    [time][channel][pol] order (the reference marshals the same layout
    host-side, :982-1061), or their raw bytes: 2 per sample for IChar
    (``data_type=5``), 1 packed byte for PackedXY (6).  Emits the
    correlation matrix on the "xcorr" message port as {"matrix", "valid"}
    (``valid`` False while pipeline_integration holds it back), in
    triangular xGPU order or full-matrix format.

    channel_major (default on in planar mode) marshals each integration
    into [F, T, S·P] and runs the stacked Gram engine
    (``dsp_xengine.xengine_correlate_stacked``).  IChar and PackedXY samples
    stay int8 all the way to the Gram — on a CUDA device, with S·P a
    multiple of 128, the hand-written Gram kernel — and the quantization
    scale (1/127² or 1/7²) is applied once on the exact integer result.
    """

    n_outputs = 0
    msg_ports = ("xcorr",)

    def __init__(self, data_type: int, polarization: int, num_inputs: int,
                 output_format: int = dsp_xengine.CLXCORR_TRIANGULAR_ORDER,
                 first_channel: int = 0, num_channels: int = 256,
                 integration: int = 1024, antenna_list=None,
                 pipeline_integration: int = 0, planar: bool = False,
                 channel_major: bool | None = None, compute_dtype=None,
                 name: str = "xengine", **legacy):
        for k in ("output_file", "file_base", "rollover_size_mb",
                  "internal_synchronizer", "sync_timestamp", "object_name",
                  "starting_chan_center_freq", "channel_width",
                  "disable_output"):
            legacy.pop(k, None)
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.data_type = data_type
        self.npol = polarization
        self.n_inputs = num_inputs
        self.num_channels = num_channels
        self.integration = integration
        self.first_channel = first_channel
        self.antenna_list = list(antenna_list or [])
        self.output_format = output_format
        # stream items per integration window: complex samples, or raw bytes
        # (2 bytes/sample for IChar, 1 packed byte/sample for PackedXY)
        samples = integration * num_channels * self.npol
        self.quantum = samples * 2 if data_type == 5 else samples
        self.planar = planar
        if channel_major and not planar:
            raise ValueError(
                "channel_major (the stacked Gram engine) is planar-only — "
                "pass planar=True")
        if channel_major is None:
            channel_major = planar
        self.channel_major = bool(channel_major) and planar
        if self.channel_major:
            # raw-int ingest: quantization scale applied once on the Gram
            scale = {5: 1.0 / 127.0 ** 2, 6: 1.0 / 7.0 ** 2}.get(
                data_type, 1.0)
            self._init, self._apply = dsp_xengine.make_xengine_channel_major(
                num_inputs=num_inputs, num_channels=num_channels,
                npol=self.npol, integration_time=integration,
                output_format=output_format,
                pipeline_integration=pipeline_integration,
                compute_dtype=compute_dtype, scale=scale, device="cpu",
            )
        else:
            self._init, self._apply = dsp_xengine.make_xengine(
                num_inputs=num_inputs, num_channels=num_channels,
                npol=self.npol, integration_time=integration,
                output_format=output_format,
                pipeline_integration=pipeline_integration, planar=planar,
                device="cpu",
            )

    def init_state(self):
        """Zero accumulators on the CPU; the Runner moves them to its
        device."""
        return self._init()

    def _decode(self, stream):
        """Per-antenna raw stream → [T, F, P] complex64 (or planar.PC)."""
        shp = (self.integration, self.num_channels, self.npol)
        if self.planar:
            if self.data_type == 5:
                z = dsp_xengine.unpack_char_planar(stream)
            elif self.data_type == 6:
                z = dsp_xengine.unpack_packed_4bit_planar(stream)
            elif isinstance(stream, planar.PC):
                z = stream
            else:
                raise TypeError("planar XEngine expects PC or raw-byte feeds")
            return planar.PC(z.re.reshape(shp), z.im.reshape(shp))
        if self.data_type == 5:  # DTYPE_BYTE / IChar
            z = dsp_xengine.unpack_char(stream)
        elif self.data_type == 6:  # DTYPE_PACKEDXY
            z = dsp_xengine.unpack_packed_4bit(stream)
        else:
            z = torch.as_tensor(stream).to(torch.complex64)
        return z.reshape(shp)

    def _decode_int(self, streams):
        """Per-antenna raw byte streams → channel-major (re, im) int8
        [F, T, S·P], UNSCALED (the stacked engine's native ingest; the
        scale lands on the Gram).  The bytes of one (time, channel) cell —
        P samples — move as one 2- or 4-byte integer to [F, T, S] order,
        and are decoded there: decoding is per sample, so it commutes with
        the move, and whole cells move far faster than single bytes.

        Traced as ``xengine.decode``; ``xengine.decode_bytes`` counts the
        input bytes and the two planes' bytes, each once."""
        if self.data_type not in (5, 6):
            raise TypeError("int decode is only for IChar/PackedXY feeds")
        with trace.span("xengine.decode"):
            raw = torch.stack([dsp_xengine._as_bytes(x, torch.int8)
                               for x in streams])
            cell = raw.shape[-1] // (self.integration * self.num_channels)
            cells = raw.view(_CELL_TYPES[cell]).view(
                len(streams), self.integration, self.num_channels)
            fmaj = cells.permute(2, 1, 0).contiguous().view(torch.int8).view(
                self.num_channels, self.integration, -1)
            if self.data_type == 5:
                re, im = dsp_xengine.unpack_char_int8(fmaj)
                re, im = re.contiguous(), im.contiguous()
            else:
                re, im = dsp_xengine.unpack_packed_4bit_int8(fmaj)
            if trace.enabled():
                trace.count("xengine.decode_bytes",
                            raw.nbytes + re.nbytes + im.nbytes)
        return re, im

    def apply(self, state, inputs):
        if self.channel_major:
            if self.data_type in (5, 6):
                f_major = self._decode_int(inputs)
            else:
                # [S][T,F,P] → [F, T, S·P] (stations·pols last)
                parts = [(d.re, d.im) for d in map(self._decode, inputs)]
                f_major = tuple(
                    torch.stack([p[comp] for p in parts]).permute(2, 1, 0, 3)
                    .reshape(self.num_channels, self.integration, -1)
                    for comp in (0, 1))
            state, (out, ready) = self._apply(state, f_major)
            return state, (), {"xcorr": {"matrix": out, "valid": ready}}

        decoded = [self._decode(x) for x in inputs]
        if self.planar:
            z = planar.PC(torch.stack([d.re for d in decoded], dim=1),
                          torch.stack([d.im for d in decoded], dim=1))
        else:
            z = torch.stack(decoded, dim=1)  # [T,S,F,P]
        state, (out, ready) = self._apply(state, z)
        return state, (), {"xcorr": {"matrix": out, "valid": ready}}
