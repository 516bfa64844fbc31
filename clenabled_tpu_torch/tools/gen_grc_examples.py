"""Generate the example .grc flowgraph corpus of the port.

The reference ships 16 ready-made demo flowgraphs (examples/*.grc — e.g.
examples/xcorr_test_opencl.grc, examples/xcorr_clxengine.grc) plus 19
per-block comparison flowgraphs (examples/test_flowgraphs/*.grc).  For a
GNU Radio user those files are the product tour, so this emits loadable
mirrors built around the ``clenabled_tpu_torch_*`` descriptors in
``clenabled_tpu_torch/grc/`` (``tools/gen_grc_yaml.py``), into
``clenabled_tpu_torch/examples/grc/``: the same 28 flowgraphs as the JAX
package's ``tools/gen_grc_examples.py``,

  * the SDR hardware sources (uhd_usrp_source, rtlsdr_source) become
    analog signal + noise sources — the demos must run anywhere;
  * the Qt GUI sinks become head + null sinks (run-to-completion);
  * every port block keeps the reference flowgraph's role and topology;
  * the FFT round trip's rescale is ``1.0/fft_size``, so it follows the
    flowgraph's own ``fft_size`` variable.

Each mirror cites its reference original in the options comment.
``tests/test_torch_grc.py`` checks that this script reproduces the
committed files byte for byte, that every .grc parses and connects, that
every ``clenabled_tpu_torch_*`` block instantiates a real port block
through ``gr_compat.wrap`` with the flowgraph's own parameter values, and
that every such parameter is declared in the block's descriptor.

    python -m clenabled_tpu_torch.tools.gen_grc_examples \
        [--outdir clenabled_tpu_torch/examples/grc]
"""

from __future__ import annotations

import argparse
import os

import yaml


# --------------------------------------------------------------------------
# compact builders for stock GNU Radio blocks (parameter sets mirror the
# fields GRC 3.10 emits for each block id, so the files load cleanly)
# --------------------------------------------------------------------------

def var(name, value):
    return (name, "variable", {"value": str(value)})


def sig_source(name, freq="1000", amp="1", waveform="analog.GR_COS_WAVE",
               samp_rate="samp_rate", out_type="complex"):
    return (name, "analog_sig_source_x", {
        "amp": str(amp), "freq": str(freq), "offset": "0", "phase": "0",
        "samp_rate": samp_rate, "type": out_type, "waveform": waveform,
        "showports": "False"})


def noise_source(name, amp="0.01"):
    return (name, "analog_noise_source_x", {
        "amp": str(amp), "noise_type": "analog.GR_GAUSSIAN", "seed": "0",
        "type": "complex"})


def add_cc(name, n="2"):
    return (name, "blocks_add_xx", {"num_inputs": str(n), "type": "complex",
                                    "vlen": "1"})


def sub_xx(name, typ="complex", n="2"):
    return (name, "blocks_sub_xx", {"num_inputs": str(n), "type": typ,
                                    "vlen": "1"})


def delay(name, d="delay_samps"):
    return (name, "blocks_delay", {"delay": str(d), "num_ports": "1",
                                   "type": "complex", "showports": "False"})


def throttle(name, rate="samp_rate"):
    return (name, "blocks_throttle", {"ignoretag": "True",
                                      "samples_per_second": rate,
                                      "type": "complex", "vlen": "1"})


def head(name, n="1048576", typ="complex"):
    return (name, "blocks_head", {"num_items": str(n), "type": typ,
                                  "vlen": "1"})


def null_sink(name, typ="complex", n="1", vlen="1"):
    return (name, "blocks_null_sink", {"bus_structure_sink": "[[0,],]",
                                       "num_inputs": str(n), "type": typ,
                                       "vlen": vlen})


def complex_to_mag(name):
    return (name, "blocks_complex_to_mag", {"vlen": "1"})


def conjugate_cc(name):
    return (name, "blocks_conjugate_cc", {})


def stream_to_vector(name, vlen="fft_size"):
    return (name, "blocks_stream_to_vector", {"num_items": str(vlen),
                                              "type": "complex", "vlen": "1"})


def vector_to_stream(name, vlen="fft_size", typ="float"):
    return (name, "blocks_vector_to_stream", {"num_items": str(vlen),
                                              "type": typ, "vlen": "1"})


def fft_vxx(name, size="fft_size"):
    return (name, "fft_vxx", {
        "fft_size": str(size), "forward": "True", "nthreads": "1",
        "shift": "False", "type": "complex", "window": "[]"})


def port(name, bid, **params):
    return (name, f"clenabled_tpu_torch_{bid}",
            {k: str(v) for k, v in params.items()})


# --------------------------------------------------------------------------
# flowgraph specs
# --------------------------------------------------------------------------

_XCORR_COMMENT = (
    "Mirror of {ref}: correlate a reference path against a delayed copy "
    "with independent noise, recovering the delay from the port's "
    "cross-correlator's 'corr' message (the reference feeds "
    "xcorrelate_ExtractDelay; any message sink/handler works here).  SDR "
    "source replaced by signal+noise so the demo runs anywhere.")

SPECS: dict[str, dict] = {}

SPECS["xcorr_test"] = {
    "title": "GPU cross-correlation demo (2 signals)",
    "comment": _XCORR_COMMENT.format(
        ref="examples/xcorr_test_opencl.grc"),
    "blocks": [
        var("samp_rate", "1e6"),
        var("delay_samps", "300"),
        var("corr_frame_size", "8192"),
        var("max_search", "512"),
        sig_source("src", freq="10e3"),
        noise_source("noise_a", "0.02"),
        noise_source("noise_b", "0.02"),
        add_cc("path_a"),
        add_cc("path_b_sum"),
        delay("path_b"),
        port("xcorr", "clXCorrelate", num_inputs=2,
            signal_length="corr_frame_size", max_search="max_search",
            decim_frames=2),
    ],
    "connections": [
        ("src", "0", "path_a", "0"), ("noise_a", "0", "path_a", "1"),
        ("src", "0", "path_b_sum", "0"), ("noise_b", "0", "path_b_sum", "1"),
        ("path_b_sum", "0", "path_b", "0"),
        ("path_a", "0", "xcorr", "0"), ("path_b", "0", "xcorr", "1"),
    ],
}

SPECS["xcorr_test_4_signals"] = {
    "title": "GPU cross-correlation demo (4 signals)",
    "comment": _XCORR_COMMENT.format(
        ref="examples/xcorr_test_opencl_4_signals.grc"),
    "blocks": [
        var("samp_rate", "1e6"),
        var("corr_frame_size", "8192"),
        var("max_search", "512"),
        sig_source("src", freq="10e3"),
        noise_source("noise_0", "0.02"), noise_source("noise_1", "0.02"),
        noise_source("noise_2", "0.02"), noise_source("noise_3", "0.02"),
        add_cc("path_0"), add_cc("path_1s"), add_cc("path_2s"),
        add_cc("path_3s"),
        delay("path_1", "150"), delay("path_2", "300"),
        delay("path_3", "450"),
        port("xcorr", "clXCorrelate", num_inputs=4,
            signal_length="corr_frame_size", max_search="max_search",
            decim_frames=2),
    ],
    "connections": [
        ("src", "0", "path_0", "0"), ("noise_0", "0", "path_0", "1"),
        ("src", "0", "path_1s", "0"), ("noise_1", "0", "path_1s", "1"),
        ("src", "0", "path_2s", "0"), ("noise_2", "0", "path_2s", "1"),
        ("src", "0", "path_3s", "0"), ("noise_3", "0", "path_3s", "1"),
        ("path_1s", "0", "path_1", "0"), ("path_2s", "0", "path_2", "0"),
        ("path_3s", "0", "path_3", "0"),
        ("path_0", "0", "xcorr", "0"), ("path_1", "0", "xcorr", "1"),
        ("path_2", "0", "xcorr", "2"), ("path_3", "0", "xcorr", "3"),
    ],
}

SPECS["xcorr_max_rate_no_ui"] = {
    "title": "GPU cross-correlation at max rate (no UI)",
    "comment": "Mirror of examples/xcorr_test_max_rate_no_ui.grc: the "
               "throughput-benchmark variant — no GUI, no throttle, head "
               "blocks bound the run.  " + _XCORR_COMMENT.format(
                   ref="examples/xcorr_test_max_rate_no_ui.grc"),
    "blocks": [
        var("samp_rate", "1e6"),
        var("delay_samps", "300"),
        sig_source("src", freq="10e3"),
        noise_source("noise_a", "0.02"),
        noise_source("noise_b", "0.02"),
        add_cc("path_a"),
        add_cc("path_b_sum"),
        delay("path_b"),
        head("head_a", "8388608"), head("head_b", "8388608"),
        port("xcorr", "clXCorrelate", num_inputs=2, signal_length=8192,
            max_search=512, decim_frames=1),
    ],
    "connections": [
        ("src", "0", "path_a", "0"), ("noise_a", "0", "path_a", "1"),
        ("src", "0", "path_b_sum", "0"), ("noise_b", "0", "path_b_sum", "1"),
        ("path_b_sum", "0", "path_b", "0"),
        ("path_a", "0", "head_a", "0"), ("path_b", "0", "head_b", "0"),
        ("head_a", "0", "xcorr", "0"), ("head_b", "0", "xcorr", "1"),
    ],
}

SPECS["xcorr_clxengine"] = {
    "title": "GPU X-Engine FX correlator demo",
    "comment": "Mirror of examples/xcorr_clxengine.grc: N antenna streams "
               "into the port's X-Engine (FX correlator); integrated "
               "cross-power baselines publish on the 'xcorr' message port "
               "(the reference feeds xcorrelate_triangular_to_full and a "
               "frequency sink).  RTL-SDR sources replaced by signal+noise "
               "chains so the demo runs anywhere.",
    "blocks": [
        var("samp_rate", "2.4e6"),
        var("num_channels", "256"),
        var("integration", "1024"),
        sig_source("ant_src", freq="250e3"),
        noise_source("ant_n0", "0.05"), noise_source("ant_n1", "0.05"),
        noise_source("ant_n2", "0.05"), noise_source("ant_n3", "0.05"),
        add_cc("ant_0"), add_cc("ant_1"), add_cc("ant_2"), add_cc("ant_3"),
        port("xengine", "clXEngine", data_type=1, polarization=1,
            num_inputs=4, num_channels="num_channels",
            integration="integration", antenna_list="[]"),
    ],
    "connections": [
        ("ant_src", "0", "ant_0", "0"), ("ant_n0", "0", "ant_0", "1"),
        ("ant_src", "0", "ant_1", "0"), ("ant_n1", "0", "ant_1", "1"),
        ("ant_src", "0", "ant_2", "0"), ("ant_n2", "0", "ant_2", "1"),
        ("ant_src", "0", "ant_3", "0"), ("ant_n3", "0", "ant_3", "1"),
        ("ant_0", "0", "xengine", "0"), ("ant_1", "0", "xengine", "1"),
        ("ant_2", "0", "xengine", "2"), ("ant_3", "0", "xengine", "3"),
    ],
}

SPECS["freq_domain_xcorr"] = {
    "title": "GPU frequency-domain cross-correlation",
    "comment": "Mirror of examples/freq_domain_xcorr_opencl.grc: two "
               "paths → stream_to_vector → forward FFT → the port's FD "
               "correlator (input_type=1, spectra in), correlation "
               "magnitude vector out to a sink (the reference drives "
               "qtgui_vector_sink_f + VectorMaxIndexToVar).",
    "blocks": [
        var("samp_rate", "1e6"),
        var("fft_size", "2048"),
        sig_source("src", freq="10e3"),
        noise_source("noise_a", "0.02"),
        noise_source("noise_b", "0.02"),
        add_cc("path_a"), add_cc("path_b_sum"),
        delay("path_b", "64"),
        stream_to_vector("vec_a"), stream_to_vector("vec_b"),
        fft_vxx("fft_a"), fft_vxx("fft_b"),
        port("fdx", "clxcorrelate_fft_vcf", fft_size="fft_size",
            num_inputs=2, input_type=1),
        vector_to_stream("tostream"),
        null_sink("sink", "float"),
    ],
    "connections": [
        ("src", "0", "path_a", "0"), ("noise_a", "0", "path_a", "1"),
        ("src", "0", "path_b_sum", "0"), ("noise_b", "0", "path_b_sum", "1"),
        ("path_b_sum", "0", "path_b", "0"),
        ("path_a", "0", "vec_a", "0"), ("path_b", "0", "vec_b", "0"),
        ("vec_a", "0", "fft_a", "0"), ("vec_b", "0", "fft_b", "0"),
        ("fft_a", "0", "fdx", "0"), ("fft_b", "0", "fdx", "1"),
        ("fdx", "0", "tostream", "0"),
        ("tostream", "0", "sink", "0"),
    ],
}

SPECS["fft_xcorr_streams"] = {
    "title": "GPU FD cross-correlation, time-domain inputs (3 streams)",
    "comment": "Mirror of examples/fft_xcorr_opencl_uhd2_30MSPS.grc: the "
               "FD correlator in input_type=2 (TIME domain) mode does its "
               "own FFTs on-device — three time-stream paths in, two "
               "correlation vectors out.  UHD source replaced by "
               "signal+noise chains.",
    "blocks": [
        var("samp_rate", "30e6"),
        var("fft_size", "2048"),
        sig_source("src", freq="100e3"),
        noise_source("noise_0", "0.02"), noise_source("noise_1", "0.02"),
        noise_source("noise_2", "0.02"),
        add_cc("path_0"), add_cc("path_1s"), add_cc("path_2s"),
        delay("path_1", "100"), delay("path_2", "200"),
        stream_to_vector("vec_0"), stream_to_vector("vec_1"),
        stream_to_vector("vec_2"),
        port("fdx", "clxcorrelate_fft_vcf", fft_size="fft_size",
            num_inputs=3, input_type=2),
        vector_to_stream("tostream_0"), vector_to_stream("tostream_1"),
        null_sink("sink_0", "float"), null_sink("sink_1", "float"),
    ],
    "connections": [
        ("src", "0", "path_0", "0"), ("noise_0", "0", "path_0", "1"),
        ("src", "0", "path_1s", "0"), ("noise_1", "0", "path_1s", "1"),
        ("src", "0", "path_2s", "0"), ("noise_2", "0", "path_2s", "1"),
        ("path_1s", "0", "path_1", "0"), ("path_2s", "0", "path_2", "0"),
        ("path_0", "0", "vec_0", "0"), ("path_1", "0", "vec_1", "0"),
        ("path_2", "0", "vec_2", "0"),
        ("vec_0", "0", "fdx", "0"), ("vec_1", "0", "fdx", "1"),
        ("vec_2", "0", "fdx", "2"),
        ("fdx", "0", "tostream_0", "0"), ("fdx", "1", "tostream_1", "0"),
        ("tostream_0", "0", "sink_0", "0"),
        ("tostream_1", "0", "sink_1", "0"),
    ],
}

# ---- per-block comparison flowgraphs (examples/test_flowgraphs mirrors):
# port block vs the stock GR implementation, difference into a sink — the
# reference's A/B verification pattern.

SPECS["test_complex_conj"] = {
    "title": "A/B: GPU complex conjugate vs GR native",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-ComplexConj"
               ".grc: same source through clComplexConjugate and GR's "
               "conjugate_cc, difference to a sink (should be ~0).",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src", freq="10e3"),
        port("conj_gpu", "clComplexConjugate"),
        conjugate_cc("conj_gr"),
        sub_xx("diff"),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "conj_gpu", "0"), ("src", "0", "conj_gr", "0"),
        ("conj_gpu", "0", "diff", "0"), ("conj_gr", "0", "diff", "1"),
        ("diff", "0", "sink", "0"),
    ],
}

SPECS["test_complex_to_mag"] = {
    "title": "A/B: GPU complex-to-mag vs GR native",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-ComplexToMag"
               ".grc.",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src", freq="10e3"),
        port("mag_gpu", "clComplexToMag"),
        complex_to_mag("mag_gr"),
        sub_xx("diff", "float"),
        null_sink("sink", "float"),
    ],
    "connections": [
        ("src", "0", "mag_gpu", "0"), ("src", "0", "mag_gr", "0"),
        ("mag_gpu", "0", "diff", "0"), ("mag_gr", "0", "diff", "1"),
        ("diff", "0", "sink", "0"),
    ],
}

SPECS["test_complex_to_arg"] = {
    "title": "GPU complex-to-arg",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-ComplexToArg"
               ".grc (the reference compares against native "
               "complex_to_arg; note its fast_atan2f LUT differs from the "
               "exact atan2 in the last digits).",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src", freq="10e3"),
        port("arg_gpu", "clComplexToArg"),
        null_sink("sink", "float"),
    ],
    "connections": [
        ("src", "0", "arg_gpu", "0"), ("arg_gpu", "0", "sink", "0"),
    ],
}

SPECS["test_mult_add_const"] = {
    "title": "GPU multiply-const + add-const chain",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-Mult-Add-"
               "Const.grc: back-to-back elementwise constant ops.",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src", freq="10e3"),
        port("mult", "clMultConst", k="2.0"),
        port("add", "clAddConst", k="0.5"),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "mult", "0"), ("mult", "0", "add", "0"),
        ("add", "0", "sink", "0"),
    ],
}

SPECS["test_mult_add_subtract"] = {
    "title": "GPU multiply / add / subtract (2-input elementwise)",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-Mult-Add-"
               "Subtract.grc: the two-input elementwise family.",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src_a", freq="10e3"),
        sig_source("src_b", freq="20e3"),
        port("mult", "clMultiply"),
        port("add", "clAdd"),
        port("sub", "clSubtract"),
        null_sink("sink"),
    ],
    "connections": [
        ("src_a", "0", "mult", "0"), ("src_b", "0", "mult", "1"),
        ("mult", "0", "add", "0"), ("src_b", "0", "add", "1"),
        ("add", "0", "sub", "0"), ("src_a", "0", "sub", "1"),
        ("sub", "0", "sink", "0"),
    ],
}

SPECS["test_mult_log10"] = {
    "title": "GPU multiply + log10 chain",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-Mult-Log10"
               ".grc: power then dB through the port's Log10 block.",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src", freq="10e3"),
        port("mult", "clMultiplyConjugate"),
        complex_to_mag("mag"),
        port("log10", "clLog10", n="10.0", k="0.0"),
        null_sink("sink", "float"),
    ],
    "connections": [
        ("src", "0", "mult", "0"), ("src", "0", "mult", "1"),
        ("mult", "0", "mag", "0"), ("mag", "0", "log10", "0"),
        ("log10", "0", "sink", "0"),
    ],
}

SPECS["test_log"] = {
    "title": "GPU natural-log-form block (clLog)",
    "comment": "Mirror of the reference's clLog block flowgraph role "
               "(grc/clenabled_clLog.block.yml): n*log10(x)+k on a float "
               "stream, the clLog companion to clLog10.",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src", freq="10e3"),
        complex_to_mag("mag"),
        port("log", "clLog", n="1.0", k="0.0"),
        null_sink("sink", "float"),
    ],
    "connections": [
        ("src", "0", "mag", "0"), ("mag", "0", "log", "0"),
        ("log", "0", "sink", "0"),
    ],
}

SPECS["test_snr_helper"] = {
    "title": "GPU SNR helper",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-SNR-Helper"
               ".grc.",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src", freq="10e3"),
        complex_to_mag("mag"),
        port("snr", "clSNR", n="10.0", k="0.0"),
        null_sink("sink", "float"),
    ],
    "connections": [
        ("src", "0", "mag", "0"), ("mag", "0", "snr", "0"),
        ("snr", "0", "sink", "0"),
    ],
}

SPECS["test_fft"] = {
    "title": "GPU forward FFT",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-FFT.grc.",
    "blocks": [
        var("samp_rate", "1e6"),
        var("fft_size", "2048"),
        sig_source("src", freq="10e3"),
        port("fft", "clFFT", fft_size="fft_size", direction=1,
            window="None", shift="False", num_streams=1),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "fft", "0"), ("fft", "0", "sink", "0"),
    ],
}

SPECS["test_fft_rev"] = {
    "title": "GPU FFT forward → reverse round trip",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-FFT-Rev.grc:"
               " fwd then rev FFT; like clFFT the reverse pass is UNSCALED "
               "(clFFT backward scale forced to 1.0), so the round trip "
               "gains a factor of fft_size.",
    "blocks": [
        var("samp_rate", "1e6"),
        var("fft_size", "2048"),
        sig_source("src", freq="10e3"),
        port("fft_fwd", "clFFT", fft_size="fft_size", direction=1,
            window="None", shift="False", num_streams=1),
        port("fft_rev", "clFFT", fft_size="fft_size", direction=-1,
            window="None", shift="False", num_streams=1),
        port("rescale", "clMultConst", k="1.0/fft_size"),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "fft_fwd", "0"), ("fft_fwd", "0", "fft_rev", "0"),
        ("fft_rev", "0", "rescale", "0"), ("rescale", "0", "sink", "0"),
    ],
}

SPECS["test_fft_multstreams"] = {
    "title": "GPU FFT over multiple parallel streams",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-FFT-"
               "MultStreams.grc: one clFFT block batch-transforms N "
               "parallel streams in a single device pass (one batched "
               "transform instead of the reference's per-stream kernels).",
    "blocks": [
        var("samp_rate", "1e6"),
        var("fft_size", "1024"),
        sig_source("src_a", freq="10e3"),
        sig_source("src_b", freq="25e3"),
        port("fft", "clFFT", fft_size="fft_size", direction=1,
            window="None", shift="False", num_streams=2),
        null_sink("sink_a"), null_sink("sink_b"),
    ],
    "connections": [
        ("src_a", "0", "fft", "0"), ("src_b", "0", "fft", "1"),
        ("fft", "0", "sink_a", "0"), ("fft", "1", "sink_b", "0"),
    ],
}

SPECS["test_filter"] = {
    "title": "GPU low-pass filter (frequency-domain)",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-Filter.grc: "
               "the designer-driven LPF in overlap-add FFT mode.",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src", freq="10e3"),
        port("lpf", "clLowPassFilter", decimation=1, gain="1.0",
            samp_rate="samp_rate", cutoff_freq="100e3",
            transition_width="50e3", use_time="False"),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "lpf", "0"), ("lpf", "0", "sink", "0"),
    ],
}

SPECS["test_filter_tapbased"] = {
    "title": "GPU FIR tap filter (frequency-domain)",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-Filter-"
               "TapBased.grc: user-supplied taps, OFA mode.",
    "blocks": [
        var("samp_rate", "1e6"),
        var("taps", "[0.04]*25"),
        sig_source("src", freq="10e3"),
        port("fir", "clFIRTapFilter", decimation=1, taps="taps",
            use_time="False"),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "fir", "0"), ("fir", "0", "sink", "0"),
    ],
}

SPECS["test_filter_tapbased_time"] = {
    "title": "GPU FIR tap filter (time-domain)",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-Filter-"
               "TapBased-Time.grc: user-supplied taps, direct TD FIR "
               "(the fir_direct kernel on the card).",
    "blocks": [
        var("samp_rate", "1e6"),
        var("taps", "[0.04]*25"),
        sig_source("src", freq="10e3"),
        port("fir", "clFIRTapFilter", decimation=1, taps="taps",
            use_time="True"),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "fir", "0"), ("fir", "0", "sink", "0"),
    ],
}

SPECS["test_complex_filter_time"] = {
    "title": "GPU complex-tap filter (time-domain)",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-"
               "ComplexFilter-TapBased-Time.grc: complex taps, TD FIR.",
    "blocks": [
        var("samp_rate", "1e6"),
        var("taps", "[0.04+0.01j]*25"),
        sig_source("src", freq="10e3"),
        port("fir", "clComplexFilter", decimation=1, taps="taps",
            use_time="True"),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "fir", "0"), ("fir", "0", "sink", "0"),
    ],
}

SPECS["test_polyphase_channelizer"] = {
    "title": "GPU polyphase channelizer",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-Polyphase"
               "Channelizer.grc (its parameters: 16 channels, critically "
               "sampled, all channels mapped).",
    "blocks": [
        var("samp_rate", "1e6"),
        var("num_channels", "16"),
        var("pfb_taps", "[0.01]*64"),
        sig_source("src", freq="10e3"),
        port("pfb", "clPolyphaseChannelizer", taps="pfb_taps",
            buf_items=8192, num_channels="num_channels",
            ninputs_per_iter="num_channels",
            ch_map="list(range(num_channels))"),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "pfb", "0"), ("pfb", "0", "sink", "0"),
    ],
}

SPECS["test_sigsource"] = {
    "title": "GPU signal source",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-SigSource"
               ".grc: the port's block generates the stream on the device "
               "in frame_size batches.",
    "blocks": [
        var("samp_rate", "1e6"),
        port("src", "clSignalSource", samp_rate="samp_rate", waveform=1,
            freq="10e3", amplitude="1.0", frame_size=8192),
        throttle("thr"),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "thr", "0"), ("thr", "0", "sink", "0"),
    ],
}

SPECS["test_magphase_roundtrip"] = {
    "title": "GPU mag/phase decompose + recompose round trip",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-"
               "MagPhaseToComplex.grc (+ ComplexToMagPhase): decompose to "
               "mag/phase and rebuild; difference vs the source is ~0.",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src", freq="10e3"),
        port("decomp", "clComplexToMagPhase"),
        port("recomp", "clMagPhaseToComplex"),
        sub_xx("diff"),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "decomp", "0"),
        ("decomp", "0", "recomp", "0"), ("decomp", "1", "recomp", "1"),
        ("recomp", "0", "diff", "0"), ("src", "0", "diff", "1"),
        ("diff", "0", "sink", "0"),
    ],
}

SPECS["test_costas_loop"] = {
    "title": "GPU Costas loop",
    "comment": "Carrier recovery on a noisy BPSK-like tone through the "
               "port's Costas loop (planar, the exact sequential kernel; "
               "blocks/demod).  Role of the reference's test-clenabled "
               "--testcostas path.",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src", freq="1e3"),
        noise_source("noise", "0.05"),
        add_cc("chan"),
        port("costas", "clCostasLoop", loop_bw="0.02", order=2),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "chan", "0"), ("noise", "0", "chan", "1"),
        ("chan", "0", "costas", "0"), ("costas", "0", "sink", "0"),
    ],
}

SPECS["test_quad_demod"] = {
    "title": "GPU quadrature demod",
    "comment": "FM discriminator through the port's quadrature demod "
               "block.  Role of the "
               "reference's clQuadratureDemod test flowgraphs.",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src", freq="10e3"),
        port("demod", "clQuadratureDemod", gain="1.0"),
        null_sink("sink", "float"),
    ],
    "connections": [
        ("src", "0", "demod", "0"), ("demod", "0", "sink", "0"),
    ],
}

SPECS["test_clkernel"] = {
    "title": "GPU custom user kernel (multiply-const examples)",
    "comment": "Mirror of examples/test_flowgraphs/OpenCL_Test-clkernel"
               ".grc using the multiply-const custom-kernel example "
               "(clenabled_tpu_torch/examples/"
               "kernel1to1_multiply_const_complex.py — the reference's "
               "kernel1to1_multiply_const_complex.cl): clKernel1To1 loads "
               "a user torch function by (file, name), "
               "exactly as the reference loads a user OpenCL kernel.",
    "blocks": [
        var("samp_rate", "1e6"),
        sig_source("src", freq="10e3"),
        port("user_kernel", "clKernel1To1",
            filename="'clenabled_tpu_torch/examples/"
                     "kernel1to1_multiply_const_complex.py'",
            fnname="'multiply_const_complex'"),
        null_sink("sink"),
    ],
    "connections": [
        ("src", "0", "user_kernel", "0"),
        ("user_kernel", "0", "sink", "0"),
    ],
}


SPECS["gpu_lowpass_demo"] = {
    "title": "GPU low-pass demo",
    "comment": "Mirror of the JAX package's hand-written low-pass demo: "
               "the port's signal source and low-pass filter inside a "
               "stock GNU Radio flowgraph, instantiated through "
               "clenabled_tpu_torch.gr_compat.wrap.  Point GRC at "
               "clenabled_tpu_torch/grc (Preferences -> block paths) with "
               "the package on PYTHONPATH.",
    "blocks": [
        var("samp_rate", "1000000"),
        port("gpu_src", "clSignalSource", samp_rate="samp_rate",
             waveform=1, freq=10000, amplitude="1.0", frame_size=8192),
        port("gpu_lpf", "clLowPassFilter", decimation=1, gain="1.0",
             samp_rate="samp_rate", cutoff_freq="100e3",
             transition_width="50e3", use_time="False"),
        head("probe"),
        null_sink("sink"),
    ],
    "connections": [
        ("gpu_src", "0", "gpu_lpf", "0"), ("gpu_lpf", "0", "probe", "0"),
        ("probe", "0", "sink", "0"),
    ],
}

# --------------------------------------------------------------------------
# emitter
# --------------------------------------------------------------------------

def _emit(name: str, spec: dict) -> dict:
    blocks = []
    # variables in a left column, processing blocks on a grid
    nvar = 0
    nproc = 0
    for bname, bid, params in spec["blocks"]:
        if bid == "variable":
            coord = [8, 100 + 80 * nvar]
            nvar += 1
        else:
            coord = [200 + 250 * (nproc % 4), 150 + 120 * (nproc // 4)]
            nproc += 1
        p = dict(params)
        p.setdefault("comment", "")
        if bid != "variable":
            p.setdefault("affinity", "")
            p.setdefault("alias", "")
            p.setdefault("maxoutbuf", "0")
            p.setdefault("minoutbuf", "0")
        blocks.append({
            "name": bname, "id": bid, "parameters": p,
            "states": {"bus_sink": False, "bus_source": False,
                       "bus_structure": None, "coordinate": coord,
                       "rotation": 0, "state": "enabled"},
        })
    doc = {
        "options": {
            "parameters": {
                "author": "clenabled_tpu_torch",
                "catch_exceptions": "True",
                "comment": spec["comment"],
                "generate_options": "no_gui",
                "id": name,
                "max_nouts": "0",
                "run": "True",
                "run_options": "run",
                "title": spec["title"],
            },
            "states": {"bus_sink": False, "bus_source": False,
                       "bus_structure": None, "coordinate": [8, 8],
                       "rotation": 0, "state": "enabled"},
        },
        "blocks": blocks,
        "connections": [list(c) for c in spec["connections"]],
        "metadata": {"file_format": 1, "grc_version": "3.10.0.0"},
    }
    return doc


EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "grc")


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default=EXAMPLES_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    paths = []
    for name, spec in SPECS.items():
        path = os.path.join(args.outdir, f"{name}.grc")
        with open(path, "w") as f:
            yaml.safe_dump(_emit(name, spec), f, sort_keys=False,
                           default_flow_style=False, width=78)
        paths.append(path)
    print(f"wrote {len(SPECS)} flowgraphs to {args.outdir}/")
    return paths


if __name__ == "__main__":
    main()
