"""Drive the PyTorch / CUDA port's FX receive step, X-Engine path (with
its synchronised ingest), FM receive path, oversampled channelizer,
spectrum chain, custom-kernel blocks, carrier recovery, sharded main path
(with the sharded X-Engines and chains), correlators and typed FIRs, the
GNU Radio adapter, the native host runtime, the CLI tools, the example
scripts and the vectorised K-frame dispatch once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card   — require a Hopper card; print its name and power limit.
2. build  — compile ``clenabled_tpu_torch/csrc/*.cu`` from this checkout,
   one ``nvcc`` per source, all started together; print ptxas's lines and,
   for each instantiation of the int8 Gram kernels, of the three
   oversampled-PFB bodies, of both direct-FIR bodies and of the three
   packed-PFB bodies, its registers, stack frame and spill bytes; a spill
   in ``fir_reg_kernel``, in any ``pfb_packed_reg_kernel<M>`` or
   ``pfb_packed_wide_kernel<M>``, in any
   ``pfb_os_wide_kernel<M, L>`` or in any ``fx_wide_kernel<T, M>`` (also
   printed, with both other FX bodies) fails.
3. kernels — each kernel against its plain torch form on the card, TF32
   off, at the main paths' shapes, with kernel and plain times from CUDA
   events.  Tolerance 1e-4 × max|plain| for float32 sums in another order
   (the FX kernels, B.1 and its flat entry B.1b, and B.2; the Gram kernel
   B.4 in bfloat16); the int8 Gram must be bit-exact.  Both Gram dtypes
   run on the tensor cores, at the X-Engine's full width (F=256, T=8192,
   S·P=128) in all three output forms and at k = 4 lane blocks (S·P=512,
   F=16); the int8 one also on bytes at the ends of the range (all −128;
   −128 and 127 alternating) at full width.  Both are also timed from
   ``torch.profiler``, the bf16 one beside the library call
   ``torch.bmm(w.mT, w, out_dtype=float32)`` on w =
   [zr | zi].  At M = 16 both FX entries run ``fx_reg_kernel`` (the body
   ``hopper_kernels.fx_body`` names; the kernels record gives it), timed
   in f32, bf16 and int8 ingest.  At M = 32, 64 and 128 (the step's own
   25-tap-a-branch prototypes, 800, 1600 and 3200 taps), 4 × 2^23, in f32,
   bf16 and int8 ingest, both FX entries (the v2 entry with the
   ``fx_tail_len`` tail, the flat entry with a W·M − 1 history) run
   ``fx_wide_kernel`` (which the rule must pick) and ``fx_tile_kernel``
   (the first body, through the C entry with body 0, no wrapper counting
   it), each held to the plain form and timed from ``torch.profiler``
   beside its CUDA-event time, the plain form's and both bound counts
   (``fx_bounds``); the new body must be the faster.  The packed PFB (B.2) runs at the planar
   step's shape ([8216, 128]: 4 antennas × 2^17, 16 channels, W = 25) and
   at the fused step's width ([524312, 128]: 4 × 2^23), then at M = 8, 4
   and 2, A = 1 and 3, W = 1 and 100, a ragged (8192 + 7 rows) and a short
   (20 rows, fewer than a block) last block, M = 32 at 2^17, and M = 32,
   64 and 128 at 4 × 2^23 (the step's own 25-tap-a-branch prototypes),
   each case printing the body ``hopper_kernels.pfb_packed_body`` ran
   (``pfb_packed_reg_kernel`` at M ≤ 16, ``pfb_packed_wide_kernel`` at 32,
   64 and 128, which the rule must pick at 4 × 2^23); at both main shapes
   and at the three wide ones the first body, ``pfb_packed_kernel``, also
   runs through the C entry (body 0, no wrapper counting it), held to the
   plain form, and both bodies are timed from ``torch.profiler``
   (``runtime.device.device_time_ms``) beside their CUDA-event times and
   ``pfb_bounds``; at M ≥ 32 the new body must be the faster.
4. main path — launch counts reset, then the fused step at full width
   (4 antennas × 2^23 samples, 16 channels, 400 taps) for 3 chained steps
   in f32 and int8 ingest, and the planar step at the entry shape (2^17);
   counts read; every step's outputs held to the plain forms, the fused
   sums checked for additivity over two chained frames, and the fused
   step held to the complex64 torch.fft pipeline on a small input.  The
   planar step must launch ``pfb_packed_reg_kernel`` once a step
   (``torch.profiler``'s kernel names); its device busy time and wall time
   a step over its 3 chained steps are printed, with the packed PFB
   kernel's share of the busy time.  Then, counts reset, the fused step at
   64 channels (the 1600-tap prototype, 4 × 2^23) for 3 chained steps in
   f32 and int8; counts read: one launch a step, every step held to the
   plain form, tails bit-equal, one ``fx_wide_kernel`` a step by the
   profiler's kernel names, its device busy and wall time a step.  Then,
   counts reset, the planar step at 64 channels (the 1600-tap prototype,
   4 × 2^23) for 3 chained steps; counts read: one launch a step, every
   step held to the plain form, tails bit-equal, one
   ``pfb_packed_wide_kernel`` a step by name, its device busy and wall
   time a step and the packed PFB kernel's share of the busy time.
5. ingest — ``HostIngest`` feeds 8 host frames through the fused step;
   device step time, kernel and plain times and end-to-end MSPS.
6. flat FX path — counts reset, 3 chained frames of 4 × 2^23 through
   ``fx_correlate_streams`` with the history carried; counts read; every
   step held to the plain form.
7. X-Engine path — counts reset, a ``Flowgraph`` holding ``XEngine`` at
   the reference configuration (64 stations × 2 pols, 256 channels, 8192
   frames, raw IChar bytes, channel-major, triangular output,
   pipeline_integration=2) driven for 3 integrations; counts read; the
   emitted matrix must equal the plain ``xengine_correlate_stacked`` of
   the same two integrations bit for bit, and the third integration must
   sit in the accumulator.  Device step time and host-to-product time
   per integration.  Then counts reset, the same block on its bf16 path
   (complex float planar feeds, ``compute_dtype=bfloat16``, 1024 frames)
   for 2 integrations; counts read; the emission held to the plain engine
   on the same bf16 operands within 1e-4 × max|plain|.  Then the
   synchronised run: the same IChar block fed through
   ``SynchronizedIngest`` from 64 per-station tagged streams, one
   integration window of host bytes a frame (each station reusing two
   8 MiB host buffers, the window's bytes made on the card from a seed of
   station and window), starts staggered by 0-2 windows (station s at
   window s % 3) and station 5 dropping window 4: the sync on window 2, the
   resync (4, 5) and every station's discards as planned, one Gram launch
   an aligned integration, and each of the 3 emissions bit-equal to the
   plain engine on its two aligned windows; wall ms an integration.
8. FM kernels — the direct FIR (B.7: 49, 241 and 1601 taps at
   decimation 1, 241 and 1601 also at 4, both planar components in one
   launch), the overlap-save filter (B.6: 49, 241 and 1601 taps, and a
   frame of exactly one quantum) and the quadrature demodulator (B.8:
   2^21 samples and an odd length) against their plain forms at 2^21
   samples, tolerance 1e-4 × max|plain|, with kernel and plain times; the
   library call ``conv1d`` (TF32 off) held to the FIR kernel at 49 and
   1601 taps and to the overlap-save kernel at 1601 taps, and timed.
   Each FIR case prints the body ``hopper_kernels.fir_body`` ran
   (``fir_reg_kernel`` at decimation 1, ``fir_direct_kernel`` at 4); at
   decimation 1 its output must equal the first body's
   (``fir_direct_kernel`` through the C entry with body 0, no wrapper
   counting it) bit for bit, here and at 1, 2, 3 and 50 taps, through the
   history-in-front form at 50, 51 and 52 taps (a frame pointer 4, 8 and
   12 bytes off 16-byte alignment), on a 100-sample frame at 241 taps
   (shorter than the history) and on a ragged last block (2^20 + 13 at
   1601 taps).  The first body is timed beside the new one at 49, 241
   and 1601 taps, each beside its bound.
9. FM paths — counts reset, then a ``Flowgraph`` of
   ``LowPassFilter(1, 1.0, 10e6, 1.5e6, 500e3, planar=True)`` (49 taps,
   the ``examples/streaming_ingest.py`` configuration) → ``QuadratureDemod
   (1.0, planar=True)`` driven for 8 frames of 2^21 samples, once in the
   time domain (the FIR kernel) and once in the frequency domain (the
   overlap-save kernel), with ``Runner.set_taps`` to new 49-tap taps
   after frame 4; counts read (one filter and one demod launch per frame).
   The filtered stream and the carried states are held to the same chain
   on the plain forms on the card, retune included, within 1e-4 ×
   max|plain|; the audio to the plain demodulator of the path's own
   filtered stream (an angle's error is the filter's over the sample's
   magnitude, so the stages are held apart).  Per frame: the step on
   CUDA events, the device's busy time from ``torch.profiler`` and the
   wall time, in MSPS.
10. oversampled channelizer — the fused kernel (B.3) against its plain
   form at 16 channels R=8 (2^23 samples, the path's shape), 64 channels
   R=16 with a 1600-tap prototype (1792-sample tail), 32 channels R=4 and
   a rotation offset, then at 16 channels R=4, 2 and 1 (L = 4, 8, 16) and
   with 1600 taps on ragged last blocks (2^21 + 80 samples), each case
   printing the body ``hopper_kernels.os_body`` ran (``pfb_os_reg_kernel``
   at M ≤ 16, ``pfb_os_wide_kernel`` above); the first body,
   ``pfb_os_kernel``, on the path's call through the C entry (body 0, no
   wrapper counting it), held to the plain form and timed beside the new
   one; ``OS_WIDE`` (BENCH_TPU.md's 64 channels R=16 with 192 and 1600
   taps, 32 channels R=4 with 96, and 128 channels R=16) at 2^23 on the
   rule's body as the path calls it and on ``pfb_os_kernel`` through the
   C entry, both held to the plain form and timed beside their bounds; and
   a channel subset through the streaming form;
   then counts reset, a ``Flowgraph`` of ``PolyphaseChannelizer(proto,
   2**23, 16, 8, list(range(16)), planar=True, fused=True)`` (the 155-tap
   ``firdes.low_pass(1.0, 16.0, 0.5, 0.25)`` zero-padded to 160) over 4
   chained frames of 2^23, one launch per frame, held to the plain chain
   within 1e-4 × max|plain|, tails bit-equal; and again, counts reset, at
   64 channels R=16 with the 1600-tap prototype, its step's kernel named
   ``pfb_os_wide_kernel`` by ``torch.profiler``.
11. spectrum chain — the FFT kernel (B.5) against its plain form at 256,
   1024, 2048 and 16384 points, forward and inverse, windowed or not,
   shifted or not, and the bare kernel held to and timed beside
   ``torch.fft.fft`` (cuFFT) at each of those sizes; then counts
   reset, ``SignalSource(1e6, 1, 250e3, 1.0, 2**21, planar=True)`` →
   ``Fft(2048, window=blackman_harris(2048), shift=True)`` →
   ``MultiplyConst(2.0)`` → ``ComplexToMag`` over 8 frames, one FFT launch
   per frame, held to the plain chain within 1e-4 × max|plain|, the tone
   in bin 1536 of every vector and the source within 5e-4 of float64
   cos/sin.  Then ``Kernel1To1``/``Kernel2To1`` with the port's torch
   example kernels (loaded from ``clenabled_tpu_torch/examples/``) in
   flowgraphs against ``MultiplyConst(3.0)`` and ``Multiply`` on 2 frames
   of 2^21, bit for bit, and ``exact_f32`` (TF32 off inside, the flags
   restored after an exception).
12. carrier recovery — the Costas kernel (B.9) against its plain form on
   2^12 samples, order 2 on BPSK and order 4 on QPSK, bit for bit; the
   probe of its chain's sin/cos over all 2^32 float32 patterns (0
   mismatches against ``sinf``/``cosf`` where |x| <= 2π or x is NaN);
   then counts reset, ``CostasLoop(0.00628, 2, planar=True,
   scalar=True)`` over 8 chained frames of 2^16 of seeded BPSK with a
   0.005 rad/sample carrier offset and noise, one launch per frame, equal
   bit for bit to one kernel call over the joined stream (the seam
   check), and locked (frequency within 5e-4 of the offset); the kernel
   held to its plain form bit for bit again on the path's first 2^16
   frame and on 2^16 samples of QPSK (order 4).  Beside each order's
   time: ns and cycles a sample at the SM clock (the highest
   ``nvidia-smi`` reading at 90% utilization or more, taken while the
   kernel runs for 3 s), and the latency bound (``latency_bound_ms``: the
   samples × the loop-carried chain's dependent operations × 4 cycles at
   that clock).  Then the batched entry (``costas_batched``) under each
   of its two bodies, forced (``block``: the chain body one block a row;
   ``lane``: one row a lane, 32 loops a warp), against its plain form on
   [8, 4096], order 2 on BPSK and order 4 on QPSK from per-row states
   (phases outside ±2π among them), every row against ``costas_scalar``
   on that row alone and each body against the other, on [1, 4096] and
   [33, 4096] (a partial warp) against ``costas_scalar`` row by row and
   the other body, and windows of 1536 at a stride of 1024 read in place
   ([4, 1536] and [2, 4, 1536]) against the same rows copied, all bit
   for bit; counts
   reset, ``CostasLoop(0.00628, 2, planar=True, chunked=True, chunk=4096,
   warmup=512)`` over 8 chained frames of 2^20 of seeded BPSK, three
   ``costas_batched`` launches a frame and no other kernel, each frame's
   residual, exact and branch hops printed beside its distance from one
   ``costas_scalar`` call over the joined stream: an exact frame must be
   bit-equal to it, a frame at residual <= 1e-3 within 2e-2 of it, and
   the loop locked (frequency within 5e-4 of the offset); the same frames
   with ``exact_fallback_residual`` (1e-3, or half the first frame's
   residual if that is lower): the first frame and every frame above the
   bound rerun on ``costas_scalar`` (two launches each, counted), each
   bit-equal to the sequential form from its carried state (the first to
   the joined call), and frames 2-7 within 2e-2 of the joined call;
   frames 0 and 1 through the chunked loop once more, and again with
   ``costas_batched_plain`` in the kernel's place, bit for bit (outputs,
   carried state, certificate); the chunked path's wall and device busy a
   frame in MSPS; counts reset,
   ``CostasLoop(0.00628, 2, planar=True, num_streams=16)`` over 16 seeded
   BPSK streams (offsets over ±0.005) × 8 frames of 2^16, one launch a
   frame, each stream bit-equal to ``costas_scalar`` over its joined
   stream; one 2^23 frame through the chunked loop (2048 windows a
   launch), three ``costas_batched`` launches and no other kernel, bit
   for bit the same run with ``costas_batched_plain`` in the kernel's
   place, its device busy a frame under each body (the rule's as the
   path calls it, the other forced through the rule, the wrapper and its
   launch count unchanged); then the multi-stream runner at [8, 4096],
   [1024, 4096] and [8192, 4096], held to the plain form bit for bit
   under each body and timed under each the same way, beside the plain
   form and the bound (the larger of the bytes and operations at the
   peak rates and one chain's latency at the measured clock; no latency
   term where the clock was not read), with the body the rule takes at
   each shape.

13. sharded main path — a ``torch.distributed`` NCCL group of one rank
   from a ``file://`` store in a temporary directory, and
   ``sharding.make_mesh(device="cuda")``; counts reset, then
   ``make_sharded_fx_pipeline_fused`` at full width (4 antennas × 2^23
   samples, 16 channels, 400 taps) for 3 chained steps in f32 and int8
   ingest; counts read (one ``fx_correlate_streams_v2`` launch a step and
   no other kernel); every output and tail equal bit for bit to
   ``make_fx_pipeline_fused`` on the same frames (at one rank the ring hop
   is the identity and the sums add one rank) and within 1e-4 × max|plain|
   of the plain form; ``fx_reg_kernel`` among the step's kernels
   (``torch.profiler``), with the device time of each kernel of one
   sharded and one unsharded step, the NCCL kernels' share, and the step
   times on CUDA events (unsharded, sharded, sharded, unsharded) beside
   the collectives' own.  Then the complex64 sharded step at 4 × 2^20
   against ``make_fx_pipeline`` and the three halo filters (FIR at
   decimation 4, overlap-add, the 16-channel R = 8 channelizer) against
   their sequential forms, bit for bit over chained frames; the
   window-parallel correlators (``make_sharded_td_xcorr`` at ±512 lags,
   ``make_sharded_fd_xcorr`` with ``perform_fft_first``) on [3, 64, 8192]
   against the unsharded planar functions, bit for bit; the planar
   sharded filters, counted and timed in turns beside their sequential
   forms, bit for bit over chained frames (outputs and state):
   ``make_sharded_fft_filter_planar`` on its kernel route (49 taps, 4
   frames of 2^21) against ``make_fft_filter_planar(fused=True)``,
   ``make_sharded_channelizer_planar`` (16 channels, R = 16, 400 taps, 4
   frames of 2^20) against ``make_channelizer(planar=True)``,
   ``make_sharded_channelizer_fused_oversampled`` (16 channels, R = 8, the
   160-tap prototype, 3 frames of 2^23) against
   ``make_channelizer_fused_oversampled``, and
   ``make_sharded_costas_channels(0.00628, 2)`` over 16 channels × 2
   frames of 2^16 (three batched launches a frame) against the chunked
   loop run channel by channel (outputs, diagnostics and state); the
   station-sharded X-Engines: ``make_sharded_xengine_stacked`` at the
   X-Engine reference configuration (F = 256, T = 8192, S·P = 128 int8,
   scale 1/127², triangular, pipeline_integration=2) over 3 integrations,
   counted (one ``xengine_gram_stacked_tri`` launch a call,
   ``gram_int8_diag_kernel`` among its kernels), every matrix, ready flag
   and the carried state bit-equal to ``make_xengine_channel_major``; bf16
   at T = 1024 within 1e-4 × max|plain| and bit-equal to the unsharded
   engine; the sharded call, the unsharded engine, the exchange
   (``all_to_all``, the identity at one rank) and NCCL's
   ``all_to_all_single`` on one component timed in turns;
   ``sharded_xengine``, ``sharded_xengine_planar`` and
   ``make_sharded_xengine`` (2 calls) at T = 64, S = 64, F = 256, P = 2 bit
   for bit against the unsharded engines; ``ShardedChain``s over 4 chained
   frames (``fft_filter(low_pass(1, 1e6, 100e3, 20e3))`` → ×2 →
   ``quadrature_demod(0.7)`` at 2^21 rounded down to the plan's 136-sample
   chunks, FIR at decimation 4 → demod and the 16-channel R = 8
   channelizer at 2^21), bit-equal, outputs and states, to the sequential
   filters and ``dsp.demod.quadrature_demod`` from a zero sample, each
   timed in turns beside it; the group is destroyed, and
   ``entry.dryrun_multichip(1)`` runs its legs (1, 1b, 2, 2b, 3, 3b, 3c,
   3d and 3e) in one spawned NCCL rank.  A run on one card has one rank
   (NCCL refuses two ranks on one card); the exchange between ranks is
   tested on the CPU.
14. correlators and typed FIRs (no kernel of their own: plain torch, as
   the JAX package runs XLA) — a ``Flowgraph`` of ``XCorrelate(4,
   signal_length=8192, max_search_index=512, accumulate_frames=64)`` (64
   windows a frame, ±512 lags) over 4 frames of seeded complex64 streams,
   inputs 1-3 being input 0 at lags +37, −200 and +511 plus noise, with
   complex64 and then planar feeds; then ``decim_frames=4`` at one window
   a frame over 8 frames.  Every message is held to a float64 NumPy lag
   scan on the host (itself checked by direct sums at six lags), corrvect
   within 1e-4 × max|float64|, the lags equal to the planted ones, the
   skipped frames' messages zeros with ``valid`` False; wall and device
   busy time a frame in MSPS of windowed stream an input.  Then
   ``FirFilterSCC`` at decimation 1 and 4 (25 complex taps, int16 inputs
   in ±800), ``FirFilterFSF(2)`` (a frame scaled so that outputs cross
   ±32767) and ``InterpFirFilter(4)`` (a 64-tap low-pass) planar and
   complex64, each over 4 chained frames of 2^21, held to the float64
   convolution of the joined stream within 1e-4 × max|float64| (fsf:
   within one count of the truncated and clamped float64 result), with
   the wall time a frame.

15. the GNU Radio adapter, the native runtime and the CLI tools — GNU
   Radio is not installed on the card's machine, so a minimal stand-in
   ``gnuradio.gr.basic_block`` and ``pmt`` carry ``gr_compat.wrap``.  The
   native library is built from ``clenabled_tpu_torch/native/src`` with
   g++: a 1 MiB ring round trip with wrap-around, both unpacks on 2^24
   bytes bit for bit the torch unpack on the card, a rolling writer over
   3 files with sidecars.  ``LowPassFilter`` (the FM path's 49 taps, time
   domain, planar) → ``QuadratureDemod`` and ``Fft(2048,
   blackman_harris, shift)`` behind ``wrap`` take 64 work calls of seeded
   1000..2^17-sample offers, per call and batched (the batched blocks
   built by the ``grc/`` descriptors' make lines, as GNU Radio builds
   them), a ``set_taps`` before call 32: the joined outputs within 1e-4 × max|ref| of a ``Flowgraph``
   over the joined stream retuned at the same sample (bit-equality
   printed), and ``fir_direct``, ``qdemod_fused`` and ``fft_batched_fused``
   launched once an ``apply``.  The wrapped LowPass's wall a work call,
   MSPS and device busy time a work call (``torch.profiler``) at
   8192-sample offers, per call and batched (printed).  An IChar
   ``XEngine`` (64 stations × 2 pols, 16 channels, 1024 frames) at the
   automatic depth 2: every matrix published after ``stop()``, bit for
   bit a ``Flowgraph``'s, one Gram launch an integration.  Then each tool
   through its ``main``: ``clview``, ``test_clenabled 2097152 --iterations
   20 --testcostas`` (every row with a kernel shows launches),
   ``test_clkernel`` on both new ``Kernel1To1`` examples (held to numpy),
   ``test_clfilter`` per call and in its complex64 default (launches
   counted), ``profile --steps 3`` (``fx_reg_kernel`` among the top
   kernels), ``test_ingest --steps 6 --dtype int8``, ``test_ingest
   --packed4`` (the sync and resync events, the writer's files and
   sidecars) and ``test_scaling --devices 1``, flagship and ``--xengine``
   at 64 stations a rank.
16. examples — the root example scripts' twins
   (``clenabled_tpu_torch/examples/``) through their ``main`` at their
   default sizes, launch counts reset before each and read after it,
   each script's wall time and rate printed.  ``flagship`` (the fused step
   at 4 × 2^21, two warm-up and 20 timed steps): one
   ``fx_correlate_streams_v2`` launch a step and no other kernel, ant2-ant0
   the strongest cross baseline, the last step held to
   ``fx_correlate_streams_v2_plain`` on its inputs and tails within 1e-4 ×
   max|plain|.  ``streaming_ingest --seconds 2`` (ring → C++ unpack →
   49-tap planar LowPass → demod, 2^16 a frame): one ``fir_direct`` and
   one ``qdemod_fused`` launch a frame; the last frame's filtered stream
   held to ``fir_direct_plain`` from the previous frame's history, and its
   audio to ``qdemod_fused_plain`` of the path's own filtered stream.
   ``xengine_synchronized``: the sync at window 4 and the resync (13, 16),
   ant2-ant0 in each of the 4 emissions, one int8 Gram launch
   (``xengine_gram_stacked_tri``, S·P = 8 padded to 128 lanes) an aligned
   window, every emission bit-equal to ``xengine_gram_stacked_plain`` of
   its 4 windows scaled and summed as the engine does.  ``fft_xcorr``,
   ``fm_receiver``, ``xcorr_test``, ``xcorr_max_rate`` and
   ``xengine_demo`` (no kernel on their paths: complex64 streams, the
   correlators and the complex engine are plain torch, as the JAX
   scripts' are XLA): no launch, their outputs held to their own
   ``--cpu`` runs within 1e-4 × max (the correlator's rate run to one CPU
   frame of the same signals), delays 25 and 37 and ant2-ant0 recovered.
17. vectorised K-frame dispatch — (a) ``Fft(2048, blackman_harris,
   shift=True)`` → ``MultiplyConst(2)`` → ``ComplexToMag`` fed planar
   8192-sample frames at the automatic K (512) with ``vectorize=True``
   (one ``torch.func.vmap`` of the step) and with ``vectorize=False`` (the
   loop, pinned to the same K): one ``fft_batched_fused`` launch against
   512, bit-equal, and within 1e-4 × max of the plain chain; the kernel
   alone at the dispatch's 2^22 samples beside its bound; (b)
   ``XCorrelateFFTVCF(8192, 2)`` at K = 512 (``tools/test_clxcorrelate``'s
   block-API shape), vectorised within 1e-4 × max|loop| of the loop; (c)
   ``Fft(2048, blackman_harris, shift)`` behind ``gr_compat.wrap`` under
   the stand-in ``gr`` at 8192-sample offers, batched at the adapter's
   automatic K (64) against per call: one launch and one ``apply`` a
   batch against one a call, the streams bit-equal.  Each form's wall
   and device busy time a dispatch or a work call (a loop's busy time from
   32 of its single-frame steps, times K).

Phases 10-12 print the path's device time per frame (``torch.profiler``)
and wall time per frame, and each kernel's device time beside its plain
form's.  A profiler trace counts only when it holds an event for every
launch the wrappers counted in it; it is taken again up to three times,
and else the device time reads "not measured" (null in the record).
The kernels record gives, for every kernel, the least time the
card could take for its work at the measured shape (``bound_ms``: the
larger of the bytes it must move at 3.35 TB/s and its operations at the
published peak for their type; the FX step's M-point transforms counted as
FFTs, beside the dense-DFT count of earlier records; so the oversampled
PFB's and the packed PFB's, with their bytes and both operation counts
beside them), and the time of one
PyTorch library call computing the same function where there is one.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this script, it exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import sys
import time

TOL = 1e-4          # × max|plain|
A, M, N_FULL = 4, 16, 1 << 23
N_ENTRY = 1 << 17
STEPS = 3
INGEST_FRAMES = 8
# the X-Engine's reference configuration: stations, pols, channels, frames
XE_S, XE_P, XE_F, XE_T = 64, 2, 256, 8192
XE_STEPS = 3
# the time-major sharded X-Engines' frames; ShardedChain's frames
XE_SH_T = 64
CHAIN_N, CHAIN_FRAMES = 1 << 21, 4
# the synchronised X-Engine run: station s starts at window s % 3, every
# station stops before window SYNC_END, and station SYNC_DROP[0] loses
# window SYNC_DROP[1]
SYNC_END, SYNC_DROP = 9, (5, 4)
# the X-Engine's bf16 path: complex float feeds at 1024 frames
XE_BF_T = 1024
# the FM receive path: BENCH_TPU's block-layer frame, 8 chained frames
FM_N, FM_FRAMES, FM_RETUNE_AT = 1 << 21, 8, 4
# the oversampled channelizer: BENCH_TPU's 16-channel R=8 configuration
OS_M, OS_R, OS_N, OS_FRAMES, OS_DEEP_N = 16, 8, 1 << 23, 4, 1 << 21
# BENCH_TPU.md:177-179's 64-channel R=16 (192- and 1600-tap prototypes) and
# 32-channel R=4 (96 taps) channelizers, and 128 channels R=16 on
# firdes.low_pass(1, 128, 0.5, 0.25): (label, M, R, ntaps or None)
# the fused FX step's wide body: 32, 64 and 128 channels on the step's own
# 25-tap-a-branch prototypes (800, 1600 and 3200 taps), 4 x 2^23, each ingest
# dtype, both entries; the 64-channel step (the 1600-tap prototype of
# BENCH_TPU.md:177) as a counted path
FX_WIDE_M, FX_PATH_M = (32, 64, 128), 64
# the packed PFB's wide body (hopper_kernels.PFB_WIDE_M: 32, 64 and 128
# channels) runs at the planar step's full width (4 x 2^23, the step's own
# 25-tap-a-branch prototypes) on both bodies; the 64-channel planar step
# (1600 taps) as a counted path
PFB_PATH_M = 64
OS_WIDE = [("64ch R=16 192 taps", 64, 16, 192),
           ("64ch R=16 1600 taps", 64, 16, 1600),
           ("32ch R=4 96 taps", 32, 4, 96), ("128ch R=16", 128, 16, None)]
# the spectrum chain: README's source → Fft → MultiplyConst → ComplexToMag
SP_N, SP_FFT, SP_FRAMES = 1 << 21, 2048, 8
# carrier recovery: the reference's loop bandwidth, BENCH_TPU's frame
CO_BW, CO_N, CO_FRAMES, CO_CHECK_N, CO_OFFSET = 0.00628, 1 << 16, 8, 1 << 12, 0.005
# the fewest dependent operations a sample on the Costas recurrence's
# loop-carried chain, phase -> phase, by order (csrc/costas.cu's head
# note): sin/cos 10 (x*2/pi, rint, 3 reduction FMAs, r*r, 4 polynomial
# FMAs; the quadrant's selects can act on the sample, off the chain),
# rotation 2 (mul, add), error 1 (order 4: compare, select, subtract), clip
# 2 (e+1, |a|-|b|; its 0.5 can go into the gains), frequency 2 (mul, add),
# phase 2 (add, add)
CO_CHAIN = {2: 19, 4: 21}
# the batched Costas entry: [8, 4096] checks and times, [1, 4096] and
# [33, 4096] checks (one warp partial), and the multi-stream runner at
# BENCH_TPU's 1024 loops of 4096 and at 8192 carrier-recovery channels; the
# chunked path at BENCH_TPU's chunk and warm-up over 8 frames of 2^20 and
# on one 2^23 frame (the main path's frame an antenna: 2048 windows a
# launch); 16 streams over 8 frames of 2^16 with offsets spread over
# +-CO_OFFSET
CB_B, CB_N, CB_MANY, CB_HUGE, CB_PARTIAL = 8, 1 << 12, 1024, 8192, (1, 33)
CH_CHUNK, CH_WARMUP, CH_N, CH_FRAMES, CH_BIG_N = 4096, 512, 1 << 20, 8, 1 << 23
# the residual under which the JAX test holds a chunked frame to 2e-2 of
# the sequential loop (tests/test_siggen_demod.py:147-159)
CH_RESID = 1e-3
MS_S, MS_N, MS_FRAMES = 16, 1 << 16, 8
# the correlators (BENCH_TPU's clXCorrelate configuration): 4 inputs,
# 64 windows of 8192 samples a frame, ±512 lags; inputs 1-3 are input 0
# at these lags plus noise; then 1-in-4 frame decimation over 8 windows
XC_A, XC_SL, XC_SHIFT, XC_ACC, XC_FRAMES = 4, 8192, 512, 64, 4
XC_LAGS, XC_NOISE, XC_DECIM, XC_DECIM_FRAMES = (37, -200, 511), 0.1, 4, 8
# the typed and interpolating FIRs: test_short_dtypes' 25 complex taps and
# int16 inputs in ±800, 4 chained frames of 2^21; fsf's frame 2 scaled so
# that its outputs cross ±32767; a 64-tap low-pass interpolating by 4
TF_N, TF_FRAMES, TF_NTAPS, TF_SPAN, TF_FSF_SCALE, TF_L = (1 << 21, 4, 25,
                                                           800, 30.0, 4)
CYCLES_PER_OP = 4
DEVICE = ("cuda", 0)
# the H100 SXM's published rates (NVIDIA's data sheet): memory bytes/s,
# FP32 outside the tensor cores, int8 and bf16 on the tensor cores
HBM_BPS, FP32_OPS, INT8_OPS, BF16_OPS = 3.35e12, 67e12, 1979e12, 989e12
# the __global__ functions of csrc/*.cu, one launched per counted wrapper call
# (costas_kernel<order, halved gains> matches "costas_kernel",
# costas_lanes_kernel<...> "costas_lanes_kernel"; the sin/cos probe is
# counted by no wrapper and runs in no timed window)
PORT_KERNELS = ("fx_tile_kernel", "fx_reg_kernel", "fx_wide_kernel",
                "pfb_packed_kernel",
                "pfb_packed_reg_kernel", "pfb_packed_wide_kernel",
                "gram_int8_diag_kernel", "gram_int8_quad_kernel",
                "gram_bf16_diag_kernel", "gram_bf16_quad_kernel",
                "fir_direct_kernel", "fir_reg_kernel", "ofs_filter_kernel",
                "qdemod_kernel",
                "pfb_os_kernel", "pfb_os_reg_kernel", "pfb_os_wide_kernel",
                "fft_batched_kernel",
                "costas_kernel", "costas_lanes_kernel",
                "costas_sincos_probe_kernel")


def bound(nbytes: float, ops: float, rate: float = FP32_OPS) -> tuple:
    """(bound_ms, bound_by): the larger of ``nbytes`` at the memory rate and
    ``ops`` at ``rate``."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, got, want) -> tuple[float, float]:
    """(max |got − want|, tolerance) for one pair of outputs."""
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail("non-finite output")
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    err = float((got.double() - want.double()).abs().max())
    return err, TOL * float(want.double().abs().max())


def check(torch, label: str, gots, wants) -> float:
    """Hold each output to its reference; returns the largest error."""
    worst, shown = 0.0, (0.0, 0.0)
    for g, w in zip(gots, wants):
        err, tol = max_err(torch, g, w)
        if not err <= tol:
            fail(f"{label}: max abs err {err:.3e} > tolerance {tol:.3e}")
        worst = max(worst, err)
        if err * shown[1] >= shown[0] * tol:    # the output nearest its limit
            shown = (err, tol)
    phase("check", f"{label}: max abs err {shown[0]:.3e} <= {shown[1]:.3e} "
                   f"({TOL} x max|ref|)")
    return worst


def frames(torch, gen, dtype, shape, device):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def extreme_bytes(torch, f, t, sp, dev):
    """int8 (zr, zi) [f, t, sp] at the ends of the byte range: the first
    half of the channels all −128, the rest −128 and 127 alternating by
    frame and column (zi the opposite of zr)."""
    alt = (torch.arange(t, device=dev)[:, None]
           + torch.arange(sp, device=dev)) % 2
    zr = torch.where(alt == 1, 127, -128).to(torch.int8).expand(f, t, sp)
    zr = zr.contiguous()
    zr[: f // 2] = -128
    zi = (-1 - zr.to(torch.int16)).to(torch.int8)
    zi[: f // 2] = -128
    return zr, zi


def gram_phase(torch, hk, gen, dev) -> dict:
    """B.4 against its plain form in all three output forms; returns the
    bfloat16 error and the kernel and plain times, and for each dtype at
    full width the kernel's device time, for bfloat16 the library call's."""
    res = {"bf16_err": 0.0}
    cases = [("int8", torch.int8, XE_F, XE_S * XE_P),
             ("int8 extreme", torch.int8, XE_F, XE_S * XE_P),
             ("int8 k=4", torch.int8, 16, 512),
             ("bf16", torch.bfloat16, XE_F, XE_S * XE_P),
             ("bf16 k=4", torch.bfloat16, 16, 512)]
    for label, dt, f, sp in cases:
        if label == "int8 extreme":
            zr, zi = extreme_bytes(torch, f, XE_T, sp, dev)
        else:
            zr, zi = (frames(torch, gen, dt, (f, XE_T, sp), dev)
                      for _ in range(2))
        shape = f"[{f}x{XE_T}x{sp}]"
        for form in ("xengine_gram_stacked_tri", "xengine_gram_stacked_blocks",
                     "xengine_gram_stacked"):
            got = getattr(hk, form)(zr, zi)[:2]
            torch.cuda.synchronize()
            want = getattr(hk, form + "_plain")(zr, zi)[:2]
            if dt == torch.int8:
                for g, w in zip(got, want):
                    if not torch.equal(g, w):
                        err = float((g.double() - w.double()).abs().max())
                        fail(f"{form} {label} {shape}: not bit-exact "
                             f"(max abs err {err})")
                phase("check", f"{form} {label} {shape}: bit-exact")
            else:
                res["bf16_err"] = max(res["bf16_err"], check(
                    torch, f"{form} {label} {shape}", got, want))
        if label == "int8 extreme":
            del zr, zi, got, want
            continue
        res[label] = (
            time_ms(torch, lambda: hk.xengine_gram_stacked_tri(zr, zi)),
            time_ms(torch, lambda: hk.xengine_gram_stacked_tri_plain(zr, zi),
                    reps=3, warmup=1))
        phase("time", f"xengine_gram_stacked_tri {label} {shape}: kernel "
                      f"{res[label][0]:.4f} ms, plain {res[label][1]:.4f} ms")
        if label in ("int8", "bf16"):
            res[f"{label} device"] = device_busy_ms(
                torch, lambda: hk.xengine_gram_stacked_tri(zr, zi), 10)
            shown = ("not measured" if res[f"{label} device"] is None
                     else f"{res[f'{label} device']:.4f} ms")
            lib = ""
            if label == "bf16":
                res["bf16 library"], res["library label"] = gram_library_ms(
                    torch, zr, zi)
                lib = (f"; {res['library label']} (library) "
                       f"{res['bf16 library']:.4f} ms")
            phase("time", f"xengine_gram_stacked_tri {label} {shape}: device "
                          f"{shown} (torch.profiler){lib}")
        del zr, zi, got, want
        torch.cuda.empty_cache()
    return res


# mangled type arguments of the kernels' templates
PTXAS_TYPES = {"f": "float", "a": "int8_t", "13__nv_bfloat16": "__nv_bfloat16"}


def ptxas_summary(log: str, names) -> dict:
    """Registers, stack frame and spill bytes of each instantiation of the
    named kernels in an ``nvcc -Xptxas -v`` log, keyed ``name<true>`` /
    ``name<false>`` for a kernel templated on one bool, ``name<16, 2>`` for
    one templated on ints, ``name<2, true>`` for ints then bools,
    ``name<float, 64>`` for a type then ints."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = None
            for name in names:
                if name in m.group(1):
                    arg = re.search(name + r"ILb([01])E", m.group(1))
                    ints = re.search(name + r"I(f|a|13__nv_bfloat16)?"
                                     r"((?:L[ib]\d+E)+)E", m.group(1))
                    if arg:
                        cur = f"{name}<{('false', 'true')[int(arg.group(1))]}>"
                    elif ints:
                        vals = [v if t == "i" else ("false", "true")[int(v)]
                                for t, v in re.findall(r"L([ib])(\d+)E",
                                                       ints.group(2))]
                        if ints.group(1):
                            vals.insert(0, PTXAS_TYPES[ints.group(1)])
                        cur = f"{name}<{', '.join(vals)}>"
                    else:
                        cur = name
                    out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def gram_library_ms(torch, zr, zi) -> tuple[float, str]:
    """(ms, label) of one PyTorch call computing the bf16 Gram's products:
    the [2·S·P]² Gram of w = [zr | zi] per channel, ``torch.bmm(w.mT, w)``
    with float32 output (bf16 output where the card's PyTorch has no
    ``out_dtype``), on a prebuilt w; the port never calls it."""
    w = torch.cat([zr, zi], -1)
    try:
        torch.bmm(w.mT, w, out_dtype=torch.float32)
        fn, label = (lambda: torch.bmm(w.mT, w, out_dtype=torch.float32),
                     "torch.bmm out_dtype=float32")
    except (TypeError, RuntimeError, NotImplementedError):
        fn, label = (lambda: torch.bmm(w.mT, w),
                     "torch.bmm bf16 output (no out_dtype)")
    ms = device_busy_ms(torch, fn, 10) or time_ms(torch, fn)
    del w
    return ms, label


def xengine_bf16_phase(torch, hk, gen, dev) -> dict:
    """The X-Engine block on its bf16 path: planar float32 feeds cast to
    bfloat16 (``compute_dtype``) into the tensor-core Gram, counted and held
    to the plain engine on the same bf16 operands."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import planar
    from clenabled_tpu_torch.dsp import xengine as X
    from clenabled_tpu_torch.streaming import Flowgraph

    xe = blocks.XEngine(data_type=1, polarization=XE_P, num_inputs=XE_S,
                        num_channels=XE_F, integration=XE_BF_T,
                        pipeline_integration=2, planar=True,
                        compute_dtype=torch.bfloat16)
    g = Flowgraph()
    for s in range(XE_S):
        g.external_input(xe, s)
    r = g.compile(xe.quantum, device=dev)
    msgs = []
    r.on_message("xengine.xcorr", msgs.append)
    feeds = [[planar.PC(*torch.randn((2, xe.quantum), generator=gen,
                                     device=dev)) for _ in range(XE_S)]
             for _ in range(2)]
    torch.cuda.synchronize()

    hk.reset_launch_counts()
    for fr in feeds:
        r.step(*fr)
    torch.cuda.synchronize()
    launches = hk.gram_launches()
    phase("xengine", f"Flowgraph/XEngine S={XE_S} P={XE_P} F={XE_F} "
                     f"T={XE_BF_T} complex float, compute_dtype=bfloat16, 2 "
                     f"integrations, pipeline_integration=2; launches "
                     f"{launches}")
    if launches < 1:
        fail("the Gram kernel was not launched on the bf16 X-Engine path")
    if [bool(m["valid"]) for m in msgs] != [False, True]:
        fail(f"emission flags {[m['valid'] for m in msgs]}")

    def marshal(fr):
        """[S] planar feeds [T·F·P] → channel-major float32 (zr, zi)."""
        return tuple(torch.stack([getattr(x, c) for x in fr])
                     .view(XE_S, XE_BF_T, XE_F, XE_P).permute(2, 1, 0, 3)
                     .reshape(XE_F, XE_BF_T, -1) for c in ("re", "im"))

    plain = [X.xengine_correlate_stacked(*marshal(fr), npol=XE_P,
                                         compute_dtype=torch.bfloat16,
                                         use_kernel=False) for fr in feeds]
    out = msgs[1]["matrix"]
    err = check(torch, f"bf16 X-Engine [{XE_F}, T={XE_BF_T}] emission vs plain "
                       f"engine", [out.re, out.im],
                [plain[0].re + plain[1].re, plain[0].im + plain[1].im])
    return {"launches": launches, "err": err}


def flat_fx_phase(torch, hk, gen, dev, taps) -> tuple[int, float]:
    """The flat-layout entry of the fused kernel over 3 chained frames,
    the history carried as the last W·m − 1 samples; (launches, max err)."""
    hl = taps.shape[0] * M - 1
    comps = [torch.randn((2 * A, N_FULL), generator=gen, device=dev)
             for _ in range(STEPS)]
    hist0 = torch.randn((2 * A, hl), generator=gen, device=dev)
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    hist, outs = hist0, []
    for c in comps:
        outs.append(hk.fx_correlate_streams(c, hist, taps, A, M))
        hist = c[:, -hl:].contiguous()
    torch.cuda.synchronize()
    launches = hk.fx_correlate_streams.launches
    phase("flat", f"fx_correlate_streams {2 * A}x{N_FULL}, hist {hl}, "
                  f"{STEPS} chained frames; launches {launches}")
    if launches < 1:
        fail("fx_correlate_streams was not launched on its path")
    worst, hist = 0.0, hist0
    for k, c in enumerate(comps):
        want = hk.fx_correlate_streams_plain(c, hist, taps, A, M)
        worst = max(worst, check(torch, f"flat step {k}", outs[k], want))
        hist = c[:, -hl:]
    return launches, worst


def fx_ops(n: int, m: int, w: int, fft: bool = True) -> float:
    """Operations of one fused FX step over A streams of n samples, M = m,
    w tap rows, default pairs: the branch FIR (2·w a sample and component),
    the stage-1 and lag M-point transforms as FFTs (5·M·log2 M real flops
    each, as fx_reg_kernel and fx_wide_kernel run them) or as dense DFTs
    (8·M², as fx_tile_kernel does), the lag products and magnitudes (10 a
    bin) and the Gram products (8 a bin and baseline)."""
    nfd, nb = A - 1, A * (A + 1) // 2
    dft = 5 * m * math.log2(m) if fft else 8 * m * m
    return (4 * A * n * w + A * (n // m) * dft
            + nfd * (n // m) * (10 * m + dft) + nb * n * 8)


def fx_bounds(n: int, h: int, m: int, w: int, elem: int) -> dict:
    """The least time of one fused FX step: the frame and tail (``elem``
    bytes a sample) and the taps read once, the sums written once, against
    ``fx_ops`` with the transforms as FFTs (``bound``, and
    ``operations_ms``) and as dense DFTs (``dense_bound_ms``)."""
    nbytes = elem * 2 * A * (n + h) + 4 * w * m
    return {"bound": bound(nbytes, fx_ops(n, m, w)),
            "bytes_ms": nbytes / HBM_BPS * 1e3,
            "operations_ms": fx_ops(n, m, w) / FP32_OPS * 1e3,
            "dense_bound_ms": bound(nbytes, fx_ops(n, m, w, False))[0]}


def fx_wide_times(torch, hk, P, gen, dev, m: int, dt) -> dict:
    """One (M, dtype) of ``FX_WIDE_M`` at 4 × 2^23 on the step's own
    prototype: the v2 entry (the ``fx_tail_len`` tail) and the flat entry
    (a W·m − 1 history) on the rule's body, which must be fx_wide_kernel,
    and on fx_tile_kernel through the C entry, each held to the plain form
    and timed (``call_times``) beside the plain form's events and
    ``fx_bounds``."""
    taps_rm, ntaps = P._prototype(m, 100e6)
    taps = torch.as_tensor(taps_rm, device=dev)
    w = taps.shape[0]
    body = hk.fx_body(m, A, w, dev)
    if body != "fx_wide_kernel":
        fail(f"fx_correlate at M = {m}: the rule picks {body}, not "
             f"fx_wide_kernel")
    name = str(dt).removeprefix("torch.")
    elem = torch.tensor([], dtype=dt).element_size()
    h = hk.fx_tail_len(dt, m, ntaps)
    hl = w * m - 1
    xr, xi = (frames(torch, gen, dt, (A, N_FULL), dev) for _ in range(2))
    tr, ti = (frames(torch, gen, dt, (A, h), dev) for _ in range(2))
    res = {"w": w, "h": h, "hist": hl, "err": 0.0}
    flat_ins = (xr, xi, tr[:, -hl:].contiguous(), ti[:, -hl:].contiguous())
    comps, hist = torch.cat([xr, xi]), torch.cat(flat_ins[2:])
    entries = {
        "v2": ((xr, xi, tr, ti),
               lambda: hk.fx_correlate_streams_v2(xr, xi, tr, ti, taps, A, m)),
        "flat": (flat_ins,
                 lambda: hk.fx_correlate_streams(comps, hist, taps, A, m))}
    for entry, (ins, wrapped) in entries.items():
        label = f"fx_correlate {entry} M={m} {name} [{A}x{N_FULL}]"
        want = hk.fx_correlate_streams_v2_plain(*ins, taps, A, m)
        got = wrapped()
        torch.cuda.synchronize()
        err = check(torch, f"{label} on {body}", got, want)

        def first():    # the first body through the C entry, uncounted
            return hk._launch_fx(*ins, taps, A, m, None, None,
                                 body="fx_tile_kernel")

        err = max(err, check(torch, f"{label} on fx_tile_kernel (the first "
                                    f"body)", first(), want))
        new_t = call_times(torch, f"{label} {body}", wrapped)
        first_t = call_times(torch, f"{label} fx_tile_kernel", first)
        plain_ms = time_ms(torch, lambda: hk.fx_correlate_streams_v2_plain(
            *ins, taps, A, m), reps=3, warmup=1)
        b = fx_bounds(N_FULL, ins[2].shape[-1], m, w, elem)
        phase("time", f"{label}: {body} {new_t['ms']:.4f} ms "
                      f"({b['bound'][0] / new_t['ms']:.0%} of its "
                      f"{b['bound'][0]:.4f} ms bound, {b['bound'][1]}; dense-"
                      f"DFT count {b['dense_bound_ms']:.4f}), fx_tile_kernel "
                      f"{first_t['ms']:.4f} ms, plain {plain_ms:.4f} ms")
        if not new_t["ms"] < first_t["ms"]:
            fail(f"{label}: {body} is not faster than fx_tile_kernel")
        res[entry] = {"ms": new_t["ms"], "device_ms": new_t["device_ms"],
                      "events_ms": new_t["events_ms"],
                      "first_body_ms": first_t["ms"],
                      "first_body_events_ms": first_t["events_ms"],
                      "plain_ms": plain_ms, "max_abs_err": err,
                      "bound_ms": b["bound"][0], "bound_by": b["bound"][1],
                      **{k: v for k, v in b.items() if k != "bound"}}
        res["err"] = max(res["err"], err)
        del got, want
    del xr, xi, tr, ti, flat_ins, comps, hist, entries
    torch.cuda.empty_cache()
    return res


def fx_wide_path(torch, hk, P, gen, dev) -> dict:
    """Counts reset, the fused step at 64 channels (the step's 1600-tap
    prototype), 4 × 2^23, 3 chained steps in f32 and int8 ingest; counts
    read: one launch a step, each step held to the plain form, the tails
    bit-equal; then one step's kernels by name (``torch.profiler``: one
    fx_wide_kernel) and the device busy and wall time a step."""
    from clenabled_tpu_torch.runtime.device import launched_kernels

    m = FX_PATH_M
    cfg = P.FxPipelineConfig(num_antennas=A, num_channels=m,
                             samples_per_step=N_FULL)
    runs = {}
    for label, dt in (("f32", torch.float32), ("int8", torch.int8)):
        fn, (_, _, tr0, ti0) = P.make_fx_pipeline_fused(cfg, in_dtype=dt,
                                                        device=dev)
        runs[label] = (fn, [(frames(torch, gen, dt, (A, N_FULL), dev),
                             frames(torch, gen, dt, (A, N_FULL), dev))
                            for _ in range(STEPS)], tr0, ti0)
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    outs = {}
    for label, (fn, fr, tr, ti) in runs.items():
        outs[label] = []
        for xr, xi in fr:
            o = fn(xr, xi, tr, ti)
            outs[label].append(o)
            tr, ti = o[3], o[4]
    torch.cuda.synchronize()
    launches = hk.fx_correlate_streams_v2.launches
    phase("main", f"fused step {A}x{N_FULL} at {m} channels "
                  f"({runs['f32'][0].taps_rm.shape[0] * m} taps), f32 and "
                  f"int8, {STEPS} steps each; launches {launches}")
    if launches != 2 * STEPS:
        fail(f"the {m}-channel fused step launched fx_correlate_streams_v2 "
             f"{launches} times in {2 * STEPS} steps")
    res = {"launches": launches, "err": 0.0}
    for label, (fn, fr, tr, ti) in runs.items():
        for k, (xr, xi) in enumerate(fr):
            fd_sum, gram = hk.fx_correlate_streams_v2_plain(
                xr, xi, tr, ti, fn.taps_rm, A, m)
            want = (torch.roll(fd_sum / (N_FULL // m), m // 2, dims=-1),
                    gram[:, :m].T[:, :, None], gram[:, m:].T[:, :, None])
            got = outs[label][k]
            res["err"] = max(res["err"], check(
                torch, f"fused {label} {m}ch step {k}", got[:3], want))
            h = fn.tail_len
            if not (torch.equal(got[3], xr[:, -h:])
                    and torch.equal(got[4], xi[:, -h:])):
                fail(f"fused {label} {m}ch step {k}: carried tail is wrong")
            tr, ti = got[3], got[4]
    del outs
    for label, (fn, fr, tr, ti) in runs.items():
        xr, xi = fr[0]
        _, names = launched_kernels(lambda: fn(xr, xi, tr, ti))
        if sum("fx_wide_kernel" in n for n in names) != 1:
            fail(f"the {m}-channel {label} step launched {names}, not one "
                 f"fx_wide_kernel")
        phase("main", f"{m}-channel {label} step kernels: "
                      f"{sorted(set(short_name(n) for n in names))}")
        res[label] = path_times(torch, f"fused step {m}ch {label}",
                                lambda: fn(xr, xi, tr, ti), N_FULL)
    return res


def xengine_phase(torch, hk, gen, dev) -> dict:
    """The X-Engine flowgraph at full width, counted and checked, then
    timed per integration."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import xengine as X
    from clenabled_tpu_torch.streaming import Flowgraph

    xe = blocks.XEngine(data_type=5, polarization=XE_P, num_inputs=XE_S,
                        num_channels=XE_F, integration=XE_T,
                        pipeline_integration=2, planar=True)
    g = Flowgraph()
    for s in range(XE_S):
        g.external_input(xe, s)
    r = g.compile(xe.quantum, device=dev)
    msgs = []
    r.on_message("xengine.xcorr", msgs.append)
    feeds = [[torch.randint(-128, 128, (xe.quantum,), generator=gen,
                            device=dev, dtype=torch.int8)
              for _ in range(XE_S)] for _ in range(XE_STEPS)]
    torch.cuda.synchronize()

    hk.reset_launch_counts()
    for fr in feeds:
        r.step(*fr)
    torch.cuda.synchronize()
    launches = hk.gram_launches()
    phase("xengine", f"Flowgraph/XEngine S={XE_S} P={XE_P} F={XE_F} "
                     f"T={XE_T} IChar, {XE_STEPS} integrations, "
                     f"pipeline_integration=2; launches {launches}")
    if launches < 1:
        fail("the Gram kernel was not launched on the X-Engine path")

    def marshal(fr):
        """IChar bytes [S][T·F·P·2] → channel-major int8 (zr, zi)."""
        raw = torch.stack(fr).view(XE_S, XE_T, XE_F, XE_P, 2)
        return tuple(raw[..., c].permute(2, 1, 0, 3).reshape(XE_F, XE_T, -1)
                     for c in (0, 1))

    plain = [X.xengine_correlate_stacked(*marshal(fr), npol=XE_P,
                                         scale=1.0 / 127.0 ** 2,
                                         use_kernel=False) for fr in feeds]
    if [bool(m["valid"]) for m in msgs] != [False, True, False]:
        fail(f"emission flags {[m['valid'] for m in msgs]}")
    out = msgs[1]["matrix"]
    nb = XE_S * (XE_S + 1) // 2
    if tuple(out.re.shape) != (XE_F, nb, XE_P * XE_P):
        fail(f"matrix shape {tuple(out.re.shape)}")
    want = (plain[0].re + plain[1].re, plain[0].im + plain[1].im)
    if not (torch.equal(out.re, want[0]) and torch.equal(out.im, want[1])):
        err = float(max((out.re - want[0]).abs().max(),
                        (out.im - want[1]).abs().max()))
        fail(f"X-Engine emission differs from the plain engine ({err})")
    if not bool(torch.isfinite(out.re).all() and torch.isfinite(out.im).all()):
        fail("X-Engine emission is not finite")
    for k in (0, 2):
        if msgs[k]["matrix"].re.any() or msgs[k]["matrix"].im.any():
            fail(f"integration {k}: held-back output is not zero")
    st = r.states[0]
    if not (st.count == 1 and torch.equal(st.accum.re, plain[2].re)
            and torch.equal(st.accum.im, plain[2].im)):
        fail("the third integration is not the carried accumulator")
    phase("check", f"X-Engine [{XE_F}, {nb}, {XE_P * XE_P}] emission = plain "
                   f"engine over the same two integrations, bit-exact; "
                   f"third integration carried")

    # device step: feeds already on the card, one integration per call
    step_ms = time_ms(torch, lambda: r.step(*feeds[0]), reps=6, warmup=2)
    # the step's marshal alone: raw bytes to channel-major int8 (zr, zi)
    marshal_ms = time_ms(torch, lambda: xe._decode_int(feeds[0]), reps=6,
                         warmup=2)
    # host to product: numpy bytes in, the emitted matrix back on the host
    host = [[f.cpu().numpy() for f in fr] for fr in feeds[:2]]
    products = []

    def fetch(m):
        if m["valid"]:
            products.append((m["matrix"].re.cpu(), m["matrix"].im.cpu()))

    r.reset()
    r.on_message("xengine.xcorr", fetch)
    n = 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n):
        r.step(*host[k % 2])
    torch.cuda.synchronize()
    h2p_ms = (time.perf_counter() - t0) / n * 1e3
    if len(products) != n // 2:
        fail(f"{len(products)} products from {n} host integrations")
    if not (torch.equal(products[0][0], out.re.cpu())
            and torch.equal(products[0][1], out.im.cpu())):
        fail("the host-fed run differs from the device-fed one")
    in_mb = XE_S * xe.quantum / 2 ** 20
    phase("xengine", f"device step {step_ms:.4f} ms per integration "
                     f"({XE_S * XE_T * XE_F / step_ms / 1e3:.1f} MSPS in all),"
                     f" of which the marshal (XEngine._decode_int) "
                     f"{marshal_ms:.4f} ms alone;"
                     f" host-to-product {h2p_ms:.2f} ms per integration "
                     f"({in_mb:.0f} MiB of bytes in)")
    return {"launches": launches, "step_ms": step_ms,
            "marshal_ms": marshal_ms, "h2p_ms": h2p_ms}


def xengine_sync_phase(torch, hk, dev) -> dict:
    """The X-Engine flowgraph at the reference configuration fed through
    ``SynchronizedIngest`` from XE_S per-station tagged streams of host
    IChar windows (one integration window a frame), starts staggered by
    0-2 windows and one window dropped: discards and callbacks as planned,
    every emission bit-equal to the plain engine on the aligned windows.
    Each station reuses two host buffers; a window's bytes are made on the
    card from a seed of (station, window) and copied into one."""
    import numpy as np

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import xengine as X
    from clenabled_tpu_torch.streaming import (Flowgraph, SynchronizedIngest,
                                               TaggedFrame)

    xe = blocks.XEngine(data_type=5, polarization=XE_P, num_inputs=XE_S,
                        num_channels=XE_F, integration=XE_T,
                        pipeline_integration=2, planar=True)
    q = xe.quantum
    gen = torch.Generator(device=dev)

    def window(s, w):
        gen.manual_seed(1_000_003 * (w + 1) + s)
        return torch.randint(-128, 128, (q,), generator=gen, device=dev,
                             dtype=torch.int8)

    def station(s):
        bufs = [np.empty(q, np.int8) for _ in range(2)]
        for k, w in enumerate(w for w in range(s % 3, SYNC_END)
                              if (s, w) != SYNC_DROP):
            buf = bufs[k % 2]
            torch.from_numpy(buf).copy_(window(s, w))
            yield TaggedFrame(w, buf)

    g = Flowgraph()
    for s in range(XE_S):
        g.external_input(xe, s)
    # one frame a dispatch: a station's buffer is refilled once its frame
    # has been stepped
    r = g.compile(q, steps_per_dispatch=1, device=dev)
    msgs = []
    r.on_message("xengine.xcorr", lambda m: msgs.append(
        (m["matrix"].re.clone(), m["matrix"].im.clone(), bool(m["valid"]))))
    synced, resyncs = [], []
    ing = SynchronizedIngest([station(s) for s in range(XE_S)],
                             block_multiple=1, on_sync=synced.append,
                             on_resync=lambda o, n: resyncs.append((o, n)))
    hk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.run(ing)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hk.gram_launches()
    # the plan: sync on window 2 (the latest start); the drop re-aligns on
    # the window after it, the other stations discarding the dropped one
    aligned = [w for w in range(2, SYNC_END) if w != SYNC_DROP[1]]
    want_disc = [2 - s % 3 + (s != SYNC_DROP[0]) for s in range(XE_S)]
    if (synced, resyncs, ing.discarded) != (
            [2], [(SYNC_DROP[1], SYNC_DROP[1] + 1)], want_disc):
        fail(f"SynchronizedIngest: sync {synced}, resync {resyncs}, "
             f"discards {ing.discarded}")
    if [v for *_, v in msgs] != [k % 2 == 1 for k in range(len(aligned))]:
        fail(f"synchronised X-Engine: ready {[v for *_, v in msgs]}")
    if launches != len(aligned):
        fail(f"synchronised X-Engine: {launches} Gram launches for "
             f"{len(aligned)} integrations")

    def marshal(w):
        raw = torch.stack([window(s, w) for s in range(XE_S)]).view(
            XE_S, XE_T, XE_F, XE_P, 2)
        return tuple(raw[..., c].permute(2, 1, 0, 3).reshape(XE_F, XE_T, -1)
                     for c in (0, 1))

    for k in range(1, len(aligned), 2):
        p0, p1 = (X.xengine_correlate_stacked(*marshal(w), npol=XE_P,
                                              scale=1.0 / 127.0 ** 2,
                                              use_kernel=False)
                  for w in aligned[k - 1:k + 1])
        gr, gi, _ = msgs[k]
        if not (torch.equal(gr, p0.re + p1.re)
                and torch.equal(gi, p0.im + p1.im)):
            fail(f"synchronised X-Engine emission {k // 2}: not bit-equal "
                 f"to the plain engine on windows {aligned[k - 1:k + 1]}")
    ms = wall / len(aligned) * 1e3
    phase("xengine", f"SynchronizedIngest over {XE_S} tagged station streams "
                     f"(starts 0-2 windows apart, station {SYNC_DROP[0]} "
                     f"drops window {SYNC_DROP[1]}): sync {synced}, resync "
                     f"{resyncs}, discards {sorted(set(ing.discarded))}; "
                     f"{len(aligned)} aligned integrations, {launches} Gram "
                     f"launches, {len(aligned) // 2} emissions bit-equal to "
                     f"the plain engine; {ms:.2f} ms an integration from host "
                     f"windows (each made on the card and copied to the host "
                     f"first), two {q / 2 ** 20:.0f} MiB host buffers a station")
    return {"launches": launches, "integrations": len(aligned),
            "discarded": ing.discarded, "ms_per_integration": ms}


def pfb_inputs(torch, gen, dev, a: int, m: int, nout: int, ntaps=None):
    """(y, hr) of the planar step's lane-packed stream: ``a`` antennas of
    nout·m samples each behind their T−1 history, ``m`` channels, the
    step's prototype (``pipelines._prototype``) or an ``ntaps``-tap
    windowed sinc."""
    import numpy as np

    from clenabled_tpu_torch import pipelines as P
    from clenabled_tpu_torch.dsp import channelizer as chan

    proto = None if ntaps is None else (
        np.sinc(np.linspace(-4, 4, ntaps)) * np.hanning(ntaps)).astype(
            np.float32)
    taps_rm, nt = P._prototype(m, 100e6, proto)
    taps = torch.as_tensor(taps_rm, device=dev)
    comps = torch.randn((2 * a, nt - 1 + nout * m), generator=gen, device=dev)
    return chan._pack_streams(comps, taps, m, nt, nout)


def pfb_bounds(nout: int, w: int, a: int, m: int) -> dict:
    """The least time of one pfb_channelize_packed call: y, hr and the
    output each moved once (``bytes_ms``); W multiply-adds an output lane
    with the M-point transforms as FFTs (5·M·log2 M flops a group, as
    pfb_packed_reg_kernel runs them; ``operations_ms``) or as dense DFTs
    (8·M², as pfb_packed_kernel does; ``dense_operations_ms``), at FP32's
    peak; ``bound`` is the larger of the first two, with what sets it."""
    gm = 2 * a * m
    nbytes = 4 * ((nout + w - 1) * gm + w * gm + nout * gm)
    fir = 2 * nout * gm * w
    fft = fir + a * nout * 5 * m * math.log2(m)
    return {"bound": bound(nbytes, fft), "bytes_ms": nbytes / HBM_BPS * 1e3,
            "operations_ms": fft / FP32_OPS * 1e3,
            "dense_operations_ms": (fir + a * nout * 8 * m * m)
            / FP32_OPS * 1e3}


def pfb_on_body(torch, hk, y, hr, a: int, m: int, body: str):
    """``clen_pfb_packed`` on the named body with its wrapper's rows a
    block, as ``pfb_channelize_packed`` calls it but uncounted; returns a
    call that writes and returns the output."""
    w = hr.shape[0]
    out = torch.empty((y.shape[0] - (w - 1), y.shape[1]), device=y.device)
    lib = hk._load()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    code = hk.PFB_PACKED_BODIES.index(body)
    tile = hk.pfb_packed_tile(a, m, code)
    tw = hk._twiddles(m, y.device)

    def call():
        err = lib.clen_pfb_packed(y.data_ptr(), hr.data_ptr(), tw.data_ptr(),
                                  out.data_ptr(), out.shape[0], w, a, m, tile,
                                  code, stream)
        if err != 0:
            fail(f"{body} launch failed: CUDA error {err}")
        return out
    return call


def call_times(torch, label: str, call) -> dict:
    """A call's device time (``runtime.device.device_time_ms``: the kernels
    of 10 calls, each call's own kernel and, for the FX step, its
    fx_reduce_kernel) and its time on CUDA events around 10 back-to-back
    calls; ``ms`` is the device time, the events' where the profiler
    records none."""
    from clenabled_tpu_torch.runtime.device import device_time_ms

    events = time_ms(torch, call)
    dev = device_time_ms(call, 10)
    shown = "not measured" if dev is None else f"{dev:.4f} ms"
    phase("time", f"{label}: device {shown}, per call (events) "
                  f"{events:.4f} ms")
    return {"ms": events if dev is None else dev, "device_ms": dev,
            "events_ms": events}


def pfb_packed_phase(torch, hk, gen, dev) -> dict:
    """B.2 against its plain form: the planar step's shape (4 antennas ×
    2^17, 16 channels, W = 25) and the fused step's width (4 × 2^23), each
    also on the first body through the C entry and timed beside it; then
    M = 8, 4, 2, A = 1 and 3, W = 1 and 100, a ragged and a short last
    block, and M = 32 at 2^17; then ``hk.PFB_WIDE_M`` at 4 × 2^23 on the
    step's own prototypes, where the rule must pick pfb_packed_wide_kernel,
    timed beside the first body, which it must beat; each case printing
    the body it ran."""
    res = {"err": 0.0, "bodies": {}, "shapes": {}}
    cases = [("entry", A, M, N_ENTRY // M, None),
             ("full width", A, M, N_FULL // M, None),
             ("M=8", A, 8, N_ENTRY // 8, None),
             ("M=4", A, 4, N_ENTRY // 4, None),
             ("M=2", A, 2, N_ENTRY // 2, None),
             ("A=1", 1, M, N_ENTRY // M, None),
             ("A=3", 3, M, N_ENTRY // M, None),
             ("W=1", A, M, N_ENTRY // M, M),
             ("W=100", A, M, N_ENTRY // M, 100 * M),
             ("ragged 8192+7", A, M, 8192 + 7, None),
             ("nout 20 < rows", A, M, 20, None),
             ("M=32", A, 32, N_ENTRY // 32, None)]
    cases += [(f"M={m} full width", A, m, N_FULL // m, None)
              for m in hk.PFB_WIDE_M]
    timed = ["entry", "full width"] + [f"M={m} full width"
                                       for m in hk.PFB_WIDE_M]
    for label, a, m, nout, ntaps in cases:
        y, hr = pfb_inputs(torch, gen, dev, a, m, nout, ntaps)
        w = hr.shape[0]
        body = hk.pfb_packed_body(m, w, dev)
        got = hk.pfb_channelize_packed(y, hr, a, m)
        torch.cuda.synchronize()
        want = hk.pfb_channelize_packed_plain(y, hr, a, m)
        res["bodies"][label] = body
        shape = f"[{y.shape[0]}, {y.shape[1]}]"
        res["err"] = max(res["err"], check(
            torch, f"pfb_packed {label} {shape}, A={a}, M={m}, W={w} on "
                   f"{body}", [got], [want]))
        if m in hk.PFB_WIDE_M and label in timed \
                and body != "pfb_packed_wide_kernel":
            fail(f"pfb_packed {label}: the rule picks {body}, not "
                 f"pfb_packed_wide_kernel")
        if label in timed:
            first = pfb_on_body(torch, hk, y, hr, a, m, "pfb_packed_kernel")
            first_err = check(torch, f"pfb_packed {label} {shape} on "
                                     f"pfb_packed_kernel (the first body)",
                              [first()], [want])
            new = call_times(torch, f"pfb_packed {label} {shape} ({body})",
                            lambda: hk.pfb_channelize_packed(y, hr, a, m))
            old = call_times(torch, f"pfb_packed {label} {shape} "
                                   f"(pfb_packed_kernel, the first body)",
                            first)
            plain_ms = time_ms(torch, lambda: hk.pfb_channelize_packed_plain(
                y, hr, a, m), reps=3, warmup=1)
            bounds = pfb_bounds(nout, w, a, m)
            phase("time", f"pfb_packed {label} {shape}: {body} "
                          f"{new['ms']:.4f} ms ({bounds['bound'][0] / new['ms']:.0%}"
                          f" of its {bounds['bound'][0]:.4f} ms bound, "
                          f"{bounds['bound'][1]}), pfb_packed_kernel "
                          f"{old['ms']:.4f} ms, plain {plain_ms:.4f} ms")
            if m in hk.PFB_WIDE_M and not new["ms"] < old["ms"]:
                fail(f"pfb_packed {label}: {body} is not faster than "
                     f"pfb_packed_kernel")
            res["shapes"][label] = dict(
                new, shape=shape, body=body, plain_ms=plain_ms,
                first_body=dict(old, max_abs_err=first_err), bounds=bounds)
        del y, hr, got, want
    torch.cuda.empty_cache()
    return res


def fm_taps():
    """(49-tap low-pass of the FM path, the retune's 49-tap low-pass,
    test_clfilter's 241-tap RRC, a 1601-tap windowed sinc)."""
    import numpy as np

    from clenabled_tpu_torch.dsp import firdes

    lpf = firdes.low_pass(1.0, 10e6, 1.5e6, 500e3)
    retune = firdes.low_pass(1.0, 10e6, 1.0e6, 500e3)
    rrc = firdes.root_raised_cosine(1.0, 10e6, 10e6 / (241 / 11 + 2), 0.22, 241)
    deep = (np.sinc(np.linspace(-8, 8, 1601)) * np.hanning(1601)).astype(
        np.float32)
    if not (len(lpf) == len(retune) == 49 and len(rrc) == 241):
        fail(f"FM tap designs have {len(lpf)}/{len(retune)}/{len(rrc)} taps")
    return lpf, retune, rrc, deep


def fm_times(torch, label: str, kernel, plain) -> tuple:
    """(kernel, plain) device time per call from ``torch.profiler`` — the
    launches' own time, which a host slower than the card hides from CUDA
    events — and (kernel, plain) time per call on CUDA events around 10
    back-to-back calls; the device times fall back to the event times
    where the profiler records none."""
    call = (time_ms(torch, kernel), time_ms(torch, plain))
    busy = (device_busy_ms(torch, kernel, 10), device_busy_ms(torch, plain, 10))
    dev = tuple(c if b is None else b for b, c in zip(busy, call))
    shown = ("not measured" if b is None else f"{b:.4f} ms" for b in busy)
    phase("time", f"{label}: device kernel {next(shown)}, plain "
                  f"{next(shown)}; per call (events) kernel {call[0]:.4f} ms, "
                  f"plain {call[1]:.4f} ms")
    return dev + call


def fir_on_body(torch, hk, x, h, t, body: str):
    """Both rows of ``x`` (history rows ``h``) through ``clen_fir_direct`` on
    the named body at decimation 1, as the wrapper calls it but uncounted;
    returns a call that writes and returns the [2, n] output."""
    y = torch.empty_like(x)
    lib = hk._load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = hk.FIR_BODIES.index(body)

    def call():
        err = lib.clen_fir_direct(
            h[0].data_ptr(), x[0].data_ptr(), y[0].data_ptr(), h[1].data_ptr(),
            x[1].data_ptr(), y[1].data_ptr(), 2, t.data_ptr(), t.shape[0],
            x.shape[-1], 1, code, stream)
        if err != 0:
            fail(f"{body} launch failed: CUDA error {err}")
        return y
    return call


def fir_bit_equal(torch, hk, label: str, got, x, h, t) -> str:
    """Hold a D = 1 call's [2, n] output to the first body's on the same
    inputs bit for bit; returns the body the call ran."""
    body = hk.fir_body(t.shape[0], 1, x.device)
    first = fir_on_body(torch, hk, x.contiguous(), h.contiguous(), t,
                        "fir_direct_kernel")()
    torch.cuda.synchronize()
    if not torch.equal(got, first):
        fail(f"{label}: {body} differs from fir_direct_kernel")
    phase("check", f"{label} on {body}: bit-equal to fir_direct_kernel")
    return body


def fir_edge_cases(torch, hk, gen, dev) -> tuple[float, dict]:
    """The direct FIR at the edges the wrappers accept: 1, 2, 3 and 50 taps
    (seeded normal taps); the history-in-front form, whose frame pointer
    is then (K − 1) mod 4 floats off 16-byte alignment; a frame shorter
    than the history; a ragged last block.  Each held to the plain form
    and, at D = 1, to the first body bit for bit; returns the largest
    error and the body of each case."""
    from clenabled_tpu_torch.dsp import planar

    worst, bodies = 0.0, {}
    cases = [("1 tap", 1, 1 << 20), ("2 taps", 2, 1 << 20),
             ("3 taps", 3, 1 << 20), ("50 taps", 50, 1 << 20),
             ("241 taps frame 100 < history", 241, 100),
             ("1601 taps ragged 2^20+13", 1601, (1 << 20) + 13)]
    for label, k, n in cases:
        t = torch.randn(k, generator=gen, device=dev)
        x = torch.randn((2, n), generator=gen, device=dev)
        h = torch.randn((2, k - 1), generator=gen, device=dev)
        got = hk.fir_direct(planar.PC(x[0], x[1]), t,
                            history=planar.PC(h[0], h[1]))
        torch.cuda.synchronize()
        want = hk.fir_direct_plain(planar.PC(x[0], x[1]), t,
                                   history=planar.PC(h[0], h[1]))
        worst = max(worst, check(torch, f"fir_direct {label} [2x{n}]",
                                 list(got), list(want)))
        bodies[label] = fir_bit_equal(torch, hk, f"fir_direct {label}",
                                      torch.stack(list(got)), x, h, t)
    # history in front: the frame starts K−1 floats into its row
    for k in (50, 51, 52):
        t = torch.randn(k, generator=gen, device=dev)
        row = torch.randn((2, k - 1 + (1 << 20)), generator=gen, device=dev)
        got = torch.stack([hk.fir_direct(row[c], t) for c in range(2)])
        torch.cuda.synchronize()
        want = [hk.fir_direct_plain(row[c], t) for c in range(2)]
        label = f"fir_direct {k} taps, history in front (frame pointer " \
                f"{row[0, k - 1:].data_ptr() % 16} B off 16)"
        worst = max(worst, check(torch, label, list(got), want))
        bodies[f"{k} taps history in front"] = fir_bit_equal(
            torch, hk, label, got, row[:, k - 1:], row[:, :k - 1], t)
    return worst, bodies


def fir_bound(n: int, k: int) -> tuple:
    """The direct FIR's bound over both components at decimation 1: each
    input and history sample read once, each output written once, the taps
    read once; 2·K operations an output."""
    return bound(4 * 2 * (2 * n + k - 1) + 4 * k, 2 * 2 * n * k)


def fm_kernel_phase(torch, hk, gen, dev) -> dict:
    """B.6-B.8 against their plain forms at 2^21 samples; returns the
    largest errors and the kernel and plain times."""
    from clenabled_tpu_torch.dsp import planar
    from clenabled_tpu_torch.runtime.device import device_time_ms

    lpf, _, rrc, deep = fm_taps()
    n = FM_N
    x = torch.randn((2, n), generator=gen, device=dev)
    pc = planar.PC(x[0], x[1])
    res = {"fir": 0.0, "ofs": 0.0, "qd": 0.0, "fir bodies": {},
           "fir first": {}, "fir bounds": {}}
    conv = torch.nn.functional.conv1d
    for name, taps in (("49", lpf), ("241", rrc), ("1601", deep)):
        t = torch.as_tensor(taps, device=dev)
        h = torch.randn((2, len(taps) - 1), generator=gen, device=dev)
        hist = planar.PC(h[0], h[1])
        for d in ((1,) if name == "49" else (1, 4)):
            got = hk.fir_direct(pc, t, decimation=d, history=hist)
            torch.cuda.synchronize()
            want = hk.fir_direct_plain(pc, t, decimation=d, history=hist)
            body = hk.fir_body(len(taps), d, dev)
            res["fir"] = max(res["fir"], check(
                torch, f"fir_direct {name} taps D={d} [2x{n}] on {body}",
                got, want))
            if d == 1:
                res["fir bodies"][f"{name} taps"] = fir_bit_equal(
                    torch, hk, f"fir_direct {name} taps [2x{n}]",
                    torch.stack(list(got)), x, h, t)
            else:
                res["fir bodies"][f"{name} taps D={d}"] = body
        res[f"fir {name}"] = fm_times(
            torch, f"fir_direct {name} taps [2x{n}] "
                   f"({hk.fir_body(len(taps), 1, dev)})",
            lambda: hk.fir_direct(pc, t, history=hist),
            lambda: hk.fir_direct_plain(pc, t, history=hist))
        # uncounted by the wrappers, so timed where the trace must hold one
        # kernel event a call
        first = fir_on_body(torch, hk, x, h, t, "fir_direct_kernel")
        events = time_ms(torch, first)
        busy = device_time_ms(first, 10)
        res["fir first"][name] = {"ms": events if busy is None else busy,
                                  "events_ms": events}
        shown = "not measured" if busy is None else f"{busy:.4f} ms"
        res["fir bounds"][name] = fir_bound(n, len(taps))
        phase("time", f"fir_direct_kernel (the first body) {name} taps "
                      f"[2x{n}]: device {shown}, per call (events) "
                      f"{events:.4f} ms; bound {res['fir bounds'][name][0]:.4f}"
                      f" ms ({res['fir bounds'][name][1]})")
        plan = hk.OfsPlan(taps)
        tr, ti = torch.randn((2, plan.tail_len), generator=gen, device=dev)
        if name in ("49", "1601"):
            # the library call for the same function: one conv1d over both
            # components, history in front (TF32 off), held to the FIR
            # kernel at 49 and 1601 taps and to the OFS kernel at 1601
            wts = t.flip(0)[None, None, :]
            v = torch.cat([h, x], dim=-1)[:, None, :]
            res["fir"] = max(res["fir"], check(
                torch, f"conv1d {name} taps (library) vs fir kernel",
                list(hk.fir_direct(pc, t, history=hist)),
                list(conv(v, wts)[:, 0])))
            if name == "1601":
                kern = hk.ofs_filter_planar(x[0], x[1], tr, ti, plan)
                tail = torch.stack([tr, ti])[:, plan.tail_len - len(taps) + 1:]
                vo = torch.cat([tail, x], dim=-1)[:, None, :]
                res["ofs"] = max(res["ofs"], check(
                    torch, f"conv1d {name} taps (library) vs ofs kernel",
                    list(kern), list(conv(vo, wts)[:, 0])))
            res[f"conv1d {name}"] = (
                device_busy_ms(torch, lambda: conv(v, wts), 10)
                or time_ms(torch, lambda: conv(v, wts)))
            phase("time", f"conv1d {name} taps [2x{n}] (library): device "
                          f"{res[f'conv1d {name}']:.4f} ms")
        sizes = (n, plan.quantum) if name == "49" else (n,)
        for m in sizes:
            for d in ((1,) if m != n or name == "49" else (1, 4)):
                args = (x[0, :m], x[1, :m], tr, ti, plan)
                got = hk.ofs_filter_planar(*args, decimation=d)
                torch.cuda.synchronize()
                want = hk.ofs_filter_planar_plain(*args, decimation=d)
                res["ofs"] = max(res["ofs"], check(
                    torch, f"ofs_filter_planar {name} taps D={d} [{m}], "
                           f"P={plan.fft_size}", got, want))
        args = (x[0], x[1], tr, ti, plan)
        res[f"ofs {name}"] = fm_times(
            torch, f"ofs_filter_planar {name} taps [{n}], P={plan.fft_size}",
            lambda: hk.ofs_filter_planar(*args),
            lambda: hk.ofs_filter_planar_plain(*args))

    err, bodies = fir_edge_cases(torch, hk, gen, dev)
    res["fir"] = max(res["fir"], err)
    res["fir bodies"].update(bodies)

    last = torch.randn((2, 1), generator=gen, device=dev)
    for m in (n, 1_000_001):
        args = (x[0, :m], x[1, :m], last[0], last[1], 1.0)
        got = hk.qdemod_fused(*args)
        torch.cuda.synchronize()
        res["qd"] = max(res["qd"], check(
            torch, f"qdemod_fused [{m}]", [got], [hk.qdemod_fused_plain(*args)]))
    args = (x[0], x[1], last[0], last[1], 1.0)
    res["qd time"] = fm_times(torch, f"qdemod_fused [{n}]",
                              lambda: hk.qdemod_fused(*args),
                              lambda: hk.qdemod_fused_plain(*args))
    return res


def device_busy_ms(torch, fn, steps: int, tries: int = 3) -> float | None:
    """The device's busy time per call of ``fn`` (the sum of its kernels'
    and copies' times over ``steps`` calls), from ``torch.profiler``.

    Late in a long process the profiler can miss the first milliseconds of
    device work in a trace, so each trace opens with at least 30 ms of
    calls that are not counted, and only the device events that start in
    the counted window are summed.  Those must hold an event for every
    launch the port's wrappers counted in the window, else the trace is
    taken again, up to ``tries`` times; None when no trace is whole or the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from clenabled_tpu_torch.dsp import hopper_kernels as hk

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.03:
                fn()
                torch.cuda.synchronize()
            before = sum(hk.launch_counts().values())
            with record_function("busy_window"):
                for _ in range(steps):
                    fn()
                torch.cuda.synchronize()
            launched = sum(hk.launch_counts().values()) - before
        events = prof.events()
        start = min(e.time_range.start for e in events
                    if e.name == "busy_window")
        window = [e for e in events      # kernels and copies, not the
                  if e.device_type == cuda   # window's own device span
                  and e.name != "busy_window" and e.time_range.start >= start]
        us = sum(e.time_range.elapsed_us() for e in window)
        recorded = sum(any(k in e.name for k in PORT_KERNELS) for e in window)
        if recorded >= launched:
            return us / steps / 1e3 if us > 0 else None
        phase("profile", f"the trace holds {recorded} of the {launched} "
                         f"kernel launches counted in it; taken again")
    return None


def fm_path_phase(torch, hk, gen, dev, use_time: bool) -> dict:
    """The planar LowPass → QuadratureDemod flowgraph at 2^21-sample
    frames, retuned mid-stream, counted, held to the same chain on the
    plain forms, and timed."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import planar
    from clenabled_tpu_torch.streaming import Flowgraph

    label = "TD" if use_time else "FD"
    taps_a, taps_b, _, _ = fm_taps()
    lpf = blocks.LowPassFilter(1, 1.0, 10e6, 1.5e6, 500e3, use_time=use_time,
                               planar=True)
    qd = blocks.QuadratureDemod(1.0, planar=True)
    g = Flowgraph()
    g.external_input(lpf)
    g.connect(lpf, qd)
    ty = g.tap(lpf, name="filtered")
    ta = g.tap(qd, name="audio")
    r = g.compile(FM_N, device=dev)
    kind = "td" if use_time else "ofs"
    if lpf._state_kind != kind:
        fail(f"{label} LowPassFilter took the {lpf._state_kind} form")
    feeds = [planar.PC(*torch.randn((2, FM_N), generator=gen, device=dev))
             for _ in range(FM_FRAMES)]
    torch.cuda.synchronize()

    hk.reset_launch_counts()
    outs = []
    for k, f in enumerate(feeds):
        if k == FM_RETUNE_AT:
            r.set_taps(lpf, taps_b)
        outs.append(r.step(f))
    torch.cuda.synchronize()
    filt = hk.fir_direct if use_time else hk.ofs_filter_planar
    launches = {filt.__name__: filt.launches,
                "qdemod_fused": hk.qdemod_fused.launches}
    phase("fm", f"{label} Flowgraph LowPass(49 taps) -> QuadratureDemod, "
                f"{FM_FRAMES} frames of {FM_N}, set_taps after frame "
                f"{FM_RETUNE_AT}; launches {launches}")
    if launches != {filt.__name__: FM_FRAMES, "qdemod_fused": FM_FRAMES}:
        fail(f"{label}: expected one filter and one demod launch per frame")

    # the same chain on the plain forms, state threaded by hand
    taps = [torch.as_tensor(t, device=dev) for t in (taps_a, taps_b)]
    plans = [hk.OfsPlan(t) for t in (taps_a, taps_b)]
    keep = len(taps_a) - 1 if use_time else plans[0].tail_len
    st = torch.zeros((2, keep), device=dev)
    last = torch.zeros((2, 1), device=dev)         # the path's own
    last_plain = last
    worst = 0.0
    for k, (f, o) in enumerate(zip(feeds, outs)):
        new = int(k >= FM_RETUNE_AT)
        if use_time:
            y = hk.fir_direct_plain(f, taps[new], history=planar.PC(*st))
        else:
            y = planar.PC(*hk.ofs_filter_planar_plain(f.re, f.im, st[0],
                                                      st[1], plans[new]))
        got = o[ty]
        worst = max(worst, check(torch, f"{label} frame {k} filtered",
                                 list(got), list(y)))
        audio = hk.qdemod_fused_plain(got.re, got.im, last[0], last[1], 1.0)
        worst = max(worst, check(torch, f"{label} frame {k} audio",
                                 [o[ta]], [audio]))
        st = torch.stack([f.re[-keep:], f.im[-keep:]])
        last = torch.stack([got.re[-1:], got.im[-1:]])
        last_plain = torch.stack([y.re[-1:], y.im[-1:]])
    fst, qst = r.states
    if not (torch.equal(fst[0], st[0]) and torch.equal(fst[1], st[1])):
        fail(f"{label}: the filter's carried state is not the last frame's "
             f"input")
    check(torch, f"{label} carried demod sample", list(qst), list(last_plain))

    step_ms = time_ms(torch, lambda: r.step(feeds[0]), reps=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in feeds + feeds:
        r.step(f)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / (2 * len(feeds)) * 1e3
    busy_ms = device_busy_ms(torch, lambda: r.step(feeds[1]), steps=5)
    busy = "not measured" if busy_ms is None else (
        f"{busy_ms:.4f} ms ({busy_ms / step_ms:.0%} of the step)")
    phase("fm", f"{label} per frame of {FM_N}: step {step_ms:.4f} ms "
                f"({FM_N / step_ms / 1e3:.1f} MSPS, CUDA events), device busy "
                f"{busy}, wall {wall_ms:.4f} ms ({FM_N / wall_ms / 1e3:.1f} "
                f"MSPS)")
    return {"launches": launches, "err": worst, "step_ms": step_ms,
            "busy_ms": busy_ms, "wall_ms": wall_ms}


def path_times(torch, label: str, step, samples: int) -> dict:
    """A path's time per frame: the device's busy time (``torch.profiler``)
    and the wall time over 8 chained steps ending in a synchronise."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 8 * 1e3
    busy_ms = device_busy_ms(torch, step, steps=4)
    busy = "not measured" if busy_ms is None else (
        f"{busy_ms:.4f} ms ({busy_ms / wall_ms:.0%} of the wall time)")
    phase("path", f"{label} per frame of {samples}: device busy {busy}, wall "
                  f"{wall_ms:.4f} ms ({samples / wall_ms / 1e3:.1f} MSPS)")
    return {"busy_ms": busy_ms, "wall_ms": wall_ms}


def os_proto(m: int, ntaps: int | None = None):
    """The oversampled path's prototype: ``firdes.low_pass(1.0, m, 0.5,
    0.25)`` (test_scaling's), or an ``ntaps``-tap windowed sinc, zero-padded
    to a multiple of m."""
    import numpy as np

    from clenabled_tpu_torch.dsp import firdes

    if ntaps is None:
        proto = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    else:
        proto = (np.sinc(np.linspace(-ntaps / (2 * m), ntaps / (2 * m), ntaps))
                 * np.hanning(ntaps)).astype(np.float32)
    return np.concatenate([proto, np.zeros((-len(proto)) % m, np.float32)])


def os_bounds(n: int, h: int, m: int, r: int, w: int) -> dict:
    """The least time of one pfb_oversampled_fused call: the frame, tail and
    taps read and [n/R, M] of both components written once (``bytes_ms``);
    the FIR's 2·W multiply-adds an output and component with the M-point
    transforms as FFTs (5·M·log2 M flops a group, as pfb_os_reg_kernel runs
    them; ``operations_ms``) or as dense DFTs (8·M², as pfb_os_kernel does;
    ``dense_operations_ms``), at FP32's peak; ``bound`` is the larger of
    the first two, with what sets it."""
    nout = n // r
    nbytes = 4 * (2 * n + 2 * h + w * m + 2 * nout * m)
    fir = 4 * nout * m * w
    fft = fir + nout * 5 * m * math.log2(m)
    return {"bound": bound(nbytes, fft), "bytes_ms": nbytes / HBM_BPS * 1e3,
            "operations_ms": fft / FP32_OPS * 1e3,
            "dense_operations_ms": (fir + nout * 8 * m * m) / FP32_OPS * 1e3}


def os_first_body_times(torch, hk, args, want, label: str) -> dict:
    """The first body, ``pfb_os_kernel``, on the same call through the C
    entry with body 0: held to the plain form, then its device time
    (``torch.profiler``) and per-call time (CUDA events).  No wrapper
    counts these launches."""
    xr, xi, tr, ti, taps, m, r, ioff = args
    zr = torch.empty((xr.shape[-1] // r, m), device=xr.device)
    zi = torch.empty_like(zr)
    tw = hk._twiddles(m, xr.device)
    lib = hk._load()
    stream = torch.cuda.current_stream(xr.device).cuda_stream

    def call():
        err = lib.clen_pfb_oversampled(
            xr.data_ptr(), xi.data_ptr(), tr.data_ptr(), ti.data_ptr(),
            taps.data_ptr(), tw.data_ptr(), zr.data_ptr(), zi.data_ptr(),
            xr.shape[-1], tr.shape[-1], m, r, taps.shape[0], ioff,
            max(1, hk._OS_GROUPS // m), hk.OS_BODIES.index("pfb_os_kernel"),
            stream)
        if err != 0:
            fail(f"pfb_os_kernel launch failed: CUDA error {err}")

    call()
    torch.cuda.synchronize()
    err = check(torch, f"pfb_oversampled {label} [{xr.shape[-1]}] on "
                       f"pfb_os_kernel (the first body)", (zr, zi), want)
    events = time_ms(torch, call)
    busy = device_busy_ms(torch, call, 10)
    shown = "not measured" if busy is None else f"{busy:.4f} ms"
    phase("time", f"pfb_os_kernel (the first body) {label} "
                  f"[{xr.shape[-1]}]: device {shown}, per call (events) "
                  f"{events:.4f} ms")
    return {"ms": events if busy is None else busy, "events_ms": events,
            "max_abs_err": err}


def os_phase(torch, hk, gen, dev) -> dict:
    """B.3 against its plain form, then the oversampled channelizer path."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import channelizer as chan
    from clenabled_tpu_torch.dsp import planar
    from clenabled_tpu_torch.streaming import Flowgraph

    res = {"err": 0.0, "bodies": {}}
    # the path's shape, 64 and 32 channels (the first body) and a rotation
    # offset; then L = 4, 8, 16 and 1600 taps at M = 16, each on a ragged
    # last block (n/R not a multiple of 128)
    ragged = OS_DEEP_N + 80
    cases = [("16ch R=8", OS_M, OS_R, None, OS_N, 0),
             ("64ch R=16 1600 taps", 64, 16, 1600, OS_DEEP_N, 0),
             ("32ch R=4 96 taps", 32, 4, 96, OS_DEEP_N, 0),
             ("16ch R=8 i_offset 5", OS_M, OS_R, None, OS_DEEP_N, 5),
             ("16ch R=4 i_offset 3", 16, 4, None, ragged, 3),
             ("16ch R=2", 16, 2, None, ragged, 0),
             ("16ch R=1 i_offset 7", 16, 1, None, ragged, 7),
             ("16ch R=8 1600 taps", 16, 8, 1600, ragged, 0)]
    for label, m, r, nt, n, ioff in cases:
        proto = os_proto(m, nt)
        taps_rm, ntaps = chan._pfb_constants(proto, m, r)
        h = hk.os_tail_len(m, r, ntaps)
        x = torch.randn((2, n), generator=gen, device=dev)
        t = torch.randn((2, h), generator=gen, device=dev)
        taps = torch.as_tensor(taps_rm, device=dev)
        args = (x[0], x[1], t[0], t[1], taps, m, r, ioff)
        got = hk.pfb_oversampled_fused(*args)
        torch.cuda.synchronize()
        want = hk.pfb_oversampled_fused_plain(*args)
        body = hk.os_body(m, r, taps.shape[0], dev)
        res["bodies"][label] = body
        res["err"] = max(res["err"], check(
            torch, f"pfb_oversampled {label} [{n}], W={taps.shape[0]}, H={h} "
                   f"on {body}", got, want))
        if label == "16ch R=8":
            res["time"] = fm_times(
                torch, f"pfb_oversampled {label} [{n}] ({body})",
                lambda: hk.pfb_oversampled_fused(*args),
                lambda: hk.pfb_oversampled_fused_plain(*args))
            res["bounds"] = os_bounds(n, h, m, r, taps.shape[0])
            res["first_body"] = os_first_body_times(torch, hk, args, want,
                                                    label)
        del x, t, got, want

    # BENCH_TPU.md's 64- and 32-channel configurations and 128 channels at
    # the path's frame, on both bodies
    res["wide"] = {label: os_wide_times(torch, hk, gen, dev, label, m, r, nt)
                   for label, m, r, nt in OS_WIDE}

    # a channel subset through the streaming form
    proto = os_proto(OS_M)
    sub = [0, 3, 5, 15]
    init, apply = chan.make_channelizer_fused_oversampled(
        proto, OS_M, OS_R, sub, device=dev)
    x = torch.randn((2, OS_DEEP_N), generator=gen, device=dev)
    st, out = apply(init(), planar.PC(x[0], x[1]))
    taps_rm, ntaps = chan._pfb_constants(proto, OS_M, OS_R)
    z0 = torch.zeros(hk.os_tail_len(OS_M, OS_R, ntaps), device=dev)
    wr, wi = hk.pfb_oversampled_fused_plain(x[0], x[1], z0, z0, taps_rm,
                                            OS_M, OS_R)
    res["err"] = max(res["err"], check(
        torch, f"fused channelizer ch_map {sub} [{OS_DEEP_N}]",
        list(out), [wr[:, sub], wi[:, sub]]))

    # the path: Flowgraph → PolyphaseChannelizer(fused), counted
    ch = blocks.PolyphaseChannelizer(proto, OS_N, OS_M, OS_R,
                                     list(range(OS_M)), planar=True,
                                     fused=True)
    g = Flowgraph()
    g.external_input(ch)
    tap = g.tap(ch, name="channels")
    r = g.compile(OS_N, device=dev)
    feeds = [planar.PC(*torch.randn((2, OS_N), generator=gen, device=dev))
             for _ in range(OS_FRAMES)]
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    outs = [r.step(f)[tap] for f in feeds]
    torch.cuda.synchronize()
    launches = hk.pfb_oversampled_fused.launches
    phase("os", f"Flowgraph PolyphaseChannelizer({ntaps} taps, {OS_N}, "
                f"{OS_M}, {OS_R}, fused), {OS_FRAMES} frames; launches "
                f"{launches}")
    if launches != OS_FRAMES:
        fail(f"expected one pfb_oversampled launch per frame, got {launches}")
    h = hk.os_tail_len(OS_M, OS_R, ntaps)
    tr = ti = torch.zeros(h, device=dev)
    for k, (f, o) in enumerate(zip(feeds, outs)):
        wr, wi = hk.pfb_oversampled_fused_plain(f.re, f.im, tr, ti, taps_rm,
                                                OS_M, OS_R)
        res["err"] = max(res["err"], check(
            torch, f"channelizer frame {k} [{OS_N // OS_R}x{OS_M}]",
            list(o), [wr.reshape(-1), wi.reshape(-1)]))
        tr, ti = f.re[-h:], f.im[-h:]
    st = r.states[0]
    if not (torch.equal(st[0], tr) and torch.equal(st[1], ti)):
        fail("the channelizer's carried tail is not the last frame's input")
    res["path"] = path_times(torch, "oversampled channelizer",
                             lambda: r.step(feeds[0]), OS_N)
    res["launches"] = launches
    del feeds, outs
    res["wide_path"] = os_wide_path(torch, hk, gen, dev)
    return res


def os_wide_times(torch, hk, gen, dev, label: str, m: int, r: int,
                  ntaps: int | None) -> dict:
    """One configuration of ``OS_WIDE`` at the path's frame (2^23 samples):
    the call as the path makes it, on the rule's body
    (``pfb_os_wide_kernel``, which it must be), held to the plain form and
    timed beside it (``fm_times``), then ``pfb_os_kernel`` on the same
    inputs through the C entry (``os_first_body_times``), beside the
    call's ``os_bounds``."""
    from clenabled_tpu_torch.dsp import channelizer as chan

    taps_rm, nt = chan._pfb_constants(os_proto(m, ntaps), m, r)
    h = hk.os_tail_len(m, r, nt)
    x = torch.randn((2, OS_N), generator=gen, device=dev)
    t = torch.randn((2, h), generator=gen, device=dev)
    taps = torch.as_tensor(taps_rm, device=dev)
    w = taps.shape[0]
    args = (x[0], x[1], t[0], t[1], taps, m, r, 0)
    body = hk.os_body(m, r, w, dev)
    if body != "pfb_os_wide_kernel":
        fail(f"pfb_oversampled {label}: the rule picks {body}, not "
             f"pfb_os_wide_kernel")
    got = hk.pfb_oversampled_fused(*args)
    torch.cuda.synchronize()
    want = hk.pfb_oversampled_fused_plain(*args)
    err = check(torch, f"pfb_oversampled {label} [{OS_N}], W={w}, H={h} on "
                       f"{body}", got, want)
    del got
    tm = fm_times(torch, f"pfb_oversampled {label} [{OS_N}] ({body})",
                  lambda: hk.pfb_oversampled_fused(*args),
                  lambda: hk.pfb_oversampled_fused_plain(*args))
    first = os_first_body_times(torch, hk, args, want, label)
    b = os_bounds(OS_N, h, m, r, w)
    phase("time", f"pfb_oversampled {label} [{OS_N}]: {body} {tm[0]:.4f} ms "
                  f"({b['bound'][0] / tm[0]:.0%} of its {b['bound'][0]:.4f} "
                  f"ms bound, {b['bound'][1]}), pfb_os_kernel "
                  f"{first['ms']:.4f} ms, plain {tm[1]:.4f} ms")
    return {"body": body, "w": w, "h": h, "ms": tm[0],
            "events_ms": tm[2], "plain_ms": tm[1],
            "first_body_ms": first["ms"],
            "first_body_events_ms": first["events_ms"],
            "max_abs_err": max(err, first["max_abs_err"]),
            "bound_ms": b["bound"][0], "bound_by": b["bound"][1],
            **{k: v for k, v in b.items() if k != "bound"}}


def os_wide_path(torch, hk, gen, dev) -> dict:
    """Counts reset, a ``Flowgraph`` of ``PolyphaseChannelizer`` at 64
    channels, R = 16 with the 1600-tap prototype (``OS_WIDE``'s second
    configuration) over ``OS_FRAMES`` chained frames of 2^23: one launch
    a frame, ``pfb_os_wide_kernel`` by its kernel name in a profiled step,
    every frame held to the plain chain, the tail bit-equal."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import channelizer as chan
    from clenabled_tpu_torch.dsp import planar
    from clenabled_tpu_torch.runtime.device import launched_kernels
    from clenabled_tpu_torch.streaming import Flowgraph

    label, m, r, nt = OS_WIDE[1]
    proto = os_proto(m, nt)
    ch = blocks.PolyphaseChannelizer(proto, OS_N, m, r, list(range(m)),
                                     planar=True, fused=True)
    g = Flowgraph()
    g.external_input(ch)
    tap = g.tap(ch, name="channels")
    run = g.compile(OS_N, device=dev)
    feeds = [planar.PC(*torch.randn((2, OS_N), generator=gen, device=dev))
             for _ in range(OS_FRAMES)]
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    outs = [run.step(f)[tap] for f in feeds]
    torch.cuda.synchronize()
    launches = hk.pfb_oversampled_fused.launches
    phase("os", f"Flowgraph PolyphaseChannelizer({len(proto)} taps, {OS_N}, "
                f"{m}, {r}, fused), {OS_FRAMES} frames; launches {launches}")
    if launches != OS_FRAMES:
        fail(f"expected one pfb_oversampled launch per frame at {label}, got "
             f"{launches}")
    taps_rm, ntaps = chan._pfb_constants(proto, m, r)
    h = hk.os_tail_len(m, r, ntaps)
    tr = ti = torch.zeros(h, device=dev)
    err = 0.0
    for k, (f, o) in enumerate(zip(feeds, outs)):
        wr, wi = hk.pfb_oversampled_fused_plain(f.re, f.im, tr, ti, taps_rm,
                                                m, r)
        err = max(err, check(
            torch, f"channelizer {label} frame {k} [{OS_N // r}x{m}]",
            list(o), [wr.reshape(-1), wi.reshape(-1)]))
        tr, ti = f.re[-h:], f.im[-h:]
        del wr, wi
    st = run.states[0]
    if not (torch.equal(st[0], tr) and torch.equal(st[1], ti)):
        fail(f"the {label} channelizer's carried tail is not the last "
             f"frame's input")
    del outs
    _, names = launched_kernels(lambda: run.step(feeds[0]))
    if not any("pfb_os_wide_kernel" in n for n in names):
        fail(f"the {label} flowgraph's step launched {names}, no "
             f"pfb_os_wide_kernel")
    phase("os", f"{label} step kernels: {sorted(set(names))}")
    times = path_times(torch, f"oversampled channelizer {label}",
                       lambda: run.step(feeds[0]), OS_N)
    return {"launches": launches, "err": err, **times}


def fft_bound(n: int, size: int, windowed: bool) -> tuple:
    return bound(4 * (4 * n + (size if windowed else 0)),
                 5 * n * math.log2(size) + (2 * n if windowed else 0))


def spectrum_phase(torch, hk, gen, dev) -> dict:
    """B.5 against its plain form and cuFFT, then the spectrum chain."""
    import numpy as np

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import planar, window
    from clenabled_tpu_torch.streaming import Flowgraph

    res = {"err": 0.0}
    x = torch.randn((2, SP_N), generator=gen, device=dev)
    for size in (256, 1024, SP_FFT, 16384):
        win = torch.as_tensor(window.blackman_harris(size), device=dev)
        for inv in (False, True):
            for w, sh in ((None, False), (win, True), (win, False)):
                args = (x[0], x[1], size, inv, w, sh)
                got = hk.fft_batched_fused(*args)
                torch.cuda.synchronize()
                res["err"] = max(res["err"], check(
                    torch, f"fft_batched {size} {'inv' if inv else 'fwd'} "
                           f"window={w is not None} shift={sh} [{SP_N}]",
                    got, hk.fft_batched_fused_plain(*args)))
    win = torch.as_tensor(window.blackman_harris(SP_FFT), device=dev)
    args = (x[0], x[1], SP_FFT, False, win, True)
    res["time"] = fm_times(torch, f"fft_batched {SP_FFT} window shift [{SP_N}]",
                           lambda: hk.fft_batched_fused(*args),
                           lambda: hk.fft_batched_fused_plain(*args))
    res["bound"] = fft_bound(SP_N, SP_FFT, True)
    # the bare kernel beside torch.fft.fft (cuFFT) at every checked size
    res["sizes"] = {}
    for size in (256, 1024, SP_FFT, 16384):
        bare = (x[0], x[1], size)
        c = torch.complex(x[0], x[1]).reshape(-1, size)
        lib = torch.fft.fft(c)
        res["err"] = max(res["err"], check(
            torch, f"fft_batched {size} vs torch.fft.fft",
            hk.fft_batched_fused(*bare),
            [lib.real.reshape(-1), lib.imag.reshape(-1)]))
        ms = {key: device_busy_ms(torch, fn, 10) or time_ms(torch, fn)
              for key, fn in (("ms", lambda: hk.fft_batched_fused(*bare)),
                              ("library_ms", lambda: torch.fft.fft(c)))}
        ms["bound_ms"] = fft_bound(SP_N, size, False)[0]
        res["sizes"][size] = ms
        phase("time", f"fft_batched {size} bare [{SP_N}]: device kernel "
                      f"{ms['ms']:.4f} ms, library torch.fft.fft (cuFFT) "
                      f"{ms['library_ms']:.4f} ms, bound {ms['bound_ms']:.4f} ms")
    res["bare_ms"] = res["sizes"][SP_FFT]["ms"]
    res["library_ms"] = res["sizes"][SP_FFT]["library_ms"]
    del x, c, lib

    # the path: SignalSource → Fft → MultiplyConst → ComplexToMag, counted
    src = blocks.SignalSource(1e6, 1, 250e3, 1.0, SP_N, planar=True)
    fft = blocks.Fft(SP_FFT, window=window.blackman_harris(SP_FFT), shift=True)
    mc = blocks.MultiplyConst(2.0)
    mag = blocks.ComplexToMag()
    g = Flowgraph()
    g.connect(src, fft)
    g.connect(fft, mc)
    g.connect(mc, mag)
    t_src, t_mag = g.tap(src, name="source"), g.tap(mag, name="magnitude")
    r = g.compile(None, device=dev)
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    outs = [r.step() for _ in range(SP_FRAMES)]
    torch.cuda.synchronize()
    launches = hk.fft_batched_fused.launches
    phase("spectrum", f"Flowgraph SignalSource({SP_N}) -> Fft({SP_FFT}, "
                      f"blackman_harris, shift) -> MultiplyConst(2) -> "
                      f"ComplexToMag, {SP_FRAMES} frames; launches {launches}")
    if launches != SP_FRAMES:
        fail(f"expected one fft_batched launch per frame, got {launches}")
    for k, o in enumerate(outs):
        s = o[t_src]
        y = planar.PC(*hk.fft_batched_fused_plain(s.re, s.im, SP_FFT, False,
                                                  win, True))
        want = planar.pabs(planar.scale(y, 2.0))
        res["err"] = max(res["err"], check(
            torch, f"spectrum frame {k} [{SP_N}]", [o[t_mag]], [want]))
        peak = o[t_mag].reshape(-1, SP_FFT).argmax(dim=-1)
        if not bool((peak == SP_FFT // 2 + SP_FFT // 4).all()):
            fail(f"spectrum frame {k}: the 250 kHz tone is not in bin "
                 f"{SP_FFT // 2 + SP_FFT // 4}")
    t = np.arange(SP_N, dtype=np.float64)
    ang = 2 * np.pi * 250e3 / 1e6 * t
    s0 = outs[0][t_src]
    src_err = max(float(np.abs(s0.re.cpu().numpy() - np.cos(ang)).max()),
                  float(np.abs(s0.im.cpu().numpy() - np.sin(ang)).max()))
    if not src_err <= 5e-4:
        fail(f"SignalSource differs from float64 cos/sin by {src_err:.3e}")
    phase("check", f"spectrum: tone in bin {SP_FFT * 3 // 4} of every "
                   f"vector; source within {src_err:.3e} of float64 cos/sin")
    res["path"] = path_times(torch, "spectrum chain", lambda: r.step(), SP_N)
    res["launches"] = launches
    return res


def custom_blocks_phase(torch, dev) -> None:
    """Kernel1To1/Kernel2To1 with the port's torch example kernels, loaded
    from their files, in flowgraphs against MultiplyConst(3.0) and
    Multiply on the same frames, bit for bit; ``exact_f32`` turns TF32 off
    inside and restores the previous flags after, an exception included."""
    import clenabled_tpu_torch
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.examples import (
        kernel1to1_multiply_const_complex as ex1,
        kernel2to1_multiply_complex as ex2)
    from clenabled_tpu_torch.streaming import Flowgraph

    def run(block, feeds):
        g = Flowgraph()
        for p in range(block.n_inputs):
            g.external_input(block, p)
        g.tap(block, name="out")
        r = g.compile(SP_N, device=dev)
        return [r.step(*fr)["out"] for fr in feeds]

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    feeds = [[torch.randn(SP_N, generator=gen, device=dev,
                          dtype=torch.complex64) for _ in range(2)]
             for _ in range(2)]
    for label, user, ref, n_in in (
            ("Kernel1To1(multiply_const_complex) vs MultiplyConst(3.0)",
             blocks.Kernel1To1(filename=ex1.__file__,
                               kernelFnName="multiply_const_complex"),
             blocks.MultiplyConst(3.0), 1),
            ("Kernel2To1(multiply_complex) vs Multiply",
             blocks.Kernel2To1(filename=ex2.__file__,
                               kernelFnName="multiply_complex"),
             blocks.Multiply(), 2)):
        fr = [f[:n_in] for f in feeds]
        for k, (g, w) in enumerate(zip(run(user, fr), run(ref, fr))):
            if g.dtype != w.dtype or not torch.equal(g, w):
                fail(f"{label}: frame {k} not bit-equal")
        phase("check", f"{label}: 2 frames of {SP_N} on the card, bit for "
                       f"bit")
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    old = tuple(f.allow_tf32 for f in flags)
    for f in flags:
        f.allow_tf32 = True
    try:
        with clenabled_tpu_torch.exact_f32():
            inside = tuple(f.allow_tf32 for f in flags)
            raise KeyError("exact_f32 check")
    except KeyError:
        pass
    after = tuple(f.allow_tf32 for f in flags)
    for f, v in zip(flags, old):
        f.allow_tf32 = v
    if inside != (False, False) or after != (True, True):
        fail(f"exact_f32: TF32 flags {inside} inside, {after} after")
    phase("check", "exact_f32: TF32 off for cuBLAS and cuDNN inside, the "
                   "flags restored after an exception")


def costas_stream(np, rng, n: int, order: int, offset: float = CO_OFFSET):
    """Seeded BPSK (order 2) or QPSK (order 4) symbols at ``offset`` rad
    per sample of carrier offset, with noise: float32 (re, im)."""
    t = np.arange(n)
    k = rng.integers(0, order, n)
    sym = np.exp(1j * (np.pi * k if order == 2 else np.pi / 4 * (2 * k + 1)))
    x = sym * np.exp(1j * (offset * t + 0.7))
    x = x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return np.stack([x.real, x.imag]).astype(np.float32)


def costas_check(torch, label: str, got, want) -> float:
    """Hold the Costas kernel's outputs and state to the plain form's bit
    for bit; returns the largest error (0.0)."""
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
        fail(f"{label}: not bit-exact (max abs err {err:.3e})")
    phase("check", f"{label}: bit-exact (outputs and state)")
    return 0.0


def sm_clock_mhz(torch, fn, seconds: float = 3.0) -> tuple:
    """The SM clock in MHz while ``fn`` runs back to back on the card for
    ``seconds``: the highest of the ``nvidia-smi`` readings, taken one
    after another by a second thread meanwhile, with the card's
    utilization at 90% or more (of all of them if none is).  Returns it
    (None if none is read) and the number of busy readings."""
    import subprocess
    import threading

    query = ["nvidia-smi", "--query-gpu=clocks.sm,utilization.gpu",
             "--format=csv,noheader,nounits"]
    readings, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            try:
                out = subprocess.run(query, capture_output=True, text=True,
                                     timeout=60).stdout
                readings.append(tuple(float(v) for v in out.split(",")))
            except (OSError, ValueError, subprocess.SubprocessError):
                return

    reader = threading.Thread(target=poll)
    reader.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    stop.set()
    reader.join()
    busy = [mhz for mhz, util in readings if util >= 90]
    return max(busy or [mhz for mhz, _ in readings], default=None), len(busy)


def costas_time(torch, hk, label: str, args, order: int, n: int) -> dict:
    """The Costas kernel's time on ``args`` (``torch.profiler``, else CUDA
    events), the SM clock while it runs, ns and cycles a sample at that
    clock and the latency bound of ``n`` samples of ``order``."""
    kern = lambda: hk.costas_scalar(*args)
    events_ms = time_ms(torch, kern, reps=5)
    ms = device_busy_ms(torch, kern, 5) or events_ms
    mhz, busy = sm_clock_mhz(torch, kern)
    if not busy:
        phase("note", f"{label}: no SM clock reading while the card was busy")
    ns = ms * 1e6 / n
    res = {"ms": ms, "events_ms": events_ms, "sm_clock_mhz": mhz,
           "clock_readings_busy": busy, "ns_per_sample": ns,
           "chain_ops": CO_CHAIN[order],
           "cycles_per_sample": None, "latency_bound_ms": None}
    shown = "SM clock not read"
    if mhz:
        res["cycles_per_sample"] = ns * mhz / 1e3
        res["latency_bound_ms"] = (n * CO_CHAIN[order] * CYCLES_PER_OP
                                   / (mhz * 1e6) * 1e3)
        shown = (f"{res['cycles_per_sample']:.1f} cycles a sample at {mhz:.0f}"
                 f" MHz (highest of {busy} readings at >= 90% utilization);"
                 f" latency bound {res['latency_bound_ms']:.4f} ms "
                 f"({CO_CHAIN[order]} dependent ops x {CYCLES_PER_OP} cycles)")
    phase("time", f"{label}: device kernel {ms:.4f} ms (events "
                  f"{events_ms:.4f} ms), {n / ms / 1e3:.2f} MSPS, {ns:.2f} ns"
                  f" a sample, {shown}")
    return res


def costas_phase(torch, hk, dev) -> dict:
    """B.9 against its plain form, then the carrier-recovery path."""
    import numpy as np

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import demod, planar
    from clenabled_tpu_torch.streaming import Flowgraph

    res = {"err": 0.0}
    alpha, beta = demod.costas_gains(CO_BW)
    rng = np.random.default_rng(0)
    for order in (2, 4):
        x = torch.as_tensor(costas_stream(np, rng, CO_CHECK_N, order),
                            device=dev)
        args = (x[0], x[1], 0.0, 0.0, 0.0, order, alpha, beta)
        got = hk.costas_scalar(*args)
        torch.cuda.synchronize()
        res["err"] = max(res["err"], costas_check(
            torch, f"costas_scalar order {order} [{CO_CHECK_N}]", got,
            hk.costas_scalar_plain(*args)))
    # the chain's sin/cos against sinf/cosf
    probe = hk.costas_sincos_probe(device=dev)
    phase("check", f"costas sin/cos probe over all 2^32 float32 patterns: "
                   f"{probe['loop']} mismatches of the chain's fast path on "
                   f"its {probe['in_domain']} patterns (|x| <= 2pi or NaN; "
                   f"{probe['loop_outside']} outside, never kept)")
    if probe["loop"] or probe["in_domain"] != hk.COSTAS_LOOP_PATTERNS:
        fail(f"the Costas sin/cos differs from sinf/cosf: {probe}")
    res["probe"] = probe

    # the path: Flowgraph → CostasLoop(planar, scalar), counted
    stream = torch.as_tensor(costas_stream(np, rng, CO_N * CO_FRAMES, 2),
                             device=dev)
    cl = blocks.CostasLoop(CO_BW, 2, planar=True, scalar=True)
    g = Flowgraph()
    g.external_input(cl)
    tap = g.tap(cl, name="baseband")
    r = g.compile(CO_N, device=dev)
    feeds = [planar.PC(stream[0, k * CO_N:(k + 1) * CO_N],
                       stream[1, k * CO_N:(k + 1) * CO_N])
             for k in range(CO_FRAMES)]
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    outs = [r.step(f)[tap] for f in feeds]
    torch.cuda.synchronize()
    launches = hk.costas_scalar.launches
    phase("costas", f"Flowgraph CostasLoop({CO_BW}, 2, planar, scalar), "
                    f"{CO_FRAMES} frames of {CO_N}; launches {launches}")
    if launches != CO_FRAMES:
        fail(f"expected one costas launch per frame, got {launches}")
    joined = hk.costas_scalar(stream[0], stream[1], 0.0, 0.0, 0.0, 2, alpha,
                              beta)
    st = r.states[0]
    if not (torch.equal(torch.cat([o.re for o in outs]), joined[0])
            and torch.equal(torch.cat([o.im for o in outs]), joined[1])
            and torch.equal(torch.stack(list(st)), torch.stack(joined[2:]))):
        fail("the 8 chained frames differ from one call over the joined stream")
    freq = float(st.freq)
    tail = float(outs[-1].im[-4096:].abs().mean())
    if not (abs(freq - CO_OFFSET) < 5e-4 and tail < 0.1):
        fail(f"the loop did not lock: freq {freq:.6f}, tail |im| {tail:.4f}")
    phase("check", f"costas seam: {CO_FRAMES} chained frames = one call over "
                   f"the joined stream, bit for bit; locked at freq {freq:.6f} "
                   f"rad/sample (offset {CO_OFFSET}), tail |im| {tail:.4f}")
    # the kernel against its plain form on the path's first frame (order 2,
    # zero state) and on 2^16 samples of QPSK (order 4): the order-2 plain
    # call is timed once and its outputs checked
    x = feeds[0]
    args = (x.re, x.im, 0.0, 0.0, 0.0, 2, alpha, beta)
    got = hk.costas_scalar(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want = hk.costas_scalar_plain(*args)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    res["err"] = max(res["err"], costas_check(
        torch, f"costas_scalar order 2 [{CO_N}] (the path's first frame)",
        got, want))
    q = torch.as_tensor(costas_stream(np, rng, CO_N, 4), device=dev)
    args4 = (q[0], q[1], 0.0, 0.0, 0.0, 4, alpha, beta)
    got = hk.costas_scalar(*args4)
    torch.cuda.synchronize()
    res["err"] = max(res["err"], costas_check(
        torch, f"costas_scalar order 4 [{CO_N}]", got,
        hk.costas_scalar_plain(*args4)))
    res["timing"] = {order: costas_time(torch, hk, f"costas_scalar order "
                                        f"{order} [{CO_N}]", a, order, CO_N)
                     for order, a in ((2, args), (4, args4))}
    res["time"] = (res["timing"][2]["ms"], plain_ms)
    phase("time", f"costas_scalar plain order 2 [{CO_N}]: {plain_ms:.1f} ms")
    res["bound"] = bound(4 * (4 * CO_N + 6), 30 * CO_N)
    res["path"] = path_times(torch, "carrier recovery",
                             lambda: r.step(feeds[0]), CO_N)
    res["launches"] = launches
    return res



def costas_batched_bound(b: int, n: int, mhz) -> dict:
    """The least time of ``b`` chains of ``n`` order-2 samples: the larger
    of the bytes and operations at the card's peak rates (as
    ``costas_phase`` counts them for one chain) and, where the SM clock
    was read, one chain's latency (n x the chain's dependent operations x
    4 cycles at ``mhz``).  Independent chains need no cross-lane work, so
    32 of them can share a warp instruction: their issue rate is the
    operations term, far below the latency."""
    bnd, by = bound(4 * b * (4 * n + 6), 30 * b * n)
    lat = n * CO_CHAIN[2] * CYCLES_PER_OP / (mhz * 1e6) * 1e3 if mhz else None
    if lat is not None and lat > bnd:
        bnd, by = lat, "operations"
    return {"bound_ms": bnd, "bound_by": by, "latency_ms": lat,
            "sm_clock_mhz": mhz}


@contextlib.contextmanager
def costas_body_forced(hk, body: str | None):
    """``hk.costas_batched`` launching ``body`` whatever the rule picks, so
    that a path that calls it (the chunked and multi-stream loops) can be
    timed under either body; None leaves the rule.  Only the rule
    (``hk.costas_body``) is replaced: the wrapper and its launch count
    stay."""
    rule = hk.costas_body
    if body is not None:
        hk.costas_body = lambda rows, device: body
    try:
        yield
    finally:
        hk.costas_body = rule


def host_calls(torch, fn) -> int:
    """The top-level torch operator calls of one ``fn()`` on the host
    (``torch.profiler``'s ``aten::`` events with no ``aten::`` parent)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.name.startswith("aten::") and not (
        e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::")))


def costas_batched_phase(torch, hk, dev) -> dict:
    """The batched Costas entry against its plain form, row by row against
    ``costas_scalar`` and on strided windows, bit for bit; then, counted,
    the chunked path (``CostasLoop(chunked=True)``) held to one sequential
    call over the joined stream, with an exact fallback, and the
    multi-stream path (``CostasLoop(num_streams=16)``) held to one
    sequential call a stream; then the batched entry's times and bounds."""
    import numpy as np

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import demod, planar
    from clenabled_tpu_torch.streaming import Flowgraph

    res = {"err": 0.0}
    alpha, beta = demod.costas_gains(CO_BW)
    rng = np.random.default_rng(12)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rule_rows = sms * hk.COSTAS_FULL_RATE_BLOCKS
    res["rule"] = {"sms": sms, "block_rows": rule_rows}
    phase("costas", f"costas_batched: the rule takes the block body up to "
                    f"{hk.COSTAS_FULL_RATE_BLOCKS} blocks an SM x {sms} SMs "
                    f"= {rule_rows} rows, the lane body above")

    def equal(got, want) -> bool:
        return all(torch.equal(g, w) for g, w in zip(got, want))

    # per-row states, phases outside [-2pi, 2pi] among them
    st = (torch.tensor([0.0, 0.3, -1.0, 7.5, -9.0, 2.0, 100.0, -0.5],
                       device=dev)[:CB_B],
          torch.linspace(-0.004, 0.004, CB_B, device=dev),
          torch.zeros(CB_B, device=dev))
    def against_rows(label, x, states, order, got):
        # every row of a batched result against costas_scalar on it alone
        for b in range(x.shape[1]):
            one = hk.costas_scalar(x[0, b], x[1, b], *(v[b] for v in states),
                                   order, alpha, beta)
            if not equal(one, [v[b] for v in got]):
                fail(f"{label}: row {b} differs from costas_scalar on it")

    bodies = hk.COSTAS_BODIES
    for order in (2, 4):
        x = torch.as_tensor(np.stack([costas_stream(np, rng, CB_N, order)
                                      for _ in range(CB_B)], 1), device=dev)
        args = (x[0], x[1], *st, order, alpha, beta)
        got = {body: hk.costas_batched(*args, body=body) for body in bodies}
        torch.cuda.synchronize()
        want = hk.costas_batched_plain(*args)
        for body in bodies:
            label = (f"costas_batched ({body} body) order {order} "
                     f"[{CB_B}, {CB_N}]")
            res["err"] = max(res["err"], costas_check(
                torch, f"{label} against its plain form", got[body], want))
            against_rows(label, x, st, order, got[body])
        phase("check", f"costas_batched order {order} [{CB_B}, {CB_N}]: "
                       f"every row of both bodies equals costas_scalar on "
                       f"that row alone, bit for bit")
        # one row, and 33: the lane body's second warp holds one live lane
        for b in CB_PARTIAL:
            xb = torch.as_tensor(np.stack([costas_stream(np, rng, CB_N, order)
                                           for _ in range(b)], 1), device=dev)
            sb = (torch.linspace(-12.0, 12.0, b, device=dev),
                  torch.linspace(-0.008, 0.008, b, device=dev),
                  torch.linspace(-1.0, 1.0, b, device=dev))
            gb = {body: hk.costas_batched(xb[0], xb[1], *sb, order, alpha,
                                          beta, body=body) for body in bodies}
            torch.cuda.synchronize()
            if not equal(gb["block"], gb["lane"]):
                fail(f"costas_batched order {order} [{b}, {CB_N}]: the lane "
                     f"body differs from the block body")
            against_rows(f"costas_batched order {order} [{b}, {CB_N}]", xb,
                         sb, order, gb["lane"])
            phase("check", f"costas_batched order {order} [{b}, {CB_N}]: "
                           f"both bodies equal, and every row equals "
                           f"costas_scalar on it, bit for bit")
        # windows of w + c at a stride of c, read in place, against copies
        ext = torch.cat([torch.zeros(2, 2, CH_WARMUP, device=dev),
                         x[:, :2]], -1)
        c, w, nch = 1024, CH_WARMUP, CB_N // 1024
        win = [e.as_strided((2, nch, w + c), (w + CB_N, c, 1)) for e in ext]
        flat = [v[0] for v in win]
        want = hk.costas_batched(*(v.contiguous() for v in win), 0.0, 0.0,
                                 0.0, order, alpha, beta, body="block")
        for body in bodies:
            got = hk.costas_batched(*win, 0.0, 0.0, 0.0, order, alpha, beta,
                                    body=body)
            got2 = hk.costas_batched(*flat, 0.0, 0.0, 0.0, order, alpha,
                                     beta, body=body)
            torch.cuda.synchronize()
            if not (equal(got, want) and equal(got2, [v[0] for v in want])):
                fail(f"costas_batched ({body} body) order {order}: strided "
                     f"windows differ from the same rows copied")
        phase("check", f"costas_batched order {order}: [2, {nch}, {w + c}] "
                       f"and [{nch}, {w + c}] windows at a stride of {c}, "
                       f"read in place by either body, equal the rows "
                       f"copied bit for bit")

    # the chunked path: Flowgraph -> CostasLoop(planar, chunked), counted
    stream = torch.as_tensor(costas_stream(np, rng, CH_N * CH_FRAMES, 2),
                             device=dev)
    cl = blocks.CostasLoop(CO_BW, 2, planar=True, chunked=True,
                           chunk=CH_CHUNK, warmup=CH_WARMUP)
    g = Flowgraph()
    g.external_input(cl)
    tap = g.tap(cl, name="baseband")
    r = g.compile(CH_N, device=dev)
    diags = []
    r.on_message("CostasLoop.lock", diags.append)
    feeds = [planar.PC(stream[0, k * CH_N:(k + 1) * CH_N],
                       stream[1, k * CH_N:(k + 1) * CH_N])
             for k in range(CH_FRAMES)]
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    outs = [r.step(f)[tap] for f in feeds]
    torch.cuda.synchronize()
    counts = {k: v for k, v in hk.launch_counts().items() if v}
    phase("costas", f"Flowgraph CostasLoop({CO_BW}, 2, planar, chunked, "
                    f"chunk={CH_CHUNK}, warmup={CH_WARMUP}), {CH_FRAMES} "
                    f"frames of {CH_N}: launches {counts} "
                    f"({counts.get('costas_batched', 0) / CH_FRAMES:g} a "
                    f"frame)")
    if counts != {"costas_batched": 3 * CH_FRAMES}:
        fail(f"the chunked path: expected 3 costas_batched launches a frame "
             f"and no other, got {counts}")
    res["chunked_launches"] = counts.get("costas_batched", 0)
    joined = hk.costas_scalar(stream[0], stream[1], 0.0, 0.0, 0.0, 2, alpha,
                              beta)

    def against_joined(k, o):
        sl = slice(k * CH_N, (k + 1) * CH_N)
        want = (joined[0][sl], joined[1][sl])
        err = max(float((o.re - want[0]).abs().max()),
                  float((o.im - want[1]).abs().max()))
        return err, equal((o.re, o.im), want)

    res["chunked_frames"] = []
    for k, (o, d) in enumerate(zip(outs, diags)):
        err, same = against_joined(k, o)
        row = {"residual": float(d["residual"]), "exact": bool(d["exact"]),
               "branch_hops": int(d["branch_hops"]), "max_abs_err": err}
        res["chunked_frames"].append(row)
        phase("costas", f"chunked frame {k}: residual {row['residual']:.3e}, "
                        f"exact {row['exact']}, branch hops "
                        f"{row['branch_hops']}, max abs err against the "
                        f"sequential call {err:.3e}")
        if row["exact"] and not same:
            fail(f"chunked frame {k}: certified exact but not bit-equal to "
                 f"the sequential call")
        if row["residual"] <= CH_RESID and err > 2e-2:
            fail(f"chunked frame {k}: residual {row['residual']:.3e} but "
                 f"{err:.3e} from the sequential call (tolerance 2e-2)")
    freq = float(r.states[0][0].freq)
    if abs(freq - CO_OFFSET) >= 5e-4:
        fail(f"the chunked loop did not lock: freq {freq:.6f}")
    phase("check", f"chunked: {sum(f['exact'] for f in res['chunked_frames'])}"
                   f" of {CH_FRAMES} frames certified exact (each bit-equal "
                   f"to the sequential call), "
                   f"{sum(f['residual'] <= CH_RESID for f in res['chunked_frames'])}"
                   f" at residual <= {CH_RESID:g} (each within 2e-2 of it), "
                   f"the others flagged; locked at freq {freq:.6f} rad/sample")
    # the same frames with exact_fallback_residual: a frame above the bound
    # (frame 0 at least: the cold start) reruns on costas_scalar, bit for
    # bit the sequential form from the state carried into it
    r0 = res["chunked_frames"][0]["residual"]
    thr = min(CH_RESID, r0 / 2)
    if not thr > 0:
        fail(f"the first chunked frame's residual is {r0}: no fallback test")
    fb = demod.make_costas_loop_chunked(CO_BW, 2, chunk=CH_CHUNK,
                                        warmup=CH_WARMUP,
                                        exact_fallback_residual=thr)
    state = fb.init_state(dev)
    hk.reset_launch_counts()
    runs = []
    for f in feeds:
        before = state
        state, o, d = fb(state, f)
        runs.append((before, o, d))
    torch.cuda.synchronize()
    counts = {k: v for k, v in hk.launch_counts().items() if v}
    fell = [k for k, (_, _, d) in enumerate(runs) if bool(d["fell_back"])]
    want = {"costas_batched": 3 * CH_FRAMES, "costas_scalar": 2 * len(fell)}
    if 0 not in fell or counts != want:
        fail(f"exact_fallback_residual={thr:.3e}: frames {fell} fell back, "
             f"launches {counts}")
    for k, ((lag, tail), o, d) in enumerate(runs):
        err, same = against_joined(k, o)
        if k in fell:
            ext = [torch.cat([t, x]) for t, x in zip(tail, feeds[k])]
            seq = hk.costas_scalar(*ext, *lag, 2, alpha, beta)
            if not (bool(d["exact"]) and equal((o.re, o.im),
                                               (seq[0][CH_WARMUP:],
                                                seq[1][CH_WARMUP:]))):
                fail(f"fallback frame {k}: not bit-equal to the sequential "
                     f"form from its carried state")
            if k == 0 and not same:
                fail("fallback frame 0: not bit-equal to the sequential call")
        elif float(d["residual"]) > thr:
            fail(f"fallback frame {k}: residual above {thr:.3e} not re-run")
        if k >= 2 and err > 2e-2:
            fail(f"fallback frame {k}: {err:.3e} from the sequential call "
                 f"(tolerance 2e-2)")
    res["fallback"] = {"threshold": thr, "frames": fell, "launches": counts}
    phase("check", f"exact_fallback_residual={thr:.3e}: frames {fell} fell "
                   f"back (launches {counts}), each bit-equal to the "
                   f"sequential form from its carried state (frame 0 to the "
                   f"sequential call); frames 2-{CH_FRAMES - 1} within 2e-2 "
                   f"of the sequential call")
    # the kernel on the path's own windows: frames 0 and 1 through the
    # chunked loop, once as it runs and once with the batched plain form in
    # the kernel's place, bit for bit (outputs, carried state, certificate)

    def two_frames():
        run = demod.make_costas_loop_chunked(CO_BW, 2, chunk=CH_CHUNK,
                                             warmup=CH_WARMUP)
        state, got = run.init_state(dev), []
        for f in feeds[:2]:
            state, o, d = run(state, f)
            got += [o.re, o.im, *state[0], state[1].re, state[1].im,
                    *(d[k] for k in sorted(d))]
        return got

    got = two_frames()
    kernel = hk.costas_batched
    hk.costas_batched = hk.costas_batched_plain
    try:
        want = two_frames()
    finally:
        hk.costas_batched = kernel
    res["err"] = max(res["err"], costas_check(
        torch, f"chunked frames 0-1 of {CH_N} ([1, {CH_N // CH_CHUNK}] "
               f"windows a segment) against the same run on "
               f"costas_batched_plain", got, want))
    res["chunked_path"] = path_times(torch, "chunked carrier recovery",
                                     lambda: r.step(feeds[0]), CH_N)
    res["chunked_path"]["host_calls"] = host_calls(torch,
                                                   lambda: r.step(feeds[0]))
    phase("path", f"chunked carrier recovery: "
                  f"{res['chunked_path']['host_calls']} top-level torch calls "
                  f"a frame (torch.profiler)")
    busy = res["chunked_path"]["busy_ms"]
    res["chunked_msps"] = {"wall": CH_N / res["chunked_path"]["wall_ms"] / 1e3,
                           "busy": busy and CH_N / busy / 1e3}
    del stream, feeds, outs, joined

    # one 2^23 frame through the chunked loop: 2048 windows a launch, past
    # the block body's rows, counted and held to the same run on the plain
    # form; then its device busy under the rule's body and under each
    big = torch.as_tensor(costas_stream(np, rng, CH_BIG_N, 2), device=dev)
    feed = planar.PC(big[0], big[1])
    run = demod.make_costas_loop_chunked(CO_BW, 2, chunk=CH_CHUNK,
                                         warmup=CH_WARMUP)
    st_big = run.init_state(dev)

    def big_frame():
        state, o, d = run(st_big, feed)
        return [o.re, o.im, *state[0], state[1].re, state[1].im,
                *(d[k] for k in sorted(d))]

    torch.cuda.synchronize()
    hk.reset_launch_counts()
    got = big_frame()
    torch.cuda.synchronize()
    counts = {k: v for k, v in hk.launch_counts().items() if v}
    rows = CH_BIG_N // CH_CHUNK
    chosen = hk.costas_body(rows, dev)
    phase("costas", f"chunked loop, one frame of {CH_BIG_N} ({rows} windows "
                    f"a launch, the {chosen} body): launches {counts}")
    if counts != {"costas_batched": 3}:
        fail(f"the chunked 2^23 frame: expected 3 costas_batched launches "
             f"and no other, got {counts}")
    kernel = hk.costas_batched
    hk.costas_batched = hk.costas_batched_plain
    try:
        want = big_frame()
    finally:
        hk.costas_batched = kernel
    res["err"] = max(res["err"], costas_check(
        torch, f"chunked frame of {CH_BIG_N} ([1, {rows}] windows a segment) "
               f"against the same run on costas_batched_plain", got, want))
    del got, want
    big_busy = {}
    for body in hk.COSTAS_BODIES:   # the rule's body unforced
        with costas_body_forced(hk, None if body == chosen else body):
            big_busy[body] = device_busy_ms(torch, big_frame, 3)
    res["chunked_big"] = {"n": CH_BIG_N, "rows": rows, "body": chosen,
                          "launches": counts.get("costas_batched", 0),
                          "busy_ms": big_busy}
    phase("time", f"chunked frame of {CH_BIG_N}: device busy " + ", ".join(
        f"{k} body " + ("not measured" if v is None else f"{v:.4f} ms")
        for k, v in big_busy.items()) + f" (the rule: {chosen})")
    del big, feed, st_big

    # the multi-stream path: Flowgraph -> CostasLoop(planar, num_streams)
    offs = np.linspace(-CO_OFFSET, CO_OFFSET, MS_S)
    streams = torch.as_tensor(np.stack([
        costas_stream(np, rng, MS_N * MS_FRAMES, 2, offset=o) for o in offs],
        1), device=dev)
    cl = blocks.CostasLoop(CO_BW, 2, planar=True, num_streams=MS_S)
    g = Flowgraph()
    for p in range(MS_S):
        g.external_input(cl, p)
    names = [g.tap(cl, p, name=f"s{p}") for p in range(MS_S)]
    r = g.compile(MS_N, device=dev)
    frames_ = [[planar.PC(streams[0, p, k * MS_N:(k + 1) * MS_N],
                          streams[1, p, k * MS_N:(k + 1) * MS_N])
                for p in range(MS_S)] for k in range(MS_FRAMES)]
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    outs = [r.step(*f) for f in frames_]
    torch.cuda.synchronize()
    counts = {k: v for k, v in hk.launch_counts().items() if v}
    phase("costas", f"Flowgraph CostasLoop({CO_BW}, 2, planar, num_streams="
                    f"{MS_S}), {MS_FRAMES} frames of {MS_N}: launches "
                    f"{counts}")
    if counts != {"costas_batched": MS_FRAMES}:
        fail(f"the multi-stream path: expected one costas_batched launch a "
             f"frame, got {counts}")
    res["streams_launches"] = counts.get("costas_batched", 0)
    for p in range(MS_S):
        one = hk.costas_scalar(streams[0, p], streams[1, p], 0.0, 0.0, 0.0, 2,
                               alpha, beta)
        got = (torch.cat([o[names[p]].re for o in outs]),
               torch.cat([o[names[p]].im for o in outs]),
               *(v[p] for v in r.states[0]))
        if not equal(got, one):
            fail(f"multi-stream: stream {p} differs from costas_scalar over "
                 f"its joined stream")
    phase("check", f"multi-stream: each of {MS_S} streams equals one "
                   f"costas_scalar call over its joined stream, bit for bit "
                   f"(outputs and state)")
    res["streams_path"] = path_times(torch, f"{MS_S}-stream carrier recovery",
                                     lambda: r.step(*frames_[0]),
                                     MS_S * MS_N)
    del streams, frames_, outs

    # the batched entry through the multi-stream runner at [8, 4096],
    # [1024, 4096] and [8192, 4096] under each body, held to its plain form
    # bit for bit (the plain call timed once) and timed; beside it its bound
    run = demod._make_costas_loop_streams(CO_BW, 2, True)
    res["shapes"] = {}
    for b in (CB_B, CB_MANY, CB_HUGE):
        x = torch.as_tensor(np.stack([costas_stream(np, rng, CB_N, 2)
                                      for _ in range(b)], 1), device=dev)
        z = torch.zeros(b, device=dev)
        st0 = demod.CostasState(z, z, z)
        fr = planar.PC(x[0], x[1])
        call = lambda: run(st0, fr)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        want = hk.costas_batched_plain(x[0], x[1], z, z, z, 2, alpha, beta)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        chosen = hk.costas_body(b, dev)
        times = {}
        for body in hk.COSTAS_BODIES:   # the rule's body unforced
            with costas_body_forced(hk, None if body == chosen else body):
                st1, out = call()
                err = costas_check(torch, f"costas_batched ({body} body) "
                                          f"[{b}, {CB_N}] (the multi-stream "
                                          f"runner) against its plain form",
                                   (out.re, out.im, *st1), want)
                res["err"] = max(res["err"], err)
                del st1, out
                events_ms = time_ms(torch, call, reps=10)
                busy = device_busy_ms(torch, call, 5)
            times[body] = {"ms": busy or events_ms, "events_ms": events_ms,
                           "device_ms": busy}
        mhz, nbusy = sm_clock_mhz(torch, call)
        bnd = costas_batched_bound(b, CB_N, mhz)
        ms = times[chosen]["ms"]
        res["shapes"][f"[{b}, {CB_N}]"] = dict(
            ms=ms, events_ms=times[chosen]["events_ms"],
            device_ms=times[chosen]["device_ms"], plain_ms=plain_ms, err=0.0,
            body=chosen, bodies=times, clock_readings_busy=nbusy, **bnd)
        shown = ("SM clock not read: no latency bound" if mhz is None else
                 f"latency {bnd['latency_ms']:.4f} ms at {mhz:.0f} MHz from "
                 f"{nbusy} busy readings")
        for body, t in times.items():
            busy = ("not measured" if t["device_ms"] is None
                    else f"{t['device_ms']:.4f} ms")
            phase("time", f"costas_batched [{b}, {CB_N}] {body} body"
                          f"{' (the rule)' if body == chosen else ''}: device "
                          f"{busy}, events {t['events_ms']:.4f} ms, "
                          f"{b * CB_N / t['ms'] / 1e3:.1f} MSPS aggregate, "
                          f"{t['ms'] / bnd['bound_ms']:.2f}x the bound")
        phase("time", f"costas_batched [{b}, {CB_N}]: plain {plain_ms:.1f} "
                      f"ms; bound {bnd['bound_ms']:.4f} ms by "
                      f"{bnd['bound_by']} ({shown})")
        del x, want, fr, st0
    return res


def lag_scan_f64(np, mags, max_shift: int):
    """The normalized lag scan in float64 NumPy, on the host: mags [nsig,
    B, n] → [nsig-1, B, 2·max_shift], corr[l] = (overlap dot) /
    sqrt(sum x² · sum y²) over each lag's overlap, -2 where that is 0.
    The dot products of every lag come from one float64 FFT
    cross-correlation; ``lag_scan_direct`` checks them by direct sums."""
    n = mags.shape[-1]
    p = 1 << (n + max_shift - 1).bit_length()
    f = np.fft.rfft(mags, p, axis=-1)
    cc = np.fft.irfft(f[0] * np.conj(f[1:]), p, axis=-1)
    c = np.concatenate([np.zeros(mags.shape[:-1] + (1,)),
                        np.cumsum(mags * mags, axis=-1)], axis=-1)
    shift = np.arange(-max_shift, max_shift)
    s = np.abs(shift)
    pos = shift > 0
    num = cc[..., np.where(pos, shift, (p - s) % p)]
    sx = np.where(pos, c[0][..., n:n + 1] - c[0][..., s], c[0][..., n - s])
    sy = np.where(pos, c[1:][..., n - s], c[1:][..., n:n + 1] - c[1:][..., s])
    den = sx * sy
    return np.where(den != 0, num / np.sqrt(np.where(den != 0, den, 1)), -2.0)


def lag_scan_direct(np, ref, sig, shift: int) -> float:
    """One lag of the scan by direct float64 sums (the reference kernel's
    loop, lib/clXCorrelate_impl.cc:843-903)."""
    n, s = len(ref), abs(shift)
    if shift > 0:
        a, b = ref[s:], sig[:n - s]
    else:
        a, b = ref[:n - s], sig[s:]
    den = (a * a).sum() * (b * b).sum()
    return float((a * b).sum() / np.sqrt(den)) if den else -2.0


def xcorr_streams(np, rng, n: int):
    """XC_A complex64 streams of n samples: input 0 a seeded complex
    Gaussian, input k that stream at lag XC_LAGS[k-1] (its sample i is
    input 0's i + lag) plus noise."""
    pad = XC_SHIFT
    base = (rng.standard_normal(n + 2 * pad)
            + 1j * rng.standard_normal(n + 2 * pad))
    out = [base[pad:pad + n]]
    for lag in XC_LAGS:
        noise = XC_NOISE * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n))
        out.append(base[pad + lag:pad + lag + n] + noise)
    return np.stack(out).astype(np.complex64)


def xcorr_phase(torch, hk, dev) -> dict:
    """The TD correlator block on the card: a Flowgraph of
    XCorrelate(XC_A, XC_SL, XC_SHIFT, accumulate_frames=XC_ACC) over
    XC_FRAMES frames, complex64 and planar feeds, then 1-in-XC_DECIM
    frame decimation at one window a frame; every message held to the
    float64 lag scan on the host, the lags to the planted ones."""
    import numpy as np

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import planar
    from clenabled_tpu_torch.streaming import Flowgraph

    rng = np.random.default_rng(140)
    want_lags = np.array(XC_LAGS, np.int32)
    res = {"forms": {}}

    def graph(acc, decim):
        xc = blocks.XCorrelate(XC_A, signal_length=XC_SL,
                               max_search_index=XC_SHIFT,
                               decim_frames=decim, accumulate_frames=acc)
        g = Flowgraph()
        for k in range(XC_A):
            g.external_input(xc, k)
        r = g.compile(frame_size=xc.quantum, device=dev)
        msgs, keep = [], [True]
        r.on_message("xcorr.corr",
                     lambda m: msgs.append(m) if keep[0] else None)
        return r, msgs, keep

    def held(label, msg, x_host, valid_want):
        """One frame's message against the float64 scan of its windows."""
        nb = x_host.shape[1] // XC_SL
        valid = np.atleast_1d(msg["valid"].numpy())
        if list(valid) != valid_want:
            fail(f"{label}: valid {list(valid)} != {valid_want}")
        vec = msg["corrvect"].reshape(nb, XC_A - 1, 2 * XC_SHIFT)
        lag = msg["corrective_lags"].reshape(nb, XC_A - 1).cpu().numpy()
        if not valid.any():
            if vec.any() or msg["corr"].any() or lag.any():
                fail(f"{label}: a skipped frame's message is not zeros")
            return 0.0
        mags = np.abs(x_host.astype(np.complex128)).reshape(XC_A, nb, XC_SL)
        want = lag_scan_f64(np, mags, XC_SHIFT).transpose(1, 0, 2)
        err = float(np.abs(vec.double().cpu().numpy() - want).max())
        tol = TOL * float(np.abs(want).max())
        if not err <= tol:
            fail(f"{label}: corrvect max abs err {err:.3e} > {tol:.3e}")
        if not (lag == want_lags).all():
            fail(f"{label}: lags {lag.tolist()} != planted {XC_LAGS}")
        corr = msg["corr"].reshape(nb, XC_A - 1).double().cpu().numpy()
        if not np.abs(corr - want.max(-1)).max() <= tol:
            fail(f"{label}: corr is not the scan's maximum")
        return err

    # the float64 scan itself, checked by direct sums on a few lags
    x = xcorr_streams(np, rng, XC_SL)
    mags = np.abs(x.astype(np.complex128))
    scan = lag_scan_f64(np, mags[:, None], XC_SHIFT)[:, 0]
    for k in range(XC_A - 1):
        for shift in (-XC_SHIFT, -1, 0, 1, XC_LAGS[k], XC_SHIFT - 1):
            d = lag_scan_direct(np, mags[0], mags[k + 1], shift)
            if abs(d - scan[k, shift + XC_SHIFT]) > 1e-9:
                fail(f"float64 lag scan: lag {shift} {d} != "
                     f"{scan[k, shift + XC_SHIFT]}")

    n_frame = XC_ACC * XC_SL
    x = xcorr_streams(np, rng, XC_FRAMES * n_frame)
    for form in ("complex", "planar"):
        r, msgs, keep = graph(XC_ACC, 1)
        feeds = []
        for f in range(XC_FRAMES):
            sl = torch.from_numpy(x[:, f * n_frame:(f + 1) * n_frame]).to(dev)
            feeds.append([planar.PC(v.real.contiguous(), v.imag.contiguous())
                          if form == "planar" else v for v in sl])
        torch.cuda.synchronize()
        hk.reset_launch_counts()
        for fd in feeds:
            r.step(*fd)
        torch.cuda.synchronize()
        counts = {k: v for k, v in hk.launch_counts().items() if v}
        worst = 0.0
        for f, m in enumerate(msgs):
            worst = max(worst, held(
                f"xcorr {form} frame {f}", m,
                x[:, f * n_frame:(f + 1) * n_frame], [True] * XC_ACC))
        if len(msgs) != XC_FRAMES:
            fail(f"xcorr {form}: {len(msgs)} messages for {XC_FRAMES} "
                 f"frames")
        phase("check", f"Flowgraph XCorrelate({XC_A}, {XC_SL}, ±{XC_SHIFT}, "
                       f"accumulate {XC_ACC}) {form}, {XC_FRAMES} frames: "
                       f"corrvect max abs err {worst:.3e} <= {TOL} x "
                       f"max|float64|, lags {list(XC_LAGS)} in every window; "
                       f"port kernel launches {counts} (none on this path)")
        keep[0] = False
        t = path_times(torch, f"xcorr {form} ({XC_A} inputs x {XC_ACC} "
                              f"windows)", lambda: r.step(*feeds[0]),
                       n_frame)
        res["forms"][form] = {"err": worst, **t,
                              "wall_msps": n_frame / t["wall_ms"] / 1e3,
                              "busy_msps": None if t["busy_ms"] is None
                              else n_frame / t["busy_ms"] / 1e3}
        del feeds

    # 1 in XC_DECIM frames at one window a frame
    r, msgs, _ = graph(1, XC_DECIM)
    x = xcorr_streams(np, rng, XC_DECIM_FRAMES * XC_SL)
    for f in range(XC_DECIM_FRAMES):
        r.step(*torch.from_numpy(x[:, f * XC_SL:(f + 1) * XC_SL]).to(dev))
    torch.cuda.synchronize()
    for f, m in enumerate(msgs):
        held(f"xcorr decim frame {f}", m, x[:, f * XC_SL:(f + 1) * XC_SL],
             [f % XC_DECIM == 0])
    phase("check", f"XCorrelate decim_frames={XC_DECIM}, {XC_DECIM_FRAMES} "
                   f"frames of one window: computed frames held to float64 "
                   f"with the planted lags, skipped frames zeros with "
                   f"valid False")
    return res


def conv_f64(np, x, taps):
    """y[m] = sum_j taps[j] x[m - j] over a stream that starts from zeros,
    float64 (real and imaginary parts as real convolutions)."""
    def real(a, t):
        return np.convolve(a, t)[:len(a)]
    x, taps = np.asarray(x), np.asarray(taps)
    if np.iscomplexobj(taps):
        if np.iscomplexobj(x):
            return (real(x.real, taps.real) - real(x.imag, taps.imag)
                    + 1j * (real(x.real, taps.imag)
                            + real(x.imag, taps.real)))
        return real(x, taps.real) + 1j * real(x, taps.imag)
    if np.iscomplexobj(x):
        return real(x.real, taps) + 1j * real(x.imag, taps)
    return real(x.astype(np.float64), taps)


def typed_fir_phase(torch, dev) -> dict:
    """FirFilterSCC (decimation 1 and 4), FirFilterFSF (decimation 2, a
    frame saturating) and InterpFirFilter (planar and complex64) on the
    card over TF_FRAMES chained frames of TF_N, held to the float64
    convolution of the joined stream."""
    import numpy as np

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import firdes, planar
    from clenabled_tpu_torch.streaming import Flowgraph

    rng = np.random.default_rng(141)
    taps = (rng.standard_normal(TF_NTAPS)
            + 1j * rng.standard_normal(TF_NTAPS)).astype(np.complex64)
    lp = np.zeros(64, np.float32)               # the 63-tap design, padded
    design = firdes.low_pass(float(TF_L), float(TF_L), 0.4, 0.153)
    lp[:len(design)] = design
    total = TF_N * TF_FRAMES
    s16 = rng.integers(-TF_SPAN, TF_SPAN, total, dtype=np.int16)
    fsf_in = s16.astype(np.float32)
    fsf_in[2 * TF_N:3 * TF_N] *= TF_FSF_SCALE    # outputs past ±32767
    cx = (rng.standard_normal(total)
          + 1j * rng.standard_normal(total)).astype(np.complex64)

    scc_ref = conv_f64(np, s16.astype(np.float64), taps.astype(np.complex128))
    fsf_ref = np.clip(np.trunc(conv_f64(np, fsf_in, taps.real.astype(
        np.float64))), -32768, 32767)[::2]
    up_ref = np.zeros(total * TF_L, np.complex128)
    for p in range(TF_L):                        # the polyphase branches
        up_ref[p::TF_L] = conv_f64(np, cx.astype(np.complex128),
                                   lp[p::TF_L].astype(np.float64))
    if not (np.abs(fsf_ref) == 32767).any() and not (fsf_ref == -32768).any():
        fail("typed FIRs: no fsf output reaches the int16 limits")

    cases = {
        "FirFilterSCC(1)": (lambda: blocks.FirFilterSCC(1, taps), s16,
                            scc_ref),
        "FirFilterSCC(4)": (lambda: blocks.FirFilterSCC(4, taps), s16,
                            scc_ref[::4]),
        "FirFilterFSF(2)": (lambda: blocks.FirFilterFSF(2, taps.real),
                            fsf_in, fsf_ref),
        f"InterpFirFilter({TF_L}, planar)": (
            lambda: blocks.InterpFirFilter(TF_L, lp, planar=True), cx,
            up_ref),
        f"InterpFirFilter({TF_L})": (
            lambda: blocks.InterpFirFilter(TF_L, lp), cx, up_ref),
    }
    res = {}
    for label, (make, x, want) in cases.items():
        blk = make()
        g = Flowgraph()
        g.external_input(blk)
        tap = g.tap(blk, name="y")
        r = g.compile(frame_size=TF_N, device=dev)
        xd = torch.from_numpy(x).to(dev)
        feeds = [xd[f * TF_N:(f + 1) * TF_N] for f in range(TF_FRAMES)]
        if "planar" in label:
            feeds = [planar.PC(f.real.contiguous(), f.imag.contiguous())
                     for f in feeds]
        outs = [r.step(f)[tap] for f in feeds]
        torch.cuda.synchronize()
        if isinstance(outs[0], planar.PC):
            outs = [torch.complex(o.re, o.im) for o in outs]
        got = torch.cat(outs).cpu().numpy()
        if got.shape != want.shape:
            fail(f"{label}: shape {got.shape} != {want.shape}")
        if "FSF" in label:
            if got.dtype != np.int16:
                fail(f"{label}: dtype {got.dtype}")
            d = np.abs(got.astype(np.int64) - want.astype(np.int64))
            err, tol = float(d.max()), 1.0
            at_limits = int((got == 32767).sum() + (got == -32768).sum())
            shown = (f"max count difference {int(err)} <= 1 to trunc-and-"
                     f"clamp of float64, {at_limits} samples at the limits")
        else:
            err = float(np.abs(got.astype(np.complex128) - want).max())
            tol = TOL * float(np.abs(want).max())
            shown = f"max abs err {err:.3e} <= {tol:.3e} ({TOL} x max|float64|)"
        if not np.isfinite(got.astype(np.complex128)).all() or not err <= tol:
            fail(f"{label}: error {err:.3e} > {tol:.3e}")
        phase("check", f"{label}, {TF_FRAMES} chained frames of {TF_N}: "
                       f"{shown}")
        step_ms = time_ms(torch, lambda: r.step(feeds[0]), reps=8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in feeds + feeds:
            r.step(f)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / (2 * len(feeds)) * 1e3
        phase("time", f"{label} per frame of {TF_N}: wall {wall_ms:.4f} ms "
                      f"({TF_N / wall_ms / 1e3:.1f} MSPS in), CUDA events "
                      f"{step_ms:.4f} ms")
        res[label] = {"err": err, "tol": tol, "wall_ms": wall_ms,
                      "step_ms": step_ms,
                      "wall_msps": TF_N / wall_ms / 1e3}
        del feeds, outs, xd
    return res


def planar_step_times(torch, step, frames, hr0, hi0, kernel_ms,
                      body: str) -> dict:
    """The planar step's device busy time (``torch.profiler``) and wall
    time a step over its chained frames, with the packed PFB kernel's share
    of the busy time; fails unless each step launched ``body``."""
    from clenabled_tpu_torch.runtime.device import launched_kernels

    def chain():
        hr, hi = hr0, hi0
        for xr, xi in frames:
            o = step(xr, xi, hr, hi)
            hr, hi = o[3], o[4]

    chain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / len(frames) * 1e3
    busy = device_busy_ms(torch, chain, steps=1)
    busy_ms = None if busy is None else busy / len(frames)
    _, names = launched_kernels(chain, least=len(frames))
    if sum(body in n for n in names) != len(frames):
        fail(f"the planar step did not launch {body} once a step: {names}")
    share = None if busy_ms is None else kernel_ms / busy_ms
    shown = "not measured" if busy_ms is None else (
        f"{busy_ms:.4f} ms ({busy_ms / wall_ms:.0%} of the wall time; the "
        f"packed PFB kernel {share:.0%} of it)")
    phase("main", f"planar step {A}x{frames[0][0].shape[-1]} on {body}, per "
                  f"step over {len(frames)} chained steps: device busy "
                  f"{shown}, wall {wall_ms:.4f} ms")
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "kernel_share": share,
            "kernels": sorted(set(short_name(n) for n in names))}


def planar_wide_path(torch, hk, P, gen, dev, kernel_ms) -> dict:
    """Counts reset, the planar step at 64 channels (the step's 1600-tap
    prototype), 4 × 2^23, 3 chained steps; counts read: one launch a step,
    each step held to the plain form on the same module, the tails
    bit-equal to the plain run's and to the frames' ends; then one
    pfb_packed_wide_kernel a step by name, the device busy and wall time a
    step with the kernel's share (``planar_step_times``), and one step's
    device time by kernel name."""
    m = PFB_PATH_M
    cfg = P.FxPipelineConfig(num_antennas=A, num_channels=m,
                             samples_per_step=N_FULL)
    fn, (_, _, hr0, hi0) = P.make_fx_pipeline_planar(cfg, device=dev)
    steps = [(torch.randn((A, N_FULL), generator=gen, device=dev),
              torch.randn((A, N_FULL), generator=gen, device=dev))
             for _ in range(STEPS)]
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    outs = []
    hr, hi = hr0, hi0
    for xr, xi in steps:
        o = fn(xr, xi, hr, hi)
        outs.append(o)
        hr, hi = o[3], o[4]
    torch.cuda.synchronize()
    launches = hk.pfb_channelize_packed.launches
    ntaps = fn.taps_rm.shape[0] * m
    phase("main", f"planar step {A}x{N_FULL} at {m} channels ({ntaps} "
                  f"taps), {STEPS} steps; launches {launches}")
    if launches != STEPS:
        fail(f"the {m}-channel planar step launched pfb_channelize_packed "
             f"{launches} times in {STEPS} steps")
    res = {"launches": launches, "err": 0.0, "ntaps": ntaps}
    fn.use_kernel = False
    hr, hi = hr0, hi0
    for k, (xr, xi) in enumerate(steps):
        want = fn(xr, xi, hr, hi)
        got = outs[k]
        res["err"] = max(res["err"], check(
            torch, f"planar {m}ch step {k}", got[:3], want[:3]))
        h = ntaps - 1
        if not (torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
                and torch.equal(got[3], xr[:, -h:])
                and torch.equal(got[4], xi[:, -h:])):
            fail(f"planar {m}ch step {k}: carried tail is wrong")
        hr, hi = want[3], want[4]
    fn.use_kernel = None
    del outs
    res.update(planar_step_times(torch, fn, steps, hr0, hi0, kernel_ms,
                                 "pfb_packed_wide_kernel"))
    # where a step's device time goes, by kernel name (one step)
    by_name, _ = step_events(torch, lambda: fn(*steps[0], hr0, hi0))
    res["by_kernel_ms"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1]))
    phase("main", f"planar {m}ch step, device ms by kernel: " + ", ".join(
        f"{k} {v:.4f}" for k, v in res["by_kernel_ms"].items()))
    return res


def short_name(name: str) -> str:
    """A device event's name without its namespace, template arguments and
    parameters (``void a::b::fx_reg_kernel<float, 16>(...)`` → ``fx_reg_kernel``)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", name, maxsplit=1)[0]
    return head.split("::")[-1].strip() or name


def step_events(torch, step) -> tuple[dict, float | None]:
    """(device ms by kernel name, the collectives' ms) of one call of
    ``step``, from ``torch.profiler``; the collectives' are the NCCL
    kernels (``ncclDevKernel_*``), None when the trace holds none."""
    from clenabled_tpu_torch.runtime.device import (_device_events,
                                                    is_nccl_kernel)

    _, window = _device_events(step, 1, 3)
    by_name: dict = {}
    coll = []
    for name, us in window:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + us / 1e3
        if is_nccl_kernel(name):
            coll.append(us / 1e3)
    return by_name, (sum(coll) if coll else None)


def planar_halo_checks(torch, hk, P, S, gen, dev, mesh) -> dict:
    """The planar sharded filters and channel-parallel Costas loops at one
    NCCL rank against their sequential forms over chained frames, bit for
    bit (outputs and carried state; the ring hop is the identity), each
    counted and timed beside the sequential form on CUDA events."""
    import numpy as np

    from clenabled_tpu_torch.dsp import (channelizer, demod, fft_filter,
                                         firdes, planar)

    def same(label, gots, wants):
        for g, w in zip(gots, wants):
            if g.dtype != w.dtype or not torch.equal(g, w):
                fail(f"{label}: not bit-equal to the sequential form")

    def pc(n, *lead):
        return planar.PC(*torch.randn((2, *lead, n), generator=gen,
                                      device=dev))

    res = {}
    lp49 = fm_taps()[0]
    proto400 = P._prototype(M, 100e6)[0].reshape(-1)
    proto160 = os_proto(OS_M)
    cases = {
        "fft_filter_planar ofs 49 taps": (
            S.make_sharded_fft_filter_planar(lp49, mesh, use_pallas=True),
            fft_filter.make_fft_filter_planar(lp49, fused=True)[:2],
            1 << 21, 4, "ofs_filter_planar"),
        "channelizer_planar 16/16 400 taps": (
            S.make_sharded_channelizer_planar(proto400, M, M, list(range(M)),
                                              mesh),
            channelizer.make_channelizer(proto400, M, M, list(range(M)),
                                         planar=True, device=dev),
            1 << 20, 4, None),
        "channelizer_fused_oversampled 16/8 160 taps": (
            S.make_sharded_channelizer_fused_oversampled(proto160, OS_M, OS_R,
                                                         mesh),
            channelizer.make_channelizer_fused_oversampled(
                proto160, OS_M, OS_R, list(range(OS_M)), device=dev),
            OS_N, 3, "pfb_oversampled_fused")}
    for label, ((i_s, a_s), (i_q, a_q), n, steps, kernel) in cases.items():
        ss, sq = i_s(), i_q()
        sq = tuple(v.to(dev) for v in sq)
        xs = [pc(n) for _ in range(steps)]
        torch.cuda.synchronize()
        hk.reset_launch_counts()
        ys = []
        for x in xs:
            ss, y = a_s(ss, x)
            ys.append(y)
        torch.cuda.synchronize()
        counts = {k: v for k, v in hk.launch_counts().items() if v}
        want = {kernel: steps} if kernel else {}
        if counts != want:
            fail(f"sharded {label}: launches {counts}, expected {want}")
        for k, x in enumerate(xs):
            sq, yq = a_q(sq, x)
            same(f"sharded {label} frame {k}", ys[k], yq)
        same(f"sharded {label} state", (ss[0][0], ss[1][0]), sq)
        x0, s0, q0 = xs[0], i_s(), tuple(v.to(dev) for v in i_q())
        t = {"sharded": [], "sequential": []}
        for who in ("sequential", "sharded", "sharded", "sequential"):
            fn = (lambda: a_s(s0, x0)) if who == "sharded" else (
                lambda: a_q(q0, x0))
            t[who].append(time_ms(torch, fn, reps=10))
        res[label] = {"launches": counts, "ms": t}
        phase("check", f"sharded {label}, {steps} chained frames of {n}: "
                       f"equal to the sequential form bit for bit "
                       f"(launches {counts})")
        phase("time", f"sharded {label} a frame (events, in turns): "
                      f"{t['sharded']} ms against the sequential form's "
                      f"{t['sequential']}")
        del xs, ys
    # channel-parallel chunked Costas loops against the chunked loop run
    # channel by channel
    chans, n = 16, 1 << 16
    init_c, apply_c = S.make_sharded_costas_channels(CO_BW, 2, mesh)
    one = demod.make_costas_loop_chunked(CO_BW, 2, chunk=1024, warmup=512)
    rng = np.random.default_rng(13)
    offs = np.linspace(-CO_OFFSET, CO_OFFSET, chans)
    x_all = torch.as_tensor(np.stack([
        costas_stream(np, rng, 2 * n, 2, offset=o) for o in offs], 1),
        device=dev)
    frames_ = [planar.PC(x_all[0, :, k * n:(k + 1) * n].contiguous(),
                         x_all[1, :, k * n:(k + 1) * n].contiguous())
               for k in range(2)]
    sc = init_c(chans)
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    outs = []
    for fr in frames_:
        sc, o, d = apply_c(sc, fr)
        outs.append((o, d))
    torch.cuda.synchronize()
    counts = {k: v for k, v in hk.launch_counts().items() if v}
    if counts != {"costas_batched": 3 * len(frames_)}:
        fail(f"sharded costas channels: launches {counts}, expected 3 "
             f"costas_batched a frame")
    for ch in range(chans):
        st = one.init_state(dev)
        for k, fr in enumerate(frames_):
            st, o, d = one(st, planar.PC(fr.re[ch], fr.im[ch]))
            got_o, got_d = outs[k]
            same(f"sharded costas channel {ch} frame {k}",
                 (got_o.re[ch], got_o.im[ch],
                  *(got_d[key][ch] for key in sorted(d))),
                 (o.re, o.im, *(d[key] for key in sorted(d))))
        same(f"sharded costas channel {ch} state",
             [v[ch] for v in sc[0]] + [sc[1].re[ch], sc[1].im[ch]],
             list(st[0]) + [st[1].re, st[1].im])
    t = {"sharded": [], "sequential": []}
    s0 = init_c(chans)
    for who in ("sequential", "sharded", "sharded", "sequential"):
        if who == "sharded":
            t[who].append(time_ms(torch, lambda: apply_c(s0, frames_[0]),
                                  reps=10))
        else:
            def per_channel():
                for ch in range(chans):
                    one(one.init_state(dev), planar.PC(frames_[0].re[ch],
                                                       frames_[0].im[ch]))
            t[who].append(time_ms(torch, per_channel, reps=3, warmup=1))
    res["costas_channels"] = {"launches": counts, "ms": t}
    phase("check", f"sharded costas channels {chans} x {n}, 2 chained frames:"
                   f" equal to the chunked loop run channel by channel bit "
                   f"for bit (outputs, diagnostics, state; launches "
                   f"{counts})")
    phase("time", f"sharded costas channels a frame (events, in turns): "
                  f"{t['sharded']} ms against {chans} chunked loops one after "
                  f"another, {t['sequential']}")
    return res


def sharded_xengine_checks(torch, hk, S, gen, dev, mesh) -> dict:
    """The station-sharded X-Engines at one NCCL rank: the stacked engine
    at the X-Engine reference configuration (int8, 3 integrations), counted
    (one int8 Gram launch a call), bit-equal to
    ``make_xengine_channel_major`` with the same ready flags and carried
    state, ``gram_int8_diag_kernel`` among its kernels; bf16 at T = 1024
    within TOL of the plain engine and bit-equal to the unsharded one;
    the sharded call, the unsharded engine and the exchange timed in
    turns; the time-major and planar forms bit-equal to theirs."""
    import torch.distributed as dist

    from clenabled_tpu_torch.dsp import planar
    from clenabled_tpu_torch.dsp import xengine as X
    from clenabled_tpu_torch.runtime.device import launched_kernels

    def same(label, got, want):
        if got[1] != want[1]:
            fail(f"{label}: ready {got[1]} != {want[1]}")
        for g, w in zip(got[0], want[0]):
            if not torch.equal(g, w):
                fail(f"{label}: not bit-equal to the unsharded engine")

    sp = XE_S * XE_P
    out = {"launches": {}, "times": {}}
    kw = dict(pipeline_integration=2, scale=1.0 / 127.0 ** 2)
    si, sa = S.make_sharded_xengine_stacked(XE_S, XE_F, XE_P, XE_T, mesh,
                                            **kw)
    ui, ua = X.make_xengine_channel_major(XE_S, XE_F, XE_P, XE_T,
                                          device=dev, **kw)
    feeds = [tuple(torch.randint(-128, 128, (XE_F, XE_T, sp), generator=gen,
                                 device=dev, dtype=torch.int8)
                   for _ in range(2)) for _ in range(XE_STEPS)]
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    ss, souts = si(), []
    for fr in feeds:
        ss, o = sa(ss, fr)
        souts.append(o)
    torch.cuda.synchronize()
    counts = {k: v for k, v in hk.launch_counts().items() if v}
    out["launches"]["int8"] = counts.get("xengine_gram_stacked_tri", 0)
    phase("sharded", f"make_sharded_xengine_stacked S={XE_S} P={XE_P} "
                     f"F={XE_F} T={XE_T} int8, {XE_STEPS} integrations, "
                     f"pipeline_integration=2: launches {counts}")
    if counts != {"xengine_gram_stacked_tri": XE_STEPS}:
        fail(f"sharded stacked X-Engine: expected one Gram launch a call, "
             f"{counts}")
    us = ui()
    for k, fr in enumerate(feeds):
        us, uo = ua(us, fr)
        same(f"sharded stacked X-Engine call {k}", souts[k], uo)
    if [o[1] for o in souts] != [False, True, False]:
        fail(f"sharded stacked X-Engine: ready {[o[1] for o in souts]}")
    if not (ss.count == us.count == 1
            and torch.equal(ss.accum.re, us.accum.re)
            and torch.equal(ss.accum.im, us.accum.im)):
        fail("sharded stacked X-Engine: carried state differs")
    _, names = launched_kernels(lambda: sa(si(), feeds[0]))
    if not any("gram_int8_diag_kernel" in n for n in names):
        fail(f"sharded stacked X-Engine: gram_int8_diag_kernel not among "
             f"{sorted(set(names))}")
    phase("check", f"sharded stacked X-Engine int8: {XE_STEPS} integrations "
                   f"equal make_xengine_channel_major bit for bit (matrices, "
                   f"ready flags, carried state); kernels "
                   f"{sorted(set(short_name(n) for n in names))}")
    zr, zi = feeds[0]
    st0, ust0 = si(), ui()
    send = zr.reshape(1, *zr.shape)
    recv = torch.empty_like(send)
    group = mesh.get_group("shard")
    calls = {
        "sharded": lambda: sa(st0, feeds[0]),
        "unsharded": lambda: ua(ust0, feeds[0]),
        # the port's exchange: the identity at one rank
        "all_to_all": lambda: (S.all_to_all(zr, mesh, 0, 2),
                               S.all_to_all(zi, mesh, 0, 2)),
        # NCCL's own all_to_all_single on one component's bytes at one
        # rank (a copy within the card)
        "nccl_all_to_all_single": lambda: dist.all_to_all_single(
            recv, send, group=group)}
    t = {k: [] for k in calls}
    for who in ("unsharded", "sharded", "all_to_all",
                "nccl_all_to_all_single", "nccl_all_to_all_single",
                "all_to_all", "sharded", "unsharded"):
        t[who].append(time_ms(torch, calls[who], reps=10))
    out["times"]["int8"] = t
    phase("time", f"sharded stacked X-Engine int8, a call (events, 10 "
                  f"calls, in turns): sharded {t['sharded']} ms, unsharded "
                  f"{t['unsharded']}, the exchange (S.all_to_all, zr and zi) "
                  f"{t['all_to_all']}, NCCL all_to_all_single of "
                  f"{zr.numel() / 2 ** 20:.0f} MiB {t['nccl_all_to_all_single']}")
    del feeds, souts, ss, us, send, recv, zr, zi, st0, ust0
    # bf16 at T = XE_BF_T: the plain engine within TOL, the unsharded one
    # bit for bit
    si, sa = S.make_sharded_xengine_stacked(XE_S, XE_F, XE_P, XE_BF_T, mesh,
                                            pipeline_integration=2)
    ui, ua = X.make_xengine_channel_major(XE_S, XE_F, XE_P, XE_BF_T,
                                          device=dev, pipeline_integration=2)
    feeds = [tuple(torch.randn((XE_F, XE_BF_T, sp), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(2)) for _ in range(2)]
    hk.reset_launch_counts()
    ss, us = si(), ui()
    for fr in feeds:
        ss, so = sa(ss, fr)
    torch.cuda.synchronize()
    out["launches"]["bf16"] = hk.gram_launches()
    if out["launches"]["bf16"] != 2:
        fail(f"sharded stacked X-Engine bf16: {out['launches']['bf16']} "
             f"Gram launches over 2 calls")
    for fr in feeds:
        us, uo = ua(us, fr)
    same("sharded stacked X-Engine bf16", so, uo)
    plain = [X.xengine_correlate_stacked(*fr, npol=XE_P, use_kernel=False)
             for fr in feeds]
    out["bf16_err"] = check(torch, f"sharded stacked X-Engine bf16 T={XE_BF_T}"
                                   f" vs plain", so[0],
                            (plain[0].re + plain[1].re,
                             plain[0].im + plain[1].im))
    del feeds, plain, ss, us, so, uo
    # the time-major and planar forms at T=64
    z = torch.randn((XE_SH_T, XE_S, XE_F, XE_P), generator=gen, device=dev,
                    dtype=torch.complex64)
    if not torch.equal(S.sharded_xengine(z, mesh), X.xengine_correlate(z)):
        fail("sharded_xengine: not bit-equal to xengine_correlate")
    pz = planar.PC(z.real.contiguous(), z.imag.contiguous())
    g, w = S.sharded_xengine_planar(pz, mesh), X.xengine_correlate_planar(pz)
    if not (torch.equal(g.re, w.re) and torch.equal(g.im, w.im)):
        fail("sharded_xengine_planar: not bit-equal to "
             "xengine_correlate_planar")
    si, sa = S.make_sharded_xengine(XE_S, XE_F, XE_P, XE_SH_T, mesh,
                                    pipeline_integration=2)
    ui, ua = X.make_xengine(XE_S, XE_F, XE_P, XE_SH_T,
                            pipeline_integration=2, device=dev)
    ss, us = si(), ui()
    for k in range(2):
        zk = torch.randn(z.shape, generator=gen, device=dev,
                         dtype=torch.complex64)
        ss, (so, sr) = sa(ss, zk)
        us, (uo, ur) = ua(us, zk)
        same(f"make_sharded_xengine call {k}", ((so,), sr), ((uo,), ur))
    phase("check", f"sharded_xengine, sharded_xengine_planar and "
                   f"make_sharded_xengine (2 calls) at T={XE_SH_T} S={XE_S} "
                   f"F={XE_F} P={XE_P}: bit-equal to the unsharded engines")
    return out


def sharded_chain_checks(torch, S, gen, dev, mesh) -> dict:
    """Three ShardedChains at one NCCL rank over CHAIN_FRAMES chained
    frames, bit-equal (outputs and every stage's state) to the sequential
    filters followed by ``demod.quadrature_demod`` from a zero sample; the
    chain and its sequential route timed in turns on frame 0."""
    from clenabled_tpu_torch.dsp import (channelizer, demod, fft_filter,
                                         fir_filter, firdes)

    lp20 = firdes.low_pass(1.0, 1e6, 100e3, 20e3)
    plan = fft_filter.plan_fft_filter(lp20)
    n_ofa = CHAIN_N // plan.nsamples * plan.nsamples   # a multiple of it
    lp = firdes.low_pass(1.0, 1e6, 100e3, 50e3)
    ch = firdes.low_pass(1.0, 16.0, 0.5, 0.25)
    chains = {
        "fft_filter -> x2 -> demod": (
            S.ShardedChain(mesh).add_fft_filter(lp20)
            .add_map(lambda x: x * 2.0).add_quadrature_demod(0.7),
            fft_filter.make_fft_filter(lp20)[:2], 2.0, n_ofa),
        "fir d=4 -> demod": (
            S.ShardedChain(mesh).add_fir_filter(lp, 4)
            .add_quadrature_demod(0.7),
            fir_filter.make_fir_filter(lp, decimation=4), None, CHAIN_N),
        "channelizer 16/8": (
            S.ShardedChain(mesh).add_channelizer(ch, 16, 8, list(range(16))),
            channelizer.make_channelizer(ch, 16, 8, list(range(16)),
                                         device=dev), None, CHAIN_N)}
    out = {}
    for label, (chain, (qi, qa), gain2, n) in chains.items():
        init, step = chain.compile()
        demods = label.endswith("demod")

        def seq(state, x):
            sq, last = state
            sq, y = qa(sq, x)
            if gain2 is not None:
                y = y * gain2
            if demods:
                y, last = demod.quadrature_demod(y, 0.7, last_sample=last)
            return (sq, last), y

        ss = init()
        sq = (qi().to(dev), torch.zeros(1, dtype=torch.complex64, device=dev))
        xs = [torch.randn(n, generator=gen, device=dev, dtype=torch.complex64)
              for _ in range(CHAIN_FRAMES)]
        for k, x in enumerate(xs):
            ss, y = step(ss, x)
            sq, yq = seq(sq, x)
            ok = torch.equal(y, yq) and torch.equal(ss[0][0], sq[0])
            if demods:
                ok = ok and torch.equal(ss[-1][0], sq[1])
            if not ok:
                fail(f"ShardedChain {label} frame {k}: not bit-equal to the "
                     f"sequential route")
        s0, q0 = init(), (qi().to(dev), torch.zeros(1, dtype=torch.complex64,
                                                    device=dev))
        calls = {"chain": lambda: step(s0, xs[0]), "sequential":
                 lambda: seq(q0, xs[0])}
        t = {k: [] for k in calls}
        for who in ("sequential", "chain", "chain", "sequential"):
            t[who].append(time_ms(torch, calls[who], reps=5))
        out[label] = {"n": n, "ms": t}
        phase("check", f"ShardedChain {label}, {CHAIN_FRAMES} frames of {n}: "
                       f"equal to the sequential route bit for bit (outputs "
                       f"and states); a frame (events, in turns) chain "
                       f"{t['chain']} ms, sequential {t['sequential']}")
    return out


def sharded_phase(torch, hk, P, gen, dev) -> dict:
    """The sharded main path on a world-size-1 NCCL group: the fused step
    at full width in f32 and int8 for 3 chained steps, counted, bit-equal
    to ``make_fx_pipeline_fused`` and within TOL of the plain form; the
    complex64 step at 4 × 2^20 bit-equal to ``make_fx_pipeline``; the three
    halo filters bit-equal to their sequential forms; then the group is
    destroyed and ``entry.dryrun_multichip(1)`` runs a rank of its own."""
    import tempfile

    import numpy as np

    from clenabled_tpu_torch import entry, sharding as S
    from clenabled_tpu_torch.dsp import (channelizer, fft_filter, fir_filter,
                                         firdes, planar, xcorr)
    from clenabled_tpu_torch.runtime.device import host_ms

    def same(label, gots, wants):
        for g, w in zip(gots, wants):
            if g.dtype != w.dtype or not torch.equal(g, w):
                fail(f"{label}: not bit-equal to the unsharded form")

    out = {"launches": {}, "times": {}, "devices": {}}
    cfg = P.FxPipelineConfig(num_antennas=A, num_channels=M,
                             samples_per_step=N_FULL)
    with tempfile.TemporaryDirectory(prefix="clen_smoke_") as workdir:
        S.initialize_distributed("cuda", f"file://{workdir}/store", 1, 0)
        try:
            mesh = S.make_mesh(device="cuda")
            phase("sharded", f"NCCL process group of 1 rank from a file "
                             f"store; {mesh}")
            for label, dt in (("f32", torch.float32), ("int8", torch.int8)):
                sfn, (_, _, tr0, ti0) = P.make_sharded_fx_pipeline_fused(
                    mesh, cfg=cfg, in_dtype=dt)
                ufn, _ = P.make_fx_pipeline_fused(cfg, in_dtype=dt, device=dev)
                frs = [(frames(torch, gen, dt, (A, N_FULL), dev),
                        frames(torch, gen, dt, (A, N_FULL), dev))
                       for _ in range(STEPS)]
                torch.cuda.synchronize()
                hk.reset_launch_counts()
                outs, tr, ti = [], tr0, ti0
                for xr, xi in frs:
                    outs.append(sfn(xr, xi, tr, ti))
                    tr, ti = outs[-1][3], outs[-1][4]
                torch.cuda.synchronize()
                counts = {k: v for k, v in hk.launch_counts().items() if v}
                out["launches"][label] = counts.get(
                    "fx_correlate_streams_v2", 0)
                phase("sharded", f"fused {label} {A}x{N_FULL}, {STEPS} "
                                 f"chained steps: launches {counts}")
                if counts != {"fx_correlate_streams_v2": STEPS}:
                    fail(f"sharded fused {label}: expected one "
                         f"fx_correlate_streams_v2 launch a step, {counts}")
                tr, ti = tr0, ti0
                for k, (xr, xi) in enumerate(frs):
                    want = ufn(xr, xi, tr, ti)
                    same(f"sharded fused {label} step {k}", outs[k], want)
                    fd_sum, gram = hk.fx_correlate_streams_v2_plain(
                        xr, xi, tr, ti, sfn.taps_rm, A, M)
                    check(torch, f"sharded fused {label} step {k} vs plain",
                          outs[k][:3],
                          (torch.roll(fd_sum / (N_FULL // M), M // 2, dims=-1),
                           gram[:, :M].T[:, :, None],
                           gram[:, M:].T[:, :, None]))
                    tr, ti = want[3], want[4]
                phase("check", f"sharded fused {label}: {STEPS} steps equal "
                               f"make_fx_pipeline_fused bit for bit (outputs "
                               f"and tails)")
                xr, xi = frs[0]
                by_name, coll_ms = step_events(
                    torch, lambda: sfn(xr, xi, tr0, ti0))
                if not any("fx_reg_kernel" in n for n in by_name):
                    fail(f"sharded fused {label}: fx_reg_kernel not in the "
                         f"step's kernels {sorted(by_name)}")
                u_names, _ = step_events(torch, lambda: ufn(xr, xi, tr0, ti0))
                t = {"unsharded": [], "sharded": []}
                for who in ("unsharded", "sharded", "sharded", "unsharded"):
                    fn = ufn if who == "unsharded" else sfn
                    t[who].append(time_ms(torch, lambda: fn(xr, xi, tr0, ti0),
                                          reps=20))
                # the step's collectives alone, on its shapes: the sums'
                # all-reduce, the tails' broadcast (the ring hop is the
                # identity at one rank)
                sums = torch.zeros((A - 1) * M + A * (A + 1) * M, device=dev)
                tails = torch.stack([tr0, ti0])

                def coll():
                    return S.psum(sums, mesh), S.broadcast(tails, mesh, 0)

                t["collectives"] = time_ms(torch, coll, reps=20)
                t["host"] = {
                    "unsharded": host_ms(lambda: ufn(xr, xi, tr0, ti0)),
                    "sharded": host_ms(lambda: sfn(xr, xi, tr0, ti0)),
                    "collectives": host_ms(coll)}
                out["times"][label] = t
                out["devices"][label] = {
                    "sharded_ms_by_kernel": by_name,
                    "unsharded_ms_by_kernel": u_names,
                    "collectives_ms": coll_ms}
                shown = "none recorded" if coll_ms is None else \
                    f"{coll_ms:.4f} ms"
                phase("time", f"sharded fused {label} step (events, 20 "
                              f"calls, in turns): {t['sharded']} ms against "
                              f"the unsharded step's {t['unsharded']}; device "
                              f"time of the collectives' kernels a step: "
                              f"{shown}; the collectives alone (events) "
                              f"{t['collectives']:.4f} ms")
                phase("time", f"sharded fused {label} step, device ms by "
                              f"kernel: {by_name}; unsharded: {u_names}")
                phase("time", f"sharded fused {label}: host time to enqueue "
                              f"a call (ms) {t['host']}")
                del frs, outs
            # the complex64 step at 4 x 2^20, on the plain torch forms
            n_c = 1 << 20
            ccfg = P.FxPipelineConfig(num_antennas=A, num_channels=M,
                                      samples_per_step=n_c)
            sfn, (_, sh) = P.make_sharded_fx_pipeline(mesh, cfg=ccfg)
            ufn, (_, uh) = P.make_fx_pipeline(ccfg, device=dev)
            for k in range(2):
                x = torch.randn((A, n_c), generator=gen, device=dev,
                                dtype=torch.complex64)
                so, uo = sfn(x, sh), ufn(x, uh)
                same(f"sharded complex64 step {k}", so, uo)
                sh, uh = so[2], uo[2]
            phase("check", f"sharded complex64 step {A}x{n_c}, 2 chained "
                           f"steps: equal to make_fx_pipeline bit for bit")
            # the three halo filters against their sequential forms
            lp = firdes.low_pass(1.0, 1e6, 100e3, 50e3)
            rrc = firdes.root_raised_cosine(1.0, 10e6, 1e6, 0.22, 241)
            ch_taps = firdes.low_pass(1.0, 16.0, 0.5, 0.25)
            plan = fft_filter.plan_fft_filter(rrc)
            halos = {
                "fir d=4": (S.make_sharded_fir_filter(lp, mesh, decimation=4),
                            fir_filter.make_fir_filter(lp, decimation=4),
                            1 << 20),
                "ofa": (S.make_sharded_fft_filter(rrc, mesh)[:2],
                        fft_filter.make_fft_filter(rrc)[:2],
                        plan.nsamples * 4096),
                "channelizer 16/8": (
                    S.make_sharded_channelizer(ch_taps, 16, 8,
                                               list(range(16)), mesh),
                    channelizer.make_channelizer(ch_taps, 16, 8,
                                                 list(range(16)), device=dev),
                    1 << 20)}
            # the window-parallel correlators: at one rank the planar
            # functions over the whole batch, bit for bit
            mags = torch.rand((3, XC_ACC, XC_SL), generator=gen, device=dev)
            same("sharded td_xcorr", S.make_sharded_td_xcorr(
                mesh, XC_SHIFT)(mags), xcorr.td_xcorr_planar_batched(
                    mags, XC_SHIFT))
            vec = planar.PC(*torch.randn((2, 3, XC_ACC, XC_SL),
                                         generator=gen, device=dev))
            same("sharded fd_xcorr", [S.make_sharded_fd_xcorr(
                mesh, perform_fft_first=True)(vec)],
                [xcorr.fd_xcorr_planar(vec, perform_fft_first=True)])
            phase("check", f"sharded td_xcorr (±{XC_SHIFT}) and fd_xcorr "
                           f"(perform_fft_first) on [3, {XC_ACC}, {XC_SL}]: "
                           f"equal to the unsharded planar functions bit "
                           f"for bit")
            del mags, vec
            for label, ((i_s, a_s), (i_q, a_q), n) in halos.items():
                ss, sq = i_s(), i_q().to(dev)
                for k in range(3):
                    x = torch.randn(n, generator=gen, device=dev,
                                    dtype=torch.complex64)
                    ss, ys = a_s(ss, x)
                    sq, yq = a_q(sq, x)
                    same(f"sharded {label} frame {k}", (ys, ss[0]), (yq, sq))
                phase("check", f"sharded {label}, 3 frames of {n}: equal to "
                               f"the sequential filter bit for bit")
            out["planar"] = planar_halo_checks(torch, hk, P, S, gen, dev, mesh)
            out["xengine"] = sharded_xengine_checks(torch, hk, S, gen, dev,
                                                    mesh)
            out["chain"] = sharded_chain_checks(torch, S, gen, dev, mesh)
        finally:
            S.shutdown_distributed()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    legs = entry.dryrun_multichip(1, device="cuda")
    if not {"1", "1b float32", "1b bfloat16", "1b int8", "2", "2b", "3",
            "3b", "3c", "3d", "3e td", "3e fd"} <= set(legs[0]):
        fail(f"dryrun_multichip(1): legs {sorted(legs[0])}")
    for leg, vals in legs[0].items():
        if not all(np.isfinite(np.asarray(v, np.complex64)).all()
                   for v in vals):
            fail(f"dryrun_multichip(1) leg {leg}: non-finite output")
    phase("sharded", f"entry.dryrun_multichip(1, 'cuda'): legs "
                     f"{sorted(legs[0])} in {time.perf_counter() - t0:.1f} s "
                     f"(one spawned rank on NCCL)")
    return out


# --------------------------------------------------------------------------
# Phase 15: the GNU Radio adapter, the native host runtime and the CLI tools
# --------------------------------------------------------------------------

GR_SEED = 15
GR_CALLS, GR_RETUNE_AT = 64, 32        # adapter work calls; set_taps before
GR_OFFER = (1000, 1 << 17)             # the scheduler's offers, samples
GR_TIME_OFFER, GR_TIME_CALLS = 8192, 256   # the reference's GR buffers
GR_XE_S, GR_XE_F, GR_XE_T, GR_XE_INTS = 64, 16, 1024, 4
NATIVE_BYTES = 1 << 24
TOOL_ARGS: list = []                   # ["--cpu"] to rehearse on the CPU
TOOL_BLOCK, TOOL_ITERS = 2097152, 20
INGEST_LOG2, SCALING_SPC, PROFILE_N = 22, 1 << 16, 1 << 21


def gr_stand_in() -> list[str]:
    """Install minimal stand-ins for ``gnuradio.gr.basic_block`` and
    ``pmt`` (GNU Radio is not installed on the card's machine): the block
    records what the adapter tells the scheduler, ``pmt.to_pmt`` passes
    its payload through.  Returns the module names to remove after."""
    import types

    class BasicBlock:
        def __init__(self, name=None, in_sig=None, out_sig=None):
            self._name, self._in_sig, self._out_sig = name, in_sig, out_sig
            self.consumed, self.published, self.registered_ports = [], [], []
            self.relative_rate = self.output_multiple = None

        def set_relative_rate(self, r):
            self.relative_rate = r

        def set_output_multiple(self, m):
            self.output_multiple = m

        def message_port_register_out(self, sym):
            self.registered_ports.append(sym)

        def message_port_pub(self, sym, msg):
            self.published.append((sym, msg))

        def consume_each(self, n):
            self.consumed.append(n)

    gr = types.ModuleType("gnuradio.gr")
    gr.basic_block = BasicBlock
    gnuradio = types.ModuleType("gnuradio")
    gnuradio.gr = gr
    pmt = types.ModuleType("pmt")
    pmt.intern = lambda s: s
    pmt.to_pmt = lambda x: x
    names = ["gnuradio", "gnuradio.gr", "pmt"]
    for name, mod in zip(names, (gnuradio, gr, pmt)):
        if name in sys.modules:
            fail(f"{name} is already imported: the stand-in would hide it")
        sys.modules[name] = mod
    return names


def native_checks(torch, dev) -> dict:
    """The native library from ``clenabled_tpu_torch/native/src`` (g++):
    a 1 MiB ring with wrap-around and refusal when full, the unpacks on
    2^24 bytes bit for bit the port's torch unpack on the card, and a
    rolling writer over 3 files with sidecars."""
    import tempfile

    import numpy as np

    from clenabled_tpu_torch import native
    from clenabled_tpu_torch.dsp import xengine as X

    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(GR_SEED)
    rb = native.RingBuffer(1 << 20)
    data = rng.integers(0, 256, 3 << 19, dtype=np.uint8)
    a, b = data[:3 << 18], data[3 << 18:]
    if rb.write(a) != a.size:
        fail("ring: the first write was cut")
    first = rb.read(1 << 19)
    if rb.write(b) != b.size:                  # wraps past the end
        fail("ring: the wrapping write was cut")
    if rb.write(np.zeros(1 << 20, np.uint8)) != 0:
        fail("ring: a full ring took bytes")
    rest = rb.read(1 << 21)
    if not (np.array_equal(first, a[:1 << 19])
            and np.array_equal(rest, np.concatenate([a[1 << 19:], b]))):
        fail("ring: the bytes read are not the bytes written")
    rb.close()

    raw = rng.integers(0, 256, NATIVE_BYTES, dtype=np.uint8)
    traw = torch.from_numpy(raw).to(dev)
    out = {"build_s": build_s}
    for label, host_fn, dev_fn, host_in, dev_in in (
            ("unpack_4bit_planar", native.unpack_4bit_planar,
             X.unpack_packed_4bit_planar, raw, traw),
            ("unpack_i8_planar", native.unpack_i8_planar,
             X.unpack_char_planar, raw.view(np.int8),
             traw.view(torch.int8))):
        t0 = time.perf_counter()
        re, im = host_fn(host_in)
        host_ms = (time.perf_counter() - t0) * 1e3
        z = dev_fn(dev_in)
        if not (np.array_equal(re, z.re.cpu().numpy())
                and np.array_equal(im, z.im.cpu().numpy())):
            fail(f"native {label} differs from the torch unpack on the card")
        card_ms = time_ms(torch, lambda: dev_fn(dev_in), reps=5, warmup=1)
        out[label] = {"host_ms": host_ms, "card_ms": card_ms}
        phase("native", f"{label} on {NATIVE_BYTES} bytes: bit-equal to the "
                        f"torch unpack on the card; host {host_ms:.2f} ms, "
                        f"card {card_ms:.4f} ms")
    with tempfile.TemporaryDirectory(prefix="clen_native_") as tmp:
        base = os.path.join(tmp, "xout")
        w = native.RollingFileWriter(base, 1000, json.dumps({"files": 3}))
        chunk = np.arange(100, dtype=np.float32)
        for _ in range(6):
            w.write(chunk)
        w.close()
        names = sorted(os.listdir(tmp))
        want = [f"xout_{i}.{ext}" for i in range(3) for ext in ("bin", "json")]
        if names != sorted(want):
            fail(f"rolling writer left {names}")
        got = np.concatenate([np.fromfile(f"{base}_{i}.bin", np.float32)
                              for i in range(3)])
        if not np.array_equal(got, np.tile(chunk, 6)):
            fail("rolling writer: the files do not hold the stream")
    phase("native", f"built from clenabled_tpu_torch/native/src in "
                    f"{build_s:.2f} s; 1 MiB ring round trip with "
                    f"wrap-around; writer rolled over 3 files, each with "
                    f"its sidecar")
    return out


def _gr_work(g, ins, space, dtype):
    """One general_work call: (consumed, produced items)."""
    import numpy as np

    before = len(g.consumed)
    out = np.zeros(space, dtype)
    n = g.general_work(ins, [out])
    return sum(g.consumed[before:]), out[:n].copy()


def _gr_drain(g, dtype, pending=None):
    """Run out a wrapped block: offer ``pending`` input until it is taken,
    flush, and emit the queue; returns the produced items."""
    import numpy as np

    outs = []
    space = 1 << 20
    for _ in range(1024):
        if pending is not None and len(pending):
            c, y = _gr_work(g, [pending], space, dtype)
            pending = pending[c:]
            outs.append(y)
            if c or len(y):
                continue
        g.flush()
        c, y = _gr_work(g, [np.zeros(0, np.complex64)], space, dtype)
        outs.append(y)
        if not len(y) and not (pending is not None and len(pending)):
            return outs
    fail("a wrapped block did not run out in 1024 work calls")


def grc_make(block_id: str, values: dict, names: dict):
    """The wrapped block that the GRC descriptor
    ``clenabled_tpu_torch/grc/clenabled_tpu_torch_<block_id>.block.yml``
    builds: its ``imports`` run and its ``make`` line evaluated with each
    ``${param}`` replaced by ``values[param]`` and the flowgraph's
    variables ``names`` in scope, as GNU Radio Companion's generated code
    does (read with plain text matching, so no YAML reader is needed).
    Returns (the wrapped block, the make line)."""
    import textwrap

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "clenabled_tpu_torch", "grc",
                           f"clenabled_tpu_torch_{block_id}.block.yml")) as f:
        text = f.read()
    imports = re.search(r"^  imports: \|-\n((?:    .*\n)+)", text, re.M)
    make = re.search(r"^  make: (.*)$", text, re.M)
    if imports is None or make is None:
        fail(f"descriptor {block_id}: no imports or make line")
    line = re.sub(r"\$\{(\w+)\}", lambda m: values[m.group(1)],
                  make.group(1))
    scope = dict(names)
    exec(textwrap.dedent(imports.group(1)), scope)
    return eval(line, scope), line


def adapter_stream_checks(torch, hk, dev) -> dict:
    """LowPassFilter (49 taps, time domain, planar) → QuadratureDemod and
    Fft(2048, Blackman-Harris, shift) behind ``gr_compat.wrap``, 64 work
    calls of seeded offers, per call (built here) and batched (built by
    the GRC descriptors' make lines, as GNU Radio would), a ``set_taps``
    before call 32; each held to a Flowgraph over the joined stream
    retuned at the same sample, and each kernel launched once an
    ``apply``."""
    import numpy as np

    from clenabled_tpu_torch import blocks, gr_compat
    from clenabled_tpu_torch.dsp import planar, window
    from clenabled_tpu_torch.streaming import Flowgraph

    taps_a, taps_b, _, _ = fm_taps()
    w = window.blackman_harris(2048)
    rng = np.random.default_rng(GR_SEED)
    offers = rng.integers(GR_OFFER[0], GR_OFFER[1] + 1, GR_CALLS)
    total = int(offers.sum())
    x = (rng.standard_normal(total) + 1j * rng.standard_normal(total)
         ).astype(np.complex64)

    def make():
        lpf = blocks.LowPassFilter(1, 1.0, 10e6, 1.5e6, 500e3, use_time=True,
                                   planar=True)
        return (lpf, blocks.QuadratureDemod(1.0, planar=True),
                blocks.Fft(2048, window=w, shift=True, planar=True))

    def from_descriptors():
        """The three blocks as the descriptors build them (wrap's
        defaults: batch_frames "auto", the first card)."""
        made = [grc_make("clLowPassFilter", {
                    "decimation": "1", "gain": "1.0", "samp_rate": "10e6",
                    "cutoff_freq": "1.5e6", "transition_width": "500e3",
                    "use_time": "True"}, {}),
                grc_make("clQuadratureDemod", {"gain": "1.0"}, {}),
                grc_make("clFFT", {
                    "fft_size": "2048", "direction": "1", "window": "w",
                    "shift": "True", "num_streams": "1"}, {"w": w})]
        for _, line in made:
            phase("gr", f"descriptor make line: {line}")
        return [g for g, _ in made]

    def pc(a):
        return planar.PC(torch.from_numpy(np.ascontiguousarray(a.real))
                         .to(dev), torch.from_numpy(
                             np.ascontiguousarray(a.imag)).to(dev))

    res = {}
    for mode in (1, "auto"):
        if mode == 1:
            g_lpf, g_qd, g_fft = (gr_compat.wrap(b, batch_frames=1,
                                                 device=dev)
                                  for b in make())
        else:
            g_lpf, g_qd, g_fft = from_descriptors()
        if not np.array_equal(g_lpf.taps(), taps_a):
            fail("the wrapped LowPassFilter is not the FM path's 49 taps")
        c64, f32 = np.complex64, np.float32
        ly, qy, fy = [], [], []
        fifo = np.zeros(0, c64)
        pos_l = pos_f = 0
        retune_at = None
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        for k, o in enumerate(int(v) for v in offers):
            if k == GR_RETUNE_AT:
                g_lpf.set_taps(taps_b)
                retune_at = pos_l
            c, y = _gr_work(g_lpf, [x[pos_l:pos_l + o]], o, c64)
            pos_l += c
            ly.append(y)
            fifo = np.concatenate([fifo, y])
            c, y = _gr_work(g_qd, [fifo], max(1, len(fifo)), f32)
            fifo = fifo[c:]
            qy.append(y)
            c, y = _gr_work(g_fft, [x[pos_f:pos_f + o]], o, c64)
            pos_f += c
            fy.append(y)
        tail = _gr_drain(g_lpf, c64)
        ly += tail
        fifo = np.concatenate([fifo, *tail])
        qy += _gr_drain(g_qd, f32, fifo)
        fy += _gr_drain(g_fft, c64)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = hk.launch_counts()
        calls = {"fir_direct": g_lpf.apply_calls,
                 "qdemod_fused": g_qd.apply_calls,
                 "fft_batched_fused": g_fft.apply_calls}
        launches = {k: counts[k] for k in calls}
        want_launches = calls if dev.type == "cuda" else dict.fromkeys(
            calls, 0)
        if launches != want_launches or min(calls.values()) < 1:
            fail(f"adapter ({mode}): launches {launches}, apply calls "
                 f"{calls}")
        ly, qy, fy = (np.concatenate(v) for v in (ly, qy, fy))
        if not (len(ly) == len(qy) == pos_l and len(fy) == pos_f):
            fail(f"adapter ({mode}): {len(ly)}/{len(qy)} LPF/QD items for "
                 f"{pos_l} consumed, {len(fy)} FFT items for {pos_f}")

        lpf_r, qd_r, fft_r = make()
        g = Flowgraph()
        g.external_input(lpf_r)
        g.connect(lpf_r, qd_r)
        g.tap(lpf_r, name="filtered")
        g.tap(qd_r, name="audio")
        r = g.compile(1, device=dev)
        parts = [r.step(pc(x[:retune_at]))]
        r.set_taps(lpf_r, taps_b)
        parts.append(r.step(pc(x[retune_at:pos_l])))
        want_l = torch.cat([planar.to_complex(p["filtered"]) for p in parts])
        want_q = torch.cat([p["audio"] for p in parts])
        g2 = Flowgraph()
        g2.external_input(fft_r)
        g2.tap(fft_r, name="spectra")
        want_f = planar.to_complex(g2.compile(2048, device=dev).step(
            pc(x[:pos_f]))["spectra"])
        errs = {}
        bit = {}
        for label, got, want in (("LowPassFilter", ly, want_l),
                                 ("QuadratureDemod", qy, want_q),
                                 ("Fft", fy, want_f)):
            errs[label] = check(torch, f"wrapped {label} ({mode}) vs "
                                       f"Flowgraph over {len(got)} samples",
                                [torch.from_numpy(got).to(dev)], [want])
            bit[label] = bool(np.array_equal(got, want.cpu().numpy()))
        res[str(mode)] = {"launches": launches, "apply_calls": calls,
                          "consumed": pos_l, "retune_at": retune_at,
                          "wall_ms": wall * 1e3, "bit_equal": bit,
                          "err": errs}
        built = "wrap" if mode == 1 else "the descriptors' wrap"
        phase("gr", f"{built}(batch_frames={mode!r}): {GR_CALLS} work calls of "
                    f"{GR_OFFER[0]}..{GR_OFFER[1]}-sample offers, {pos_l} "
                    f"samples through LowPass(49 taps, TD, planar) -> "
                    f"QuadratureDemod, set_taps at sample {retune_at}, "
                    f"{pos_f} through Fft(2048); launches {launches} = "
                    f"apply calls; bit-equal to the Flowgraph {bit}; wall "
                    f"{wall * 1e3:.1f} ms")
    return res


def adapter_timing(torch, dev) -> dict:
    """The wrapped LowPassFilter at the reference's 8192-sample offers,
    per call against batched: the wall time a work call and MSPS, and the
    device's busy time a work call (kernels and copies, from
    ``torch.profiler`` over a window of 256 work calls after 30 ms of
    uncounted ones: ``device_busy_ms``)."""
    import numpy as np

    from clenabled_tpu_torch import blocks, gr_compat

    n = GR_TIME_OFFER * GR_TIME_CALLS
    rng = np.random.default_rng(GR_SEED + 1)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    out = {}
    for mode in (1, "auto"):
        g = gr_compat.wrap(blocks.LowPassFilter(
            1, 1.0, 10e6, 1.5e6, 500e3, use_time=True, planar=True),
            batch_frames=mode, device=dev)
        for _ in range(4):                      # warm-up
            _gr_work(g, [x[:GR_TIME_OFFER]], GR_TIME_OFFER, np.complex64)
        _gr_drain(g, np.complex64)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = 0
        for k in range(GR_TIME_CALLS):
            got += len(_gr_work(g, [x[k * GR_TIME_OFFER:(k + 1)
                                      * GR_TIME_OFFER]], GR_TIME_OFFER,
                                np.complex64)[1])
        got += sum(len(y) for y in _gr_drain(g, np.complex64))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if got != n:
            fail(f"adapter timing ({mode}): {got} of {n} samples out")
        ms = wall / GR_TIME_CALLS * 1e3
        busy_ms = None
        if dev.type == "cuda":
            busy_ms = device_busy_ms(torch, lambda: _gr_work(
                g, [x[:GR_TIME_OFFER]], GR_TIME_OFFER, np.complex64),
                steps=GR_TIME_CALLS)
            _gr_drain(g, np.complex64)
        out[str(mode)] = {"ms_per_call": ms, "msps": n / wall / 1e6,
                          "busy_ms_per_call": busy_ms}
        busy = "not measured" if busy_ms is None else (
            f"{busy_ms:.4f} ms (wall / busy {ms / busy_ms:.1f})")
        phase("gr", f"wrapped LowPass(49 taps, TD, planar), batch_frames="
                    f"{mode!r}: {GR_TIME_CALLS} work calls of "
                    f"{GR_TIME_OFFER}: wall {ms:.4f} ms a call, "
                    f"{n / wall / 1e6:.1f} MSPS; device busy a call {busy}")
    return out


def adapter_sink_check(torch, hk, dev) -> dict:
    """XEngine on IChar bytes (64 stations × 2 pols: the int8 Gram
    kernel) behind ``wrap`` at the automatic depth 2: every matrix
    published after ``stop()``, in order, bit for bit a Flowgraph's; one
    Gram launch an integration."""
    import numpy as np

    from clenabled_tpu_torch import blocks, gr_compat
    from clenabled_tpu_torch.streaming import Flowgraph

    def make():
        return blocks.XEngine(data_type=5, polarization=2,
                              num_inputs=GR_XE_S, num_channels=GR_XE_F,
                              integration=GR_XE_T, planar=True)

    xe = make()
    q = xe.quantum
    g = gr_compat.wrap(xe, in_sig=[np.int8] * GR_XE_S, batch_frames=1,
                       device=dev)
    rng = np.random.default_rng(GR_SEED + 2)
    feeds = [[rng.integers(-128, 128, q, dtype=np.int8)
              for _ in range(GR_XE_S)] for _ in range(GR_XE_INTS)]
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    for fr in feeds:
        if g.general_work(fr, []) != 0:
            fail("a sink produced stream items")
    before = len(g.published)
    g.stop()
    wall = time.perf_counter() - t0
    launches = hk.gram_launches()
    if dev.type == "cuda" and launches != GR_XE_INTS:
        fail(f"wrapped XEngine: {launches} Gram launches for {GR_XE_INTS} "
             f"integrations")
    if before != GR_XE_INTS - 1 or len(g.published) != GR_XE_INTS:
        fail(f"wrapped XEngine published {before} before stop(), "
             f"{len(g.published)} after")
    xr = make()
    fg = Flowgraph()
    for s in range(GR_XE_S):
        fg.external_input(xr, s)
    r = fg.compile(q, device=dev)
    msgs = []
    r.on_message(f"{xr.name}.xcorr", msgs.append)
    for fr in feeds:
        r.step(*(torch.from_numpy(f).to(dev) for f in fr))
    for k, ((port, got), want) in enumerate(zip(g.published, msgs)):
        if port != "xcorr" or bool(got["valid"]) != bool(want["valid"]):
            fail(f"wrapped XEngine message {k}: port {port}, valid "
                 f"{got['valid']}")
        m = got["matrix"]
        if not (np.array_equal(m.real, want["matrix"].re.cpu().numpy())
                and np.array_equal(m.imag,
                                   want["matrix"].im.cpu().numpy())):
            fail(f"wrapped XEngine matrix {k} differs from the Flowgraph's")
    phase("gr", f"wrap(XEngine IChar S={GR_XE_S} P=2 F={GR_XE_F} "
                f"T={GR_XE_T}), depth 2: {before} published before stop(), "
                f"{len(g.published)} after, each bit-equal to the "
                f"Flowgraph's in order; Gram launches {launches}; wall "
                f"{wall * 1e3:.1f} ms")
    return {"launches": launches, "published_before_stop": before,
            "published": len(g.published), "wall_ms": wall * 1e3}


def tools_checks(torch, hk, dev) -> dict:
    """Each CLI tool through its ``main(argv)`` in this process."""
    import tempfile

    import numpy as np

    from clenabled_tpu_torch.tools import (clview, profile, test_clenabled,
                                           test_clfilter, test_clkernel,
                                           test_ingest, test_scaling)

    on_card = dev.type == "cuda"
    out = {"clview": clview.main(list(TOOL_ARGS))["devices"]}
    rows = test_clenabled.main([str(TOOL_BLOCK), "--iterations",
                                str(TOOL_ITERS), "--testcostas", *TOOL_ARGS])
    missing = [r["name"] for r in rows if r["has_kernel"] and
               not r["launches"]]
    if on_card and missing:
        fail(f"test_clenabled rows with a kernel that launched none: "
             f"{missing}")
    launched = sorted({k for r in rows for k in r["launches"]})
    want = ["costas_scalar", "fft_batched_fused", "fir_direct",
            "ofs_filter_planar", "qdemod_fused"]
    if on_card and launched != want:
        fail(f"test_clenabled launched {launched}")
    out["test_clenabled"] = [{k: r[k] for k in ("name", "msps", "launches")}
                             for r in rows]
    here = os.path.dirname(os.path.abspath(__file__))
    out["test_clkernel"] = {}
    for name, fn, flag, ref in (
            ("kernel1to1_multiply_const_float", "multiply_float_const",
             "--float", lambda a: a * np.float32(3.0)),
            ("kernel1to1_sincos", "sincos", "--complex",
             lambda a: (np.sin(a.real) + 1j * np.cos(a.imag)).astype(
                 np.complex64))):
        rec = test_clkernel.main([
            f"--kernelfile={here}/clenabled_tpu_torch/examples/{name}.py",
            f"--fnname={fn}", "--1to1", flag, str(TOOL_BLOCK),
            "--iterations", str(TOOL_ITERS), *TOOL_ARGS])
        err = float(np.abs(rec["output"] - ref(rec["inputs"][0])).max())
        if not err <= 1e-5:
            fail(f"test_clkernel {fn}: max abs err {err} against numpy")
        out["test_clkernel"][fn] = {"msps": rec["msps"], "err": err}
    out["test_clfilter"] = {}
    for flags in (["--percall"], []):
        hk.reset_launch_counts()
        rows = test_clfilter.main(["--iterations", str(TOOL_ITERS), *flags,
                                   *TOOL_ARGS])
        counts = {k: hk.launch_counts()[k] for k in ("fir_direct",
                                                     "ofs_filter_planar")}
        if on_card and min(counts.values()) < TOOL_ITERS:
            fail(f"test_clfilter {flags}: launches {counts}")
        out["test_clfilter"][" ".join(flags) or "complex64"] = {
            "rows": [{k: r[k] for k in ("name", "msps")} for r in rows],
            "launches": counts}
    with tempfile.TemporaryDirectory(prefix="clen_tools_") as tmp:
        prof = profile.main(["--steps", "3", "--samples-per-step",
                             str(PROFILE_N), "--outdir", tmp, *TOOL_ARGS])
        if on_card and not any("fx_reg_kernel" in n for n, _ in prof["top"]):
            fail(f"profile: fx_reg_kernel is not among {prof['top']}")
        out["profile"] = prof["top"]
        out["test_ingest"] = test_ingest.main([
            "--steps", "6", "--dtype", "int8", "--samples-per-step",
            str(INGEST_LOG2), *TOOL_ARGS])
        p4 = test_ingest.main(["--packed4", "--samples-per-step",
                               str(INGEST_LOG2), "--outdir",
                               os.path.join(tmp, "p4"), *TOOL_ARGS])["packed4"]
        files = sorted(os.listdir(os.path.join(tmp, "p4")))
        if p4["events"] != [("sync", 4), ("resync", 5, 6)]:
            fail(f"test_ingest --packed4: events {p4['events']}")
        bins = [f for f in files if f.endswith(".bin")]
        if not bins or len(files) != 2 * len(bins):
            fail(f"test_ingest --packed4: the writer left {files}")
        out["test_ingest_packed4"] = {k: p4[k] for k in (
            "events", "e2e_ms", "e2e_msps", "wire_gbs", "files",
            "writer_bytes", "write_s")}
    sc = test_scaling.main(["--devices", "1", "--samples-per-chip",
                            str(SCALING_SPC), "--iterations", "10",
                            *TOOL_ARGS])
    sx = test_scaling.main(["--devices", "1", "--xengine",
                            "--stations-per-chip", "64", *TOOL_ARGS])
    if on_card:
        fx_l = sc["rows"][0]["launches"][0]
        if fx_l != {d: {"fx_correlate_streams_v2": 2} for d in
                    ("float32", "int8")}:
            fail(f"test_scaling: launches {fx_l}")
        if sx["rows"][0]["launches"][0].get("xengine_gram_stacked_tri") != 1:
            fail(f"test_scaling --xengine: launches "
                 f"{sx['rows'][0]['launches'][0]}")
    out["test_scaling"] = sc["rows"]
    out["test_scaling_xengine"] = sx["rows"]
    return out


def gr_tools_phase(torch, hk, dev) -> dict:
    """Phase 15: the native runtime, the GNU Radio adapter on stream
    blocks and on a sink, and the CLI tools, each failing the run."""
    phase("gr", "GNU Radio is not installed here: a minimal stand-in "
                "gnuradio.gr.basic_block and pmt carry the adapter")
    t0 = time.perf_counter()
    names = gr_stand_in()
    try:
        res = {"native": native_checks(torch, dev),
               "stream": adapter_stream_checks(torch, hk, dev),
               "timing": adapter_timing(torch, dev),
               "sink": adapter_sink_check(torch, hk, dev)}
    finally:
        for name in names:
            sys.modules.pop(name, None)
    res["adapter_s"] = time.perf_counter() - t0
    res["tools"] = tools_checks(torch, hk, dev)
    res["phase_s"] = time.perf_counter() - t0
    phase("gr", f"phase 15 in {res['phase_s']:.1f} s (adapter and native "
                f"{res['adapter_s']:.1f} s)")
    return res


# the example scripts: the ingest run's seconds, and the flags added to every
# card run (["--cpu"] rehearses phase 16 on the CPU)
EX_INGEST_S = 2.0
EX_ARGS: list = []


def example_run(torch, hk, name: str, mod, argv) -> tuple:
    """One example script's ``main(argv)`` on the phase's device, its
    launches counted: (record, wall s, launches)."""
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    rec = mod.main([*argv, *EX_ARGS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in hk.launch_counts().items() if v}
    phase("examples", f"{name}: {wall:.2f} s wall, launches {counts}")
    return rec, wall, counts


def example_flagship(torch, hk, dev, flagship) -> dict:
    """The flagship on its fused step: one ``fx_correlate_streams_v2``
    launch a step, ant2-ant0 the strongest cross baseline, and the last
    step held to the plain form on the same inputs and tails."""
    rec, wall, counts = example_run(torch, hk, "flagship", flagship, [])
    if dev.type == "cuda" and counts != {"fx_correlate_streams_v2":
                                         rec["steps"]}:
        fail(f"flagship: launches {counts}, {rec['steps']} steps")
    if rec["baseline"] != (2, 0):
        fail(f"flagship: strongest cross baseline {rec['baseline']}")
    fn, n = rec["step"], rec["samples_per_step"]
    fd_sum, gram = hk.fx_correlate_streams_v2_plain(*rec["last_step"],
                                                    fn.taps_rm, A, M)
    want = (torch.roll(fd_sum / (n // M), M // 2, dims=-1),
            gram[:, :M].T[:, :, None], gram[:, M:].T[:, :, None])
    got = [torch.as_tensor(rec[k], device=dev) for k in ("fd", "xre", "xim")]
    err = check(torch, f"flagship last step [{A}x{n}] vs "
                       f"fx_correlate_streams_v2_plain", got, want)
    return {"wall_s": wall, "launches": counts, "steps": rec["steps"],
            "msps": rec["msps"], "step_ms": rec["step_s"] * 1e3,
            "samples_per_step": n, "err": err}


def example_ingest(torch, hk, dev, streaming_ingest) -> dict:
    """The ring → unpack → LowPass → demod chain for ``EX_INGEST_S``: one
    ``fir_direct`` and one ``qdemod_fused`` launch a frame; the last
    frame's filtered stream held to ``fir_direct_plain`` from the previous
    frame's history, and its audio to ``qdemod_fused_plain`` of the path's
    own filtered stream (an angle's error is the filter's over the
    sample's magnitude, so the stages are held apart)."""
    from clenabled_tpu_torch import native
    from clenabled_tpu_torch.dsp import planar

    rec, wall, counts = example_run(torch, hk, "streaming_ingest",
                                    streaming_ingest,
                                    ["--seconds", str(EX_INGEST_S)])
    nf = rec["frames"]
    if nf < 2:
        fail(f"streaming_ingest: {nf} frames")
    if dev.type == "cuda" and counts != {"fir_direct": nf,
                                         "qdemod_fused": nf}:
        fail(f"streaming_ingest: launches {counts}, {nf} frames")
    taps = torch.as_tensor(rec["taps"], device=dev)
    k = taps.numel()

    def planes(raw):
        return [torch.as_tensor(c, device=dev)
                for c in native.unpack_4bit_planar(raw)]

    (pr, pi), (lr, li) = (planes(raw) for raw in rec["raws"])
    (fpr, fpi), (flr, fli) = ([torch.as_tensor(c, device=dev) for c in f]
                              for f in rec["filtered"])
    want = hk.fir_direct_plain(planar.PC(lr, li), taps,
                               history=planar.PC(pr[-(k - 1):],
                                                 pi[-(k - 1):]))
    err = check(torch, f"streaming_ingest last frame ({rec['frame']}) "
                       f"filtered vs fir_direct_plain", [flr, fli],
                [want.re, want.im])
    audio = torch.as_tensor(rec["audio"], device=dev)
    want = hk.qdemod_fused_plain(flr, fli, fpr[-1:], fpi[-1:], 1.0)
    err_qd = check(torch, "streaming_ingest last frame audio vs "
                          "qdemod_fused_plain", [audio], [want])
    return {"wall_s": wall, "launches": counts, "frames": nf,
            "frame": rec["frame"], "msps": rec["msps"],
            "run_wall_s": rec["wall_s"], "drain_s": rec["drain_s"],
            "fir_err": err, "qd_err": err_qd}


def example_xengine_sync(torch, hk, dev, xengine_synchronized) -> dict:
    """The synchronised IChar X-Engine: the sync and resync windows as
    planned, one int8 Gram launch an aligned window, and every emission
    bit-equal to ``xengine_gram_stacked_plain`` of its windows (lanes
    zero-padded as the kernel ran them), scaled and summed as the engine
    does."""
    import shutil

    import numpy as np

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import planar
    from clenabled_tpu_torch.dsp import xengine as X

    rec, wall, counts = example_run(torch, hk, "xengine_synchronized",
                                    xengine_synchronized, [])
    shutil.rmtree(rec["outdir"], ignore_errors=True)
    nw, pipe = len(rec["windows"]), rec["pipeline_integration"]
    if rec["events"] != [("sync", 4), ("resync", 13, 16)]:
        fail(f"xengine_synchronized: events {rec['events']}")
    if rec["baselines"] != [(2, 0)] * 4 or len(rec["files"]) != 2:
        fail(f"xengine_synchronized: baselines {rec['baselines']}, files "
             f"{rec['files']}")
    if dev.type == "cuda" and counts != {"xengine_gram_stacked_tri": nw}:
        fail(f"xengine_synchronized: launches {counts}, {nw} windows")
    f, t, sp = rec["shape"]
    s, p = sp // 2, 2
    xe = blocks.XEngine(data_type=5, polarization=p, num_inputs=s,
                        num_channels=f, integration=t, planar=True)
    scale = np.float32(1.0 / 127.0 ** 2)
    zero = torch.zeros((f, X.num_baselines(s), p * p), device=dev)
    acc = planar.PC(zero, zero)
    for k, window in enumerate(rec["windows"][:len(rec["matrices"]) * pipe]):
        zr, zi = (torch.nn.functional.pad(z, (0, -sp % 128)) for z in
                  xe._decode_int([torch.as_tensor(w, device=dev)
                                  for w in window]))
        a, b = hk.xengine_gram_stacked_plain(zr, zi)
        a, b = a[:, :sp, :sp], b[:, :sp, :sp]
        tri = X._triangular(planar.PC(a.float() * scale,
                                      (b - b.mT).float() * scale), s, p)
        acc = planar.PC(acc.re + tri.re, acc.im + tri.im)
        if (k + 1) % pipe == 0:
            mat = rec["matrices"][k // pipe]
            if not (np.array_equal(acc.re.cpu().numpy(), mat.real)
                    and np.array_equal(acc.im.cpu().numpy(), mat.imag)):
                fail(f"xengine_synchronized: emission {k // pipe} differs "
                     f"from xengine_gram_stacked_plain")
            acc = planar.PC(zero, zero)
    phase("check", f"xengine_synchronized: {len(rec['matrices'])} emissions "
                   f"of {pipe} windows [F={f}, T={t}, S·P={sp}] bit-equal to "
                   f"xengine_gram_stacked_plain")
    return {"wall_s": wall, "launches": counts, "windows": nw,
            "emissions": len(rec["matrices"]), "events": rec["events"]}


def examples_phase(torch, hk, dev) -> dict:
    """Phase 16: the root example scripts' twins through their ``main`` at
    their default sizes, each counted; the three with kernels held to the
    plain forms, the others to their own ``--cpu`` runs."""
    import shutil

    import numpy as np

    from clenabled_tpu_torch.examples import (fft_xcorr, flagship,
                                              fm_receiver, streaming_ingest,
                                              xcorr_max_rate, xcorr_test,
                                              xengine_demo,
                                              xengine_synchronized)

    t0 = time.perf_counter()
    res = {"flagship": example_flagship(torch, hk, dev, flagship),
           "streaming_ingest": example_ingest(torch, hk, dev,
                                              streaming_ingest),
           "xengine_synchronized": example_xengine_sync(
               torch, hk, dev, xengine_synchronized)}
    # the kernel-free scripts: (name, module, card argv, CPU argv, outputs);
    # the correlator's rate run takes one frame of the same signals on the CPU
    plain = (("fft_xcorr", fft_xcorr, [], [], ("corr",)),
             ("fm_receiver", fm_receiver, [], [], ("audio",)),
             ("xcorr_test", xcorr_test, [], [], ("corr", "corrvect")),
             ("xcorr_max_rate", xcorr_max_rate, [], ["--frames", "1"],
              ("corr", "corr_vectors")),
             ("xengine_demo", xengine_demo, [], [], ("matrices",)))
    for name, mod, argv, cpu_argv, keys in plain:
        rec, wall, counts = example_run(torch, hk, name, mod, argv)
        ref = mod.main([*cpu_argv, "--cpu"])
        for r in (rec, ref):
            if "outdir" in r:
                shutil.rmtree(r["outdir"], ignore_errors=True)
        if dev.type == "cuda" and counts:
            fail(f"{name} launched {counts}; its path runs no kernel")
        err = check(torch, f"{name} on {dev.type} vs its --cpu run",
                    [torch.as_tensor(np.asarray(rec[k])) for k in keys],
                    [torch.as_tensor(np.asarray(ref[k])) for k in keys])
        res[name] = {"wall_s": wall, "launches": counts, "err": err}
        if "msps" in rec:
            res[name]["msps"] = rec["msps"]
        for k, want in (("delay", 25), ("lags", [-37] * 4),
                        ("baselines", [(2, 0)] * 3)):
            if k in rec and rec[k] != want:
                fail(f"{name}: {k} {rec[k]}, expected {want}")
            if k in ref and ref[k] != want:
                fail(f"{name} --cpu: {k} {ref[k]}, expected {want}")
        if "lag" in rec and not np.array_equal(rec["lag"], ref["lag"]):
            fail(f"{name}: lags {rec['lag']} on the card, {ref['lag']} on "
                 f"the CPU")
    res["phase_s"] = time.perf_counter() - t0
    phase("examples", "rates: " + ", ".join(
        f"{k} {v['msps']:.1f} MSPS" for k, v in res.items()
        if isinstance(v, dict) and "msps" in v))
    phase("examples", f"phase 16 in {res['phase_s']:.1f} s")
    return res


# --------------------------------------------------------------------------
# Phase 17: the vectorised K-frame dispatch
# --------------------------------------------------------------------------

VEC_N, VEC_FFT = 8192, 2048        # the GR-buffer frame; the Fft block's size
VEC_REPS = 2                       # timed dispatches a form
VEC_BUSY_FRAMES = 32               # single-frame steps traced for the loop
VEC_GR_BATCHES = 4                 # the adapter's batches of auto K frames


def vec_times(torch, label: str, fn, per: int, what: str,
              frame_fn=None) -> dict:
    """Wall and device busy time of ``fn`` (a dispatch of ``per`` frames, or
    a run of work calls), after one warm-up call.  Given ``frame_fn``, one
    frame of a loop, the busy time is its own over VEC_BUSY_FRAMES calls
    times ``per``: a trace of a whole 512-frame loop holds every torch
    call of its frames as a host event, and the profiler's bookkeeping of
    them takes seconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(VEC_REPS):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / VEC_REPS * 1e3
    if frame_fn is None:
        busy_ms = device_busy_ms(torch, fn, steps=1)
    else:
        busy_ms = device_busy_ms(torch, frame_fn, steps=VEC_BUSY_FRAMES)
        busy_ms = None if busy_ms is None else busy_ms * per
    busy = "not measured" if busy_ms is None else f"{busy_ms:.4f} ms"
    phase("vectorised", f"{label}: wall {wall_ms:.4f} ms a {what} "
                        f"({per} frames of {VEC_N}), device busy {busy} "
                        f"a {what}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def vectorised_graphs(torch, hk, dev) -> dict:
    """(a) Fft(2048, blackman_harris, shift) → MultiplyConst(2) →
    ComplexToMag fed planar 8192-sample frames at auto K: the vectorised
    dispatch (one ``fft_batched_fused`` launch) bit-equal to the loop (K
    launches) and within 1e-4 × max of the plain chain; (b)
    XCorrelateFFTVCF(8192, 2) at auto K: the vectorised dispatch within
    1e-4 × max|loop| of the loop.  Both forms timed."""
    import numpy as np

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import planar, window
    from clenabled_tpu_torch.streaming import Flowgraph

    win = window.blackman_harris(VEC_FFT)
    rng = np.random.default_rng(17)

    def spectrum(vectorize, k):
        fft = blocks.Fft(VEC_FFT, window=win, shift=True)
        mc, mag = blocks.MultiplyConst(2.0), blocks.ComplexToMag()
        g = Flowgraph()
        g.external_input(fft)
        g.connect(fft, mc)
        g.connect(mc, mag)
        g.tap(mag, name="mag")
        return g.compile(VEC_N, k, vectorize=vectorize, device=dev)

    def xcorr(vectorize, k):
        xc = blocks.XCorrelateFFTVCF(VEC_N, 2)
        g = Flowgraph()
        for p in range(2):
            g.external_input(xc, p)
        g.tap(xc, name="corr")
        return g.compile(VEC_N, k, vectorize=vectorize, device=dev)

    def feed(k):
        return planar.PC(*(rng.standard_normal((k, VEC_N), np.float32)
                           for _ in range(2)))

    res = {}
    for name, make, ports in (("spectrum", spectrum, 1),
                              ("xcorrelate_fft_vcf", xcorr, 2)):
        # the vectorised form at auto K; the loop pinned to the same K (its
        # own auto K would be 2^21 samples, not 2^22)
        runners = {True: make(True, "auto")}
        k = runners[True].steps_per_dispatch
        runners[False] = make(False, k)
        if not runners[True]._vectorized() or runners[False]._vectorized():
            fail(f"{name}: the dispatch forms are not the ones asked for")
        feeds = [feed(k) for _ in range(ports)]
        outs, launches, times = {}, {}, {}
        for v, r in runners.items():
            form = "vectorised" if v else "loop"
            hk.reset_launch_counts()
            outs[form] = r.step(*feeds)
            torch.cuda.synchronize()
            launches[form] = hk.fft_batched_fused.launches
            frame = tuple(planar.PC(f.re[0], f.im[0]) for f in feeds)
            times[form] = vec_times(
                torch, f"{name} {form}", lambda r=r: r.step(*feeds), k,
                "dispatch", None if v else lambda r=r: r._dispatch([frame]))
        tap = "mag" if name == "spectrum" else "corr"
        got, loop = outs["vectorised"][tap], outs["loop"][tap]
        if tuple(got.shape) != (k, VEC_N) or not bool(
                torch.isfinite(got).all()):
            fail(f"{name}: vectorised output {tuple(got.shape)} is not "
                 f"finite [{k}, {VEC_N}]")
        bit = bool(torch.equal(got, loop))
        rec = {"k": k, "launches": launches, "bit_equal": bit,
               "times": times}
        if name == "spectrum":
            if launches != {"vectorised": 1, "loop": k}:
                fail(f"spectrum: fft_batched_fused launches {launches}, "
                     f"expected 1 vectorised and {k} in the loop")
            if not bit:
                fail("spectrum: the vectorised dispatch is not bit-equal to "
                     "the loop")
            x = [torch.as_tensor(a, device=dev).reshape(-1)
                 for a in feeds[0]]
            y = planar.PC(*hk.fft_batched_fused_plain(*x, VEC_FFT, False,
                                                      win, True))
            want = planar.pabs(planar.scale(y, 2.0)).reshape(k, VEC_N)
            rec["err"] = check(torch, f"spectrum vectorised [{k}, {VEC_N}] "
                                      f"vs the plain chain", [got], [want])
            # the kernel alone at the dispatch's shape
            args = (*x, VEC_FFT, False,
                    torch.as_tensor(win, device=dev), True)
            rec["kernel_ms"] = (device_busy_ms(
                torch, lambda: hk.fft_batched_fused(*args), 10)
                or time_ms(torch, lambda: hk.fft_batched_fused(*args)))
            rec["kernel_bound"] = fft_bound(k * VEC_N, VEC_FFT, True)
            phase("time", f"fft_batched {VEC_FFT} window shift "
                          f"[{k * VEC_N}] (one vectorised dispatch): device "
                          f"kernel {rec['kernel_ms']:.4f} ms, bound "
                          f"{rec['kernel_bound'][0]:.4f} ms")
        else:
            rec["err"] = check(torch, f"xcorrelate_fft_vcf vectorised [{k}, "
                                      f"{VEC_N}] vs the loop", [got], [loop])
        phase("vectorised", f"{name} at auto K = {k}: fft_batched_fused "
                            f"launches {launches}; vectorised bit-equal to "
                            f"the loop: {bit}")
        res[name] = rec
        del runners, feeds, outs, got, loop
    return res


def vectorised_adapter(torch, hk, dev) -> dict:
    """(c) The wrapped Fft(2048, blackman_harris, shift, planar) under the
    stand-in GNU Radio at 8192-sample offers, batched at auto K against
    per call: one launch a batch, the streams bit-equal; both timed."""
    import numpy as np

    from clenabled_tpu_torch import blocks, gr_compat
    from clenabled_tpu_torch.dsp import window

    win = window.blackman_harris(VEC_FFT)
    gs = {mode: gr_compat.wrap(blocks.Fft(VEC_FFT, window=win, shift=True,
                                          planar=True),
                               batch_frames=mode, device=dev)
          for mode in ("auto", 1)}
    k = min(64, (1 << 21) // VEC_N)         # the adapter's automatic K
    calls = VEC_GR_BATCHES * k
    rng = np.random.default_rng(18)
    x = (rng.standard_normal(calls * VEC_N)
         + 1j * rng.standard_normal(calls * VEC_N)).astype(np.complex64)
    outs, launches, times = {}, {}, {}
    for mode, g in gs.items():
        hk.reset_launch_counts()
        ys = [_gr_work(g, [x[j * VEC_N:(j + 1) * VEC_N]], VEC_N,
                       np.complex64)[1] for j in range(calls)]
        ys += _gr_drain(g, np.complex64)
        torch.cuda.synchronize()
        launches[str(mode)] = (hk.fft_batched_fused.launches, g.apply_calls)
        outs[str(mode)] = np.concatenate(ys)

        def work(g=g):
            for j in range(k):
                _gr_work(g, [x[j * VEC_N:(j + 1) * VEC_N]], VEC_N,
                         np.complex64)
        t = vec_times(torch, f"wrapped Fft batch_frames={mode!r}", work, k,
                      f"run of {k} work calls")
        times[str(mode)] = {key: None if v is None else v / k
                            for key, v in t.items()}
        _gr_drain(g, np.complex64)
    if launches != {"auto": (VEC_GR_BATCHES, VEC_GR_BATCHES),
                    "1": (calls, calls)}:
        fail(f"wrapped Fft: (launches, apply calls) {launches}, expected "
             f"one a batch of {k} batched and one a call per call")
    if len(outs["auto"]) != len(x):
        fail(f"wrapped Fft: {len(outs['auto'])} of {len(x)} samples out")
    bit = bool(np.array_equal(outs["auto"], outs["1"]))
    if not bit:
        fail("wrapped Fft: the batched stream is not bit-equal to the "
             "per-call stream")
    phase("vectorised", f"wrapped Fft({VEC_FFT}) at {VEC_N}-sample offers: "
                        f"(launches, apply calls) {launches}; batched "
                        f"bit-equal to per call; a work call: " + ", ".join(
                            f"{m} wall {t['wall_ms']:.4f} ms busy "
                            + ("not measured" if t["busy_ms"] is None
                               else f"{t['busy_ms']:.4f} ms")
                            for m, t in times.items()))
    return {"k": k, "launches": launches, "bit_equal": bit,
            "per_work_call": times}


def vectorised_phase(torch, hk, dev) -> dict:
    """Phase 17: the vectorised K-frame dispatch of all-stateless Runner
    graphs and of a stateless block behind the GNU Radio adapter."""
    t0 = time.perf_counter()
    res = vectorised_graphs(torch, hk, dev)
    names = gr_stand_in()
    try:
        res["adapter"] = vectorised_adapter(torch, hk, dev)
    finally:
        for name in names:
            sys.modules.pop(name, None)
    res["phase_s"] = time.perf_counter() - t0
    phase("vectorised", f"phase 17 in {res['phase_s']:.1f} s")
    return res


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "clenabled_tpu_torch")):
        fail("the clenabled_tpu_torch package is not beside this script")
    sys.path.insert(0, here)
    from clenabled_tpu_torch import _build
    from clenabled_tpu_torch import pipelines as P
    from clenabled_tpu_torch.dsp import hopper_kernels as hk
    from clenabled_tpu_torch.runtime.device import card_info, require_hopper
    from clenabled_tpu_torch.streaming import HostIngest

    # 1. card
    dev = torch.device(*DEVICE)
    require_hopper(dev)
    card = card_info()
    print(card, flush=True)
    phase("card", f"{torch.cuda.get_device_name(0)} | torch {torch.__version__}"
                  f" | CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.load(verbose=True)
    phase("build", f"{len(_build.sources())} sources -> "
                   f"{os.path.basename(_build.last_build['path'])} in "
                   f"{time.perf_counter() - t0:.1f} s")
    for line in _build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            phase("ptxas", line.strip())
    gram_ptxas = ptxas_summary(_build.last_build["log"],
                               ("gram_int8_diag_kernel",
                                "gram_int8_quad_kernel"))
    for name, info in gram_ptxas.items():
        phase("ptxas", f"{name}: {info}")
    os_ptxas = ptxas_summary(_build.last_build["log"],
                             ("pfb_os_reg_kernel", "pfb_os_wide_kernel",
                              "pfb_os_kernel"))
    for name, info in os_ptxas.items():
        phase("ptxas", f"{name}: {info}")
    for m in hk.OS_WIDE_M:
        for ell in hk.OS_WIDE_L:
            reg = os_ptxas.get(f"pfb_os_wide_kernel<{m}, {ell}>", {})
            if "registers" not in reg or reg.get("spill_stores") or reg.get(
                    "spill_loads"):
                fail(f"pfb_os_wide_kernel<{m}, {ell}>: ptxas reports "
                     f"{reg or 'nothing'}")
    fir_ptxas = ptxas_summary(_build.last_build["log"],
                              ("fir_direct_kernel", "fir_reg_kernel"))
    for name, info in fir_ptxas.items():
        phase("ptxas", f"{name}: {info}")
    reg = fir_ptxas.get("fir_reg_kernel", {})
    if "registers" not in reg or reg.get("spill_stores") or reg.get(
            "spill_loads"):
        fail(f"fir_reg_kernel: ptxas reports {reg or 'nothing'}")
    costas_ptxas = ptxas_summary(_build.last_build["log"],
                                 ("costas_kernel", "costas_lanes_kernel"))
    for name, info in costas_ptxas.items():
        phase("ptxas", f"{name}: {info}")
    for o in (2, 4):
        for h in ("true", "false"):
            reg = costas_ptxas.get(f"costas_lanes_kernel<{o}, {h}>", {})
            if "registers" not in reg or reg.get("spill_stores") or reg.get(
                    "spill_loads"):
                fail(f"costas_lanes_kernel<{o}, {h}>: ptxas reports "
                     f"{reg or 'nothing'}")
    pk_ptxas = ptxas_summary(_build.last_build["log"],
                             ("pfb_packed_kernel", "pfb_packed_reg_kernel",
                              "pfb_packed_wide_kernel"))
    for name, info in pk_ptxas.items():
        phase("ptxas", f"{name}: {info}")
    for name in ([f"pfb_packed_reg_kernel<{m}>" for m in hk.PFB_REG_M]
                 + [f"pfb_packed_wide_kernel<{m}>" for m in hk.PFB_WIDE_M]):
        reg = pk_ptxas.get(name, {})
        if "registers" not in reg or reg.get("spill_stores") or reg.get(
                "spill_loads"):
            fail(f"{name}: ptxas reports {reg or 'nothing'}")
    fx_ptxas = ptxas_summary(_build.last_build["log"],
                             ("fx_reg_kernel", "fx_wide_kernel",
                              "fx_tile_kernel"))
    for name, info in fx_ptxas.items():
        phase("ptxas", f"{name}: {info}")
    for m in hk.FX_WIDE_M:
        for t in PTXAS_TYPES.values():
            reg = fx_ptxas.get(f"fx_wide_kernel<{t}, {m}>", {})
            if "registers" not in reg or reg.get("spill_stores") or reg.get(
                    "spill_loads"):
                fail(f"fx_wide_kernel<{t}, {m}>: ptxas reports "
                     f"{reg or 'nothing'}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    cfg = P.FxPipelineConfig(num_antennas=A, num_channels=M,
                             samples_per_step=N_FULL)
    taps_rm, ntaps = P._prototype(M, 100e6)
    taps = torch.as_tensor(taps_rm, device=dev)

    # 3. kernels against their plain forms
    errs = {"fx": 0.0, "pfb": 0.0}
    times = {}
    fx_cases = [("f32", torch.float32, N_FULL, None, None, None),
                ("bf16", torch.bfloat16, N_FULL, None, None, None),
                ("int8", torch.int8, N_FULL, None, None, None),
                ("f32 pairs", torch.float32, N_FULL, None, [(0, 3), (2, 2)],
                 [(0, 1), (3, 3), (2, 0)]),
                ("f32 1600 taps", torch.float32, N_FULL, 1600, None, None)]
    import numpy as np
    for label, dt, n, deep, fdp, xep in fx_cases:
        if deep:
            proto = (np.sinc(np.linspace(-4, 4, deep))
                     * np.hanning(deep)).astype(np.float32)
            t_rm, nt = P._prototype(M, 100e6, proto)
            tk = torch.as_tensor(t_rm, device=dev)
        else:
            tk, nt = taps, ntaps
        h = hk.fx_tail_len(dt, M, nt)
        xr, xi = (frames(torch, gen, dt, (A, n), dev) for _ in range(2))
        tr, ti = (frames(torch, gen, dt, (A, h), dev) for _ in range(2))
        args = (xr, xi, tr, ti, tk, A, M)
        kw = dict(fd_pairs=fdp, xe_pairs=xep)
        got = hk.fx_correlate_streams_v2(*args, **kw)
        torch.cuda.synchronize()
        want = hk.fx_correlate_streams_v2_plain(*args, **kw)
        errs["fx"] = max(errs["fx"], check(
            torch, f"fx_correlate {label} [{A}x{n}, H={h}, W={tk.shape[0]}]",
            got, want))
        if label in ("f32", "bf16", "int8"):
            times[f"fx {label}"] = (
                time_ms(torch, lambda: hk.fx_correlate_streams_v2(*args)),
                time_ms(torch, lambda: hk.fx_correlate_streams_v2_plain(*args),
                        reps=3, warmup=1))
            phase("time", f"fx_correlate {label}: kernel "
                          f"{times[f'fx {label}'][0]:.3f} ms, plain "
                          f"{times[f'fx {label}'][1]:.3f} ms")
        del xr, xi, tr, ti, got, want
    pk = pfb_packed_phase(torch, hk, gen, dev)
    errs["pfb"] = pk["err"]
    hl = taps.shape[0] * M - 1
    comps = torch.randn((2 * A, N_FULL), generator=gen, device=dev)
    hist = torch.randn((2 * A, hl), generator=gen, device=dev)
    got = hk.fx_correlate_streams(comps, hist, taps, A, M)
    torch.cuda.synchronize()
    errs["fx1"] = check(torch, f"fx_correlate_streams [{2 * A}x{N_FULL}, "
                               f"hist {hl}]", got,
                        hk.fx_correlate_streams_plain(comps, hist, taps, A, M))
    times["fx1"] = (
        time_ms(torch, lambda: hk.fx_correlate_streams(comps, hist, taps, A, M)),
        time_ms(torch, lambda: hk.fx_correlate_streams_plain(
            comps, hist, taps, A, M), reps=3, warmup=1))
    phase("time", f"fx_correlate_streams: kernel {times['fx1'][0]:.3f} ms, "
                  f"plain {times['fx1'][1]:.3f} ms")
    del comps, hist, got
    fx_wide = {f"{m}ch {str(dt).removeprefix('torch.')}":
               fx_wide_times(torch, hk, P, gen, dev, m, dt)
               for m in FX_WIDE_M
               for dt in (torch.float32, torch.bfloat16, torch.int8)}
    errs["fx"] = max([errs["fx"]] + [r["err"] for r in fx_wide.values()])
    gram_res = gram_phase(torch, hk, gen, dev)

    # 4. the main path, counted
    runs = {}
    fused = {}
    for label, dt in (("f32", torch.float32), ("int8", torch.int8)):
        fused[label] = P.make_fx_pipeline_fused(cfg, in_dtype=dt, device=dev)
        fn, (_, _, tr0, ti0) = fused[label]
        runs[label] = ([(frames(torch, gen, dt, (A, N_FULL), dev),
                         frames(torch, gen, dt, (A, N_FULL), dev))
                        for _ in range(STEPS)], tr0, ti0)
    ecfg = P.FxPipelineConfig(num_antennas=A, num_channels=M,
                              samples_per_step=N_ENTRY)
    planar_fn, (_, _, ph0, pi0) = P.make_fx_pipeline_planar(ecfg, device=dev)
    planar_frames = [(torch.randn((A, N_ENTRY), generator=gen, device=dev),
                      torch.randn((A, N_ENTRY), generator=gen, device=dev))
                     for _ in range(STEPS)]
    torch.cuda.synchronize()

    hk.reset_launch_counts()
    outs = {}
    for label, (fr, tr, ti) in runs.items():
        fn = fused[label][0]
        outs[label] = []
        for xr, xi in fr:
            o = fn(xr, xi, tr, ti)
            outs[label].append(o)
            tr, ti = o[3], o[4]
    hr, hi = ph0, pi0
    outs["planar"] = []
    for xr, xi in planar_frames:
        o = planar_fn(xr, xi, hr, hi)
        outs["planar"].append(o)
        hr, hi = o[3], o[4]
    torch.cuda.synchronize()
    launches = {"fx": hk.fx_correlate_streams_v2.launches,
                "pfb": hk.pfb_channelize_packed.launches}
    phase("main", f"fused step {A}x{N_FULL} f32 and int8, {STEPS} steps "
                  f"each; planar step {A}x{N_ENTRY}, {STEPS} steps; launches "
                  f"{launches}")
    if launches["fx"] < 1 or launches["pfb"] < 1:
        fail(f"a kernel of the main path was not launched: {launches}")
    planar = planar_step_times(torch, planar_fn, planar_frames, ph0, pi0,
                               pk["shapes"]["entry"]["ms"],
                               "pfb_packed_reg_kernel")

    for label, (fr, tr, ti) in runs.items():
        fn = fused[label][0]
        for k, (xr, xi) in enumerate(fr):
            fd_sum, gram = hk.fx_correlate_streams_v2_plain(
                xr, xi, tr, ti, fn.taps_rm, A, M)
            want = (torch.roll(fd_sum / (N_FULL // M), M // 2, dims=-1),
                    gram[:, :M].T[:, :, None], gram[:, M:].T[:, :, None])
            got = outs[label][k]
            check(torch, f"fused {label} step {k}", got[:3], want)
            h = fn.tail_len
            if not (torch.equal(got[3], xr[:, -h:])
                    and torch.equal(got[4], xi[:, -h:])):
                fail(f"fused {label} step {k}: carried tail is wrong")
            tr, ti = got[3], got[4]
    planar_fn.use_kernel = False
    hr, hi = ph0, pi0
    for k, (xr, xi) in enumerate(planar_frames):
        want = planar_fn(xr, xi, hr, hi)
        check(torch, f"planar step {k}", outs["planar"][k][:3], want[:3])
        hr, hi = want[3], want[4]

    # additivity: two chained frames == one doubled frame from the same tail
    fr, tr, ti = runs["f32"]
    (x1r, x1i), (x2r, x2i) = fr[0], fr[1]
    h = fused["f32"][0].tail_len
    s1 = hk.fx_correlate_streams_v2(x1r, x1i, tr, ti, taps, A, M)
    s2 = hk.fx_correlate_streams_v2(x2r, x2i, x1r[:, -h:].contiguous(),
                                    x1i[:, -h:].contiguous(), taps, A, M)
    both = hk.fx_correlate_streams_v2(torch.cat([x1r, x2r], -1),
                                      torch.cat([x1i, x2i], -1), tr, ti,
                                      taps, A, M)
    check(torch, "additivity (2 chained steps vs 1 doubled frame)",
          [s1[0] + s2[0], s1[1] + s2[1]], list(both))

    # the fused step against the complex64 torch.fft pipeline, small input
    n_small = 1 << 14
    scfg = P.FxPipelineConfig(num_antennas=A, num_channels=M,
                              samples_per_step=n_small)
    sfn, (_, _, st0, _) = P.make_fx_pipeline_fused(scfg, device=dev)
    cfn, (_, hist0) = P.make_fx_pipeline(scfg, device=dev)
    h = st0.shape[-1]
    vr = torch.randn((A, h + n_small), generator=gen, device=dev)
    vi = torch.randn((A, h + n_small), generator=gen, device=dev)
    got = sfn(vr[:, h:], vi[:, h:], vr[:, :h], vi[:, :h])
    v = torch.complex(vr, vi)
    hl = hist0.shape[-1]
    fd_c, xm_c, _ = cfn(v[:, hl:hl + n_small], v[:, :hl])
    check(torch, "fused vs complex64 pipeline (2^14)",
          [got[0], torch.complex(got[1], got[2])], [fd_c, xm_c])
    del runs, outs, fr
    torch.cuda.empty_cache()
    # the fused step at 64 channels, counted on its own
    fx_path = fx_wide_path(torch, hk, P, gen, dev)
    errs["fx"] = max(errs["fx"], fx_path["err"])
    torch.cuda.empty_cache()
    # the planar step at 64 channels, counted on its own
    pk_path = planar_wide_path(
        torch, hk, P, gen, dev, pk["shapes"][f"M={PFB_PATH_M} full width"]["ms"])
    torch.cuda.empty_cache()

    # 5. HostIngest at full width
    fn = fused["f32"][0]
    rng = np.random.default_rng(0)
    host = [(rng.standard_normal((A, N_FULL), dtype=np.float32),
             rng.standard_normal((A, N_FULL), dtype=np.float32))
            for _ in range(4)]
    tail0 = fused["f32"][1][2]

    def step(carry, xr, xi):
        fd, xre, xim, ntr, nti = fn(xr, xi, carry[0], carry[1])
        return (ntr, nti), (fd, xre, xim)

    ing = HostIngest(step, (tail0, tail0), N_FULL, prefetch=2, fetch_every=1,
                     device=dev)
    ing.run(iter(host))                  # warm-up: pins the staging ring
    fetched = []
    stats = ing.run((host[i % len(host)] for i in range(INGEST_FRAMES)),
                    on_outputs=lambda k, o: fetched.append(o))
    if stats["steps"] != INGEST_FRAMES or len(fetched) != INGEST_FRAMES:
        fail(f"HostIngest ran {stats['steps']} steps")
    last = host[(INGEST_FRAMES - 1) % len(host)][0][:, -fn.tail_len:]
    if not np.array_equal(ing.carry[0].cpu().numpy(), last):
        fail("HostIngest carry is not the last frame's tail")
    if not all(bool(torch.isfinite(t).all()) for o in fetched for t in o):
        fail("HostIngest produced non-finite outputs")
    dr = torch.as_tensor(host[0][0], device=dev)
    di = torch.as_tensor(host[0][1], device=dev)
    step_ms = time_ms(torch, lambda: fn(dr, di, tail0, tail0), reps=20)
    # the feed's two legs for one frame (re and im planes): host staging
    # copy into pinned memory, and the pinned -> device copy
    src = torch.from_numpy(host[0][0])
    pin = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    t0 = time.perf_counter()
    for _ in range(4):
        pin.copy_(src)
    stage_ms = 2 * (time.perf_counter() - t0) / 4 * 1e3
    h2d_ms = 2 * time_ms(torch, lambda: dr.copy_(pin, non_blocking=True))
    frame_gb = 2 * src.numel() * src.element_size() / 1e9
    phase("ingest", f"{INGEST_FRAMES} frames of {A}x{N_FULL} f32 through "
                    f"HostIngest: {stats['wall_s'] * 1e3:.1f} ms, "
                    f"{stats.msps:.1f} MSPS per antenna end to end")
    phase("ingest", f"per frame ({frame_gb:.3f} GB): host staging copy "
                    f"{stage_ms:.2f} ms ({frame_gb / stage_ms * 1e3:.1f} GB/s),"
                    f" pinned->device {h2d_ms:.2f} ms "
                    f"({frame_gb / h2d_ms * 1e3:.1f} GB/s)")
    phase("ingest", f"device step {step_ms:.3f} ms = "
                    f"{N_FULL / step_ms / 1e3:.1f} MSPS per antenna; fused "
                    f"kernel {times['fx f32'][0]:.3f} ms, plain "
                    f"{times['fx f32'][1]:.3f} ms")
    del ing, fetched, host, dr, di, pin, src
    torch.cuda.empty_cache()

    # 6. the flat-layout FX path, counted
    flat_launches, errs["fx1 path"] = flat_fx_phase(torch, hk, gen, dev, taps)
    torch.cuda.empty_cache()

    # 7. the X-Engine path, counted
    xe = xengine_phase(torch, hk, gen, dev)
    torch.cuda.empty_cache()
    xe_sync = xengine_sync_phase(torch, hk, dev)
    torch.cuda.empty_cache()
    xe_bf16 = xengine_bf16_phase(torch, hk, gen, dev)
    phase("xengine", f"on {card}")
    torch.cuda.empty_cache()

    # 8. the FM kernels against their plain forms
    fmk = fm_kernel_phase(torch, hk, gen, dev)
    torch.cuda.empty_cache()

    # 9. the FM receive paths, counted
    fm = {label: fm_path_phase(torch, hk, gen, dev, use_time)
          for label, use_time in (("td", True), ("fd", False))}
    phase("fm", f"on {card}")
    torch.cuda.empty_cache()

    # 10. the oversampled channelizer, kernels and path
    osr = os_phase(torch, hk, gen, dev)
    torch.cuda.empty_cache()

    # 11. the spectrum chain, kernels and path
    spr = spectrum_phase(torch, hk, gen, dev)
    custom_blocks_phase(torch, dev)
    torch.cuda.empty_cache()

    # 12. carrier recovery, kernels and paths
    cor = costas_phase(torch, hk, dev)
    cob = costas_batched_phase(torch, hk, dev)
    phase("new paths", f"on {card}")
    torch.cuda.empty_cache()

    # 13. the sharded main path on a world-size-1 NCCL group, counted
    sharded = sharded_phase(torch, hk, P, gen, dev)
    phase("sharded", f"on {card}")
    torch.cuda.empty_cache()

    # 14. the correlators and the typed and interpolating FIRs, with TF32 on
    # in the process: the port's own full-float32 sections must hold 1e-4
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    correlators = {"xcorr": xcorr_phase(torch, hk, dev),
                   "typed_fir": typed_fir_phase(torch, dev)}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    correlators["phase_s"] = time.perf_counter() - t0
    phase("correlators", f"phase 14 in {correlators['phase_s']:.1f} s on "
                         f"{card}")
    torch.cuda.empty_cache()

    # 15. the native runtime, the GNU Radio adapter and the CLI tools
    gr_tools = gr_tools_phase(torch, hk, dev)
    phase("gr", f"on {card}")
    torch.cuda.empty_cache()

    # 16. the example scripts, counted
    examples = examples_phase(torch, hk, dev)
    phase("examples", f"on {card}")
    torch.cuda.empty_cache()

    # 17. the vectorised K-frame dispatch, counted
    vectorised = vectorised_phase(torch, hk, dev)
    phase("vectorised", f"on {card}")
    print(card, flush=True)

    # the least time the card could take for each kernel's work at the
    # shapes measured above
    nfd, nb = A - 1, A * (A + 1) // 2
    h32 = hk.fx_tail_len(torch.float32, M, ntaps)
    w = taps.shape[0]

    sp = XE_S * XE_P

    def gram_bound(f, t, width, elem, rate):
        # zr and zi read once, the a and gi blocks (4 bytes) written once;
        # the products the _tri form needs: a's lower triangle, w (w + 1) / 2
        # entries of 2 multiply-adds, and gi = b - b^T below the diagonal,
        # w (w - 1) / 2 entries of 2: 2 w^2 multiply-adds, 4 w^2 operations
        # a frame
        nbt = (width // 128) * (width // 128 + 1) // 2
        return bound(2 * elem * f * t * width + 4 * 2 * f * nbt * 128 * 128,
                     4 * f * width * width * t, rate)

    plan49 = hk.OfsPlan(fm_taps()[0])

    def ofs_bound(plan):
        p = plan.fft_size
        return bound(4 * (4 * FM_N + 2 * plan.tail_len) + 8 * p,
                     -(-FM_N // plan.valid) * (10 * p * math.log2(p) + 6 * p))

    k49, p49 = plan49.ntaps, plan49.fft_size
    bounds = {
        "fx": bound(4 * 2 * A * (N_FULL + h32), fx_ops(N_FULL, M, w)),
        "fx1": bound(4 * 2 * A * (N_FULL + w * M - 1), fx_ops(N_FULL, M, w)),
        "fx dense": bound(4 * 2 * A * (N_FULL + h32),
                          fx_ops(N_FULL, M, w, False)),
        "gram": gram_bound(XE_F, XE_T, sp, 1, INT8_OPS),
        "gram bf16": gram_bound(XE_F, XE_T, sp, 2, BF16_OPS),
        "gram k=4": gram_bound(16, XE_T, 512, 1, INT8_OPS),
        "gram bf16 k=4": gram_bound(16, XE_T, 512, 2, BF16_OPS),
        "ofs": ofs_bound(plan49),
        "ofs 1601": ofs_bound(hk.OfsPlan(fm_taps()[3])),
        "fir": fmk["fir bounds"]["49"],
        "qd": bound(4 * (3 * FM_N + 2), 7 * FM_N),
    }

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
              library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"clenabled_tpu_torch/csrc/{source}",
                "replaces": f"clenabled_tpu/dsp/pallas_kernels.py:{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    pk_entry = pk["shapes"]["entry"]
    record = {"kernels": [
        dict(entry("fx_correlate_streams_v2", "fx_correlate.cu", 1172,
                   launches["fx"], errs["fx"], *times["fx f32"], bounds["fx"]),
             body=hk.fx_body(M), sharded_launches=sharded["launches"],
             example_launches=examples["flagship"]["launches"].get(
                 "fx_correlate_streams_v2", 0),
             ms_plain_ms_by_dtype={k[3:]: times[k] for k in (
                 "fx f32", "fx bf16", "fx int8")},
             dense_dft_bound_ms=bounds["fx dense"][0],
             wide={k: dict(r["v2"], w=r["w"], h=r["h"])
                   for k, r in fx_wide.items()},
             wide_path=fx_path,
             cuda_kernels=sorted(fx_ptxas), ptxas=fx_ptxas),
        dict(entry("pfb_channelize_packed", "pfb_packed.cu", 1678,
                   launches["pfb"], errs["pfb"], pk_entry["ms"],
                   pk_entry["plain_ms"], pk_entry["bounds"]["bound"]),
             body=pk_entry["body"], bodies=pk["bodies"],
             shape=pk_entry["shape"], device_ms=pk_entry["device_ms"],
             events_ms=pk_entry["events_ms"],
             first_body={r["shape"]: r["first_body"]
                         for r in pk["shapes"].values()},
             by_shape={r["shape"]: {
                 "body": r["body"], "ms": r["ms"], "device_ms": r["device_ms"],
                 "events_ms": r["events_ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bounds"]["bound"][0],
                 "bound_by": r["bounds"]["bound"][1],
                 **{k: v for k, v in r["bounds"].items() if k != "bound"},
                 "first_body": r["first_body"]}
                 for r in pk["shapes"].values()},
             **{k: v for k, v in pk_entry["bounds"].items() if k != "bound"},
             wide={m: {"body": r["body"], "shape": r["shape"], "ms": r["ms"],
                       "device_ms": r["device_ms"],
                       "events_ms": r["events_ms"], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bounds"]["bound"][0],
                       "bound_by": r["bounds"]["bound"][1],
                       "first_body_ms": r["first_body"]["ms"]}
                   for m in hk.PFB_WIDE_M
                   for r in [pk["shapes"][f"M={m} full width"]]},
             wide_path_launches=pk_path["launches"], wide_path=pk_path,
             cuda_kernels=sorted(pk_ptxas), ptxas=pk_ptxas),
        dict(entry("fx_correlate_streams", "fx_correlate.cu", 876,
                   flat_launches, max(errs["fx1"], errs["fx1 path"]),
                   *times["fx1"], bounds["fx1"]), body=hk.fx_body(M),
             wide={k: dict(r["flat"], w=r["w"], h=r["hist"])
                   for k, r in fx_wide.items()}),
        dict(entry("xengine_gram_stacked", "xengine_gram_int8.cu", 2142,
                   xe["launches"], 0.0, *gram_res["int8"], bounds["gram"]),
             sharded_launches=sharded["xengine"]["launches"]["int8"],
             sync_launches=xe_sync["launches"],
             adapter_launches=gr_tools["sink"]["launches"],
             example_launches=examples["xengine_synchronized"][
                 "launches"].get("xengine_gram_stacked_tri", 0),
             device_ms=gram_res["int8 device"],
             k4_ms_plain_ms=gram_res["int8 k=4"],
             k4_bound_ms=bounds["gram k=4"][0],
             k4_bound_by=bounds["gram k=4"][1],
             cuda_kernels=sorted(gram_ptxas), ptxas=gram_ptxas),
        dict(entry("xengine_gram_stacked_bf16", "xengine_gram_bf16.cu", 2142,
                   xe_bf16["launches"],
                   max(gram_res["bf16_err"], xe_bf16["err"],
                       sharded["xengine"]["bf16_err"]),
                   *gram_res["bf16"], bounds["gram bf16"],
                   gram_res["bf16 library"]),
             sharded_launches=sharded["xengine"]["launches"]["bf16"],
             device_ms=gram_res["bf16 device"],
             library_call=gram_res["library label"],
             k4_ms_plain_ms=gram_res["bf16 k=4"],
             k4_bound_ms=bounds["gram bf16 k=4"][0],
             k4_bound_by=bounds["gram bf16 k=4"][1]),
        dict(entry("ofs_filter_planar", "ofs_filter.cu", 1909,
                   fm["fd"]["launches"]["ofs_filter_planar"], fmk["ofs"],
                   *fmk["ofs 49"][:2], bounds["ofs"], fmk["conv1d 49"]),
             taps_1601={"ms": fmk["ofs 1601"][0],
                        "plain_ms": fmk["ofs 1601"][1],
                        "bound_ms": bounds["ofs 1601"][0],
                        "library_ms": fmk["conv1d 1601"]}),
        dict(entry("fir_direct", "fir_direct.cu", "280+128",
                   fm["td"]["launches"]["fir_direct"], fmk["fir"],
                   *fmk["fir 49"][:2], bounds["fir"], fmk["conv1d 49"]),
             body=hk.fir_body(k49, 1, dev), bodies=fmk["fir bodies"],
             adapter_launches={m: r["launches"]["fir_direct"] for m, r in
                               gr_tools["stream"].items()},
             example_launches=examples["streaming_ingest"]["launches"].get(
                 "fir_direct", 0),
             by_ntaps={k: {"ms": fmk[f"fir {k}"][0],
                           "plain_ms": fmk[f"fir {k}"][1],
                           "events_ms": fmk[f"fir {k}"][2],
                           "bound_ms": fmk["fir bounds"][k][0],
                           "bound_by": fmk["fir bounds"][k][1],
                           "first_body": fmk["fir first"][k],
                           "library_ms": fmk.get(f"conv1d {k}")}
                       for k in ("49", "241", "1601")},
             first_body={k: v["ms"] for k, v in fmk["fir first"].items()},
             cuda_kernels=sorted(fir_ptxas), ptxas=fir_ptxas),
        dict(entry("qdemod_fused", "qdemod.cu", 358,
                   sum(fm[p]["launches"]["qdemod_fused"] for p in fm),
                   fmk["qd"], *fmk["qd time"][:2], bounds["qd"]),
             adapter_launches={m: r["launches"]["qdemod_fused"] for m, r in
                               gr_tools["stream"].items()},
             example_launches=examples["streaming_ingest"]["launches"].get(
                 "qdemod_fused", 0)),
        dict(entry("pfb_oversampled_fused", "pfb_oversampled.cu", 1587,
                   osr["launches"], osr["err"], *osr["time"][:2],
                   osr["bounds"]["bound"]),
             body=osr["bodies"]["16ch R=8"], bodies=osr["bodies"],
             first_body=osr["first_body"],
             **{k: v for k, v in osr["bounds"].items() if k != "bound"},
             wide=osr["wide"], wide_path_launches=osr["wide_path"]["launches"],
             cuda_kernels=sorted(os_ptxas), ptxas=os_ptxas),
        dict(entry("fft_batched_fused", "fft_batched.cu", 505,
                   spr["launches"], spr["err"], *spr["time"][:2],
                   spr["bound"], spr["library_ms"]),
             bare_by_size=spr["sizes"],
             adapter_launches={m: r["launches"]["fft_batched_fused"]
                               for m, r in gr_tools["stream"].items()},
             vectorised_launches={
                 "spectrum": vectorised["spectrum"]["launches"],
                 "adapter": vectorised["adapter"]["launches"]},
             vectorised_dispatch={
                 "shape": vectorised["spectrum"]["k"] * VEC_N,
                 "ms": vectorised["spectrum"]["kernel_ms"],
                 "bound_ms": vectorised["spectrum"]["kernel_bound"][0],
                 "bound_by": vectorised["spectrum"]["kernel_bound"][1],
                 "max_abs_err": vectorised["spectrum"]["err"]}),
        dict(entry("costas_scalar", "costas.cu", 2287, cor["launches"],
                   cor["err"], *cor["time"], cor["bound"]),
             latency_bound_ms=cor["timing"][2]["latency_bound_ms"],
             by_order={o: {k: t[k] for k in (
                 "ms", "events_ms", "sm_clock_mhz", "clock_readings_busy",
                 "ns_per_sample", "cycles_per_sample", "chain_ops",
                 "latency_bound_ms")}
                 for o, t in cor["timing"].items()},
             sincos_probe=cor["probe"],
             cuda_kernels=[f"costas_kernel<{o}, {h}>" for o in (2, 4)
                           for h in ("true", "false")]
             + ["costas_sincos_probe_kernel"]),
        *(dict(entry("costas_batched", "costas.cu", 2287,
                     cob["chunked_launches"] + cob["streams_launches"]
                     + cob["chunked_big"]["launches"],
                     max(r["err"], cob["err"]), r["ms"], r["plain_ms"],
                     (r["bound_ms"], r["bound_by"])),
               shape=shape, body=r["body"], body_rule=cob["rule"],
               bodies={k: t["ms"] for k, t in r["bodies"].items()},
               bodies_events_ms={k: t["events_ms"]
                                 for k, t in r["bodies"].items()},
               device_ms=r["device_ms"],
               events_ms=r["events_ms"], latency_bound_ms=r["latency_ms"],
               sm_clock_mhz=r["sm_clock_mhz"],
               clock_readings_busy=r["clock_readings_busy"],
               launches_by_path={"chunked": cob["chunked_launches"],
                                 "chunked_2p23": cob["chunked_big"][
                                     "launches"],
                                 "streams": cob["streams_launches"]},
               chunked_2p23=cob["chunked_big"],
               jax_counterpart="clenabled_tpu/dsp/demod.py:274-285 and "
                               "clenabled_tpu/blocks/demod.py:95 (jax.vmap "
                               "of the lax.scan; no Pallas kernel)",
               cuda_kernels=["costas_kernel<2, true>",
                             "costas_lanes_kernel<2, true>"],
               ptxas=costas_ptxas)
          for shape, r in cob["shapes"].items()),
    ], "step_ms": step_ms, "ingest_msps": stats.msps,
        "stage_ms": stage_ms, "h2d_ms": h2d_ms,
        "int8_fx_ms": times["fx int8"][0], "int8_fx_plain_ms": times["fx int8"][1],
        "xengine_step_ms": xe["step_ms"],
        "xengine_marshal_ms": xe["marshal_ms"],
        "xengine_host_to_product_ms": xe["h2p_ms"],
        "xengine_sync": xe_sync,
        "fir_ms_plain_ms": {k: fmk[f"fir {k}"] for k in ("49", "241",
                                                         "1601")},
        "ofs_ms_plain_ms": {k[4:]: v for k, v in fmk.items()
                            if k.startswith("ofs ")},
        "fm_path": {p: {k: fm[p][k] for k in ("err", "step_ms", "busy_ms",
                                               "wall_ms")} for p in fm},
        "fft_bare_ms": spr["bare_ms"],
        "paths": {"oversampled": osr["path"],
                  "oversampled_64ch_1600taps": {
                      k: osr["wide_path"][k] for k in ("busy_ms", "wall_ms")},
                  "spectrum": spr["path"],
                  "costas": cor["path"],
                  "costas_chunked": dict(
                      cob["chunked_path"], msps=cob["chunked_msps"],
                      frames=cob["chunked_frames"]),
                  "costas_streams": cob["streams_path"],
                  "costas_chunked_2p23": cob["chunked_big"],
                  "planar_step": planar,
                  "planar_step_64ch": pk_path,
                  "sharded": sharded, "correlators": correlators,
                  "gr_tools": gr_tools, "examples": examples,
                  "vectorised": vectorised}}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
