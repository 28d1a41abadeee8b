"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It drives the streaming and training paths of `fastenhancer_tpu_torch` (no
JAX anywhere) through the hand-written CUDA kernels, in thirty phases,
each printed on its own line:

  1. card: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is switched off for the float32 checks;
  2. build: every kernel compiled from this checkout with nvcc, one nvcc
     process per source, all at once, with `-Xptxas -v`; the registers,
     static shared memory and spills of the block stack's and the whole
     frame's instantiations (the bfloat16 tensor-core forms and the
     float32 forms), of the BSRNN, dprnn and dpt stacks' bfloat16 forms
     (tensor-core and scalar), of three of the GRU scan's tensor-core
     instantiations and its float32 form and of segmental RMS are
     printed;
  3. kernels: each kernel against its plain PyTorch version on the card in
     float32 and bfloat16 (the block stack and the whole frame at the
     FastEnhancer T/B/S shapes, the block stack's LN form at LN_B's shape
     with non-trivial LayerNorm terms, the dpt stack at the DPT T/B/S block shapes
     with a wrapped pointer and unwritten cache slots, the BSRNN stack at
     the BSRNN-XT and -S shapes, the dprnn stack at the DPRNN-T and -B
     shapes, segmental RMS with silent, half-quiet and short rows, rows
     that do not start on 16 bytes, one row and 200, and the absolute
     floor on and off, the GRU scan at H=20 and 36, T=13 and 126, ragged
     N, with and without h0), and each timed with CUDA events beside its
     plain version and its bound, with the bound's share of the kernel's
     time (the stacks, LN form included, at B=256 bfloat16, segmental RMS
     at the shard recipe's [32, 64000] float32 train batch beside an empty
     kernel, the GRU scan at its bfloat16 valid shape [126, 1024, 60]
     beside cuDNN's GRU as the library yardstick); the BSRNN, dprnn, dpt
     and GRU-scan kernels print the form each case ran (bfloat16 the
     tensor-core form, float32 the scalar one) and, at BSRNN-S, DPRNN-B
     and DPT-B bf16 and the GRU scan's valid shape and FE_B's width
     [126, 301, 108], the scalar form's time beside the tensor-core
     form's in the same call (the GRU scan's beside cuDNN's GRU too); the
     GRU scan also at every shape phases 16 and 18 give it, FE_B's chunks
     [C, 6144, 108] for C = 1, 4, 8 with a carried state (and a ragged
     N = 6143 at C = 4) and the huge noncausal model's biGRU
     [641, 256, 384] in both directions, each timed in bfloat16 beside
     its plain version, its bound and cuDNN's GRU; and at every shape
     phases 19 and 20 give it: FSPEN's and LiSenNet's intra biGRUs (T = 32
     bins, H = 16 and 12, both directions) and time GRUs (H = 16 and 24)
     per frame, in chunks of 4 and offline, with a ragged N, timed the
     same way;
  4. serving FE_B: a StreamingEngine (capacity 256, bfloat16, fused)
     answers a few staggered requests; outputs are checked for length,
     finiteness, agreement with an isolated run, and the stack kernel's
     launch count; the unfused float32 path is checked against the fused
     one;
  5. throughput FE_B: Model.stream over 256 streams in bfloat16, reported
     as per-stream RTF = wall / (audio seconds x streams);
  6. serving DPT-B: the same for the dptransformer model through the dpt
     stack kernel, a slot reused while the shared slot pointer moves on;
  7. whole frame FE_B: streaming_step_fused_frame (one kernel per frame for
     the whole spec->mask model) over 256 streams, against
     streaming_step_fused on the same input, both timed per frame;
  8. throughput DPT-B: Model.stream(fused_plan=...) over 256 streams;
  9. serving BSRNN-S, as phase 4, through the BSRNN stack kernel;
 10. serving DPRNN-B, as phase 4, through the dprnn stack kernel;
 11. throughput BSRNN-S: Model.stream(fused_plan=...) over 256 streams;
 12. serving LN_B (the ln ablation), as phase 4, through the block stack's
     LN form, with its GroupNorm and LayerNorm affine terms drawn away from
     their init (weight 1, bias 0);
 13. serving TIME_KERNEL_B (the time_kernel ablation), as phase 4, through
     the block stack's folded default form, its 2-D causal convs eager
     with their frame caches;
 14. train FE-T on the shard recipe (presets.FE_T_SHARD) through the
     ns_shard ModelWrapper's train_epoch: 5 bfloat16 steps over float32
     masters on one synthetic batch of 32 x 4 s (speech with silent
     stretches, noise with a silent row, 0.5 s RIRs), each step mixed on
     the card (segmental RMS kernel, twice) with the mixer's generator
     re-seeded so every step sees the same mix; losses finite and
     falling, trained params moved and the fixed filterbanks not, BN
     statistics moved, the warmup followed; then one float32 step (TF32
     off) against the same step on the CPU's plain path from the same
     variables and batch;
 15. valid FE-T: valid_epoch over 64 x 2 s paired batches (the GRU scan
     kernel, once per block), and the float32 valid losses against the
     CPU's plain path;
 16. chunked FE_B: Model.stream(chunk_frames=C) over 256 streams of 5 s in
     bfloat16 for C = 1 (the per-frame unfused stream), 4 and 8, each
     block's time GRU one GRU-scan launch a chunk on its tensor-core form
     and no other kernel; per-stream RTF and launches per frame; bf16
     chunked against the per-frame fused stream (the block stack kernel),
     float32 chunked against the per-frame unfused stream (to 1e-4 of its
     peak);
 17. chunked, the other six served families (conv_stft at FE_B's widths,
     DPT-B, DPRNN-B, LN_B, TIME_KERNEL_B, BSRNN-S), C = 4 over 256 streams
     of 1 s: bf16 launches (the GRU scan's tensor-core form once a block a
     chunk where the family has a time GRU, no kernel otherwise) and RTF,
     float32 chunked against the per-frame unfused stream (to 1e-4 of its
     peak);
 18. noncausal offline: Model.forward of the huge noncausal recipe
     (presets.NONCAUSAL_HUGE) over 4 streams of 4 s in bfloat16, its six
     biGRUs twelve tensor-core GRU-scan launches at H = 128 and no other
     kernel, timed; the bf16 forward against the float32 forward on the
     card (to 2^-5 of its peak), and the float32 forward on a short input
     against the CPU's plain path (to 1e-4 of its peak);
 19. FSPEN (presets.FSPEN) and 20. LiSenNet (presets.LISENNET), every GRU
     a GRU-scan launch (FSPEN 30 a frame or chunk, LiSenNet 6): a
     StreamingEngine (capacity 256, bfloat16, unfused: neither has a stack
     plan) answers staggered requests with a reused slot, checked as in
     phase 4 against an isolated run; Model.stream over 256 streams of 2 s
     in bfloat16 at C = 1 and 4 (RTF, launches a frame); Model.forward of
     4 x 4 s in bfloat16, timed; float32 on 32 of the streams, chunked
     against per frame (to 1e-4 of the peak), and the bfloat16 chunked
     stream against it (its RMS error to BASELINE_BF16_RMS of the RMS, its
     largest to BASELINE_BF16_PEAK of the peak, both measured); the
     float32 chunked stream and offline forward on 2 x 1 s, card against
     the CPU's plain path (to 1e-4 of the peak; the forward's audio has
     silent edges, since LiSenNet's phase features sit on their branch
     cut on a real-spectrum edge frame); for FSPEN, the 16 float32
     streams with the card's largest bf16 errors run again through the
     CPU's bf16 plain path on the same inputs and weights: both held to
     the card's float32 stream, the card's largest error within 1.5x the
     CPU's; and a control with FSPEN's convolutions called on their bf16
     values (cuDNN rounds each sum before its bias) that must miss by more
     than 1.5x the CPU's on its own 16 worst streams;
 21. train through the CLI: in a temporary directory, synthetic shards
     (speech with silent stretches, noise with a silent cut, 0.5 s RIRs;
     plain ustar tars of WAVs with gzipped cut lists) and a paired
     clean/noisy WAV directory, then `python -m fastenhancer_tpu_torch.train`'s
     `main` in this process on configs/fastenhancer_shard/t.yaml at its
     width (FE-T) with -p overrides for the paths, CLI_STEPS steps an
     epoch, 2 epochs, a checkpoint and PESQ/STOI each epoch: the run dir's
     files, finite losses, PESQ and STOI in range, #4 twice a train step
     and #5 once a block in every valid batch (tensor-core form, bf16) and
     every PESQ forward (scalar form, float32), no other kernel; then a
     resume from the run dir (no -c, max_epochs 3, -f) whose state right
     after `load` equals 00002.ckpt bit for bit (params, BN statistics, m,
     v, step, scheduler); each epoch's wall, load/step split, valid and
     PESQ times are printed;
 22. train every family through the CLI: (a) `main` in this process on
     each VoiceBank recipe (configs/fastenhancer/b.yaml, configs/ablation/
     {dpt,dprnn,ln,time_kernel}_b.yaml, configs/others/{bsrnn_s,fspen,
     lisennet}.yaml) at its width, batch (64 x 2 s), precision and losses
     (the `pesq` loss among them), on a synthetic paired-wav corpus (128
     train pairs of 2-2.5 s: 2 steps; 8 valid/PESQ pairs), one epoch with
     valid, PESQ/STOI and a checkpoint, FE-B resumed for a second: finite
     losses, every trained leaf moved, #5 only in the valid (tensor-core
     form in the bf16 recipes) and PESQ forwards, as often as the model and
     the files give, and never inside train_epoch, each input it got held
     against its plain version; each step's ms, the valid ms, PESQ/STOI s,
     the epoch's wall split and the peak memory printed; (b) one float32
     train step of each of the eight families (the noncausal one too) at
     2 x 1 s (the noncausal one 2 x 0.5 s) with silent edges (as phase
     20), card against the CPU's plain
     path (loss 1e-4, grad norm 1e-3 relative); (c) train.remat on FE-L
     (configs/fastenhancer/l.yaml): one bf16 step at 16 x 2 s with and
     without from one state, each twice: the two steps of one mode
     bit-equal in every gradient leaf and the loss (and, as a control,
     not so with the offline overlap-add as an index_add_), equal losses
     with and without, every leaf's gradient equal within 1e-3 of its
     norm (the recompute of the backward checked) and a lower peak memory
     with; with remat at the recipe's 64 x 2 s, which without remat does
     not fit the card. No kernel runs inside any train step;
 23. train the on-the-fly recipes through the CLI: `main` in this process
     on configs/fastenhancer_dns/b.yaml (bf16), configs/fastenhancer_48khz/
     b.yaml (bf16, the dynamic low-pass at p 0.5), configs/others_dns/
     bsrnn_xt.yaml (float32), configs/fastenhancer_dns/huge_noncausal.yaml
     (bf16, 16 x 2 s) and a copy of configs/fastenhancer_dns/t.yaml with
     reverb at p 0.5 (the RIR convolution), each at its width and batch, 2
     steps, 1 epoch with valid, PESQ/STOI and a checkpoint, on a synthetic
     corpus at 16 and 48 kHz (speech-like clean files of 1-5 s, so that
     clips are both concatenated and cropped, one at -80 dBFS that the
     dataset skips, noise, 10 valid/PESQ pairs of 2-2.5 s, RIRs): finite
     losses, #5 only in the valid and PESQ forwards and never inside
     train_epoch, each input shape it got held against its plain version;
     the step ms, the data-load share of the epoch and the peak memory
     printed; the mixer (its RIR convolution too) and the low-pass on the
     card against the CPU in float32 on a run's own first batch and
     draws (to 1e-5 of the peak); #5 timed at the recipes' own valid
     shapes (the 48 kHz FE-B, the noncausal model at 16 and 24 kHz);
 24. the entry points on three of those runs, in this process: `python -m
     fastenhancer_tpu_torch.scripts.enhance` on the FE-B DNS run (the
     card's float32 outputs against the CPU's to 1e-4 of the peak, #5's
     inputs held to its plain version), `...scripts.serve --fused --dtype
     bf16` (capacity 8) on the FE-B DNS (#1 at F = 24), FE-B 48 kHz (#1 at
     F = 36) and BSRNN-XT (#3 at C = 16) runs, every launch held against
     the plain version and the outputs against the same checkpoint served
     unfused in float32 (to 2^-5 of the peak), tick p50/p99 and RTF
     printed; the float32 `enhance` and `serve` of the FE-B DNS run again
     in a fresh process in which nothing sets a float flag (the entry
     points turn TF32 off themselves), against the in-process runs to
     1e-6 of the peak; `...scripts.metrics_ns` on the FE-B DNS run
     (SISDR, STOI, ESTOI, PESQ finite and the card's equal to the CPU's
     to 1e-4); #1 at F = 36 and #3 at C = 16 timed at 256 streams with
     the checkpoints' plans;
 25. the training CLI's summaries, in this process: `main` on a copy of
     configs/fastenhancer_shard/t.yaml with train.profile {start: 1,
     steps: 2} (FE-T at its width, phase 21's synthetic corpus and valid
     batch), 2 epochs of 5 steps with infer.interval=1 (4 showcase files)
     and train.plot_param_and_grad: the run dir's train/ and valid/ event
     files read back with every record's CRCs checked, one param/ and one
     grad/ histogram a leaf an epoch, the losses and lr, the showcase's
     audio (noisy and clean only in epoch 1), spectrogram and log-mel
     images and infer/sisdr; #4 twice a step, #5 once a block in every
     valid batch (tensor-core form) and in infer_epoch once a block a file
     (float32 scalar form), no other kernel; the profiler's Chrome trace
     holding CUDA kernel events and #4 twice for its one step; the
     showcase of 00002.ckpt enhanced on the card against the CPU (to 1e-5
     of the peak) and against the logged PCM16 audio; the shard reader on
     the native decoder (its walks counted), its members equal to the
     Python walker's bit for bit, both decode rates printed (in turns:
     native, Python, Python, native); then one more
     epoch of phase 23's 48 kHz FE-B run with infer.interval=1 (the log-mel
     at 48 kHz), checked the same way; the summarize and infer_epoch walls
     and their shares of an epoch, and the step ms inside and outside the
     profiler's window, printed;
 26. several devices: (a) FE_B's fused bf16 engine at capacity 256 with
     its slots split over the one card listed twice (two shards of 128,
     each its own carry, plan and step), against the engine at 256 on the
     card, over the same 320 requests of 0.5-2 s that join as slots free
     and leave on both shards, on the block stack (#1) and on the whole
     frame (#7, its plan and step in the stack's place): the kernel twice
     a tick sharded and once unsharded, every output within 2^-5 of the
     peak and reported bitwise or not, tick p50/p99; (b) the training CLI
     on configs/fastenhancer/b.yaml at its width and batch (64), float32,
     2 epochs of 2 steps on synthetic length-sorted paired wavs, with
     `--coordinator 127.0.0.1:<port> --num_processes 1 --process_id 0`
     (the group over NCCL, left at the end) against the same run without
     the flags: the final checkpoint; (c) two ranks on the one card:
     over NCCL each rank's `parallel.init` raises (NCCL takes one rank a
     card), then over gloo (`parallel.init(..., backend="gloo")` in two
     spawned processes, the CLI's `main` in each) at batch 32 against
     (b)'s one process at 64 on the same items: every param and BN
     statistic of the final checkpoint and every epoch's losses, each
     step's wall and its all-reduce share, rank 1 silent, each rank's TF32
     off after the CLI's main though the phase sets no flag; #5 once a block
     in each valid forward of (b) and (c); the first launches of #1 and
     #7 in each engine of (a), at the shard's batch of 128, held against
     the plain versions;
 27. export (run after 25, before 26, while phase 23's runs exist): the
     folded float32 streaming step exported at 256 streams through
     `python -m fastenhancer_tpu_torch.scripts.export`'s `main` with
     `--save` (phase 23's FE-B DNS run as wav2wav --fused, spec2spec
     --fused and wav2wav, its BSRNN-XT run as wav2wav --fused, DPT-B and
     DPRNN-B --fused from untrained checkpoints of their configs), the
     export's kernel nodes, seconds, artifact bytes, per-tick p50/p99 and
     slope (16 vs 80 frames; BSRNN-XT's float32 frame, ~70 ms, 4 vs 12)
     printed, its launches the kernel's alone; then one fresh spawned
     process, which must load no model, wrapper or trainer module, runs
     each artifact through the runner's `main` on 0.5 s of audio (its
     lines printed; the kernel once a frame, NB times for #5, and no
     other) and over 32 seeded hops from the zero carry, against the
     eager step the program was exported from on the same variables,
     carry and hops (output and every carry leaf within 1e-5 of the peak;
     the runner's process sets no float flag, the runner's main turns
     TF32 off; each runner's tick p50, ticks 2 on, within 3x the loaded
     program's graph on flat inputs in a loop in that process, each frame
     fetched); every tensor of each loaded program (parameters, buffers,
     constants, the values its nodes were traced with), its variables,
     carry, feed and returned carry on the card; BSRNN-XT's artifact again
     in 2 fresh runner processes, each one's tick p50 within 3x its own
     loop (a slow one first takes a profiler window: its costliest
     kernels and host ops, the host ms inflated by the tracing); #2's
     artifact, which writes its K/V caches in place, timed against its
     functional form
     (`run_decompositions`: the caches cloned and copied back a frame);
     the host cost a call of #5's CUDA implementation called directly,
     through `torch.ops.fastenhancer.gru_scan` and through the wrapper,
     1,000 calls each;
 28. a reference PyTorch checkpoint served: each family's seeded init
     (FE_B, LN_B, TIME_KERNEL_B, DPT-B, DPRNN-B, BSRNN-S, FSPEN,
     LiSenNet, NONCAUSAL_HUGE) written in the reference repo's state-dict
     layout by tests/_torch_reference_sd.py (weight norm as
     `parametrizations.*.original0/1`, wrapped as {"model": {"module." +
     key: tensor}}), saved with torch.save, loaded with
     `torch.load(..., map_location="cpu", weights_only=True)` and
     converted on the card by `utils.convert_checkpoint`: every leaf
     bit-equal to the init's; then folded, in bf16, the converted weights
     and the init's through the family's path (256 streams x 32 frames:
     FE_B per frame on #1 and through the whole frame on #7, LN_B on #1's
     LN form, TIME_KERNEL_B on #1, DPT-B on #2, DPRNN-B on #6, BSRNN-S
     on #3, FSPEN and LiSenNet per frame and in chunks of 4 on #5; the
     noncausal model's 4 x 4 s forward, its biGRUs on #5), outputs equal
     within 1e-7 of the peak, the path's own kernel alone and as often as
     phases 4-20 count it, its launch at frame 16 (#5: each input shape)
     held against the plain version; the .pth bytes, load and convert
     seconds, the device ms a frame and the GMAC/s from the port's
     `models.macs.macs_for_config` printed a path; then `python -m
     fastenhancer_tpu_torch.scripts.gen_configs --check` on configs/
     (no pyyaml on the card) exits 0;
 29. the corpus tools: in a temporary directory, a raw corpus (long
     speech recordings of utterances between silences, stereo noise with a
     silent source, 0.5 s RIRs with a DNS-style CSV, a 4-channel .mat RIR
     bank at 48 kHz a BRUDEX room), then the port's tools, each `python -m
     fastenhancer_tpu_torch.scripts.data.*` in its own process at -j 4
     (spawned pools): segment_daps -> shard_speech (and again at -j 1),
     shard_noise, shard_dns_rir, preprocess_brudex -> shard_brudex, and
     shard_test (noise and RIR fields, its config written by
     `utils/yaml_subset.py::dump`); each builder's cuts a second and audio
     seconds a wall second printed; the -j 1 and -j 4 speech shards equal
     (tar bytes, decompressed cut lists, .done text), every tar plain
     ustar; then the training CLI's `main` in this process on
     configs/fastenhancer_shard/t.yaml (FE-T at its width) with its
     speech, noise and RIR inputs pointed at the built shards, CLI_STEPS
     steps, 1 epoch: finite losses, #4 twice a step and #5 once a block in
     every valid batch (tensor-core form), no other kernel, the reader on
     the native walker; its load/step split beside phase 21's; the frozen
     test set read back (fields recording/rir/noise, each tar walked
     natively, the float32 RIR members equal to the Python walker's) and
     mixed through DynamicMixer on the card (#4 twice), against the same
     mix on #4's plain version (to 1e-5 of the peak) and each row against
     the direct convolution of its speech and RIR (correlation above
     0.9999; with the RIR dropped it must fall below);
 30. the training demo (`python -m fastenhancer_tpu_torch.scripts.
     train_demo`): a seeded 31 s stand-in of its bundled 48 kHz recording
     (voiced harmonic stretches with a gliding f0 of 100-250 Hz, moving
     formant bumps on a falling tilt, 4 Hz syllable envelopes, short
     pauses) written to a temporary directory and named by the demo's
     `BUNDLED`; the demo's `main` in this process on the paired recipe
     and on the shard recipe (`P30_RUNS`' epochs), each with this
     script's `--device`; its two children (the training CLI and
     `metrics_ns`) run as the demo starts them, through a shim that
     reports each child's launch counts and the first input of each
     kernel form it ran when it exits: both runs end with code 0, the
     demo's `corpus:` and `noisy baseline:` lines and metrics_ns's scores
     are printed and finite, #5 ran in every child, #4 in the shard
     recipe's training child, and no other kernel ran; each recorded
     input (#4 on the mixer's batch, #5's tensor-core form in the bf16
     valid pass and its scalar form in the float32 PESQ and metrics_ns
     forwards) run here through the kernel and held against its plain
     version at phase 3's tolerances.

Each of phases 4 to 30 drives a path: every kernel's launch count is set to
0 just before it and read just after, and the path fails unless its own
kernel ran as often as the path needs it and no other kernel ran. The
block stack's two forms are counted apart (`rnnformer_stack_step.launches`
and `.ln_launches`); the BSRNN, dprnn and dpt stacks' and the GRU
scan's tensor-core forms are counted inside their launches (`.tc_launches`
of each wrapper), and the bf16 paths of BSRNN-S, DPRNN-B and DPT-B must
run them on every frame, FE-T's bf16 valid step on every launch. The
line before the last holds the kernels' JSON record (the GRU scan's
launches there are the sum over the bf16 paths of phases 15-20, the valid
and PESQ forwards of phases 21-23, the entry points of phase 24, the
valid and showcase forwards of phase 25 and the valid forwards of phase
26 (its ranks report theirs), the block stack's over its serving phases
and phases 24 and 26, the whole frame's over phases 7 and 26, the BSRNN
stack's over its serving phases and phase 24, segmental RMS's over
phases 14, 21 and 25, each listed by path before it; phase 27's
launches of #1, #2, #3, #5 and #6, phase 28's of every kernel but #4
and phases 29's and 30's of #4 and #5
are added to theirs), and the line before it the script's wall; every
phase prints its own wall; the last line is
{"ok": true, "device": {...}}. Any failure raises
and exits non-zero, and so does a machine without a CUDA device.
"""
import gzip
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tarfile
import tempfile
import time
import wave

T_START = time.perf_counter()

F32_TOL = 1e-5      # absolute, kernel vs plain, float32
BF16_REL = 2 ** -5  # bfloat16: of the largest magnitude (a few bf16 ulps)
STREAM_F32_TOL = 1e-4  # float32 stream outputs, fused vs unfused
# float32 outputs computed in another order (chunked against per frame, the
# card against the CPU): of the reference output's largest magnitude
F32_OUT_REL = 1e-4
SR = 16_000
STREAMS = 256
FE_SECONDS = 10.0      # phase 5's audio per stream
FRAME_SECONDS = 5.0    # phase 7's audio per stream
DPT_SECONDS = 5.0      # phase 8's audio per stream
BSRNN_SECONDS = 5.0    # phase 11's audio per stream
TRAIN_ROWS, TRAIN_SECONDS = 32, 4.0   # phase 14: 128 s = max_duration
TRAIN_STEPS = 5
RIR_SECONDS = 0.5
MIX_SEED = 11
VALID_ROWS, VALID_SECONDS, VALID_BATCHES = 64, 2.0, 2   # phase 15
CHUNK_SECONDS = 5.0    # phase 16's audio per stream
FAMILY_SECONDS = 1.0   # phase 17's audio per stream
# phase 18 and its GRU-scan shape: streams and audio per stream
NC_STREAMS, NC_SECONDS = 4, 4.0
# phases 19-20 (FSPEN, LiSenNet): audio per stream of the 256-stream runs,
# the streams of the float32 checks, and the offline forward's streams and
# audio (and #5's offline shapes in 3g')
BASELINE_SECONDS = 2.0
BASELINE_F32_STREAMS = 32
BASELINE_OFF_STREAMS, BASELINE_OFF_SECONDS = 4, 4.0
# the baselines' bfloat16 chunked stream against the float32 one, where
# 2^-5 of the peak does not hold (the JAX package's own bf16 stream misses
# its f32 one by 3.1-3.2% of the peak at these widths): the error's RMS
# within BASELINE_BF16_RMS of the float32 output's RMS (measured on the
# H100 at 256 streams x 2 s, seeds 0-1: 1.4-1.8% in both models) and its
# largest sample within BASELINE_BF16_PEAK of the output's peak (measured:
# FSPEN 0.024 with its convolutions summed in float32, 0.101 before;
# LiSenNet 0.025-0.036; FSPEN's mask takes the full-band mask's direction,
# which is ill-conditioned where that mask's magnitude is small); on the
# streams with FSPEN's largest bf16 errors, the card's largest error
# within BASELINE_CARD_CPU x that of the CPU's plain path on the same
# inputs (the card path adds no error of its own)
BASELINE_BF16_RMS = 2 ** -5
BASELINE_BF16_PEAK = {"FSPEN": 2 ** -4, "LiSenNet": 2 ** -4}
BASELINE_CARD_CPU = 1.5
# phase 21 (the training CLI on configs/fastenhancer_shard/t.yaml): its
# synthetic corpus, CLI_SHARDS speech shards of CLI_SPEECH_CUTS cuts of
# CLI_CUT_SECONDS and CLI_WAVS paired files of 2-4 s; its train steps an
# epoch and its valid batch (PESQ batches are the recipe's
# pesq.batch_size). The cuts fill the recipe's batches: all in one of its
# 30 buckets, 33-34 of them reach max_duration (128 s), and each of its 2
# reader threads serves 2 shards, 5 full batches and a short tail a pass,
# so every step of an epoch mixes a full batch. 10 files in batches of 4
# leave a ragged last valid and PESQ batch.
CLI_SHARDS, CLI_SPEECH_CUTS, CLI_WAVS = 4, 88, 10
CLI_CUT_SECONDS = (3.8, 4.0)
CLI_STEPS, CLI_VALID_BATCH = 5, 4
# float32 card vs the CPU's plain path, over a whole train or valid batch:
# losses and grad norm relative (sums over 128 s of audio in another order,
# cuFFT against pocketfft), params absolute (twice the first step's lr of
# 4e-6: a gradient near zero may take either sign on the two devices)
TRAIN_F32_RTOL = 1e-4
TRAIN_F32_PARAM_ATOL = 1e-5
# the H100 SXM's published peaks (NVIDIA H100 datasheet)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}


# the block stack's LN form (the ln ablation's) in the launch counts and
# the kernels' record
LN_KERNEL = "rnnformer_stack_step (ln)"
# the tensor-core forms of the BSRNN, dprnn and dpt stacks in the launch
# counts (each a form of its kernel's one record, counted inside its
# launches)
BAND_TC = "bsrnn_stack_step (tc form)"
DPRNN_TC = "dprnn_stack_step (tc form)"
DPT_TC = "dpt_stack_step (tc form)"
GRU_TC = "gru_scan (tc form)"
TC_FORMS = {"bsrnn_stack_step": BAND_TC, "dprnn_stack_step": DPRNN_TC,
            "dpt_stack_step": DPT_TC, "gru_scan": GRU_TC}


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# the block stack's and the whole frame's kernel instantiations, as their
# mangled names show them in ptxas's report
PTXAS_KERNELS = {
    "rnnformer_stack_tc_kernelILb0E": "rnnformer_stack bf16 (tensor cores)",
    "rnnformer_stack_tc_kernelILb1E": "rnnformer_stack bf16 LN form "
                                      "(tensor cores)",
    "rnnformer_stack_kernelIfLb0E": "rnnformer_stack f32",
    "rnnformer_stack_kernelIfLb1E": "rnnformer_stack f32 LN form",
    "fused_frame_tc_kernel": "fused_frame bf16 (tensor cores)",
    "fused_frame_kernelIfE": "fused_frame f32",
    "bsrnn_stack_tc_kernel": "bsrnn_stack bf16 (tensor cores)",
    "bsrnn_stack_kernelI13__nv_bfloat16E": "bsrnn_stack bf16 scalar",
    "dprnn_stack_tc_kernelILi16E": "dprnn_stack bf16 (tensor cores, Hd <= "
                                   "16: DPRNN-T)",
    "dprnn_stack_tc_kernelILi24E": "dprnn_stack bf16 (tensor cores, Hd <= "
                                   "24: DPRNN-B)",
    "dprnn_stack_kernelI13__nv_bfloat16E": "dprnn_stack bf16 scalar",
    "dpt_stack_tc_kernel": "dpt_stack bf16 (tensor cores)",
    "dpt_stack_kernelI13__nv_bfloat16E": "dpt_stack bf16 scalar",
    "gru_scan_tc_kernelILi2ELi1ELb1E": "gru_scan bf16 (tensor cores, "
                                       "H = 18..32: FE-T)",
    "gru_scan_tc_kernelILi3ELi1ELb1E": "gru_scan bf16 (tensor cores, "
                                       "H = 34..48: FE_B)",
    "gru_scan_tc_kernelILi8ELi2ELb0E": "gru_scan bf16 (tensor cores, "
                                       "H = 114..128)",
    "gru_scan_kernelIfE": "gru_scan f32",
    "segmental_rms_kernelIfE": "segmental_rms f32"}


def ptxas_summary(reports):
    """{label: registers, static smem and spill bytes} of each kernel in
    PTXAS_KERNELS, from `nvcc -Xptxas -v` reports."""
    def number_before(text, phrase):
        head, found, _ = text.partition(phrase)
        return int(head.split()[-1]) if found else None

    out = {}
    for text in reports.values():
        for part in text.split("Compiling entry function '")[1:]:
            name = part.split("'", 1)[0]
            label = next((v for k, v in PTXAS_KERNELS.items() if k in name),
                         None)
            if label is None:
                continue
            used = part.partition("Used ")[2]
            out[label] = dict(
                registers=int(used.split()[0]) if used else None,
                smem=number_before(used.partition("\n")[0], " bytes smem")
                or 0,
                spill_stores=number_before(part, " bytes spill stores"),
                spill_loads=number_before(part, " bytes spill loads"))
    return out


def kernel_counters():
    """Each kernel's launch counter: {name: (wrapper, attribute)}; the
    block stack's LN form is a kernel of its own, counted apart. The
    counts grow in the ops' CUDA implementations (ops/_library.py)."""
    from fastenhancer_tpu_torch.ops import bsrnn_stack as band
    from fastenhancer_tpu_torch.ops import dprnn_stack as dprnn
    from fastenhancer_tpu_torch.ops import dpt_stack as dpt
    from fastenhancer_tpu_torch.ops import fused_frame as frame
    from fastenhancer_tpu_torch.ops import gru_scan as scan
    from fastenhancer_tpu_torch.ops import rnnformer_stack as stack
    from fastenhancer_tpu_torch.ops import segmental_rms as seg

    return {
        "rnnformer_stack_step": (stack.rnnformer_stack_step, "launches"),
        LN_KERNEL: (stack.rnnformer_stack_step, "ln_launches"),
        "fused_frame_step": (frame.fused_frame_step, "launches"),
        "dpt_stack_step": (dpt.dpt_stack_step, "launches"),
        DPT_TC: (dpt.dpt_stack_step, "tc_launches"),
        "bsrnn_stack_step": (band.bsrnn_stack_step, "launches"),
        BAND_TC: (band.bsrnn_stack_step, "tc_launches"),
        "dprnn_stack_step": (dprnn.dprnn_stack_step, "launches"),
        DPRNN_TC: (dprnn.dprnn_stack_step, "tc_launches"),
        "segmental_rms_fused": (seg.segmental_rms_fused, "launches"),
        "gru_scan": (scan.gru_scan, "launches"),
        GRU_TC: (scan.gru_scan, "tc_launches")}


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fastenhancer_tpu_torch import require_cuda
    from fastenhancer_tpu_torch.models import get_model
    from fastenhancer_tpu_torch.ops import _build
    from fastenhancer_tpu_torch.ops import bsrnn_stack as band
    from fastenhancer_tpu_torch.ops import dprnn_stack as dprnn
    from fastenhancer_tpu_torch.data import (DynamicMixer, ShardBatch,
                                             get_dataset_dataloader)
    from fastenhancer_tpu_torch.ops import dpt_stack as dpt
    from fastenhancer_tpu_torch.ops import fused_frame as frame
    from fastenhancer_tpu_torch.ops import gru_scan as scan
    from fastenhancer_tpu_torch.ops import rnnformer_stack as stack
    from fastenhancer_tpu_torch.ops import segmental_rms as seg
    from fastenhancer_tpu_torch.optim import get_optimizer
    from fastenhancer_tpu_torch.presets import (BSRNN_S, DPRNN_B, DPT_B, FE_B,
                                                FE_T_SHARD, FSPEN, LISENNET,
                                                LN_B, NONCAUSAL_HUGE,
                                                TIME_KERNEL_B)
    from fastenhancer_tpu_torch.serving import StreamingEngine
    from fastenhancer_tpu_torch.train import (make_infer_fn, make_train_step,
                                              make_valid_step)
    from fastenhancer_tpu_torch.utils import cast_floating, tree_map, tree_paths
    from fastenhancer_tpu_torch.data.audio_io import write_wav
    from fastenhancer_tpu_torch.train import load_checkpoint
    from fastenhancer_tpu_torch.train.__main__ import main as train_main
    from fastenhancer_tpu_torch.utils.hparams import HParams, get_hparams
    from fastenhancer_tpu_torch.wrappers import get_wrapper
    from fastenhancer_tpu_torch.wrappers import ns as ns_wrapper

    dev = require_cuda()
    counters = kernel_counters()

    def zero_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counts():
        return {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}

    def check_launches(counts, name, n, what, tc=None):
        """The path's own kernel ran n times and no other kernel ran; the
        BSRNN, dprnn and dpt stacks' and the GRU scan's launches are all
        their tensor-core forms' (bf16), or `tc` of them where given."""
        want = {k: 0 for k in counters}
        want[name] = n
        if name in TC_FORMS:
            want[TC_FORMS[name]] = n if tc is None else tc
        _check(counts == want, f"{what}: launches {counts} != {want}")

    t_mark = time.perf_counter()

    def phase_wall(phase, own=False):
        """Phase `phase`'s wall, the seconds since the last phase ended;
        printed unless the phase printed its own."""
        nonlocal t_mark
        now = time.perf_counter()
        if not own:
            print(f"[{phase}/30] phase wall {now - t_mark:.1f} s")
        t_mark = now

    # -- 1. card -----------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    card = f"[{smi}]"
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1/30] card: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} "
          f"| torch {torch.__version__}, CUDA {torch.version.cuda} | TF32 off "
          "for matmul and cuDNN (float32 checks run in full float32)")
    phase_wall(1)

    # -- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    names = _build.SOURCES
    _build.build_all(names, verbose=True)
    print(f"[2/30] build: {', '.join(n + '.cu' for n in names)} with nvcc for "
          f"sm_90a, in parallel, in {time.perf_counter() - t0:.2f} s")
    for label, info in ptxas_summary(_build.REPORTS).items():
        print(f"[2/30] ptxas {label}: {info['registers']} registers, "
              f"{info['smem']} bytes static smem, spill stores "
              f"{info['spill_stores']} B, spill loads {info['spill_loads']} B")
    phase_wall(2)

    # -- 3. kernels against their plain versions ------------------------------------
    def time_ms(fn, reps=7, inner=20):
        """(device ms, host ms) per call. Device: the median over `reps` of
        CUDA-event time over `inner` back-to-back calls, with a sleep
        kernel queued first that outlasts the host's enqueueing of the
        calls, so the events time the card and not the host's dispatch.
        Host: wall time per call of the same calls run unqueued, which is
        what a caller waits for when the host is the slower side."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        cycles = int(4e9 * host_s)  # twice the enqueue time at <= 2 GHz
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times), 1e3 * host_s / inner

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def bound(flops, n_bytes, dtype):
        """The least time the card could take: the larger of the bytes over
        the memory rate and the operations over the type's peak."""
        t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        return dict(bound_ms=max(t_ops, t_bytes), flops=flops, bytes=n_bytes,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")

    def compare(name, pairs, dtype):
        """Max abs error of each (kernel, plain) pair against its
        tolerance; raises on any above it."""
        errs = []
        for got, want in pairs:
            want = want.float()
            err = (got.float() - want).abs().max().item()
            tol = (F32_TOL if dtype == torch.float32
                   else BF16_REL * want.abs().max().item())
            _check(err <= tol, f"{name} {dtype}: kernel vs plain max abs "
                               f"err {err:.3e} > {tol:.3e}")
            errs.append((err, tol))
        return errs

    def graphed(fn):
        """fn captured as one CUDA graph: its replay is one launch for the
        host, so the sleep kernel can keep the queue ahead of a plain
        version of thousands of launches."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return graph.replay

    def timed(kernel, plain, err, bound_info, plain_graph=False):
        ms, host_ms = time_ms(kernel)
        if plain_graph:
            # thousands of launches per call: the device time of the plain
            # version is timed as a CUDA graph's replay, the host time as
            # its eager calls
            plain_ms, _ = time_ms(graphed(plain), inner=4)
            _, plain_host_ms = time_ms(plain, reps=1, inner=1)
        else:
            # few calls: ~130 launches each must fit the card's launch
            # queue while the sleep kernel holds it
            plain_ms, plain_host_ms = time_ms(plain, inner=4)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    host_ms=host_ms, plain_host_ms=plain_host_ms,
                    plain_timing="as a CUDA graph" if plain_graph
                    else "eagerly", **bound_info)

    def uniform_plan(shapes, c, dtype, g):
        return {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(
            dev, dtype) for k, s in shapes.items()}

    def stack_flops(b, f, c, nb):
        # operations per row and block: GRU 6 CxC, rnn_fc, qkv 3, attn_fc
        # (11 C^2 multiply-adds) and the scores and mix (2 F C of them)
        return b * f * nb * (22 * c * c + 4 * f * c)

    heads = 4
    record = {}
    fe_t = dict(FE_B, channels=24, rnnformer_kwargs=dict(
        FE_B["rnnformer_kwargs"], num_blocks=2, channels=20, freq=16))
    fe_s = dict(FE_B, channels=64, kernel_size=[8, 3, 3, 3],
                rnnformer_kwargs=dict(FE_B["rnnformer_kwargs"], channels=48,
                                      freq=36))

    # 3a. the block stack (kernel 1)
    for name, (b, f, c, nb) in (("FE_B", (STREAMS, 24, 36, 3)),
                                ("FE_T", (STREAMS, 16, 20, 2)),
                                ("FE_S", (STREAMS, 36, 48, 3))):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(f * c)
            plan = uniform_plan(stack.plan_shapes(nb, f, c), c, dtype, g)
            x = torch.randn(b, f, c, generator=g).to(dev, dtype)
            h = (torch.randn(nb, b * f, c, generator=g) * 0.5).to(dev, dtype)
            xo, ho = stack.rnnformer_stack_step(plan, x, h, heads)
            torch.cuda.synchronize()
            xr, hr = stack.rnnformer_stack_reference(plan, x, h, heads)
            errs = compare(f"rnnformer_stack {name}", ((xo, xr), (ho, hr)),
                           dtype)
            print(f"[3/30] kernel rnnformer_stack {name} B={b} F={f} C={c} "
                  f"H={heads} NB={nb} {str(dtype)[6:]}: max abs err x_out "
                  f"{errs[0][0]:.3e} (tol {errs[0][1]:.3e}), h_new "
                  f"{errs[1][0]:.3e} (tol {errs[1][1]:.3e})")
            if name == "FE_B" and dtype == torch.bfloat16:
                bound_info = bound(stack_flops(b, f, c, nb),
                                     nbytes(x, h, xo, ho, *plan.values()),
                                     dtype)
                record["rnnformer_stack_step"] = timed(
                    lambda: stack.rnnformer_stack_step(plan, x, h, heads),
                    lambda: stack.rnnformer_stack_reference(plan, x, h,
                                                            heads),
                    max(errs[0][0], errs[1][0]), bound_info)

    # 3a'. the block stack's LN form (kernel 1's ln form) at LN_B's block
    # shape: each post-norm's weight ~ 1 + 0.2 N(0, 1) and bias ~ 0.3 N(0, 1)
    # as plan_stack combines them, so diff + inv * (weight * bias) matters
    ln_rf = LN_B["rnnformer_kwargs"]
    b, f, c, nb = (STREAMS, ln_rf["freq"], ln_rf["channels"],
                   ln_rf["num_blocks"])
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(7 * f * c)
        plan = uniform_plan(stack.plan_shapes(nb, f, c), c, dtype, g)
        for key in stack.LN_KEYS:
            weight = 1.0 + 0.2 * torch.randn(nb, c, generator=g)
            bias = 0.3 * torch.randn(nb, c, generator=g)
            plan[key] = (weight * bias).to(dev, dtype)
        plan["ln_eps"] = float(ln_rf["eps"])
        x = torch.randn(b, f, c, generator=g).to(dev, dtype)
        h = (torch.randn(nb, b * f, c, generator=g) * 0.5).to(dev, dtype)
        xo, ho = stack.rnnformer_stack_step(plan, x, h, heads)
        torch.cuda.synchronize()
        xr, hr = stack.rnnformer_stack_reference(plan, x, h, heads)
        errs = compare("rnnformer_stack LN form LN_B", ((xo, xr), (ho, hr)),
                       dtype)
        print(f"[3/30] kernel rnnformer_stack LN form LN_B B={b} F={f} "
              f"C={c} H={heads} NB={nb} eps={plan['ln_eps']:g} "
              f"{str(dtype)[6:]}: max abs err x_out {errs[0][0]:.3e} (tol "
              f"{errs[0][1]:.3e}), h_new {errs[1][0]:.3e} (tol "
              f"{errs[1][1]:.3e})")
        if dtype == torch.bfloat16:
            # two LayerNorms a block: about 6 operations an element each
            # (sum, difference, square-sum, normalise, add) beside the stack
            bound_info = bound(
                stack_flops(b, f, c, nb) + b * nb * 2 * 6 * f * c,
                nbytes(x, h, xo, ho, *(v for v in plan.values()
                                       if torch.is_tensor(v))), dtype)
            record[LN_KERNEL] = timed(
                lambda: stack.rnnformer_stack_step(plan, x, h, heads),
                lambda: stack.rnnformer_stack_reference(plan, x, h, heads),
                max(errs[0][0], errs[1][0]), bound_info)

    # 3b. the whole frame (kernel 7), on folded random-init models
    def frame_case(kwargs, b, dtype, seed):
        model = get_model("fastenhancer.default", **kwargs)
        folded = model.fold(model.init(torch.Generator().manual_seed(seed),
                                       dev))
        plan = model.build_frame_plan(folded, dtype=dtype)
        g = torch.Generator().manual_seed(seed + 1)
        x = torch.randn(b, model.freq + 1, 2 * model.stride, generator=g)
        h = torch.randn(model.num_blocks, b * model.block_freq,
                        model.block_channels, generator=g) * 0.5
        kw = dict(num_heads=model.rf.num_heads,
                  n_enc=len(model.kernel_size) - 1,
                  enc_ks=tuple(model.kernel_size[1:]), f_enc=model.freq,
                  block_freq=model.block_freq, stride=model.stride,
                  resnet=model.resnet, mask=model.mask_name)
        return model, plan, x.to(dev, dtype), h.to(dev, dtype), kw

    def frame_flops(model, b):
        fe_, c, s2 = model.freq, model.channels, 2 * model.stride
        f2, c2 = model.block_freq, model.block_channels
        ks = model.kernel_size[1:]
        per = (fe_ * c * 2 * s2                        # PreNet, 2 taps
               + sum(fe_ * c * k * c for k in ks)      # encoder convs
               + f2 * c * fe_ + f2 * c2 * c            # rf_pre
               + fe_ * c2 * f2 + fe_ * c * c2          # rf_post
               + sum(fe_ * c * 2 * c + fe_ * c * k * c for k in ks)  # dec
               + fe_ * c * 2 * c                       # dec_post
               + fe_ * s2 * 2 * c)                     # ConvTranspose
        return 2 * b * per + stack_flops(b, f2, c2, model.num_blocks)

    for name, kwargs in (("FE_B", FE_B), ("FE_T", fe_t), ("FE_S", fe_s)):
        for dtype in (torch.float32, torch.bfloat16):
            model, plan, x, h, kw = frame_case(kwargs, STREAMS, dtype, 3)
            mo, ho = frame.fused_frame_step(plan, x, h,
                                            num_blocks=model.num_blocks, **kw)
            torch.cuda.synchronize()
            mr, hr = frame.fused_frame_reference(plan, x, h, **kw)
            errs = compare(f"fused_frame {name}", ((mo, mr), (ho, hr)), dtype)
            print(f"[3/30] kernel fused_frame {name} B={STREAMS} F_enc="
                  f"{model.freq} C={model.channels} F'={model.block_freq} "
                  f"C'={model.block_channels} NB={model.num_blocks} "
                  f"{str(dtype)[6:]}: max abs err mask8 {errs[0][0]:.3e} "
                  f"(tol {errs[0][1]:.3e}), h_new {errs[1][0]:.3e} (tol "
                  f"{errs[1][1]:.3e})")
            if name == "FE_B" and dtype == torch.bfloat16:
                flat = [plan[k] for k in frame.frame_plan_keys(kw["n_enc"])]
                bound_info = bound(
                    frame_flops(model, STREAMS),
                    nbytes(x, h, mo, ho, *flat, *plan["stack"].values()),
                    dtype)
                record["fused_frame_step"] = timed(
                    lambda: frame.fused_frame_step(
                        plan, x, h, num_blocks=model.num_blocks, **kw),
                    lambda: frame.fused_frame_reference(plan, x, h, **kw),
                    max(errs[0][0], errs[1][0]), bound_info)

    def print_forms(what, rec):
        """A stack's tensor-core form beside its scalar form (timed in the
        same call, launched directly), bf16 at 256 streams."""
        print(f"[3/30] {what} bf16 B={STREAMS}: the tensor-core form "
              f"{rec['ms']:.4f} ms, {100 * rec['bound_ms'] / rec['ms']:.2f}% "
              f"of its bound {1e3 * rec['bound_ms']:.3f} us "
              f"({rec['bound_by']}); the scalar form {rec['scalar_ms']:.4f} "
              f"ms ({rec['scalar_ms'] / rec['ms']:.2f}x); on {card}")

    # 3c. the dpt stack (kernel 2): a wrapped pointer, unwritten slots
    def dpt_flops(b, f, c, nb, lb):
        # multiply-adds per row and block: time qkv 3, time_fc, freq qkv 3,
        # freq_fc (8 C^2), the time scores and mix over L+1 keys and the
        # freq scores and mix over F keys
        return 2 * b * f * nb * (8 * c * c + 2 * (lb + 1) * c + 2 * f * c)

    lb = DPT_B["dpt_kwargs"]["lookbehind"]
    for name, (f, c, nb), (ptr, written) in (
            ("DPT_B", (24, 36, 3), (lb - 1, lb)),   # about to wrap
            ("DPT_T", (16, 20, 2), (0, lb)),        # wrapped to 0
            ("DPT_S", (36, 48, 3), (5, 12))):       # slots 12.. unwritten
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(f * c + 1)
            plan = uniform_plan(dpt.plan_shapes(nb, f, c, heads, lb), c,
                                dtype, g)
            x = torch.randn(STREAMS, f, c, generator=g).to(dev, dtype)
            shape = dpt.cache_shape(nb, STREAMS, lb, f, c)
            kc = torch.randn(shape, generator=g) * 0.5
            vc = torch.randn(shape, generator=g) * 0.5
            kc[:, :, written:] = 0
            vc[:, :, written:] = 0
            kc, vc = kc.to(dev, dtype), vc.to(dev, dtype)
            p = torch.tensor(ptr, dtype=torch.int32, device=dev)
            kc_r, vc_r = kc.clone(), vc.clone()
            form = dpt.kernel_form(f, c, heads, lb, dtype)
            before_tc = dpt.dpt_stack_step.tc_launches
            xo, po = dpt.dpt_stack_step(plan, x, kc, vc, p, heads)
            torch.cuda.synchronize()
            _check(dpt.dpt_stack_step.tc_launches - before_tc
                   == (form == "tc"), f"dpt_stack {name}: form {form}")
            _check((form == "tc") == (dtype == torch.bfloat16),
                   f"dpt_stack {name} {dtype} runs the {form} form")
            xr, pr = dpt.dpt_stack_reference(plan, x, kc_r, vc_r, p, heads)
            _check(int(po) == int(pr) == (ptr + 1) % lb,
                   f"dpt_stack pointer {int(po)} / {int(pr)}")
            errs = compare(f"dpt_stack {name}",
                           ((xo, xr), (kc, kc_r), (vc, vc_r)), dtype)
            print(f"[3/30] kernel dpt_stack {name} B={STREAMS} F={f} C={c} "
                  f"H={heads} NB={nb} L={lb} ptr={ptr} written slots "
                  f"{written} {str(dtype)[6:]}, {form} form: max abs err "
                  f"x_out {errs[0][0]:.3e} (tol {errs[0][1]:.3e}), k cache "
                  f"{errs[1][0]:.3e}, v cache {errs[2][0]:.3e}")
            if name == "DPT_B" and dtype == torch.bfloat16:
                # bytes: the whole cache read once, one slot per block and
                # cache written, the frame in and out, the plan
                slot = kc[:, :, 0]
                bound_info = bound(
                    dpt_flops(STREAMS, f, c, nb, lb),
                    nbytes(x, kc, vc, xo, slot, slot, *plan.values()), dtype)
                rec = record["dpt_stack_step"] = timed(
                    lambda: dpt.dpt_stack_step(plan, x, kc, vc, p, heads),
                    lambda: dpt.dpt_stack_reference(plan, x, kc_r, vc_r, p,
                                                    heads),
                    max(e for e, _ in errs), bound_info)
                # the scalar form in the same call, launched directly: not
                # a launch of the main path
                rec["scalar_ms"], _ = time_ms(
                    lambda: dpt.launch_scalar(plan, x, kc, vc, p, heads))
                print_forms("dpt_stack DPT_B", rec)
    # 3d. the BSRNN stack (kernel 3) at the XT and S shapes, 256 streams
    def band_flops(b, f, c, nl):
        # multiply-adds per row and layer with H = 2C: the time cell and
        # both sweep directions 4H (C + H) each, fc_time H C, fc_freq 2H C
        hd = 2 * c
        return 2 * b * f * nl * (3 * 4 * hd * (c + hd) + 3 * hd * c)

    for name, c in (("BSRNN_S", 64), ("BSRNN_XT", 16)):
        nl, f, hd = 6, 31, 2 * c
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(c + 3)
            plan = uniform_plan(band.plan_shapes(nl, c, hd), c, dtype, g)
            x = torch.randn(f, STREAMS, c, generator=g).to(dev, dtype)
            h = (torch.randn(nl, 2, f, STREAMS, hd, generator=g) * 0.5).to(
                dev, dtype)
            form = band.kernel_form(f, c, hd, dtype)
            before_tc = band.bsrnn_stack_step.tc_launches
            xo, ho = band.bsrnn_stack_step(plan, x, h)
            torch.cuda.synchronize()
            _check(band.bsrnn_stack_step.tc_launches - before_tc
                   == (form == "tc"), f"bsrnn_stack {name}: form {form}")
            _check((form == "tc") == (dtype == torch.bfloat16),
                   f"bsrnn_stack {name} {dtype} runs the {form} form")
            xr, hr = band.bsrnn_stack_reference(plan, x, h)
            errs = compare(f"bsrnn_stack {name}", ((xo, xr), (ho, hr)), dtype)
            print(f"[3/30] kernel bsrnn_stack {name} B={STREAMS} F={f} C={c} "
                  f"H={hd} L={nl} {str(dtype)[6:]}, {form} form: max abs err "
                  f"x_out {errs[0][0]:.3e} (tol {errs[0][1]:.3e}), h_new "
                  f"{errs[1][0]:.3e} (tol {errs[1][1]:.3e})")
            if name == "BSRNN_S" and dtype == torch.bfloat16:
                bound_info = bound(band_flops(STREAMS, f, c, nl),
                                   nbytes(x, h, xo, ho, *plan.values()),
                                   dtype)
                rec = record["bsrnn_stack_step"] = timed(
                    lambda: band.bsrnn_stack_step(plan, x, h),
                    lambda: band.bsrnn_stack_reference(plan, x, h),
                    max(errs[0][0], errs[1][0]), bound_info, plain_graph=True)
                # the scalar form in the same call, launched directly: not
                # a launch of the main path
                rec["scalar_ms"], _ = time_ms(
                    lambda: band.launch_scalar(plan, x, h))
                print_forms("bsrnn_stack BSRNN_S", rec)

    # 3e. the dprnn stack (kernel 6) at the DPRNN-T and -B shapes
    def dprnn_flops(b, f, c, hd, nb):
        # multiply-adds per row and block: the time GRU 6 C^2, trnn_fc C^2,
        # both sweep directions 3Hd (C + Hd) each, frnn_fc 2Hd C
        return 2 * b * f * nb * (7 * c * c + 6 * hd * (c + hd) + 2 * hd * c)

    for name, (f, c, nb) in (("DPRNN_B", (24, 36, 3)),
                             ("DPRNN_T", (16, 20, 2))):
        hd = c // 2
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(f * c + 2)
            plan = uniform_plan(dprnn.plan_shapes(nb, c, hd), c, dtype, g)
            x = torch.randn(f, STREAMS, c, generator=g).to(dev, dtype)
            h = (torch.randn(nb, f, STREAMS, c, generator=g) * 0.5).to(
                dev, dtype)
            form = dprnn.kernel_form(f, c, hd, dtype)
            before_tc = dprnn.dprnn_stack_step.tc_launches
            xo, ho = dprnn.dprnn_stack_step(plan, x, h)
            torch.cuda.synchronize()
            _check(dprnn.dprnn_stack_step.tc_launches - before_tc
                   == (form == "tc"), f"dprnn_stack {name}: form {form}")
            _check((form == "tc") == (dtype == torch.bfloat16),
                   f"dprnn_stack {name} {dtype} runs the {form} form")
            xr, hr = dprnn.dprnn_stack_reference(plan, x, h)
            errs = compare(f"dprnn_stack {name}", ((xo, xr), (ho, hr)), dtype)
            print(f"[3/30] kernel dprnn_stack {name} B={STREAMS} F={f} C={c} "
                  f"Hd={hd} NB={nb} {str(dtype)[6:]}, {form} form: max abs "
                  f"err x_out {errs[0][0]:.3e} (tol {errs[0][1]:.3e}), h_new "
                  f"{errs[1][0]:.3e} (tol {errs[1][1]:.3e})")
            if name == "DPRNN_B" and dtype == torch.bfloat16:
                bound_info = bound(dprnn_flops(STREAMS, f, c, hd, nb),
                                   nbytes(x, h, xo, ho, *plan.values()),
                                   dtype)
                rec = record["dprnn_stack_step"] = timed(
                    lambda: dprnn.dprnn_stack_step(plan, x, h),
                    lambda: dprnn.dprnn_stack_reference(plan, x, h),
                    max(errs[0][0], errs[1][0]), bound_info, plain_graph=True)
                rec["scalar_ms"], _ = time_ms(
                    lambda: dprnn.launch_scalar(plan, x, h))
                print_forms("dprnn_stack DPRNN_B", rec)

    # 3f. segmental RMS (kernel 4): silent, half-quiet and -60 dB rows, T
    # a multiple of the window, not one, and shorter than one
    def rms_rows(b, t, seed):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(b, t, generator=g) * 0.1
        x[1:2] = 0.0                 # silent: +inf
        x[2:3, : t // 2] *= 1e-3     # 60 dB quieter first half: dropped
        x[3:4] *= 1e-2               # -60 dB: below the -50 dB floor
        return x

    def rms_err(got, want, dtype, what):
        """Max abs error over the finite entries; +inf where plain has it;
        each finite entry within 1e-5 (float32) or one bf16 ulp (2^-7) of
        the plain value, relative."""
        _check(torch.equal(torch.isinf(got), torch.isinf(want)),
               f"{what}: +inf rows differ")
        fin = torch.isfinite(want)
        diff = (got.float()[fin] - want.float()[fin]).abs()
        rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        _check(bool((diff <= rel * want.float()[fin].abs()).all()),
               f"{what}: kernel vs plain relative error above {rel:g}")
        return diff.max().item(), rel

    for b, t in ((TRAIN_ROWS, int(TRAIN_SECONDS * SR)), (5, 5 * 1600 + 700),
                 (4, 1300), (1, 64_003), (200, 64_003)):
        for abs_db in (None, -50.0):
            for dtype in (torch.float32, torch.bfloat16):
                x = rms_rows(b, t, t).to(dev, dtype)
                got = seg.segmental_rms_fused(x, absolute_threshold_db=abs_db)
                torch.cuda.synchronize()
                want = seg.segmental_rms(x, absolute_threshold_db=abs_db)
                err, rel = rms_err(got, want, dtype, f"segmental_rms {b}x{t}")
                print(f"[3/30] kernel segmental_rms B={b} T={t} abs floor "
                      f"{abs_db} {str(dtype)[6:]}, {seg.cluster_size(b)} "
                      f"blocks a row: rows +inf "
                      f"{torch.isinf(got).flatten().tolist()[:4]}, max abs "
                      f"err {err:.3e} (each within {rel:g} relative)")
                if ((b, t) == (TRAIN_ROWS, int(TRAIN_SECONDS * SR))
                        and abs_db is None and dtype == torch.float32):
                    bound_info = bound(2 * b * t, nbytes(x, got), dtype)
                    rec = record["segmental_rms_fused"] = timed(
                        lambda: seg.segmental_rms_fused(
                            x, absolute_threshold_db=None),
                        lambda: seg.segmental_rms(
                            x, absolute_threshold_db=None), err, bound_info)
                    # a launch's own device time: an empty kernel (a spin
                    # of 0 cycles) timed the same way, in the same call
                    rec["empty_ms"], _ = time_ms(
                        lambda: torch.cuda._sleep(0))
                    print(f"[3/30] segmental_rms B={b} T={t} float32, a "
                          f"cluster of {seg.cluster_size(b)} blocks a row: "
                          f"{rec['ms']:.4f} ms, "
                          f"{100 * rec['bound_ms'] / rec['ms']:.2f}% of its "
                          f"bound {1e3 * rec['bound_ms']:.3f} us (bytes); an "
                          f"empty kernel {rec['empty_ms']:.4f} ms; on {card}")

    # 3g. the GRU scan (kernel 5) at FE-T's and FE-B's widths
    def scan_case(t, n, h, dtype, seed, h0):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(t, n, 3 * h, generator=g)
        w = (torch.rand(3 * h, h, generator=g) * 2 - 1) / h ** 0.5
        b = (torch.rand(3 * h, generator=g) * 2 - 1) / h ** 0.5
        hh = (torch.randn(n, h, generator=g) * 0.5 if h0
              else torch.zeros(n, h))
        return [a.to(dev, dtype) for a in (x, hh, w, b)]

    valid_frames = int(VALID_SECONDS * SR) // 256 + 1
    valid_n = VALID_ROWS * FE_T_SHARD["model_kwargs"]["rnnformer_kwargs"][
        "freq"]
    def cudnn_gru(args):
        """The library yardstick: cuDNN's GRU with W_ih = I and b_ih = 0
        computes the same recurrence from x_proj (it may round its state
        each step); checked within 2^-3 of the peak, and timed."""
        h = args[2].shape[1]
        lib = torch.nn.GRU(3 * h, h).to(dev, args[0].dtype)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(torch.eye(3 * h))
            lib.bias_ih_l0.zero_()
            lib.weight_hh_l0.copy_(args[2])
            lib.bias_hh_l0.copy_(args[3])
            lib.flatten_parameters()
            ys_l, _ = lib(args[0], args[1][None])
            ys_r, _ = scan.gru_scan_reference(*args)
            lib_err = (ys_l.float() - ys_r.float()).abs().max().item()
            _check(lib_err <= 2 ** -3 * ys_r.float().abs().max().item(),
                   f"cuDNN GRU vs gru_scan's plain version: {lib_err}")
            return time_ms(lambda: lib(args[0], args[1][None]))

    def check_scan(t, n, h, h0, dtype, flip=False, phase=3):
        """One case of #5 against its plain version, its form checked;
        flip runs the backward direction of a biGRU (x_proj time-flipped).
        -> (args, ys, h_T, errs)."""
        args = scan_case(t, n, h, dtype, t + n + h, h0)
        if flip:
            args[0] = args[0].flip(0)
        form = scan.kernel_form(n, h, dtype)
        before_tc = scan.gru_scan.tc_launches
        ys, h_t = scan.gru_scan(*args)
        torch.cuda.synchronize()
        _check(scan.gru_scan.tc_launches - before_tc == (form == "tc")
               and (form == "tc") == (dtype == torch.bfloat16),
               f"gru_scan T={t} N={n} H={h} {dtype} runs the {form} form")
        ys_r, h_r = scan.gru_scan_reference(*args)
        errs = compare(f"gru_scan T={t} N={n} H={h}",
                       ((ys, ys_r), (h_t, h_r)), dtype)
        print(f"[{phase}/30] kernel gru_scan T={t} N={n} H={h} h0 "
              f"{'given' if h0 else 'None'}{', time-flipped' if flip else ''}"
              f" {str(dtype)[6:]}, {form} form: max abs err ys "
              f"{errs[0][0]:.3e} (tol {errs[0][1]:.3e}), h_T "
              f"{errs[1][0]:.3e} (tol {errs[1][1]:.3e})")
        return args, ys, h_t, errs

    def scan_bound(t, n, h, args, ys, h_t, dtype):
        # operations: 3H x H multiply-adds a row and step, and about 12
        # more a unit for the gates
        return bound(t * n * (6 * h * h + 12 * h), nbytes(*args, ys, h_t),
                     dtype)

    for t, n, h, h0 in ((valid_frames, valid_n, 20, False), (13, 37, 20, True),
                        (valid_frames, 301, 36, True), (13, 5, 36, False)):
        for dtype in (torch.float32, torch.bfloat16):
            args, ys, h_t, errs = check_scan(t, n, h, h0, dtype)
            if t != valid_frames or dtype != torch.bfloat16:
                continue
            # both forms launched directly (not launches of the main path)
            # and cuDNN's GRU, in this call
            forms = {f"tc ({scan.tc_warps(h)} warps a tile)": time_ms(
                lambda: scan.launch_tc(*args))[0]}
            forms["scalar"] = time_ms(lambda: scan.launch_scalar(*args))[0]
            lib_ms, lib_host_ms = cudnn_gru(args)
            forms["cuDNN GRU"] = lib_ms
            print(f"[3/30] gru_scan T={t} N={n} H={h} bf16 ({scan.tc_tiles(n)}"
                  " tiles of 16 rows): " + ", ".join(
                      f"{k} {v:.4f} ms" for k, v in forms.items())
                  + f"; on {card}")
            if n == valid_n:
                bound_info = scan_bound(t, n, h, args, ys, h_t, dtype)
                rec = timed(lambda: scan.gru_scan(*args),
                            lambda: scan.gru_scan_reference(*args),
                            max(errs[0][0], errs[1][0]), bound_info,
                            plain_graph=True)
                rec["library_ms"], rec["library_host_ms"] = (lib_ms,
                                                             lib_host_ms)
                record["gru_scan"] = rec

    # 3g'. #5 at every shape this slice's paths give it: FE_B's chunked
    # stream (phase 16: chunks of 1, 4 and 8 frames over 256 x 24 rows from
    # a carried state; the tile tail ragged at one row less) and the huge
    # noncausal model's biGRU (phase 18: the offline STFT's frames of
    # NC_SECONDS, N = NC_STREAMS x 64, H = 128, both directions), each
    # timed in bf16 beside its plain version, its bound and cuDNN's GRU
    nc_frames = int(NC_SECONDS * SR) // NONCAUSAL_HUGE["hop_size"] + 1
    nc_rows = NC_STREAMS * NONCAUSAL_HUGE["rnnformer_kwargs"]["freq"]
    def check_and_time(shapes, phase=3):
        """Each (T, N, H, h0, flip, timed, path) of #5 against its plain
        version in both dtypes; the timed ones also in bf16 beside the
        plain version, the bound and cuDNN's GRU."""
        for t, n, h, h0, flip, timed_case, path in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                args, ys, h_t, errs = check_scan(t, n, h, h0, dtype, flip,
                                                 phase)
                if dtype != torch.bfloat16 or not timed_case:
                    continue
                rec = timed(lambda: scan.gru_scan(*args),
                            lambda: scan.gru_scan_reference(*args),
                            max(errs[0][0], errs[1][0]),
                            scan_bound(t, n, h, args, ys, h_t, dtype),
                            plain_graph=True)
                rec["library_ms"], _ = cudnn_gru(args)
                print(f"[{phase}/30] time gru_scan T={t} N={n} H={h} bf16, "
                      f"{path} "
                      f"({scan.tc_tiles(n)} tiles of 16 rows, "
                      f"{scan.tc_warps(h)} warps a tile): kernel "
                      f"{rec['ms']:.4f} ms, plain PyTorch "
                      f"{rec['plain_ms']:.4f} ms (as a CUDA graph), cuDNN GRU "
                      f"{rec['library_ms']:.4f} ms; bound "
                      f"{1e3 * rec['bound_ms']:.3f} us, "
                      f"{100 * rec['bound_ms'] / rec['ms']:.2f}% of the "
                      f"kernel's time ({rec['bound_by']}; "
                      f"{rec['flops'] / 1e9:.4f} GFLOP, "
                      f"{rec['bytes'] / 1e6:.4f} MB); on {card}")

    check_and_time([
        (1, STREAMS * 24, 36, True, False, True, "FE_B per frame"),
        (4, STREAMS * 24, 36, True, False, True, "FE_B chunk of 4"),
        (4, STREAMS * 24 - 1, 36, True, False, False, "ragged"),
        (8, STREAMS * 24, 36, True, False, True, "FE_B chunk of 8"),
        (nc_frames, nc_rows, 128, False, False, True, "noncausal biGRU"),
        (nc_frames, nc_rows, 128, False, True, False,
         "noncausal biGRU backward")])

    # 3g''. #5 at every shape phases 19 and 20 give it: FSPEN's (H = 16)
    # and LiSenNet's (H = 12 a direction) intra biGRUs over the 32 bins of
    # a frame (N = 256 streams), of a chunk of 4 (N = 1024) and offline (N
    # = 4 streams x 251 frames), both directions; their time GRUs (FSPEN's
    # 8 groups of 4 bins, H = 16; LiSenNet's 32 bins, H = 24) a frame and a
    # chunk from a carried state (ragged at one row less) and offline
    bl_frames = int(BASELINE_OFF_SECONDS * SR) // 256 + 1
    bl_rows = BASELINE_OFF_STREAMS * bl_frames
    baseline_shapes = []
    for tag, h_intra, h_time, bins in (("FSPEN", 16, 16, 4),
                                       ("LiSenNet", 12, 24, 32)):
        for n, what in ((STREAMS, "a frame"), (4 * STREAMS, "a chunk of 4"),
                        (bl_rows, "offline")):
            for flip in (False, True):
                baseline_shapes.append(
                    (32, n, h_intra, False, flip, not flip,
                     f"{tag} intra biGRU{' backward' if flip else ''}, "
                     f"{what}"))
        rows = STREAMS * bins
        baseline_shapes += [
            (1, rows, h_time, True, False, True, f"{tag} time GRU, a frame"),
            (4, rows, h_time, True, False, True,
             f"{tag} time GRU, a chunk of 4"),
            (4, rows - 1, h_time, True, False, False, "ragged"),
            (bl_frames, BASELINE_OFF_STREAMS * bins, h_time, False, False,
             True, f"{tag} time GRU, offline")]
    check_and_time(baseline_shapes)

    for name, r in record.items():
        lib = ("" if r.get("library_ms") is None else
               f", library {r['library_ms']:.4f} ms")
        print(f"[3/30] time {name}: kernel {r['ms']:.4f} ms, "
              f"plain PyTorch {r['plain_ms']:.4f} ms{lib} on the device "
              f"(CUDA events, median, queue kept ahead; plain timed "
              f"{r['plain_timing']}); bound "
              f"{1e3 * r['bound_ms']:.3f} us, "
              f"{100 * r['bound_ms'] / r['ms']:.2f}% of the kernel's time "
              f"({r['bound_by']}; "
              f"{r['flops'] / 1e9:.4f} GFLOP, {r['bytes'] / 1e6:.4f} MB); "
              "with the "
              f"host's dispatch: kernel {r['host_ms']:.4f} ms, plain "
              f"{r['plain_host_ms']:.4f} ms per call; on {card}")

    phase_wall(3)

    # -- 4. serving FE_B; 6. serving DPT-B ---------------------------------------------
    def vary_norms(tree, g):
        """Every GroupNorm and LayerNorm affine pair (gn, gn1, gn2, ln) set
        to weight ~ 1 + 0.2 N(0, 1) and bias ~ 0.1 N(0, 1): at init they are
        1 and 0, which makes the GroupNorms identities and the LayerNorm's
        weight * bias term zero."""
        if isinstance(tree, list):
            return [vary_norms(v, g) for v in tree]
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k in ("gn", "gn1", "gn2", "ln"):
                n = v["weight"].shape
                v = {"weight": (1.0 + 0.2 * torch.randn(n, generator=g)
                                ).to(dev),
                     "bias": (0.1 * torch.randn(n, generator=g)).to(dev)}
            out[k] = vary_norms(v, g)
        return out

    def serve(model_name, kwargs, tag, phase, norms=False, fused=True):
        """Staggered requests through a capacity-256 bf16 engine, fused
        unless told otherwise; the launch counts are zeroed just before and
        read just after. With norms, the norm affine terms are drawn away
        from their init."""
        model = get_model(model_name, **kwargs, stft_method="matmul")
        hop = model.hop_size
        g = torch.Generator().manual_seed(0)
        variables = model.init(g, device=dev)
        if norms:
            variables["params"] = vary_norms(variables["params"], g)
        folded = model.fold(variables)
        folded_bf16 = cast_floating(folded, torch.bfloat16)
        engine = StreamingEngine(model, folded_bf16, capacity=STREAMS,
                                 dtype=torch.bfloat16, fused=fused,
                                 device=dev)
        delay_ticks = -(-engine.delay_samples // hop)
        rng = np.random.default_rng(1)
        seconds = (1.0, 1.5, 2.0, 1.25, 1.75, 1.0)
        open_at = (0, 3, 7, 12, 20, 90)  # the last opens after the first closed
        wavs = [rng.uniform(-0.1, 0.1, int(s * SR)).astype(np.float32)
                for s in seconds]
        n_hops = [-(-len(w) // hop) for w in wavs]
        outs = {k: [] for k in range(len(wavs))}
        handles, pos, slots, done = {}, {}, {}, set()
        ticks = 0
        zero_counts()
        t0 = time.perf_counter()
        while len(done) < len(wavs):
            for k, t_open in enumerate(open_at):
                if t_open == ticks:
                    handles[k] = engine.open_stream()
                    slots[k] = engine._slot_of[handles[k]]
                    pos[k] = 0
            feed = {}
            for k, hnd in handles.items():
                seg = np.zeros(hop, np.float32)
                w = wavs[k][pos[k] * hop:(pos[k] + 1) * hop]
                seg[:len(w)] = w
                feed[hnd] = seg
            got = engine.tick(feed)
            ticks += 1
            for k in list(handles):
                outs[k].append(got[handles[k]])
                pos[k] += 1
                if pos[k] == n_hops[k] + delay_ticks:
                    engine.close_stream(handles.pop(k))
                    done.add(k)
        serve_s = time.perf_counter() - t0
        counts = read_counts()
        _check(slots[5] == slots[0], f"slot reuse expected: {slots}")

        results = {}
        for k, chunks in outs.items():
            y = np.concatenate(chunks)[engine.delay_samples:
                                       engine.delay_samples + len(wavs[k])]
            _check(y.shape == (len(wavs[k]),), f"stream {k}: length {y.shape}")
            _check(np.isfinite(y).all(), f"stream {k}: non-finite output")
            results[k] = y

        def isolated(variables, wav, dtype, plan):
            pad = -len(wav) % hop + delay_ticks * hop
            x = torch.from_numpy(np.pad(wav, (0, pad)))[None].to(dev, dtype)
            plan_arg = {} if plan is None else {"fused_plan": plan}
            y = model.stream(variables, x, **plan_arg)[0].float().cpu()
            return y.numpy()[engine.delay_samples:
                             engine.delay_samples + len(wav)]

        k = 2  # the longest request, served beside the others
        ref = isolated(folded_bf16, wavs[k], torch.bfloat16,
                       model.build_stack_plan(folded_bf16) if fused
                       else None)
        iso_err = float(np.abs(results[k] - ref).max())
        iso_tol = BF16_REL * float(np.abs(ref).max())
        _check(iso_err <= iso_tol, f"{tag} engine vs isolated: {iso_err} > "
                                   f"{iso_tol}")
        f32_note = "unfused (no stack plan)"
        if fused:
            y_fused = isolated(folded, wavs[k], torch.float32,
                               model.build_stack_plan(folded))
            y_plain = isolated(folded, wavs[k], torch.float32, None)
            f32_err = float(np.abs(y_fused - y_plain).max())
            _check(f32_err <= STREAM_F32_TOL,
                   f"{tag} fused vs unfused float32: {f32_err} > "
                   f"{STREAM_F32_TOL}")
            f32_note = (f"fused vs unfused float32 max abs err {f32_err:.3e}"
                        f" (tol {STREAM_F32_TOL:g})")
        print(f"[{phase}/30] serving {tag} bf16 capacity {STREAMS}: "
              f"{len(wavs)} requests ({', '.join(f'{s:g}' for s in seconds)} "
              f"s) in {ticks} ticks, slot {slots[0]} reused, launches "
              f"{counts}; all outputs finite and full length; stream {k} vs "
              f"its isolated run max abs err {iso_err:.3e} (tol "
              f"{iso_tol:.3e}); {f32_note}; {serve_s:.2f} s wall "
              "(informational)")
        return ticks, counts

    ticks, counts = serve("fastenhancer.default", FE_B, "FE_B", 4)
    check_launches(counts, "rnnformer_stack_step", ticks, "FE_B serving")
    record["rnnformer_stack_step"]["launches"] = counts["rnnformer_stack_step"]
    phase_wall(4)

    # -- 5. throughput FE_B; 8. throughput DPT-B ----------------------------------------
    def throughput(model_name, kwargs, tag, seconds, phase, kernel):
        model = get_model(model_name, **kwargs, stft_method="matmul")
        hop = model.hop_size
        folded = cast_floating(model.fold(model.init(
            torch.Generator().manual_seed(0), device=dev)), torch.bfloat16)
        plan = model.build_stack_plan(folded)
        g = torch.Generator().manual_seed(2)
        n_samples = int(seconds * SR) // hop * hop
        wav = (torch.randn(STREAMS, n_samples, generator=g) * 0.05).to(
            dev, torch.bfloat16)
        model.stream(folded, wav[:, :hop * 16], fused_plan=plan)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        y = model.stream(folded, wav, fused_plan=plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        frames = n_samples // hop
        check_launches(counts, kernel, frames, f"{tag} throughput")
        _check(tuple(y.shape) == (STREAMS, n_samples),
               f"stream shape {y.shape}")
        _check(bool(torch.isfinite(y).all()), "non-finite stream output")
        audio_s = n_samples / SR
        rtf = wall / (audio_s * STREAMS)
        print(f"[{phase}/30] throughput {tag} bf16 Model.stream fused, "
              f"{STREAMS} streams x {audio_s:g} s: wall {wall:.3f} s, "
              f"{1e3 * wall / frames:.4f} ms per frame step, per-stream RTF "
              f"{rtf:.4e} = wall/(audio s x streams) on {card}")
        return 1e3 * wall / frames, rtf

    fe_ms, fe_rtf = throughput("fastenhancer.default", FE_B, "FE_B",
                               FE_SECONDS, 5, "rnnformer_stack_step")
    phase_wall(5)

    ticks, counts = serve("fastenhancer.dptransformer", DPT_B, "DPT-B", 6)
    check_launches(counts, "dpt_stack_step", ticks, "DPT-B serving")
    record["dpt_stack_step"]["launches"] = counts["dpt_stack_step"]
    phase_wall(6)

    # -- 7. whole frame FE_B ---------------------------------------------------------
    model = get_model("fastenhancer.default", **FE_B, stft_method="matmul")
    hop = model.hop_size
    folded = cast_floating(model.fold(model.init(
        torch.Generator().manual_seed(0), device=dev)), torch.bfloat16)
    frame_plan = model.build_frame_plan(folded)
    stack_plan = model.build_stack_plan(folded)
    frames = -(-int(FRAME_SECONDS * SR) // hop)  # at least FRAME_SECONDS
    g = torch.Generator().manual_seed(4)
    wav = (torch.randn(STREAMS, frames * hop, generator=g) * 0.05).to(
        dev, torch.bfloat16)

    def run(step, plan, n):
        carry = model.init_streaming_carry(STREAMS, torch.bfloat16, dev,
                                           fused=True)
        outs = []
        for i in range(n):
            carry, y = step(folded, plan, carry, wav[:, i * hop:(i + 1) * hop])
            outs.append(y)
        return torch.cat(outs, 1)

    run(model.streaming_step_fused_frame, frame_plan, 8)   # warm-up
    run(model.streaming_step_fused, stack_plan, 8)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    y_frame = run(model.streaming_step_fused_frame, frame_plan, frames)
    torch.cuda.synchronize()
    wall_frame = time.perf_counter() - t0
    counts = read_counts()
    check_launches(counts, "fused_frame_step", frames, "whole frame")
    record["fused_frame_step"]["launches"] = counts["fused_frame_step"]
    t0 = time.perf_counter()
    y_stack = run(model.streaming_step_fused, stack_plan, frames)
    torch.cuda.synchronize()
    wall_stack = time.perf_counter() - t0
    _check(tuple(y_frame.shape) == (STREAMS, frames * hop)
           and bool(torch.isfinite(y_frame).all()),
           f"whole frame output {tuple(y_frame.shape)} not finite/full")
    frame_err = (y_frame.float() - y_stack.float()).abs().max().item()
    frame_tol = BF16_REL * y_stack.float().abs().max().item()
    _check(frame_err <= frame_tol, f"whole frame vs streaming_step_fused: "
                                   f"{frame_err:.3e} > {frame_tol:.3e}")
    audio_s = frames * hop / SR
    print(f"[7/30] whole frame FE_B bf16, {STREAMS} streams x {audio_s:g} s: "
          f"streaming_step_fused_frame {1e3 * wall_frame / frames:.4f} ms "
          f"per frame (per-stream RTF "
          f"{wall_frame / (audio_s * STREAMS):.4e}), fused_frame_step "
          f"launches {counts['fused_frame_step']} == frames; "
          f"streaming_step_fused on the same input "
          f"{1e3 * wall_stack / frames:.4f} ms per frame (RTF "
          f"{wall_stack / (audio_s * STREAMS):.4e}; phase 5: {fe_ms:.4f} ms, "
          f"RTF {fe_rtf:.4e}); outputs max abs diff {frame_err:.3e} (tol "
          f"{frame_tol:.3e}) on {card}")
    phase_wall(7)

    throughput("fastenhancer.dptransformer", DPT_B, "DPT-B", DPT_SECONDS, 8,
               "dpt_stack_step")
    phase_wall(8)

    # -- 9. serving BSRNN-S; 10. serving DPRNN-B; 11. throughput BSRNN-S ----------
    for model_name, kwargs, tag, phase, kernel in (
            ("bsrnn", BSRNN_S, "BSRNN-S", 9, "bsrnn_stack_step"),
            ("fastenhancer.dprnn", DPRNN_B, "DPRNN-B", 10,
             "dprnn_stack_step")):
        ticks, counts = serve(model_name, kwargs, tag, phase)
        check_launches(counts, kernel, ticks, f"{tag} serving")
        record[kernel]["launches"] = counts[kernel]
        phase_wall(phase)
    throughput("bsrnn", BSRNN_S, "BSRNN-S", BSRNN_SECONDS, 11,
               "bsrnn_stack_step")
    phase_wall(11)

    # -- 12. serving LN_B; 13. serving TIME_KERNEL_B --------------------------
    # LN_B, its norms' affine terms drawn away from 1 and 0, through the
    # block stack's LN form; TIME_KERNEL_B through its folded default form
    # (its launches stay FE_B's in the record)
    ticks, counts = serve("fastenhancer.ln", LN_B, "LN_B", 12, norms=True)
    check_launches(counts, LN_KERNEL, ticks, "LN_B serving")
    record[LN_KERNEL]["launches"] = counts[LN_KERNEL]
    phase_wall(12)
    ticks, counts = serve("fastenhancer.time_kernel", TIME_KERNEL_B,
                          "TIME_KERNEL_B", 13)
    check_launches(counts, "rnnformer_stack_step", ticks,
                   "TIME_KERNEL_B serving")
    phase_wall(13)

    # -- 14. train FE-T on the shard recipe ---------------------------------
    def speech_like(rng, rows, n):
        """Noise under a 3 Hz syllable envelope, silent for a sixth of the
        row, so the segmental thresholds have frames to drop."""
        tt = np.arange(n) / SR
        env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * tt
                                 + rng.uniform(0, 2 * np.pi, (rows, 1)))
        x = rng.standard_normal((rows, n)) * 0.1 * env
        x[:, n // 3: n // 2] = 0.0
        return x.astype(np.float32)

    def shard_batch(rows, n, seed):
        """A synthetic ShardBatch: noise with a silent row, 0.5 s RIRs that
        are unit impulses on half the rows and decaying noise on the others,
        with t60 above and below the recipe's t60_max of 0.15 s."""
        rng = np.random.default_rng(seed)
        speech = speech_like(rng, rows, n)
        noise = (rng.standard_normal((rows, n)) * 0.05).astype(np.float32)
        noise[0] = 0.0
        t_rir = int(RIR_SECONDS * SR)
        rir = np.zeros((rows, t_rir), np.float32)
        rir[:, 0] = 1.0
        onset = np.zeros(rows, np.int64)
        t60 = np.full(rows, 1e-3, np.float32)
        k = np.arange(t_rir)
        for i in range(rows // 2, rows):
            t60[i] = 0.3 if i % 2 else 0.1
            onset[i] = rng.integers(0, 200)
            r = rng.standard_normal(t_rir) * np.exp(
                -6.9 * np.clip(k - onset[i], 0, None) / (t60[i] * SR))
            r[:onset[i]] = 0.0
            rir[i] = r / np.abs(r).max()
        return ShardBatch(
            speech=speech[:, None], speech_clean=speech[:, None].copy(),
            noise=noise[:, None], rir=rir[:, None], rir_onset=onset,
            rir_t60=t60, num_samples=np.full(rows, n),
            id_speech=[f"synthetic-{i}" for i in range(rows)])

    def tree_diff(got, want):
        """Max over leaves of |got - want| - 1e-5 |want| (<= atol passes)."""
        w = dict(tree_paths(want))
        return max(((a.detach().cpu() - w[p].detach().cpu()).abs()
                    - 1e-5 * w[p].detach().cpu().abs()).max().item()
                   for p, a in tree_paths(got))

    hps = FE_T_SHARD
    n_train = int(TRAIN_SECONDS * SR)
    batch = shard_batch(TRAIN_ROWS, n_train, seed=5)
    wrapper = get_wrapper(hps["wrapper"])(HParams(**hps), train=True)
    _check(wrapper.compute_dtype == torch.bfloat16,
           "the recipe's fp16 flag did not give bfloat16 compute")
    model = wrapper.model
    start = tree_map(lambda a: a.detach().clone(), wrapper.state["variables"])
    warmup = hps["train"]["scheduler_kwargs"]["warmup_iterations"]
    base_lrs = list(wrapper.optim.base_lrs)
    totals, norms, lrs_used, mix_ms, step_ms = [], [], [], [], []
    handed_at = []  # host clock when train_epoch took each batch

    def batches():
        """The one batch over and over, the mixer re-seeded each time so
        that every step sees the same mix."""
        while True:
            wrapper.mix_generator.manual_seed(MIX_SEED)
            torch.cuda.synchronize()
            handed_at.append(time.perf_counter())
            yield batch

    train_step = wrapper.train_step

    def timed_step(state, dev_batch, lrs):
        """The wrapper's train step, timed and its metrics kept; the time
        since its batch was handed over is the mixer's (copies to the card
        included)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mix_ms.append(1e3 * (t0 - handed_at[-1]))
        lrs_used.append(list(lrs))
        state, metrics = train_step(state, dev_batch, lrs)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        _check(all(bool(torch.isfinite(v)) for v in metrics.values()),
               f"train step {len(step_ms)}: non-finite metrics {metrics}")
        totals.append(float(metrics["loss/total"]))
        norms.append(float(metrics["grad_norm"]))
        return state, metrics

    wrapper.train_step = timed_step
    wrapper.steps_per_epoch = TRAIN_STEPS
    zero_counts()
    epoch = wrapper.train_epoch(batches())
    counts = read_counts()
    wrapper.train_step = train_step
    _check(len(totals) == TRAIN_STEPS
           and all(np.isfinite(v) for v in epoch["scalars"].values()),
           f"train_epoch: {len(totals)} steps, losses {epoch['scalars']}")
    check_launches(counts, "segmental_rms_fused", 2 * TRAIN_STEPS,
                   "FE-T train")
    record["segmental_rms_fused"]["launches"] = counts["segmental_rms_fused"]
    _check(totals[-1] < totals[0], f"train loss did not fall: {totals}")
    fixed = set(model.fixed_param_paths())
    p0 = dict(tree_paths(start["params"]))
    for path, t in tree_paths(wrapper.state["variables"]["params"]):
        moved = not torch.equal(t.detach(), p0[path])
        _check(moved != (path in fixed), f"param {path}: moved={moved}")
    s0 = dict(tree_paths(start["stats"]))
    for path, t in tree_paths(wrapper.state["variables"]["stats"]):
        _check(not torch.equal(t, s0[path]), f"BN statistic {path} unmoved")
    want_lrs = [[b * max(k - 1, 1) / warmup for b in base_lrs]
                for k in range(1, TRAIN_STEPS + 1)]
    _check(all(np.allclose(a, b, rtol=1e-12) for a, b in zip(lrs_used,
                                                             want_lrs))
           and np.allclose(wrapper.scheduler.lrs,
                           [b * TRAIN_STEPS / warmup for b in base_lrs],
                           rtol=1e-12),
           f"warmup lrs {lrs_used[:2]}... != {want_lrs[:2]}...")
    step_med = statistics.median(step_ms[1:])
    mix_med = statistics.median(mix_ms[1:])
    audio_s = TRAIN_ROWS * TRAIN_SECONDS
    print(f"[14/30] train FE-T shard recipe bf16 over float32 masters, "
          f"{TRAIN_ROWS} x {TRAIN_SECONDS:g} s ({audio_s:g} s of audio) a "
          f"step, {model.num_params(start['params'])} trainable params: "
          f"total loss {', '.join(f'{v:.5f}' for v in totals)}; grad norm "
          f"{', '.join(f'{v:.4f}' for v in norms)}; lr {lrs_used[0][0]:.3e} "
          f"to {lrs_used[-1][0]:.3e} (warmup {warmup}); segmental_rms "
          f"launches {counts['segmental_rms_fused']} = 2 a step, no other "
          f"kernel; train step {step_med:.1f} ms (median of steps 2-"
          f"{TRAIN_STEPS} of one train_epoch; step 1 {step_ms[0]:.1f} ms), "
          f"mixer {mix_med:.2f} ms, "
          f"{audio_s / (1e-3 * (step_med + mix_med)):.1f} "
          f"audio s trained per wall s; on {card}")

    # 12b. one float32 step on the card against the CPU's plain path
    cpu_wrapper = get_wrapper(hps["wrapper"])(HParams(**hps), train=True,
                                              device="cpu")
    _check(tree_diff(cpu_wrapper.state["variables"], start) <= 0.0,
           "the CPU wrapper's init differs from the card's")
    wrapper.mix_generator.manual_seed(MIX_SEED)
    cpu_wrapper.mix_generator.manual_seed(MIX_SEED)
    mixed_card, _ = wrapper._mix_to_device(batch)
    mixed_cpu, _ = cpu_wrapper._mix_to_device(batch)
    mix_err = max((mixed_card[k].cpu() - mixed_cpu[k]).abs().max().item()
                  / mixed_cpu[k].abs().max().item()
                  for k in ("clean", "noisy"))
    _check(mix_err <= 1e-5, f"mix card vs CPU: {mix_err:.3e} of the peak")
    card_vars = tree_map(lambda a: a.clone(), start)
    steps = {
        "card": make_train_step(model, wrapper.loss, get_optimizer(
            model, card_vars["params"], hps["train"])),
        "cpu": make_train_step(model, cpu_wrapper.loss, cpu_wrapper.optim)}
    lrs0 = [b / warmup for b in base_lrs]
    out_card = steps["card"]({"variables": card_vars}, mixed_card, lrs0)
    t0 = time.perf_counter()
    out_cpu = steps["cpu"](cpu_wrapper.state,
                           {k: v.cpu() for k, v in mixed_card.items()}, lrs0)
    cpu_s = time.perf_counter() - t0
    rel = {k: abs(float(out_card[1][k]) - float(out_cpu[1][k]))
           / abs(float(out_cpu[1][k])) for k in out_cpu[1]}
    _check(max(rel.values()) <= TRAIN_F32_RTOL,
           f"float32 step card vs CPU: relative {rel}")
    p_err = tree_diff(out_card[0]["variables"]["params"],
                      out_cpu[0]["variables"]["params"])
    s_err = tree_diff(out_card[0]["variables"]["stats"],
                      out_cpu[0]["variables"]["stats"])
    _check(p_err <= TRAIN_F32_PARAM_ATOL and s_err <= TRAIN_F32_PARAM_ATOL,
           f"float32 step card vs CPU: params {p_err:.3e}, stats "
           f"{s_err:.3e}")
    print(f"[14/30] float32 train step (TF32 off) card vs the CPU's plain "
          f"path, same variables and batch: mix {mix_err:.3e} of the peak; "
          f"loss and grad norm max relative diff {max(rel.values()):.3e} "
          f"(tol {TRAIN_F32_RTOL:g}; loss "
          f"{float(out_card[1]['loss/total']):.6f} vs "
          f"{float(out_cpu[1]['loss/total']):.6f}); params and BN "
          f"statistics within {TRAIN_F32_PARAM_ATOL:g} + 1e-5 relative "
          f"(worst margin {max(p_err, s_err):.3e}); the CPU step took "
          f"{cpu_s:.1f} s")

    phase_wall(14)

    # -- 15. valid FE-T -----------------------------------------------------
    def valid_batch(seed):
        rng = np.random.default_rng(seed)
        n = int(VALID_SECONDS * SR)
        clean = speech_like(rng, VALID_ROWS, n)
        noise = rng.standard_normal((VALID_ROWS, n)) * rng.uniform(
            0.01, 0.1, (VALID_ROWS, 1))
        return {"clean": clean, "noisy": (clean + noise).astype(np.float32)}

    valid = [valid_batch(20 + i) for i in range(VALID_BATCHES)]
    wrapper.valid_epoch(valid[:1])  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    scalars = wrapper.valid_epoch(valid)["scalars"]
    torch.cuda.synchronize()
    valid_s = time.perf_counter() - t0
    counts = read_counts()
    check_launches(counts, "gru_scan", model.num_blocks * VALID_BATCHES,
                   "FE-T valid")
    # #5's launches on each bf16 path that runs it (phases 15-20); the
    # record's count is their sum
    scan_paths = {"FE-T valid": counts["gru_scan"]}
    _check(all(np.isfinite(v) for v in scalars.values()),
           f"valid losses {scalars}")
    trained = tree_map(lambda a: a.detach(), wrapper.state["variables"])
    dev_batch, _ = wrapper._device_batch(valid[0], ("clean", "noisy"))
    v_card = make_valid_step(model, wrapper.loss)(trained, dev_batch)
    v_cpu = make_valid_step(model, cpu_wrapper.loss)(
        tree_map(lambda a: a.cpu(), trained),
        {k: v.cpu() for k, v in dev_batch.items()})
    v_rel = {k: abs(float(v_card[k]) - float(v_cpu[k])) / abs(float(v_cpu[k]))
             for k in v_cpu}
    _check(max(v_rel.values()) <= TRAIN_F32_RTOL,
           f"float32 valid card vs CPU: relative {v_rel}")
    print(f"[15/30] valid FE-T bf16, {VALID_BATCHES} batches of "
          f"{VALID_ROWS} x {VALID_SECONDS:g} s: losses "
          f"{', '.join(f'{k} {v:.5f}' for k, v in scalars.items())}; "
          f"gru_scan launches {counts['gru_scan']} = {model.num_blocks} a "
          f"forward, all of them its tensor-core form "
          f"({counts[GRU_TC]}), no other kernel; "
          f"{1e3 * valid_s / VALID_BATCHES:.1f} ms "
          f"per valid batch; float32 valid losses card vs CPU max relative "
          f"diff {max(v_rel.values()):.3e} (tol {TRAIN_F32_RTOL:g}); on "
          f"{card}")

    phase_wall(15)

    # -- 16. chunked FE_B -----------------------------------------------------
    def run_stream(model, variables, wav, chunk, gru, tc, what):
        """One Model.stream over `wav` after a short warm-up, the launch
        counts zeroed just before and read just after: the GRU scan ran
        `gru` times (`tc` of them its tensor-core form) and no other
        kernel ran. -> (y, wall s)."""
        model.stream(variables, wav[:, :model.hop_size * 16],
                     chunk_frames=chunk)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        y = model.stream(variables, wav, chunk_frames=chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_launches(read_counts(), "gru_scan", gru, what, tc)
        _check(tuple(y.shape) == tuple(wav.shape)
               and bool(torch.isfinite(y).all()),
               f"{what}: output {tuple(y.shape)} not finite/full")
        return y, wall

    def max_err(got, want):
        return (got.float() - want.float()).abs().max().item()

    model = get_model("fastenhancer.default", **FE_B, stft_method="matmul")
    hop, nb = model.hop_size, model.num_blocks
    folded = model.fold(model.init(torch.Generator().manual_seed(0),
                                   device=dev))
    folded_bf16 = cast_floating(folded, torch.bfloat16)
    frames = int(CHUNK_SECONDS * SR) // hop // 8 * 8  # a multiple of 4 and 8
    audio_s = frames * hop / SR
    g = torch.Generator().manual_seed(6)
    wav = (torch.randn(STREAMS, frames * hop, generator=g) * 0.05).to(dev)
    wav_bf16 = wav.to(torch.bfloat16)
    y_fused = model.stream(folded_bf16, wav_bf16,
                           fused_plan=model.build_stack_plan(folded_bf16))
    tol = BF16_REL * y_fused.float().abs().max().item()
    chunk_rows = {}
    for c in (1, 4, 8):
        n = nb * frames // c
        y, wall = run_stream(model, folded_bf16, wav_bf16, c, n, n,
                             f"FE_B chunked C={c}")
        err = max_err(y, y_fused)
        _check(err <= tol, f"FE_B bf16 C={c} vs the fused per-frame stream: "
                           f"{err:.3e} > {tol:.3e}")
        chunk_rows[c] = (wall, n, err)
        scan_paths[f"FE_B chunked C={c}"] = n
    y4 = model.stream(folded, wav, chunk_frames=4)
    y1 = model.stream(folded, wav)
    f32_err = max_err(y4, y1)
    f32_tol = F32_OUT_REL * y1.abs().max().item()
    _check(f32_err <= f32_tol, f"FE_B float32 C=4 vs per frame: "
                               f"{f32_err:.3e} > {f32_tol:.3e}")
    for c, (wall, n, err) in chunk_rows.items():
        print(f"[16/30] chunked FE_B bf16 Model.stream(chunk_frames={c}"
              f"{', the per-frame unfused stream' if c == 1 else ''}), "
              f"{STREAMS} streams x {audio_s:g} s: wall {wall:.3f} s, "
              f"{1e3 * wall / frames:.4f} ms per frame, per-stream RTF "
              f"{wall / (audio_s * STREAMS):.4e}; gru_scan launches {n} = "
              f"{nb} a chunk ({n / frames:.3f} a frame), all its tensor-core "
              f"form, no other kernel; vs the fused per-frame stream (block "
              f"stack kernel) max abs err {err:.3e} (tol {tol:.3e} = "
              f"2^-5 of its output peak {tol / BF16_REL:.3e}); on {card}")
    print(f"[16/30] chunked FE_B float32 C=4 vs the per-frame unfused stream "
          f"on the same input: max abs err {f32_err:.3e} (tol {f32_tol:.3e} "
          f"= {F32_OUT_REL:g} of the output peak "
          f"{y1.abs().max().item():.3e})")

    phase_wall(16)

    # -- 17. chunked, the other six served families ---------------------------
    # (model, kwargs, tag, whether its blocks run a time GRU)
    for name, kwargs, tag, has_gru in (
            ("fastenhancer.conv_stft", FE_B, "conv_stft (FE_B widths)", True),
            ("fastenhancer.dptransformer", DPT_B, "DPT-B", False),
            ("fastenhancer.dprnn", DPRNN_B, "DPRNN-B", True),
            ("fastenhancer.ln", LN_B, "LN_B", True),
            ("fastenhancer.time_kernel", TIME_KERNEL_B, "TIME_KERNEL_B",
             True),
            ("bsrnn", BSRNN_S, "BSRNN-S", False)):
        model = get_model(name, **kwargs, stft_method="matmul")
        hop = model.hop_size
        g = torch.Generator().manual_seed(0)
        variables = model.init(g, device=dev)
        if name == "fastenhancer.ln":
            variables["params"] = vary_norms(variables["params"], g)
        folded = model.fold(variables)
        frames = int(FAMILY_SECONDS * SR) // hop // 4 * 4
        audio_s = frames * hop / SR
        wav = (torch.randn(STREAMS, frames * hop, generator=g) * 0.05).to(dev)
        n = model.num_blocks * frames // 4 if has_gru else 0
        _, wall = run_stream(model, cast_floating(folded, torch.bfloat16),
                             wav.to(torch.bfloat16), 4, n, n,
                             f"{tag} chunked bf16")
        if n:
            scan_paths[f"{tag} chunked C=4"] = n
        y4, _ = run_stream(model, folded, wav, 4, n, 0,
                           f"{tag} chunked float32")
        y1 = model.stream(folded, wav)
        f32_err = max_err(y4, y1)
        f32_tol = F32_OUT_REL * y1.abs().max().item()
        _check(f32_err <= f32_tol, f"{tag} float32 C=4 vs per frame: "
                                   f"{f32_err:.3e} > {f32_tol:.3e}")
        print(f"[17/30] chunked {tag} C=4, {STREAMS} streams x {audio_s:g} "
              f"s: bf16 wall {wall:.3f} s, {1e3 * wall / frames:.4f} ms per "
              f"frame, per-stream RTF {wall / (audio_s * STREAMS):.4e}, "
              f"gru_scan launches {n} ({'one a block a chunk, all its '
              'tensor-core form' if has_gru else 'no time GRU'}), no other "
              f"kernel; float32 chunked vs the per-frame unfused stream max "
              f"abs err {f32_err:.3e} (tol {f32_tol:.3e} = {F32_OUT_REL:g} of "
              f"the output peak {y1.abs().max().item():.3e}); on {card}")

    phase_wall(17)

    # -- 18. noncausal offline ------------------------------------------------
    model = get_model("fastenhancer.noncausal", **NONCAUSAL_HUGE)
    variables = model.init(torch.Generator().manual_seed(0), device=dev)
    folded = model.fold(variables)
    folded_bf16 = cast_floating(folded, torch.bfloat16)
    g = torch.Generator().manual_seed(8)
    wav = (torch.randn(NC_STREAMS, int(NC_SECONDS * SR), generator=g)
           * 0.05).to(dev, torch.bfloat16)
    model.forward(folded_bf16, wav[:, :SR // 2])  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    y, spec_hat, _ = model.forward(folded_bf16, wav)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = 2 * model.num_blocks
    check_launches(read_counts(), "gru_scan", n, "noncausal forward")
    scan_paths["noncausal forward"] = n
    _check(tuple(y.shape) == tuple(wav.shape)
           and bool(torch.isfinite(y).all()), "noncausal output")
    _check(spec_hat.shape[2] == nc_frames,
           f"noncausal frames {spec_hat.shape[2]} != 3g's {nc_frames}")
    fwd_ms, fwd_host_ms = time_ms(lambda: model.forward(folded_bf16, wav),
                                  reps=3, inner=2)
    # the bf16 forward (the GRU scan's tensor-core form in its model)
    # against the float32 forward on the card, on the same input
    y32, _, _ = model.forward(folded, wav.float())
    bf_peak = y32.abs().max().item()
    bf_err = max_err(y, y32)
    _check(bf_err <= BF16_REL * bf_peak, f"noncausal bf16 vs float32: "
                                         f"{bf_err:.3e} > "
                                         f"{BF16_REL * bf_peak:.3e}")
    wav32 = (torch.randn(2, SR // 2, generator=g) * 0.05)
    want, _, _ = model.forward(tree_map(lambda a: a.cpu(), variables), wav32)
    got, _, _ = model.forward(variables, wav32.to(dev))
    nc_err = max_err(got.cpu(), want)
    nc_peak = want.abs().max().item()
    _check(nc_err <= F32_OUT_REL * nc_peak, f"noncausal float32 card vs "
                                            f"CPU: {nc_err:.3e} > "
                                            f"{F32_OUT_REL * nc_peak:.3e}")
    print(f"[18/30] noncausal NONCAUSAL_HUGE bf16 Model.forward, "
          f"{NC_STREAMS} streams x {NC_SECONDS:g} s ({nc_frames} frames): "
          f"gru_scan launches {n} = 2 a block, all its tensor-core form at "
          f"H = {model.block_channels}, no other kernel; wall {1e3 * wall:.2f} "
          f"ms for the first timed forward, {fwd_ms:.3f} ms on the device "
          f"(CUDA events), {fwd_host_ms:.3f} ms with the host's dispatch; "
          f"bf16 vs the float32 forward on the card max abs err "
          f"{bf_err:.3e} (tol {BF16_REL * bf_peak:.3e} = 2^-5 of the output "
          f"peak {bf_peak:.3e}); float32 forward on 2 x 0.5 s card vs the "
          f"CPU's plain path max abs err {nc_err:.3e} (tol "
          f"{F32_OUT_REL * nc_peak:.3e} = {F32_OUT_REL:g} of the output peak "
          f"{nc_peak:.3e}); on {card}")

    phase_wall(18)

    # -- 19. FSPEN; 20. LiSenNet ---------------------------------------------
    def baseline(name, kwargs, tag, phase, per_step, cpu_picks=0):
        """One baseline's paths; per_step: #5 launches a frame or chunk;
        cpu_picks: the float32 streams with the largest bf16 errors whose
        bf16 chunked stream is run again on the CPU's plain path, both
        held to the card's float32 stream."""
        ticks, counts = serve(name, kwargs, tag, phase, fused=False)
        check_launches(counts, "gru_scan", per_step * ticks,
                       f"{tag} serving")
        scan_paths[f"{tag} serving"] = counts["gru_scan"]
        model = get_model(name, **kwargs, stft_method="matmul")
        hop = model.hop_size
        g = torch.Generator().manual_seed(0)
        folded = model.fold(model.init(g, device=dev))
        folded_bf16 = cast_floating(folded, torch.bfloat16)
        frames = int(BASELINE_SECONDS * SR) // hop // 4 * 4
        audio_s = frames * hop / SR
        wav = (torch.randn(STREAMS, frames * hop, generator=g) * 0.05).to(dev)
        runs = {}
        for c in (1, 4):
            n = per_step * frames // c
            y, wall = run_stream(model, folded_bf16, wav.to(torch.bfloat16),
                                 c, n, n, f"{tag} bf16 C={c}")
            runs[c] = (y, wall, n)
            scan_paths[f"{tag} stream C={c}"] = n
        # float32 on the first streams: chunked against per frame, and the
        # bf16 chunked stream against the float32 one
        sub = wav[:BASELINE_F32_STREAMS]
        n4 = per_step * frames // 4
        y4, _ = run_stream(model, folded, sub, 4, n4, 0, f"{tag} f32 C=4")
        y1, _ = run_stream(model, folded, sub, 1, 4 * n4, 0,
                           f"{tag} f32 C=1")
        peak = y1.abs().max().item()
        f32_err = max_err(y4, y1)
        _check(f32_err <= F32_OUT_REL * peak, f"{tag} float32 C=4 vs per "
                                              f"frame: {f32_err:.3e}")
        bf_diff = runs[4][0][:BASELINE_F32_STREAMS].float() - y4
        bf_err = bf_diff.abs().max().item() / y4.abs().max().item()
        bf_rms = (bf_diff.square().mean().sqrt()
                  / y4.square().mean().sqrt()).item()
        _check(bf_err <= BASELINE_BF16_PEAK[tag]
               and bf_rms <= BASELINE_BF16_RMS,
               f"{tag} bf16 vs float32 C=4: max {bf_err:.4f} of the peak, "
               f"RMS {bf_rms:.4f} of the RMS")
        if cpu_picks:
            # the card's bf16 path against the CPU's on the streams with
            # the card's largest errors; then the control: the same with
            # each convolution called on its bf16 values, so that cuDNN
            # rounds its sum before the bias, which must miss by more
            # than BASELINE_CARD_CPU x the CPU
            def card_vs_cpu(y_card):
                diff = y_card[:BASELINE_F32_STREAMS].float() - y4
                pick = diff.abs().amax(dim=1).argsort(descending=True)[
                    :cpu_picks].sort().values
                t0 = time.perf_counter()
                with torch.no_grad():
                    y_cpu = model.stream(
                        tree_map(lambda a: a.cpu(), folded_bf16),
                        sub[pick].to(torch.bfloat16).cpu(), chunk_frames=4)
                shares = {}
                for what, y in (("card", y_card[pick]),
                                ("CPU", y_cpu.to(dev))):
                    d = y.float() - y4[pick]
                    shares[what] = (
                        (d.abs().max() / y4[pick].abs().max()).item(),
                        (d.square().mean().sqrt()
                         / y4[pick].square().mean().sqrt()).item())
                return (pick.tolist(), shares,
                        shares["card"][0] / shares["CPU"][0],
                        time.perf_counter() - t0)

            fspen_mod = sys.modules[type(model).__module__]
            conv = fspen_mod._conv
            fspen_mod._conv = lambda fn, p, x, **kw: fn(p, x, **kw)
            try:
                with torch.no_grad():
                    y_ctl = model.stream(folded_bf16, sub.to(torch.bfloat16),
                                         chunk_frames=4)
            finally:
                fspen_mod._conv = conv
            for form, y_card in (("float32 sums", runs[4][0]),
                                 ("control, cuDNN's bf16 sums", y_ctl)):
                pick, shares, ratio, cpu_s = card_vs_cpu(y_card)
                if form == "float32 sums":
                    _check(ratio <= BASELINE_CARD_CPU, f"{tag} bf16: the "
                           f"card's largest error {ratio:.3f}x the CPU's on "
                           f"the same streams (tol {BASELINE_CARD_CPU:g})")
                else:
                    _check(ratio > BASELINE_CARD_CPU, f"{tag} bf16 control:"
                           f" the card's largest error with cuDNN's bf16 "
                           f"sums only {ratio:.3f}x the CPU's (the check "
                           f"would not see that rounding)")
                print(f"[{phase}/30] {tag} bf16 C=4 ({form}) on the "
                      f"{cpu_picks} of the first {BASELINE_F32_STREAMS} "
                      f"streams with the card's largest bf16 errors "
                      f"(streams {pick}), against the card's float32 "
                      f"stream: the card max {shares['card'][0]:.4f} of "
                      f"the peak, RMS {shares['card'][1]:.4f} of the RMS; "
                      f"the CPU's plain path on the same inputs and weights"
                      f" max {shares['CPU'][0]:.4f}, RMS "
                      f"{shares['CPU'][1]:.4f} ({cpu_s:.1f} s); card / CPU "
                      f"peak share {ratio:.3f} (tol "
                      f"{'<=' if form == 'float32 sums' else '>'} "
                      f"{BASELINE_CARD_CPU:g}); on {card}")
        # the offline forward, bf16
        wav_off = (torch.randn(BASELINE_OFF_STREAMS,
                               int(BASELINE_OFF_SECONDS * SR), generator=g)
                   * 0.05).to(dev, torch.bfloat16)
        model.forward(folded_bf16, wav_off[:, :SR // 2])  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        y_off, spec_off, _ = model.forward(folded_bf16, wav_off)
        torch.cuda.synchronize()
        off_wall = time.perf_counter() - t0
        check_launches(read_counts(), "gru_scan", per_step,
                       f"{tag} forward")
        scan_paths[f"{tag} forward"] = per_step
        _check(tuple(y_off.shape) == tuple(wav_off.shape)
               and bool(torch.isfinite(y_off).all()), f"{tag} forward")
        _check(spec_off.shape[2] == bl_frames,
               f"{tag} forward frames {spec_off.shape[2]} != {bl_frames}")
        off_ms, off_host_ms = time_ms(
            lambda: model.forward(folded_bf16, wav_off), reps=3, inner=2)
        # float32 card against the CPU's plain path: the chunked stream,
        # and the forward on audio with silent edges (their frames zero)
        x = torch.randn(2, SR, generator=g) * 0.05
        x[:, :257] = 0.0
        x[:, -257:] = 0.0
        cpu_vars = tree_map(lambda a: a.cpu(), folded)
        cpu_errs = []
        for run in (lambda v, a: model.stream(v, a, chunk_frames=4),
                    lambda v, a: model.forward(v, a)[0]):
            want = run(cpu_vars, x)
            err = max_err(run(folded, x.to(dev)).cpu(), want)
            tol = F32_OUT_REL * want.abs().max().item()
            _check(err <= tol, f"{tag} float32 card vs CPU: {err:.3e} > "
                               f"{tol:.3e}")
            cpu_errs.append((err, tol))
        for c, (_, wall, n) in runs.items():
            print(f"[{phase}/30] {tag} bf16 Model.stream(chunk_frames={c}), "
                  f"{STREAMS} streams x {audio_s:g} s: wall {wall:.3f} s, "
                  f"{1e3 * wall / frames:.4f} ms per frame, per-stream RTF "
                  f"{wall / (audio_s * STREAMS):.4e}; gru_scan launches {n}"
                  f" = {per_step} a {'chunk' if c > 1 else 'frame'} "
                  f"({n / frames:.2f} a frame), all its tensor-core form, no "
                  f"other kernel; on {card}")
        print(f"[{phase}/30] {tag} bf16 Model.forward, "
              f"{BASELINE_OFF_STREAMS} streams x {BASELINE_OFF_SECONDS:g} s "
              f"({bl_frames} frames): gru_scan launches {per_step}, all "
              f"tensor-core, no other kernel; wall {1e3 * off_wall:.2f} ms "
              f"for the first timed forward, {off_ms:.3f} ms on the device "
              f"(CUDA events), {off_host_ms:.3f} ms with the host's "
              f"dispatch; on {card}")
        print(f"[{phase}/30] {tag} float32 on {BASELINE_F32_STREAMS} "
              f"streams: C=4 vs per frame max abs err {f32_err:.3e} (tol "
              f"{F32_OUT_REL * peak:.3e} = {F32_OUT_REL:g} of the peak "
              f"{peak:.3e}); bf16 C=4 vs float32 C=4: max abs err "
              f"{bf_err:.4f} of the peak (tol {BASELINE_BF16_PEAK[tag]:g}), "
              f"RMS err {bf_rms:.4f} of the RMS (tol {BASELINE_BF16_RMS:g});"
              " card vs the "
              f"CPU's plain path on 2 x 1 s: stream {cpu_errs[0][0]:.3e} "
              f"(tol {cpu_errs[0][1]:.3e}), forward {cpu_errs[1][0]:.3e} "
              f"(tol {cpu_errs[1][1]:.3e})")

    baseline("fspen", FSPEN, "FSPEN", 19, 30, cpu_picks=16)
    phase_wall(19)
    baseline("lisennet", LISENNET, "LiSenNet", 20, 6)
    phase_wall(20)

    # -- 21. train through the CLI --------------------------------------------
    def wav_bytes(x):
        buf = io.BytesIO()
        with wave.open(buf, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(SR)
            f.writeframes(np.clip(x * 32768, -32768, 32767).astype("<i2")
                          .tobytes())
        return buf.getvalue()

    def write_shards(root, name, cuts_per_shard, make, custom=None):
        """CLI_SHARDS shards of `cuts_per_shard` cuts in ShardSource's
        layout: cuts.NNNNNN.jsonl.gz and a plain ustar recording.NNNNNN.tar
        of 16 kHz WAVs; make(index) -> the cut's audio."""
        d = os.path.join(root, name)
        os.makedirs(d)
        k = 0
        for s_ in range(CLI_SHARDS):
            metas = []
            with tarfile.open(os.path.join(d, f"recording.{s_:06d}.tar"), "w",
                              format=tarfile.USTAR_FORMAT) as tar:
                for _ in range(cuts_per_shard):
                    x = make(k)
                    cid = f"{name}-{k:04d}"
                    data = wav_bytes(x)
                    info = tarfile.TarInfo(f"{cid}.wav")
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
                    metas.append(dict({"id": cid, "duration": len(x) / SR},
                                      **({"custom": custom} if custom
                                         else {})))
                    k += 1
            with gzip.open(os.path.join(d, f"cuts.{s_:06d}.jsonl.gz"),
                           "wt") as f:
                f.write("".join(json.dumps(m) + "\n" for m in metas))
        return d

    def write_corpus(root, seed):
        """Speech cuts of CLI_CUT_SECONDS with silent stretches, noise (one
        source silent), 0.5 s decaying RIRs, and CLI_WAVS paired
        clean/noisy files of 2-4 s. -> (inputs, wav dirs, wav lengths)."""
        rng = np.random.default_rng(seed)

        def speech(_, seconds=CLI_CUT_SECONDS):
            return speech_like(rng, 1, int(rng.uniform(*seconds) * SR))[0]

        def noise(k):
            n = int(rng.uniform(2.0, 4.0) * SR)
            return (np.zeros(n) if k == 0 else rng.standard_normal(n) * 0.05)

        def rir(_):
            t = np.arange(int(RIR_SECONDS * SR))
            r = rng.standard_normal(len(t)) * np.exp(-6.9 * t / (0.3 * SR))
            return 0.9 * r / np.abs(r).max()

        inputs = {
            "speech": [{"shard_dir": write_shards(root, "speech",
                                                  CLI_SPEECH_CUTS, speech)}],
            "noise": [{"shard_dir": write_shards(root, "noise", 4, noise)}],
            "rir": [{"shard_dir": write_shards(
                root, "rir", 2, rir, custom={"rir_onset": 0, "t60": 0.3})}]}
        wav_dirs = [os.path.join(root, "wav", k) for k in ("clean", "noisy")]
        for d in wav_dirs:
            os.makedirs(d)
        lengths = []
        for i in range(CLI_WAVS):
            clean = speech(i, (2.0, 4.0))
            noisy = clean + rng.standard_normal(len(clean)) * rng.uniform(
                0.01, 0.05)
            for d, x in zip(wav_dirs, (clean, noisy)):
                write_wav(os.path.join(d, f"{i:03d}.wav"), x, SR)
            lengths.append(len(clean))
        return inputs, wav_dirs, lengths

    class Tee:
        """stdout copied into a buffer, so the CLI's lines can be read."""

        def __init__(self, out):
            self.out, self.buf = out, io.StringIO()

        def write(self, text):
            self.buf.write(text)
            return self.out.write(text)

        def flush(self):
            self.out.flush()

    def run_cli(argv, entry=None):
        """train_main(argv), or another entry point's main, with its stdout
        kept; the launch counts zeroed just before and read just after; ->
        (what main returned, counts, stdout)."""
        tee, old = Tee(sys.stdout), sys.stdout
        sys.stdout = tee
        torch.cuda.synchronize()
        zero_counts()
        try:
            history = (entry or train_main)(argv)
            torch.cuda.synchronize()
        finally:
            sys.stdout = old
        return history, read_counts(), tee.buf.getvalue()

    def snapshot(w):
        """A wrapper's state as host arrays, keyed by tree path."""
        v = w.state["variables"]
        out = {("params",) + p: t.detach().cpu().numpy().copy()
               for p, t in tree_paths(v["params"])}
        out.update({("stats",) + p: t.detach().cpu().numpy().copy()
                    for p, t in tree_paths(v["stats"])})
        out.update({("opt",) + p: a for p, a in tree_paths(
            w.optim.state_tree(v["params"]))})
        return out, w.scheduler.state_dict(), w.epoch

    def expected_scan_shapes(hps, lengths):
        """Each (x_proj shape, dtype) #5 meets in a CLI epoch, worked out
        from the config and the paired files' lengths: the bf16 valid step
        on segment_size crops, and the float32 PESQ forward on the
        length-sorted files, a batch padded to 16 hops."""
        mk = hps.model_kwargs
        hop, freq = mk.hop_size, mk.rnnformer_kwargs.freq
        gates = 3 * mk.rnnformer_kwargs.channels
        seg_len = hps.data.valid.segment_size
        want = {((seg_len // hop + 1, min(vb, CLI_WAVS - i) * freq, gates),
                 torch.bfloat16)
                for vb in [hps.valid.batch_size]
                for i in range(0, CLI_WAVS, vb)}
        ordered, pb, pad = sorted(lengths), hps.pesq.batch_size, 16 * hop
        for i in range(0, CLI_WAVS, pb):
            padded = -(-max(ordered[i:i + pb]) // pad) * pad
            want.add(((padded // hop + 1, len(ordered[i:i + pb]) * freq,
                       gates), torch.float32))
        return want

    # what the CLI's path hands #4 (every mix's call) and #5 (the first
    # launch of each shape and dtype), cloned on the way while installed,
    # to be held against the plain versions after the run; each call goes
    # on unchanged
    seen_rms, seen_scan = [], {}
    mixer_rms = DynamicMixer._rms
    scan_launch = {"tc": scan.launch_tc, "scalar": scan.launch_scalar}

    def spy_rms(self, wav, absolute_threshold_db):
        seen_rms.append((wav[:, 0].detach().clone(), dict(
            sr=self.sr, window_ms=self.seg_window_ms,
            relative_threshold_db=self.seg_rel_thr,
            absolute_threshold_db=absolute_threshold_db)))
        return mixer_rms(self, wav, absolute_threshold_db)

    def spy_scan(form):
        def launch(*args):
            seen_scan.setdefault((tuple(args[0].shape), args[0].dtype),
                                 (form, [a.detach().clone() for a in args]))
            return scan_launch[form](*args)
        return launch

    def record_inputs(on):
        DynamicMixer._rms = spy_rms if on else mixer_rms
        scan.launch_tc = spy_scan("tc") if on else scan_launch["tc"]
        scan.launch_scalar = (spy_scan("scalar") if on
                              else scan_launch["scalar"])

    cli_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t0 = time.perf_counter()
        inputs, (clean_dir, noisy_dir), wav_lengths = write_corpus(cli_dir,
                                                                   seed=21)
        corpus_s = time.perf_counter() - t0
        config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "configs", "fastenhancer_shard", "t.yaml")
        logs = os.path.join(cli_dir, "logs")
        run_dir = os.path.join(logs, "cli")
        params = [
            f"data.train.inputs={inputs!r}",
            f"data.valid.clean_dir={clean_dir!r}",
            f"data.valid.noisy_dir={noisy_dir!r}",
            f"data.pesq.clean_dir={clean_dir!r}",
            f"data.pesq.noisy_dir={noisy_dir!r}",
            f"train.steps_per_epoch={CLI_STEPS}", "train.max_epochs=2",
            "train.save_interval=1", "pesq.interval=1",
            f"valid.batch_size={CLI_VALID_BATCH}"]
        record_inputs(True)
        try:
            history, counts, out = run_cli(
                ["-n", "cli", "-c", config, "--base_dir", logs, "-p",
                 *params])
        finally:
            record_inputs(False)
        files = sorted(os.listdir(run_dir))
        _check(files == ["00001.ckpt", "00002.ckpt", "config.yaml", "train",
                         "valid"], f"CLI run dir holds {files}")
        run_hps = get_hparams(None, run_dir)
        blocks = FE_T_SHARD["model_kwargs"]["rnnformer_kwargs"]["num_blocks"]
        pesq_batch = run_hps.pesq.batch_size
        valid_n = -(-CLI_WAVS // CLI_VALID_BATCH)
        pesq_n = -(-CLI_WAVS // pesq_batch)

        def check_cli_counts(counts, epochs, what):
            want = {k: 0 for k in counters}
            want["segmental_rms_fused"] = 2 * CLI_STEPS * epochs
            want["gru_scan"] = blocks * (valid_n + pesq_n) * epochs
            want[GRU_TC] = blocks * valid_n * epochs
            _check(counts == want, f"{what}: launches {counts} != {want}")

        check_cli_counts(counts, 2, "CLI train")
        for r in history:
            vals = list(r["train"].values()) + list(r["valid"].values())
            _check(all(np.isfinite(v) for v in vals),
                   f"CLI epoch {r['epoch']}: {r}")
            _check(1.0 <= r["valid"]["metrics/pesq"] <= 4.65
                   and -1.0 <= r["valid"]["metrics/stoi"] <= 1.0,
                   f"CLI epoch {r['epoch']} metrics: {r['valid']}")
        _check([r["epoch"] for r in history] == [1, 2]
               and "Epoch 2/2  valid:" in out, "CLI epochs")
        # every train step mixed a batch of the recipe's max_duration
        # (padded to its longest cut, cut to a multiple of the hop)
        batch_s = [x.shape[0] * x.shape[1] / SR for x, _ in seen_rms]
        batch_rows = sorted({x.shape[0] for x, _ in seen_rms})
        _check(min(batch_s) >= 0.95 * run_hps.data.max_duration,
               f"CLI train batches of {batch_s} s, not the recipe's "
               f"{run_hps.data.max_duration} s")
        # #4 on every input the mixes gave it, against its plain version
        rms_worst = 0.0
        for x, kw in seen_rms:
            got = seg.segmental_rms_fused(x, **kw)
            torch.cuda.synchronize()
            err, rms_rel = rms_err(got, seg.segmental_rms(x, **kw), x.dtype,
                                   f"segmental_rms {tuple(x.shape)} from "
                                   "the CLI's mix")
            rms_worst = max(rms_worst, err)
        print(f"[21/30] kernel segmental_rms on the {len(seen_rms)} inputs "
              f"of the CLI's mixes (B in {batch_rows}, "
              f"{min(batch_s):.1f}-{max(batch_s):.1f} s of audio a batch, "
              f"float32): max abs err {rms_worst:.3e} (each within "
              f"{rms_rel:g} relative)")
        # #5: the shapes the run gave it are the ones the config and the
        # files give; each recorded input against the plain version, and
        # each shape in both dtypes on random inputs
        want_shapes = expected_scan_shapes(run_hps, wav_lengths)
        _check(set(seen_scan) == want_shapes,
               f"#5 in the CLI run: {sorted(seen_scan, key=str)} != "
               f"{sorted(want_shapes, key=str)}")
        for (shape, dtype), (form, args) in sorted(seen_scan.items(),
                                                   key=str):
            _check(form == ("tc" if dtype == torch.bfloat16 else "scalar"),
                   f"gru_scan {shape} {dtype} ran the {form} form")
            ys, h_t = scan.gru_scan(*args)
            torch.cuda.synchronize()
            ys_r, h_r = scan.gru_scan_reference(*args)
            errs = compare(f"gru_scan {shape} from the CLI",
                           ((ys, ys_r), (h_t, h_r)), dtype)
            print(f"[21/30] kernel gru_scan T={shape[0]} N={shape[1]} "
                  f"H={shape[2] // 3} {str(dtype)[6:]} on the CLI's own "
                  f"input ({form} form, the "
                  f"{'valid step' if form == 'tc' else 'PESQ forward'}): "
                  f"max abs err ys {errs[0][0]:.3e} (tol {errs[0][1]:.3e}), "
                  f"h_T {errs[1][0]:.3e} (tol {errs[1][1]:.3e})")
        check_and_time([(t, n, g // 3, False, False, False, "CLI")
                        for t, n, g in sorted({sh for sh, _ in want_shapes})],
                       phase=21)
        # resume from the run dir: the state right after load against the
        # saved 00002.ckpt, bit for bit
        saved = load_checkpoint(os.path.join(run_dir, "00002.ckpt"))
        want = {("params",) + p: a for p, a in tree_paths(
            saved["variables"]["params"])}
        want.update({("stats",) + p: a for p, a in tree_paths(
            saved["variables"]["stats"])})
        want.update({("opt",) + p: a for p, a in tree_paths(
            saved["opt_state"])})
        loaded = []
        load = ns_wrapper.ModelWrapper.load

        def spy_load(self, epoch=None):
            ok = load(self, epoch)
            loaded.append(snapshot(self))
            return ok

        ns_wrapper.ModelWrapper.load = spy_load
        try:
            resumed, counts_r, out_r = run_cli(
                ["-n", "cli", "--base_dir", logs, "-p", "train.max_epochs=3",
                 "-f"])
        finally:
            ns_wrapper.ModelWrapper.load = load
        got, sched, epoch = loaded[0]
        _check(got.keys() == want.keys()
               and all(got[k].dtype == want[k].dtype
                       and np.array_equal(got[k], want[k]) for k in want),
               "resumed state != 00002.ckpt")
        _check(sched == saved["scheduler"] and epoch == 2,
               f"resumed scheduler {sched} / epoch {epoch}")
        _check("loaded checkpoint" in out_r
               and [r["epoch"] for r in resumed] == [3]
               and os.path.exists(os.path.join(run_dir, "00003.ckpt")),
               f"CLI resume: epochs {[r['epoch'] for r in resumed]}")
        check_cli_counts(counts_r, 1, "CLI resume")
        # the trained 00003.ckpt on the card against the CPU's plain path,
        # float32: the losses of the CLI's first valid batch (as phase 15)
        # and the offline forward of its first PESQ batch
        final = load_checkpoint(os.path.join(run_dir, "00003.ckpt"))
        v_card = tree_map(lambda a: torch.tensor(a, device=dev),
                          final["variables"])
        v_cpu = tree_map(torch.tensor, final["variables"])
        _, loader = get_dataset_dataloader(run_hps, "valid", ["clean",
                                                              "noisy"])
        dev_batch, _ = wrapper._device_batch(next(iter(loader)),
                                             ("clean", "noisy"))
        l_card = make_valid_step(wrapper.model, wrapper.loss)(v_card,
                                                              dev_batch)
        l_cpu = make_valid_step(wrapper.model, cpu_wrapper.loss)(
            v_cpu, {k: v.cpu() for k, v in dev_batch.items()})
        l_rel = {k: abs(float(l_card[k]) - float(l_cpu[k]))
                 / abs(float(l_cpu[k])) for k in l_cpu}
        _check(max(l_rel.values()) <= TRAIN_F32_RTOL,
               f"CLI float32 valid card vs CPU: relative {l_rel}")
        _, loader = get_dataset_dataloader(run_hps, "pesq", ["clean",
                                                             "noisy"])
        noisy = torch.from_numpy(np.ascontiguousarray(
            next(iter(loader))["noisy"], dtype=np.float32))
        infer = make_infer_fn(wrapper.model)
        y_cpu = infer(v_cpu, noisy)
        y_err = (infer(v_card, noisy.to(dev)).cpu() - y_cpu).abs().max()
        y_peak = y_cpu.abs().max().item()
        _check(y_err.item() <= F32_OUT_REL * y_peak,
               f"CLI PESQ forward card vs CPU: {y_err.item()} of a peak "
               f"{y_peak}")
        print(f"[21/30] CLI's 00003.ckpt, float32, card vs the CPU's plain "
              f"path: valid losses of the first valid batch "
              f"({dev_batch['noisy'].shape[0]} x "
              f"{dev_batch['noisy'].shape[1] / SR:g} s) max relative diff "
              f"{max(l_rel.values()):.3e} (tol {TRAIN_F32_RTOL:g}); the "
              f"first PESQ batch's forward ({tuple(noisy.shape)}) max abs "
              f"err {y_err.item():.3e} (tol {F32_OUT_REL * y_peak:.3e} = "
              f"{F32_OUT_REL:g} of the peak {y_peak:.3e})")
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)
    rms_paths = {"FE-T train (14)": record["segmental_rms_fused"]["launches"],
                 "CLI (21)": counts["segmental_rms_fused"]
                 + counts_r["segmental_rms_fused"]}
    record["segmental_rms_fused"]["launches"] = sum(rms_paths.values())
    scan_paths["CLI valid bf16 + PESQ f32 (21)"] = (counts["gru_scan"]
                                                    + counts_r["gru_scan"])
    for r in history + resumed:
        tm = r["timing"]
        print(f"[21/30] CLI epoch {r['epoch']} (FE-T, the recipe's width): "
              f"wall {r['seconds']:.2f} s; train_epoch load {tm['load']:.3f}"
              f" s ({100 * tm['load'] / r['seconds']:.1f}% of the epoch), "
              f"mix+step {tm['step']:.3f} s over {tm['steps']} steps "
              f"({1e3 * tm['step'] / tm['steps']:.1f} ms a step); valid "
              f"{tm['valid']:.3f} s ({valid_n} batches of up to "
              f"{CLI_VALID_BATCH}, {1e3 * tm['valid'] / valid_n:.1f} ms a "
              f"batch); PESQ/STOI {tm['metrics']:.3f} s ({CLI_WAVS} files in "
              f"{pesq_n} float32 forwards); train losses "
              f"{', '.join(f'{k} {v:.4g}' for k, v in r['train'].items())}"
              f"; PESQ {r['valid']['metrics/pesq']:.3f}, STOI "
              f"{r['valid']['metrics/stoi']:.4f}; on {card}")
    print(f"[21/30] CLI: corpus of {CLI_SHARDS * CLI_SPEECH_CUTS} speech "
          f"cuts of {CLI_CUT_SECONDS[0]:g}-{CLI_CUT_SECONDS[1]:g} s written "
          f"in {corpus_s:.2f} s; train batches of {batch_rows} cuts; "
          f"launches per "
          f"epoch: segmental_rms {2 * CLI_STEPS} (2 a step), gru_scan "
          f"{blocks * (valid_n + pesq_n)} ({blocks * valid_n} tensor-core in "
          f"the bf16 valid step, {blocks * pesq_n} scalar in the float32 "
          f"PESQ forward), no other kernel; resume: state after load equal "
          f"to 00002.ckpt bit for bit over {len(want)} arrays, scheduler "
          f"and epoch; segmental_rms launches by path {rms_paths}")

    phase_wall(21)

    # -- 22. train every family through the CLI ---------------------------
    scan_paths["VoiceBank CLI valid + PESQ (22)"] = phase_22(
        dict(counters=counters, zero_counts=zero_counts,
             read_counts=read_counts, run_cli=run_cli,
             record_inputs=record_inputs, seen_scan=seen_scan,
             compare=compare, speech_like=speech_like, card=card, dev=dev))
    phase_wall(22, own=True)

    # -- 23. the on-the-fly recipes; 24. the entry points on their runs ------
    ctx = dict(counters=counters, zero_counts=zero_counts,
               read_counts=read_counts, run_cli=run_cli,
               record_inputs=record_inputs, seen_scan=seen_scan,
               compare=compare, speech_like=speech_like, card=card, dev=dev,
               check_launches=check_launches, check_and_time=check_and_time,
               timed=timed, bound=bound, nbytes=nbytes,
               stack_flops=stack_flops, band_flops=band_flops,
               write_corpus=write_corpus, time_ms=time_ms, rms_err=rms_err)
    otf_root = tempfile.mkdtemp(prefix="chip_smoke_otf_")
    try:
        runs, scan_paths["on-the-fly CLI valid + PESQ (23)"] = phase_23(
            ctx, otf_root)
        phase_wall(23, own=True)
        paths = phase_24(ctx, runs)
        phase_wall(24, own=True)
        # -- 25. summaries, showcase, histograms, profiler, native decoder ----
        launches_25 = phase_25(ctx, runs, otf_root)
        phase_wall(25, own=True)
        # -- 27. the streaming step exported, run with no model code -------
        launches_27 = phase_27(ctx, runs, otf_root)
        phase_wall(27, own=True)
    finally:
        shutil.rmtree(otf_root, ignore_errors=True)
    # -- 26. several devices: the sharded engine, NCCL and gloo ranks -----------
    launches_26 = phase_26(ctx)
    phase_wall(26, own=True)
    scan_paths.update(launches_26["gru_scan"])
    scan_paths["summaries CLI valid + infer_epoch (25)"] = launches_25[
        "gru_scan"]
    rms_paths["summaries CLI (25)"] = launches_25["segmental_rms_fused"]
    record["segmental_rms_fused"]["launches"] = sum(rms_paths.values())
    print(f"[25/30] segmental_rms launches by path: {rms_paths}; "
          f"{record['segmental_rms_fused']['launches']} in all")
    scan_paths.update(paths["gru_scan"])
    for name, first in (("rnnformer_stack_step", "FE_B serving (4)"),
                        ("bsrnn_stack_step", "BSRNN-S serving (9)")):
        by_path = {first: record[name]["launches"], **paths[name],
                   **launches_26.get(name, {})}
        record[name]["launches"] = sum(by_path.values())
        print(f"[24/30] {name} launches by path: {by_path}; "
              f"{record[name]['launches']} in all")
    by_path = {"FE_B whole frame (7)": record["fused_frame_step"][
        "launches"], **launches_26["fused_frame_step"]}
    record["fused_frame_step"]["launches"] = sum(by_path.values())
    print(f"[26/30] fused_frame_step launches by path: {by_path}; "
          f"{record['fused_frame_step']['launches']} in all")
    record["gru_scan"]["launches"] = sum(scan_paths.values())
    print(f"[24/30] gru_scan launches by path: {scan_paths}; "
          f"{record['gru_scan']['launches']} in all")

    for name, by_path in launches_27.items():
        record[name]["launches"] += sum(by_path.values())
        print(f"[27/30] {name} launches in phase 27 by path: {by_path}; "
              f"{record[name]['launches']} in all")

    # -- 28. a reference PyTorch checkpoint served ------------------------------
    for name, by_path in phase_28(ctx).items():
        record[name]["launches"] += sum(by_path.values())
        print(f"[28/30] {name} launches in phase 28 by path: {by_path}; "
              f"{record[name]['launches']} in all")
    phase_wall(28)

    # -- 29. the corpus tools: shards built, trained on, mixed -----------------
    for name, by_path in phase_29(dict(ctx, cli_history=history)).items():
        record[name]["launches"] += sum(by_path.values())
        print(f"[29/30] {name} launches in phase 29 by path: {by_path}; "
              f"{record[name]['launches']} in all")
    phase_wall(29)

    # -- 30. the training demo, both recipes, its children on the card -------
    for name, by_path in phase_30(ctx).items():
        record[name]["launches"] += sum(by_path.values())
        print(f"[30/30] {name} launches in phase 30 by path: {by_path}; "
              f"{record[name]['launches']} in all")
    phase_wall(30)
    print(f"[30/30] script wall {time.perf_counter() - T_START:.1f} s, the "
          f"kernels' build included (limit 1200 s)")

    sources = {
        "rnnformer_stack_step": ("rnnformer_stack", "rnnformer_stack.py:394"),
        LN_KERNEL: ("rnnformer_stack", "rnnformer_stack.py:394"),
        "fused_frame_step": ("fused_frame", "fused_frame.py:303"),
        "dpt_stack_step": ("dpt_stack", "dpt_stack.py:323"),
        "bsrnn_stack_step": ("bsrnn_stack", "bsrnn_stack.py:249"),
        "dprnn_stack_step": ("dprnn_stack", "dprnn_stack.py:269"),
        "segmental_rms_fused": ("segmental_rms", "segmental_rms.py:64"),
        "gru_scan": ("gru_scan", "gru_scan.py:43")}
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"fastenhancer_tpu_torch/ops/csrc/{src}.cu",
        "replaces": f"fastenhancer_tpu/ops/{tpu}",
        "launches": r["launches"],
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_us": 1e3 * r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r.get("library_ms"),
    } for name, (src, tpu) in sources.items()
        for r in [record[name]]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# phase 22: the VoiceBank recipes the CLI trains (config, the family's
# fixed stream of #5 launches per offline forward is worked out from the
# model), their synthetic paired-wav corpus and FE-L's remat step
VB_CONFIGS = ["fastenhancer/b.yaml", "ablation/dpt_b.yaml",
              "ablation/dprnn_b.yaml", "ablation/ln_b.yaml",
              "ablation/time_kernel_b.yaml", "others/bsrnn_s.yaml",
              "others/fspen.yaml", "others/lisennet.yaml"]
VB_TRAIN_PAIRS, VB_EVAL_PAIRS = 128, 8   # 2 steps of the recipe's 64
VB_SECONDS = (2.0, 2.5)                  # >= the recipe's 2 s segments
VB_CPU_ROWS, VB_CPU_SECONDS = 2, 1.0     # 22b: card vs CPU, float32
# 22b's noncausal step on the CPU took 50.4 s of the phase at 1 s (NVIDIA
# H100 80GB HBM3 host): it runs on the first half of the batch's audio
NC_CPU_SECONDS = 0.5
VB_LOSS_RTOL, VB_GNORM_RTOL = 1e-4, 1e-3
REMAT_ROWS, REMAT_SECONDS, REMAT_RTOL = 64, 2.0, 1e-3   # 22c: FE-L
# two steps of one mode from one state give the same gradients bit for
# bit; each leaf's gradient with remat against without: the norm of the
# gap within REMAT_GRAD_RTOL of the leaf's norm (a bias that a train-mode
# BN follows has a gradient of float noise only, so any difference in the
# order of a sum shows there)
REMAT_GRAD_RTOL = 1e-3
# without remat, FE-L's bf16 step at 64 x 2 s does not fit the card's 80 GB
# (72.8 GiB allocated above the earlier phases' when it ran out, H100 80GB
# HBM3 at 700 W): the two are compared at 16 rows
REMAT_CMP_ROWS = 16


def overlap_add_atomic(frames, hop):
    """The offline overlap-add as one index_add_ of every frame's samples
    at their output positions (phase 22c's control)."""
    import torch

    b, t, n_fft = frames.shape
    idx = (torch.arange(t, device=frames.device)[:, None] * hop
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    out = frames.new_zeros(b, (t - 1) * hop + n_fft)
    return out.index_add_(1, idx, frames.reshape(b, -1))


def scans_per_forward(model):
    """#5 launches of one offline eval forward, from the model: a time GRU
    a block (FE, dprnn, ln, time_kernel), a biGRU's two directions a block
    (noncausal), 2 + groups a block (FSPEN's intra biGRU and grouped time
    GRUs), 3 a block (LiSenNet), none (dpt's time attention, BSRNN's
    LSTMs)."""
    from fastenhancer_tpu_torch.models import bsrnn, fspen, lisennet
    from fastenhancer_tpu_torch.models.fastenhancer import (dptransformer,
                                                            noncausal)

    if isinstance(model, (bsrnn.Model, dptransformer.Model)):
        return 0
    if isinstance(model, noncausal.Model):
        return 2 * model.num_blocks
    if isinstance(model, fspen.Model):
        return model.dpe.num_blocks * (2 + model.dpe.groups)
    if isinstance(model, lisennet.Model):
        return 3 * model.n_blocks
    return model.num_blocks


def mem_base():
    """Start a peak-memory window; -> the bytes already allocated (the
    earlier phases' tensors), which peaks are counted above."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_gib(base):
    import torch

    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def phase_22(ctx):
    """Phase 22 (see the module docstring); returns #5's launches on its
    CLI paths (the valid and PESQ forwards)."""
    import numpy as np
    import torch

    import fastenhancer_tpu_torch.functional.stft  # noqa: F401
    from fastenhancer_tpu_torch.data.audio_io import write_wav
    from fastenhancer_tpu_torch.models import get_model
    from fastenhancer_tpu_torch.ops import gru_scan as scan
    from fastenhancer_tpu_torch.optim import get_optimizer
    from fastenhancer_tpu_torch.train import load_checkpoint, make_train_step
    from fastenhancer_tpu_torch.utils import tree_map, tree_paths
    from fastenhancer_tpu_torch.utils.hparams import HParams, get_hparams
    from fastenhancer_tpu_torch.wrappers import get_wrapper
    from fastenhancer_tpu_torch.wrappers import ns as ns_wrapper

    # the module (the package's `functional.stft` is the function)
    stft_mod = sys.modules["fastenhancer_tpu_torch.functional.stft"]
    card, dev = ctx["card"], ctx["dev"]
    zero_counts, read_counts = ctx["zero_counts"], ctx["read_counts"]

    repo = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    print(f"[22/30] train every family through the CLI, cuts: none of width "
          f"or the recipes' batch (64 x 2 s); {VB_TRAIN_PAIRS} synthetic "
          f"train pairs (2 steps an epoch, 1 epoch; FE-B resumed for a "
          f"second), {VB_EVAL_PAIRS} valid/PESQ pairs; FE-L with and without "
          f"remat compared at {REMAT_CMP_ROWS} x {REMAT_SECONDS:g} s (without"
          f" remat its recipe's {REMAT_ROWS} x {REMAT_SECONDS:g} s does not "
          f"fit the card); the noncausal recipe trains in phase 23")

    def config_hps(config):
        """A config's dict with the paired-wav wrapper and no PESQ loader
        (the steps of 22b-c read no files)."""
        hps = get_hparams(os.path.join(repo, "configs", config)).to_dict()
        hps["wrapper"] = "ns"
        hps.pop("pesq", None)
        return hps

    def corpus(root, seed):
        """(train, eval) (clean dir, noisy dir) of speech-like wavs."""
        rng = np.random.default_rng(seed)
        out = []
        for name, n in (("train", VB_TRAIN_PAIRS), ("eval", VB_EVAL_PAIRS)):
            dirs = [os.path.join(root, name, k) for k in ("clean", "noisy")]
            for d in dirs:
                os.makedirs(d)
            for i in range(n):
                t = int(rng.uniform(*VB_SECONDS) * SR)
                clean = ctx["speech_like"](rng, 1, t)[0]
                noisy = clean + rng.standard_normal(t) * rng.uniform(0.01,
                                                                     0.1)
                for d, x in zip(dirs, (clean, noisy)):
                    write_wav(os.path.join(d, f"{i:04d}.wav"), x, SR)
            out.append(dirs)
        return out

    # the train step's timing and #5's counter around train_epoch, with
    # the wrapper's own methods restored after the phase
    step_ms, scan_in_train = [], []
    step_and_account = ns_wrapper.ModelWrapper._step_and_account
    train_epoch = ns_wrapper.ModelWrapper.train_epoch

    def timed_step(self, dev_batch, rows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_and_account(self, dev_batch, rows)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    def counted_epoch(self, loader):
        before = read_counts()["gru_scan"]
        out = train_epoch(self, loader)
        scan_in_train.append(read_counts()["gru_scan"] - before)
        return out

    root = tempfile.mkdtemp(prefix="chip_smoke_vb_")
    total_scans = 0
    try:
        t0 = time.perf_counter()
        (tr_clean, tr_noisy), (ev_clean, ev_noisy) = corpus(root, seed=22)
        corpus_s = time.perf_counter() - t0
        logs = os.path.join(root, "logs")
        paths = [f"data.train.clean_dir={tr_clean!r}",
                 f"data.train.noisy_dir={tr_noisy!r}",
                 f"data.valid.clean_dir={ev_clean!r}",
                 f"data.valid.noisy_dir={ev_noisy!r}",
                 f"data.pesq.clean_dir={ev_clean!r}",
                 f"data.pesq.noisy_dir={ev_noisy!r}"]
        ns_wrapper.ModelWrapper._step_and_account = timed_step
        ns_wrapper.ModelWrapper.train_epoch = counted_epoch
        for config in VB_CONFIGS + ["fastenhancer/b.yaml (resumed)"]:
            resumed = config.endswith("(resumed)")
            name = config.split("/")[-1].split(".")[0]
            run = os.path.join(logs, name)
            argv = (["-n", name, "--base_dir", logs, "-p",
                     "train.max_epochs=2", "-f"] if resumed else
                    ["-n", name, "-c", os.path.join(repo, "configs", config),
                     "--base_dir", logs, "-p", *paths, "train.max_epochs=1",
                     "train.save_interval=1", "pesq.interval=1"])
            step_ms.clear()
            scan_in_train.clear()
            ctx["seen_scan"].clear()
            base = mem_base()
            ctx["record_inputs"](True)
            try:
                history, counts, out = ctx["run_cli"](argv)
            finally:
                ctx["record_inputs"](False)
            peak_gb = peak_gib(base)
            hps = get_hparams(None, run)
            model = get_model(hps.model, **hps.model_kwargs.to_dict())
            (r,) = history
            epoch = 2 if resumed else 1
            _check(r["epoch"] == epoch and os.path.exists(os.path.join(
                run, f"{epoch:05d}.ckpt")), f"{config}: epoch {r['epoch']}")
            _check(not resumed or "loaded checkpoint" in out,
                   f"{config}: no resume")
            vals = list(r["train"].values()) + list(r["valid"].values())
            _check(all(np.isfinite(v) for v in vals), f"{config}: {r}")
            _check("loss/pesq" in r["train"] and "loss/pesq" in r["valid"],
                   f"{config}: no pesq loss in {sorted(r['train'])}")
            _check(1.0 <= r["valid"]["metrics/pesq"] <= 4.65
                   and -1.0 <= r["valid"]["metrics/stoi"] <= 1.0,
                   f"{config} metrics: {r['valid']}")
            # every trained leaf moved, the fixed ones did not
            ckpt = load_checkpoint(os.path.join(run, f"{epoch:05d}.ckpt"))
            start = (load_checkpoint(os.path.join(run, "00001.ckpt"))
                     ["variables"] if resumed else model.init(
                         torch.Generator().manual_seed(hps.train.seed),
                         "cpu"))
            p0 = dict(tree_paths(start["params"]))
            fixed = set(model.fixed_param_paths())
            for path, a in tree_paths(ckpt["variables"]["params"]):
                moved = not np.array_equal(a, np.asarray(p0[path]))
                _check(moved != (path in fixed),
                       f"{config}: param {path} moved={moved}")
            # #5: only in the valid and PESQ forwards, never in train_epoch
            per = scans_per_forward(model)
            valid_n = -(-VB_EVAL_PAIRS // hps.valid.batch_size)
            pesq_n = -(-VB_EVAL_PAIRS // hps.pesq.batch_size)
            bf16 = bool(hps.train.fp16)
            want = {k: 0 for k in ctx["counters"]}
            want["gru_scan"] = per * (valid_n + pesq_n)
            want[GRU_TC] = per * valid_n if bf16 else 0
            _check(counts == want, f"{config}: launches {counts} != {want}")
            _check(scan_in_train == [0], f"{config}: #5 ran {scan_in_train} "
                   "times in train_epoch")
            total_scans += counts["gru_scan"]
            worst = 0.0
            for (shape, dtype), (form, args) in ctx["seen_scan"].items():
                ys, h_t = scan.gru_scan(*args)
                torch.cuda.synchronize()
                ys_r, h_r = scan.gru_scan_reference(*args)
                errs = ctx["compare"](f"{config} gru_scan {shape}",
                                      ((ys, ys_r), (h_t, h_r)), dtype)
                worst = max(worst, errs[0][0], errs[1][0])
            tm = r["timing"]
            rest = (r["seconds"] - tm["load"] - tm["step"] - tm["valid"]
                    - tm["metrics"])
            losses = ", ".join(f"{k[5:]} {v:.4g}" for k, v in
                               r["train"].items() if k.startswith("loss/"))
            print(f"[22/30] CLI {config} ({hps.model}, the recipe's width, "
                  f"{'bf16' if bf16 else 'float32'} over float32 masters, "
                  f"batch {hps.train.batch_size} x "
                  f"{hps.data.train.segment_size / SR:g} s): step ms "
                  f"{', '.join(f'{v:.1f}' for v in step_ms)}; valid "
                  f"{1e3 * tm['valid']:.1f} ms ({valid_n} batch of "
                  f"{VB_EVAL_PAIRS}); PESQ/STOI {tm['metrics']:.2f} s; "
                  f"epoch wall {r['seconds']:.2f} s = load {tm['load']:.2f}"
                  f" + step {tm['step']:.2f} + valid {tm['valid']:.2f} + "
                  f"PESQ/STOI {tm['metrics']:.2f} + rest {rest:.2f} s; peak "
                  f"memory {peak_gb:.2f} GiB above the phase's; #5 "
                  f"{counts['gru_scan']} launches ({counts[GRU_TC]} tc), none "
                  f"in train_epoch, {len(ctx['seen_scan'])} input shapes "
                  f"held to the plain version (max abs err {worst:.3e}); "
                  f"losses {losses}; PESQ {r['valid']['metrics/pesq']:.3f}; "
                  f"on {card}")
    finally:
        ns_wrapper.ModelWrapper._step_and_account = step_and_account
        ns_wrapper.ModelWrapper.train_epoch = train_epoch
        shutil.rmtree(root, ignore_errors=True)
    t_cli = time.perf_counter() - t_phase

    # 22b. one float32 step of each family, card against CPU
    rng = np.random.default_rng(23)
    n = int(VB_CPU_SECONDS * SR)
    clean = ctx["speech_like"](rng, VB_CPU_ROWS, n)
    noisy = (clean + rng.standard_normal(clean.shape) * 0.05).astype(
        np.float32)
    # silent edges: LiSenNet's phase features sit on their branch cut on
    # the offline STFT's edge frames of other audio (reflect padding makes
    # those spectra real), where the two devices' rounding picks +-pi (as
    # in phase 20)
    for x in (clean, noisy):
        x[:, :257] = x[:, -257:] = 0.0
    batch = {"clean": torch.from_numpy(clean),
             "noisy": torch.from_numpy(noisy),
             "row_mask": torch.ones(VB_CPU_ROWS)}
    nc = int(NC_CPU_SECONDS * SR)
    nc_batch = {"clean": batch["clean"][:, :nc].contiguous(),
                "noisy": batch["noisy"][:, :nc].contiguous(),
                "row_mask": batch["row_mask"]}
    for k in ("clean", "noisy"):
        nc_batch[k][:, -257:] = 0.0
    lines = []
    for config in VB_CONFIGS + ["fastenhancer_dns/huge_noncausal.yaml"]:
        hps = config_hps(config)
        cut = "noncausal" in config
        out = {}
        for where in ("cpu", "card"):
            w = get_wrapper("ns")(HParams(**hps), train=True,
                                  device="cpu" if where == "cpu" else dev)
            step = make_train_step(w.model, w.loss, w.optim)  # float32
            lrs = [1e-3] * w.optim.n_groups
            b = {k: v.to(w.device)
                 for k, v in (nc_batch if cut else batch).items()}
            zero_counts()
            t0 = time.perf_counter()
            _, m = step(w.state, b, lrs)
            if where == "card":
                torch.cuda.synchronize()
                _check(not any(read_counts().values()),
                       f"{config}: a kernel ran in a train step")
            out[where] = ({k: float(v) for k, v in m.items()},
                          time.perf_counter() - t0)
        (mc, tc), (mg, tg) = out["cpu"], out["card"]
        rel_l = abs(mg["loss/total"] / mc["loss/total"] - 1)
        rel_g = abs(mg["grad_norm"] / mc["grad_norm"] - 1)
        _check(rel_l <= VB_LOSS_RTOL and rel_g <= VB_GNORM_RTOL,
               f"{config} card vs CPU: loss {rel_l:.3e}, grad norm "
               f"{rel_g:.3e}")
        lines.append(f"{config.split('/')[-1][:-5]}"
                     f"{f' ({NC_CPU_SECONDS:g} s)' if cut else ''} loss "
                     f"{rel_l:.1e} gnorm {rel_g:.1e} (card {1e3 * tg:.0f} ms, "
                     f"CPU {tc:.1f} s)")
    print(f"[22/30] float32 train step, card vs the CPU's plain path, "
          f"{VB_CPU_ROWS} x {VB_CPU_SECONDS:g} s with silent edges, same "
          f"variables and batch "
          f"(tol loss {VB_LOSS_RTOL:g}, grad norm {VB_GNORM_RTOL:g} "
          f"relative): {'; '.join(lines)}")

    # 22c. train.remat on FE-L: one bf16 step with and without from one
    # state at REMAT_CMP_ROWS rows; with remat at the recipe's batch
    hps = config_hps("fastenhancer/l.yaml")
    w = get_wrapper("ns")(HParams(**hps), train=True, device=dev)
    rng = np.random.default_rng(24)
    n = int(REMAT_SECONDS * SR)
    clean = ctx["speech_like"](rng, REMAT_ROWS, n)
    noisy = (clean + rng.standard_normal(clean.shape) * 0.05).astype(
        np.float32)
    b_full = {"clean": torch.from_numpy(clean).to(dev),
              "noisy": torch.from_numpy(noisy).to(dev),
              "row_mask": torch.ones(REMAT_ROWS, device=dev)}

    def remat_step(remat, rows):
        """One bf16 step from a copy of the wrapper's variables ->
        (loss, grad norm, ms, peak GiB above the window's start, each
        leaf's gradient as the optimizer got it)."""
        w.model.remat = remat
        v = tree_map(lambda a: a.clone(), w.state["variables"])
        opt = get_optimizer(w.model, v["params"], hps["train"])
        grads = []
        opt_step = opt.step

        def spy_step(*a, **kw):
            grads.extend(p.grad.detach().clone() for g in opt.param_groups
                         for p in g["params"])
            return opt_step(*a, **kw)

        opt.step = spy_step
        step = make_train_step(w.model, w.loss, opt,
                               compute_dtype=w.compute_dtype)
        b = {k: t[:rows] for k, t in b_full.items()}
        base = mem_base()
        zero_counts()
        t0 = time.perf_counter()
        _, m = step({"variables": v}, b, [1e-3] * w.optim.n_groups)
        torch.cuda.synchronize()
        out = (float(m["loss/total"]), float(m["grad_norm"]),
               1e3 * (time.perf_counter() - t0), peak_gib(base), grads)
        _check(not any(read_counts().values()),
               "FE-L: a kernel ran in a train step")
        return out

    def gaps(a, b):
        """Per leaf, the norm of the gap of two gradient lists."""
        return np.array([float((y - x).norm()) for x, y in zip(a, b)])

    def differ(a, b):
        """The leaves of two gradient lists that are not bit-equal."""
        return [i for i, (x, y) in enumerate(zip(a, b))
                if not torch.equal(x, y)]

    res = {False: [], True: []}
    for remat in (False, True, False, True):   # each twice, interleaved
        res[remat].append(remat_step(remat, REMAT_CMP_ROWS))
    (l0, g0, t0_ms, p0_gb, gr0), (l1, g1, t1_ms, p1_gb, gr1) = (
        res[False][1], res[True][1])
    for remat, (a, b) in res.items():
        bad = differ(a[4], b[4])
        _check(not bad and a[0] == b[0], f"FE-L remat={remat}: two steps "
               f"from one state differ in gradient leaves {bad} (loss "
               f"{a[0]} vs {b[0]})")
    norm0 = np.array([float(x.norm()) for x in gr0])
    gap = gaps(gr0, gr1)
    bound = REMAT_GRAD_RTOL * norm0
    worst = int(np.argmax(gap / np.maximum(bound, 1e-30)))
    _check(abs(l1 / l0 - 1) <= REMAT_RTOL and np.isfinite(g1),
           f"FE-L remat loss {l1} vs {l0}")
    _check(len(gr0) == len(gr1) and bool((gap <= bound).all()),
           f"FE-L remat gradients: leaf {worst} off by {gap[worst]:.3e}, "
           f"bound {bound[worst]:.3e} (norm {norm0[worst]:.3e})")
    rel_gap = float((gap / np.maximum(norm0, 1e-30)).max())
    remat_differ = len(differ(gr0, gr1))
    _check(p1_gb < p0_gb, f"FE-L remat peak {p1_gb:.2f} GiB >= {p0_gb:.2f}")
    del res, gr0, gr1
    # the control: the offline iSTFT's overlap-add as an index_add_ (CUDA
    # adds a sample's overlapping frames with atomics, in the order they
    # land; FE-L's hop of 100 does not divide its n_fft of 512), the form
    # F.fold replaced: two steps from one state then differ
    ola = stft_mod.overlap_add
    stft_mod.overlap_add = overlap_add_atomic
    try:
        atomic = [remat_step(False, REMAT_CMP_ROWS) for _ in range(2)]
    finally:
        stft_mod.overlap_add = ola
    atomic_bad = differ(atomic[0][4], atomic[1][4])
    atomic_rel = float(max(gaps(atomic[0][4], atomic[1][4])
                           / np.maximum(norm0, 1e-30)))
    _check(atomic_bad, "FE-L with the index_add_ overlap-add: two steps "
           "from one state gave the same gradients (the control did not "
           "show the atomics' order)")
    del atomic
    remat_step(True, REMAT_ROWS)
    lf, gf, tf_ms, pf_gb, _ = remat_step(True, REMAT_ROWS)
    _check(np.isfinite(lf) and np.isfinite(gf), f"FE-L remat {lf}, {gf}")
    print(f"[22/30] train.remat FE-L (configs/fastenhancer/l.yaml, bf16, "
          f"one step from one state), {REMAT_CMP_ROWS} x {REMAT_SECONDS:g} "
          f"s: loss {l0:.6f} without, {l1:.6f} with (relative "
          f"{abs(l1 / l0 - 1):.2e}, tol {REMAT_RTOL:g}); grad norm {g0:.4f}"
          f" / {g1:.4f}; two steps of each mode from one state bit-equal "
          f"in all {len(norm0)} gradient leaves (the control with the "
          f"offline overlap-add as an index_add_: {len(atomic_bad)} leaves "
          f"differ, up to {atomic_rel:.2e} of a leaf's norm); with remat "
          f"against without: {remat_differ} leaves not bit-equal, gap up to"
          f" {rel_gap:.2e} of the leaf's norm, the worst leaf at "
          f"{gap[worst] / max(bound[worst], 1e-30):.2f} of its bound "
          f"({REMAT_GRAD_RTOL:g} x norm); peak "
          f"memory {p0_gb:.2f} GiB without, {p1_gb:.2f} "
          f"GiB with ({100 * (1 - p1_gb / p0_gb):.1f}% less); step "
          f"{t0_ms:.0f} ms without, {t1_ms:.0f} ms with; at the recipe's "
          f"{REMAT_ROWS} x {REMAT_SECONDS:g} s with remat: step {tf_ms:.0f}"
          f" ms, peak {pf_gb:.2f} GiB, loss {lf:.6f}; on {card}")

    print(f"[22/30] phase wall {time.perf_counter() - t_phase:.1f} s (CLI "
          f"runs {t_cli:.1f} s, corpus written in {corpus_s:.2f} s)")
    return total_scans


# phases 23-24: the on-the-fly recipes the CLI trains (a config marked
# "(reverb)" runs a copy of it with reverb on, written to the temp dir: the
# config reader refuses keys a config lacks, and t.yaml has no rir_length
# or rir_dir), their synthetic corpus (files a rate; the RIRs at 16 kHz),
# then the entry points on three of the runs
OTF_CONFIGS = ["fastenhancer_dns/b.yaml", "fastenhancer_48khz/b.yaml",
               "others_dns/bsrnn_xt.yaml",
               "fastenhancer_dns/huge_noncausal.yaml",
               "fastenhancer_dns/t.yaml (reverb)"]
OTF_STEPS = 2
OTF_CLEAN, OTF_NOISE, OTF_EVAL = 48, 16, 10
OTF_CLEAN_SECONDS, OTF_EVAL_SECONDS = (1.0, 5.0), (2.0, 2.5)
OTF_RIRS, OTF_RIR_SECONDS, OTF_REVERB_PROB = 4, 0.25, 0.5
# the mixer, the RIR convolution and the low-pass on the card against the
# CPU in float32: of the output's peak
OTF_MIX_REL = 1e-5
# phase 24: the engine's slots and ticks between admissions; the scores of
# metrics_ns, card against the CPU (tests/test_torch_scripts.py's
# tolerance)
SERVE_CAPACITY, SERVE_STAGGER = 8, 5
METRICS_TOL = 1e-4
# the float32 enhance and serve run again in a fresh process in which
# nothing sets a float flag, against the in-process runs (TF32 off): of
# the file's peak (the same settings compute the same bits; TF32 on in one
# of them misses this by ~100x)
FRESH_REL = 1e-6


def phase_23(ctx, root):
    """Phase 23 (see the module docstring), its files in `root`; -> ({config:
    its run dir}, #5's launches on its CLI paths)."""
    import numpy as np
    import torch

    from fastenhancer_tpu_torch.data import ns_on_the_fly as otf
    from fastenhancer_tpu_torch.data.audio_io import write_wav
    from fastenhancer_tpu_torch.models import get_model
    from fastenhancer_tpu_torch.ops import gru_scan as scan
    from fastenhancer_tpu_torch.utils import yaml_subset
    from fastenhancer_tpu_torch.utils.hparams import get_hparams
    from fastenhancer_tpu_torch.wrappers import ns as ns_wrapper
    from fastenhancer_tpu_torch.wrappers import ns_on_the_fly as otf_wrapper

    card, dev = ctx["card"], ctx["dev"]
    repo = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    print(f"[23/30] the on-the-fly recipes through the CLI, cuts: none of "
          f"width or the recipes' batch; {OTF_STEPS} steps, 1 epoch; a "
          f"synthetic corpus a rate of {OTF_CLEAN} clean files of "
          f"{OTF_CLEAN_SECONDS[0]:g}-{OTF_CLEAN_SECONDS[1]:g} s and one at "
          f"-80 dBFS, {OTF_NOISE} noise files, {OTF_EVAL} valid/PESQ pairs "
          f"of {OTF_EVAL_SECONDS[0]:g}-{OTF_EVAL_SECONDS[1]:g} s, "
          f"{OTF_RIRS} RIRs of {OTF_RIR_SECONDS:g} s")

    def corpus(sr, rng):
        """{clean, noise, eval_clean, eval_noisy, rir: dir} at sr."""
        dirs = {k: os.path.join(root, str(sr), k) for k in
                ("clean", "noise", "eval_clean", "eval_noisy", "rir")}
        for d in dirs.values():
            os.makedirs(d)

        def speech(seconds):
            n = int(rng.uniform(*seconds) * sr)
            return ctx["speech_like"](rng, 1, n)[0]

        for i in range(OTF_CLEAN):
            write_wav(os.path.join(dirs["clean"], f"{i:03d}.wav"),
                      speech(OTF_CLEAN_SECONDS), sr)
        # no segment above the recipes' -40 dB activity threshold: the
        # dataset gives it RMS 0 and skips it
        write_wav(os.path.join(dirs["clean"], "quiet.wav"),
                  1e-3 * speech(OTF_CLEAN_SECONDS), sr)
        for i in range(OTF_NOISE):
            n = int(rng.uniform(*OTF_CLEAN_SECONDS) * sr)
            write_wav(os.path.join(dirs["noise"], f"{i:03d}.wav"),
                      rng.standard_normal(n) * 0.05, sr)
        for i in range(OTF_EVAL):
            clean = speech(OTF_EVAL_SECONDS)
            noisy = clean + rng.standard_normal(len(clean)) * rng.uniform(
                0.01, 0.1)
            for k, x in (("eval_clean", clean), ("eval_noisy", noisy)):
                write_wav(os.path.join(dirs[k], f"{i:03d}.wav"), x, sr)
        t = np.arange(int(OTF_RIR_SECONDS * sr))
        for i in range(OTF_RIRS):
            r = rng.standard_normal(len(t)) * np.exp(-6.9 * t / (0.2 * sr))
            r[0] = np.abs(r).max()
            write_wav(os.path.join(dirs["rir"], f"{i:03d}.wav"),
                      0.9 * r / np.abs(r).max(), sr)
        return dirs

    t0 = time.perf_counter()
    rng = np.random.default_rng(23)
    corpora = {sr: corpus(sr, rng) for sr in (SR, 48_000)}
    corpus_s = time.perf_counter() - t0

    # spies, restored after the phase: the dataset's RMS-0 skips and files
    # a clip; the first raw train batch of each run with its wrapper's
    # mixer and low-pass; the step times; #5 inside train_epoch
    current, raw_batches, skipped, files_a_clip = [None], {}, [], []
    step_ms, scan_in_train = [], []
    rms, gen_audio = otf.NSOnTheFlyDataset.rms, otf.NSOnTheFlyDataset.gen_audio
    device_batch = otf_wrapper.ModelWrapper._device_batch
    step_and_account = ns_wrapper.ModelWrapper._step_and_account
    train_epoch = ns_wrapper.ModelWrapper.train_epoch

    def spy_rms(self, wav, activity_ratio):
        out = rms(self, wav, activity_ratio)
        skipped.append(out == 0.0)
        return out

    def spy_gen_audio(self, *args):
        out = gen_audio(self, *args)
        files_a_clip.append(len(out[1]))
        return out

    def spy_device_batch(self, batch, keys, **kwargs):
        if "noise" in batch and current[0] not in raw_batches:
            raw_batches[current[0]] = (
                {k: np.array(batch[k]) for k in ("clean", "noise", "rir")
                 if k in batch},
                (self.snr_mixer, self.dynamic_lpf, self.hop_size))
        return device_batch(self, batch, keys, **kwargs)

    def timed_step(self, dev_batch, rows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_and_account(self, dev_batch, rows)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    def counted_epoch(self, loader):
        before = ctx["read_counts"]()["gru_scan"]
        out = train_epoch(self, loader)
        scan_in_train.append(ctx["read_counts"]()["gru_scan"] - before)
        return out

    logs = os.path.join(root, "logs")
    runs, total_scans = {}, 0
    otf.NSOnTheFlyDataset.rms = spy_rms
    otf.NSOnTheFlyDataset.gen_audio = spy_gen_audio
    otf_wrapper.ModelWrapper._device_batch = spy_device_batch
    ns_wrapper.ModelWrapper._step_and_account = timed_step
    ns_wrapper.ModelWrapper.train_epoch = counted_epoch
    try:
        for config in OTF_CONFIGS:
            path = config.split()[0]
            reverb = config.endswith("(reverb)")
            name = path[:-5].replace("/", "_") + ("_reverb" if reverb
                                                   else "")
            cfg_path = os.path.join(repo, "configs", path)
            hps0 = get_hparams(cfg_path)
            dirs = corpora[hps0.data.sampling_rate]
            if reverb:
                cfg = hps0.to_dict()
                cfg["data"].update(reverb_prob=OTF_REVERB_PROB,
                                   rir_length=int(OTF_RIR_SECONDS
                                                  * hps0.data.sampling_rate))
                cfg["data"]["train"]["rir_dir"] = dirs["rir"]
                cfg_path = os.path.join(root, f"{name}.yaml")
                with open(cfg_path, "w") as f:
                    f.write(yaml_subset.dump(cfg))
            argv = ["-n", name, "-c", cfg_path, "--base_dir", logs, "-p",
                    f"data.train.clean_dir={dirs['clean']!r}",
                    f"data.train.noise_dir={dirs['noise']!r}",
                    f"data.train.length={OTF_STEPS * hps0.train.batch_size}",
                    f"data.valid.clean_dir={dirs['eval_clean']!r}",
                    f"data.valid.noisy_dir={dirs['eval_noisy']!r}",
                    f"data.pesq.clean_dir={dirs['eval_clean']!r}",
                    f"data.pesq.noisy_dir={dirs['eval_noisy']!r}",
                    "train.max_epochs=1", "train.save_interval=1",
                    "pesq.interval=1"]
            current[0] = name
            step_ms.clear()
            scan_in_train.clear()
            ctx["seen_scan"].clear()
            base = mem_base()
            ctx["record_inputs"](True)
            try:
                history, counts, out = ctx["run_cli"](argv)
            finally:
                ctx["record_inputs"](False)
            peak = peak_gib(base)
            run = os.path.join(logs, name)
            runs[config] = run
            hps = get_hparams(None, run)
            (r,) = history
            files = sorted(os.listdir(run))
            _check(r["epoch"] == 1 and files == ["00001.ckpt", "config.yaml",
                                                 "train", "valid"],
                   f"{config}: epoch {r['epoch']}, files {files}")
            vals = list(r["train"].values()) + list(r["valid"].values())
            _check(all(np.isfinite(v) for v in vals), f"{config}: {r}")
            _check(1.0 <= r["valid"]["metrics/pesq"] <= 4.65
                   and -1.0 <= r["valid"]["metrics/stoi"] <= 1.0,
                   f"{config} metrics: {r['valid']}")
            tm = r["timing"]
            _check(tm["steps"] == OTF_STEPS, f"{config}: {tm['steps']} steps")
            # #5: only in the valid and PESQ forwards, never in train_epoch
            model = get_model(hps.model, **hps.model_kwargs.to_dict())
            per = scans_per_forward(model)
            valid_n = -(-OTF_EVAL // hps.valid.batch_size)
            pesq_n = -(-OTF_EVAL // hps.pesq.batch_size)
            bf16 = bool(hps.train.fp16)
            want = {k: 0 for k in ctx["counters"]}
            want["gru_scan"] = per * (valid_n + pesq_n)
            want[GRU_TC] = per * valid_n if bf16 else 0
            _check(counts == want, f"{config}: launches {counts} != {want}")
            _check(scan_in_train == [0], f"{config}: #5 ran {scan_in_train} "
                   "times in train_epoch")
            total_scans += counts["gru_scan"]
            worst, shapes = 0.0, []
            for (shape, dtype), (form, args) in ctx["seen_scan"].items():
                ys, h_t = scan.gru_scan(*args)
                torch.cuda.synchronize()
                ys_r, h_r = scan.gru_scan_reference(*args)
                errs = ctx["compare"](f"{config} gru_scan {shape}",
                                      ((ys, ys_r), (h_t, h_r)), dtype)
                worst = max(worst, errs[0][0], errs[1][0])
                shapes.append(f"({shape[0]}, {shape[1]}, {shape[2] // 3}) "
                              f"{str(dtype)[6:]} {form}")
            rest = (r["seconds"] - tm["load"] - tm["step"] - tm["valid"]
                    - tm["metrics"])
            losses = ", ".join(f"{k[5:]} {v:.4g}" for k, v in
                               r["train"].items() if k.startswith("loss/"))
            print(f"[23/30] CLI {config} ({hps.model}, "
                  f"{'bf16' if bf16 else 'float32'} over float32 masters, "
                  f"batch {hps.train.batch_size} x "
                  f"{hps.data.train.segment_size / hps.data.sampling_rate:g}"
                  f" s at {hps.data.sampling_rate} Hz): step ms "
                  f"{', '.join(f'{v:.1f}' for v in step_ms)}; data load "
                  f"{tm['load']:.2f} s ({100 * tm['load'] / r['seconds']:.1f}"
                  f"% of the epoch); valid {1e3 * tm['valid']:.1f} ms "
                  f"({valid_n} batch of {OTF_EVAL}); PESQ/STOI "
                  f"{tm['metrics']:.2f} s; epoch wall {r['seconds']:.2f} s = "
                  f"load {tm['load']:.2f} + step {tm['step']:.2f} + valid "
                  f"{tm['valid']:.2f} + PESQ/STOI {tm['metrics']:.2f} + rest "
                  f"{rest:.2f} s; peak memory {peak:.2f} GiB above the "
                  f"phase's; #5 {counts['gru_scan']} launches "
                  f"({counts[GRU_TC]} tc), none in train_epoch, inputs "
                  f"{'; '.join(shapes) or 'none'} held to the plain version "
                  f"(max abs err {worst:.3e}); losses {losses}; PESQ "
                  f"{r['valid']['metrics/pesq']:.3f}; on {card}")
    finally:
        otf.NSOnTheFlyDataset.rms = rms
        otf.NSOnTheFlyDataset.gen_audio = gen_audio
        otf_wrapper.ModelWrapper._device_batch = device_batch
        ns_wrapper.ModelWrapper._step_and_account = step_and_account
        ns_wrapper.ModelWrapper.train_epoch = train_epoch
    _check(any(skipped) and max(files_a_clip) > 1,
           f"the dataset's branches: {sum(skipped)} RMS-0 skips, up to "
           f"{max(files_a_clip)} files a clip")

    # the mixer (its RIR convolution too) and the low-pass on the card
    # against the CPU, float32, on each run's first raw batch with one set
    # of host draws
    lines = []
    for config in ("fastenhancer_48khz/b.yaml",
                   "fastenhancer_dns/t.yaml (reverb)"):
        name = os.path.basename(runs[config])
        raw, (mixer, lpf, hop) = raw_batches[name]
        rows = raw["clean"].shape[0]
        t = min(raw["clean"].shape[-1], raw["noise"].shape[-1]) // hop * hop
        snr, rms_target = mixer.sample_params()
        kernels = lpf.sample_kernels(rows, np.random.default_rng(23))
        low_passed = sum(not np.array_equal(k, lpf.delta) for k in kernels)
        reverb_rows = (int((raw["rir"][:, 1:] != 0).any(1).sum())
                       if "rir" in raw else 0)
        _check(low_passed if lpf.p_lpf > 0 else reverb_rows,
               f"{config}: {low_passed} rows low-passed, {reverb_rows} "
               "reverberant")
        outs = {}
        for where in ("cpu", dev):
            def put(a):
                return torch.from_numpy(np.ascontiguousarray(
                    a, dtype=np.float32)).to(where)

            rir = put(raw["rir"]) if "rir" in raw else None
            c, n, y = mixer(put(raw["clean"][:, :t]),
                            put(raw["noise"][:, :t]), snr, rms_target, rir)
            if lpf.p_lpf > 0:
                c, y = lpf(c, kernels), lpf(y, kernels)
            outs[where] = [c, n, y] + ([] if rir is None else [
                otf.batch_rir_conv(put(raw["clean"][:, :t]), rir)])
        errs = []
        for got, want in zip(outs[dev], outs["cpu"]):
            err = float((got.cpu() - want).abs().max())
            peak = float(want.abs().max())
            _check(err <= OTF_MIX_REL * peak, f"{config} mix card vs CPU: "
                   f"{err:.3e} of a peak {peak:.3e}")
            errs.append(err / peak)
        lines.append(f"{config} ({rows} x {t} samples, SNR {snr} dB, "
                     f"{rms_target} dBFS, {low_passed} rows low-passed, "
                     f"{reverb_rows} reverberant): max abs err of the peak "
                     f"clean {errs[0]:.2e}, noise {errs[1]:.2e}, noisy "
                     f"{errs[2]:.2e}"
                     + (f", batch_rir_conv {errs[3]:.2e}" if rir is not None
                        else ""))
    print(f"[23/30] SNRMixer, batch_rir_conv and DynamicBatchLPF, card vs "
          f"the CPU in float32 on each run's first train batch and one set "
          f"of draws (tol {OTF_MIX_REL:g} of the peak): {'; '.join(lines)}; "
          f"the dataset skipped {sum(skipped)} of {len(skipped)} files at "
          f"RMS 0, up to {max(files_a_clip)} files a clip")

    # #5 at the shapes these recipes give it at their own valid batch: the
    # 48 kHz FE-B (H = 36), the noncausal recipes at 16 and 24 kHz (H =
    # 128), both directions
    shapes = []
    for path in ("fastenhancer_48khz/b.yaml",
                 "fastenhancer_dns/huge_noncausal.yaml",
                 "fastenhancer_dns/huge_noncausal_24khz.yaml"):
        hps = get_hparams(os.path.join(repo, "configs", path))
        mk = hps.model_kwargs
        t = hps.data.valid.segment_size // mk.hop_size + 1
        n = hps.valid.batch_size * mk.rnnformer_kwargs.freq
        h = mk.rnnformer_kwargs.channels
        what = f"{path} valid forward ({hps.valid.batch_size} x 2 s)"
        shapes.append((t, n, h, False, False, True, what))
        if "noncausal" in path:
            shapes.append((t, n, h, False, True, False, what + " backward"))
    ctx["check_and_time"](shapes, phase=23)
    print(f"[23/30] phase wall {time.perf_counter() - t_phase:.1f} s "
          f"(corpus written in {corpus_s:.2f} s)")
    return runs, total_scans


def phase_24(ctx, runs):
    """Phase 24 (see the module docstring) on phase 23's runs; -> the
    launches of its paths: {kernel: {path: launches}}."""
    import numpy as np
    import torch

    import fastenhancer_tpu_torch.data as data_pkg
    from fastenhancer_tpu_torch import serving
    from fastenhancer_tpu_torch.models import bsrnn as bsrnn_model
    from fastenhancer_tpu_torch.models.fastenhancer import default as fe_model
    from fastenhancer_tpu_torch.ops import bsrnn_stack as band
    from fastenhancer_tpu_torch.ops import gru_scan as scan
    from fastenhancer_tpu_torch.ops import rnnformer_stack as stack
    from fastenhancer_tpu_torch.scripts import enhance, metrics_ns, serve
    from fastenhancer_tpu_torch.utils.hparams import get_hparams

    card, dev = ctx["card"], ctx["dev"]
    t_phase = time.perf_counter()
    out_root = os.path.join(os.path.dirname(os.path.dirname(
        runs[OTF_CONFIGS[0]])), "out")
    paths = {"gru_scan": {}, "rnnformer_stack_step": {},
             "bsrnn_stack_step": {}}

    # the float outputs each script writes, by file name
    written, write_wav = {}, data_pkg.write_wav

    def keep_wav(path, x, sr):
        written[os.path.basename(path)] = np.array(x, np.float32)
        write_wav(path, x, sr)

    def run(entry, config, extra, record=False):
        """entry.main on the config's run, its launches counted and #5's
        inputs recorded (record) -> (returned, counts, stdout, outputs)."""
        base, name = os.path.split(runs[config])
        written.clear()
        ctx["seen_scan"].clear()
        ctx["record_inputs"](record)
        try:
            ret, counts, out = ctx["run_cli"](
                ["-n", name, "--base_dir", base, *extra], entry.main)
        finally:
            ctx["record_inputs"](False)
        return ret, counts, out, dict(written)

    def scan_inputs(what):
        """#5 on each input shape the run gave it, against the plain
        version -> (shapes, max abs err)."""
        worst = 0.0
        for (shape, dtype), (_, args) in ctx["seen_scan"].items():
            ys, h_t = scan.gru_scan(*args)
            torch.cuda.synchronize()
            ys_r, h_r = scan.gru_scan_reference(*args)
            errs = ctx["compare"](f"{what} gru_scan {shape}",
                                  ((ys, ys_r), (h_t, h_r)), dtype)
            worst = max(worst, errs[0][0], errs[1][0])
        return len(ctx["seen_scan"]), worst

    def worst_rel(got, want):
        """The largest per-file max abs error over the file's peak."""
        _check(got.keys() == want.keys() and len(want) == OTF_EVAL,
               f"outputs {sorted(got)} != {sorted(want)}")
        return max(float(np.abs(got[f] - w).max()) / float(np.abs(w).max())
                   for f, w in want.items())

    def after(text, key):
        return float(text.split(key, 1)[1].split()[0].rstrip(")"))

    data_pkg.write_wav = keep_wav
    try:
        # 24a. enhance on the FE-B DNS run, card against the CPU
        dns = "fastenhancer_dns/b.yaml"
        hps = get_hparams(None, runs[dns])
        blocks = hps.model_kwargs.rnnformer_kwargs.num_blocks
        io_args = ["-i", hps.data.pesq.noisy_dir]
        _, counts, out, y_card = run(
            enhance, dns, [*io_args, "-o", os.path.join(out_root, "enh")],
            record=True)
        n_shapes, worst = scan_inputs("enhance")
        batches = -(-OTF_EVAL // 8)
        ctx["check_launches"](counts, "gru_scan", blocks * batches,
                              "enhance", tc=0)
        paths["gru_scan"]["enhance FE-B DNS, float32 (24)"] = counts[
            "gru_scan"]
        _, _, _, y_cpu = run(enhance, dns, [
            *io_args, "-o", os.path.join(out_root, "enh_cpu"), "--device",
            "cpu"])
        rel = worst_rel(y_card, y_cpu)
        _check(rel <= F32_OUT_REL, f"enhance card vs CPU: {rel:.3e} of the "
               "peak")
        print(f"[24/30] enhance {dns} on {OTF_EVAL} files: the card's float32"
              f" outputs vs the CPU's max abs err {rel:.2e} of the file's "
              f"peak (tol {F32_OUT_REL:g}); #5 {counts['gru_scan']} "
              f"launches ({batches} batches of 8, scalar form), "
              f"{n_shapes} input shapes held to the plain version (max abs "
              f"err {worst:.3e}); RTF {after(out, 'RTF ')} on the card; on "
              f"{card}")

        # 24b. serve --fused --dtype bf16 against serve in float32
        launches, ticks = [], [0]
        tick = serving.StreamingEngine.tick

        def counted_tick(self, hops):
            ticks[0] += 1
            return tick(self, hops)

        def spy(real):
            def launch(plan, *args):
                out = real(plan, *args)
                launches.append((plan, [a.clone() if torch.is_tensor(a)
                                        else a for a in args],
                                 [o.clone() for o in out]))
                return out
            return launch

        timing_cases, f32_served = {}, {}
        for config, tag, module, kernel, reference in (
                (dns, "FE-B DNS", fe_model, "rnnformer_stack_step",
                 stack.rnnformer_stack_reference),
                ("fastenhancer_48khz/b.yaml", "FE-B 48 kHz", fe_model,
                 "rnnformer_stack_step", stack.rnnformer_stack_reference),
                ("others_dns/bsrnn_xt.yaml", "BSRNN-XT", bsrnn_model,
                 "bsrnn_stack_step", band.bsrnn_stack_reference)):
            hps = get_hparams(None, runs[config])
            serve_args = ["-i", hps.data.pesq.noisy_dir, "--capacity",
                          str(SERVE_CAPACITY), "--stagger",
                          str(SERVE_STAGGER)]
            real = getattr(module, kernel)
            launches.clear()
            ticks[0] = 0
            setattr(module, kernel, spy(real))
            serving.StreamingEngine.tick = counted_tick
            try:
                _, counts, out_b, y_b = run(serve, config, [
                    *serve_args, "-o", os.path.join(out_root, f"{tag}_bf16"),
                    "--fused", "--dtype", "bf16"])
            finally:
                setattr(module, kernel, real)
            n = len(launches)
            _check(n == ticks[0] > 0, f"{tag}: {n} launches in {ticks[0]} "
                   "ticks")
            _, first_args, _ = launches[0]
            form = "tc"
            if kernel == "bsrnn_stack_step":
                x, h = first_args
                form = band.kernel_form(x.shape[0], x.shape[2], h.shape[-1],
                                        torch.bfloat16)
            ctx["check_launches"](counts, kernel, n,
                                  f"serve --fused bf16 {tag}",
                                  tc=n if form == "tc" else 0)
            worst = 0.0
            for plan, args, outs in launches:
                errs = ctx["compare"](f"{tag} {kernel} in serve",
                                      zip(outs, reference(plan, *args)),
                                      torch.bfloat16)
                worst = max(worst, *(e for e, _ in errs))
            timing_cases[tag] = launches[0][:2]
            launches.clear()
            paths[kernel][f"serve --fused bf16 {tag} (24)"] = n
            # the same checkpoint served unfused in float32
            ticks[0] = 0
            try:
                _, counts_f, out_f, y_f = run(serve, config, [
                    *serve_args, "-o", os.path.join(out_root, f"{tag}_f32")],
                    record=True)
            finally:
                serving.StreamingEngine.tick = tick
            n_shapes, worst_scan = scan_inputs(f"serve {tag}")
            per_tick = blocks if kernel == "rnnformer_stack_step" else 0
            ctx["check_launches"](counts_f, "gru_scan", per_tick * ticks[0],
                                  f"serve float32 {tag}", tc=0)
            if per_tick:
                paths["gru_scan"][f"serve float32 {tag} (24)"] = counts_f[
                    "gru_scan"]
            f32_served[config] = y_f
            rel = worst_rel(y_b, y_f)
            _check(rel <= BF16_REL, f"serve {tag}: bf16 fused vs float32 "
                   f"{rel:.3e} of the peak")
            print(f"[24/30] serve {config} (capacity {SERVE_CAPACITY}, a "
                  f"stream every {SERVE_STAGGER} ticks, {OTF_EVAL} files): "
                  f"--fused --dtype bf16 {n} launches of {kernel} in {n} "
                  f"ticks ({form} form), each held to the plain version (max "
                  f"abs err {worst:.3e}), tick ms p50 "
                  f"{after(out_b, 'p50 ')} p90 {after(out_b, 'p90 ')} p99 "
                  f"{after(out_b, 'p99 ')}, RTF "
                  f"{after(out_b, 'aggregate RTF ')}; float32 unfused "
                  f"{ticks[0]} ticks, #5 {counts_f['gru_scan']} launches "
                  f"({n_shapes} shapes held, max abs err {worst_scan:.3e}), "
                  f"tick ms p50 {after(out_f, 'p50 ')} p99 "
                  f"{after(out_f, 'p99 ')}, RTF "
                  f"{after(out_f, 'aggregate RTF ')}; bf16 fused vs float32 "
                  f"max abs err {rel:.2e} of the file's peak (tol "
                  f"{BF16_REL:g}); on {card}")

        # 24b'. the float32 enhance and serve of the FE-B DNS run again,
        # in a fresh process in which nothing sets a float flag: the
        # entry points' own full float32
        base, name = os.path.split(runs[dns])
        serve_in = get_hparams(None, runs[dns]).data.pesq.noisy_dir
        fresh_spec = os.path.join(out_root, "fresh.json")
        with open(fresh_spec, "w") as f:
            json.dump([
                ("enhance", ["-n", name, "--base_dir", base, *io_args, "-o",
                             os.path.join(out_root, "enh_fresh")]),
                ("serve", ["-n", name, "--base_dir", base, "-i", serve_in,
                           "--capacity", str(SERVE_CAPACITY), "--stagger",
                           str(SERVE_STAGGER), "-o",
                           os.path.join(out_root, "serve_fresh")])], f)
        fresh_out = os.path.join(out_root, "fresh.npz")
        spawned(_phase_24_child, 1, fresh_spec, fresh_out)
        fresh = np.load(fresh_out)
        at_start, after_main = (fresh["tf32_at_start"].tolist(),
                                fresh["tf32_after"].tolist())
        _check(after_main == [False, False], f"fresh enhance/serve: TF32 "
               f"flags {after_main} after their mains")
        fresh_rel = {}
        for entry, want in (("enhance", y_card), ("serve", f32_served[dns])):
            got = {k.split("__", 1)[1]: fresh[k] for k in fresh.files
                   if k.startswith(entry + "__")}
            fresh_rel[entry] = worst_rel(got, want)
            _check(fresh_rel[entry] <= FRESH_REL, f"fresh-process float32 "
                   f"{entry} vs in-process: {fresh_rel[entry]:.3e} of the "
                   "peak")
        print(f"[24/30] float32 enhance and serve (unfused) of {dns} again "
              f"in a fresh process that sets no float flag (TF32 [matmul, "
              f"cuDNN] {at_start} at its start, {after_main} after the "
              f"entry points' mains) vs the in-process runs: max abs err "
              f"{fresh_rel['enhance']:.2e} and {fresh_rel['serve']:.2e} of "
              f"the file's peak (tol {FRESH_REL:g}); on {card}")

        # 24c. metrics_ns on the FE-B DNS run, card against the CPU
        pesq_n = -(-OTF_EVAL // get_hparams(None, runs[dns]).pesq.batch_size)
        got, counts, _, _ = run(metrics_ns, dns, ["--no-external"],
                                record=True)
        n_shapes, worst = scan_inputs("metrics_ns")
        ctx["check_launches"](counts, "gru_scan", blocks * pesq_n,
                              "metrics_ns", tc=0)
        paths["gru_scan"]["metrics_ns FE-B DNS, float32 (24)"] = counts[
            "gru_scan"]
        want, _, _, _ = run(metrics_ns, dns, ["--no-external", "--device",
                                              "cpu"])
        _check(got.keys() == want.keys() == {"sisdr", "stoi", "estoi",
                                              "pesq"}
               and all(np.isfinite(v) for v in got.values())
               and all(abs(got[k] - want[k]) <= METRICS_TOL for k in want),
               f"metrics_ns card {got} vs CPU {want}")
        print(f"[24/30] metrics_ns {dns} on {OTF_EVAL} files: "
              + ", ".join(f"{k.upper()} {v:.4f} (CPU {want[k]:.4f})"
                          for k, v in got.items())
              + f" (tol {METRICS_TOL:g}); #5 {counts['gru_scan']} launches, "
              f"{n_shapes} shapes held (max abs err {worst:.3e}); on {card}")
    finally:
        data_pkg.write_wav = write_wav

    # 24d. #1 at the 48 kHz FE-B's F = 36 and #3 at BSRNN-XT's C = 16 with
    # the checkpoints' bf16 plans, at 256 streams, timed beside the plain
    # version and the bound
    g = torch.Generator().manual_seed(24)
    for tag, kernel, reference, flops in (
            ("FE-B 48 kHz", stack.rnnformer_stack_step,
             stack.rnnformer_stack_reference, ctx["stack_flops"]),
            ("BSRNN-XT", band.bsrnn_stack_step, band.bsrnn_stack_reference,
             ctx["band_flops"])):
        plan, (x1, h1, *rest) = timing_cases[tag]
        if kernel is stack.rnnformer_stack_step:
            nb, f, c = h1.shape[0], x1.shape[1], x1.shape[2]
            x = torch.randn(STREAMS, f, c, generator=g)
            h = torch.randn(nb, STREAMS * f, c, generator=g) * 0.5
            shape = f"B={STREAMS} F={f} C={c} H={rest[0]} NB={nb}"
        else:
            f, c, nb = x1.shape[0], x1.shape[2], h1.shape[0]
            x = torch.randn(f, STREAMS, c, generator=g)
            h = torch.randn(*h1.shape[:3], STREAMS, h1.shape[-1],
                            generator=g) * 0.5
            shape = f"B={STREAMS} F={f} C={c} H={h1.shape[-1]} L={nb}"
        x, h = (t.to(dev, torch.bfloat16) for t in (x, h))
        xo, ho = kernel(plan, x, h, *rest)
        torch.cuda.synchronize()
        errs = ctx["compare"](f"{tag} timing case",
                              zip((xo, ho), reference(plan, x, h, *rest)),
                              torch.bfloat16)
        tensors = [v for v in plan.values() if torch.is_tensor(v)]
        rec = ctx["timed"](
            lambda: kernel(plan, x, h, *rest),
            lambda: reference(plan, x, h, *rest),
            max(e for e, _ in errs),
            ctx["bound"](flops(STREAMS, f, c, nb),
                         ctx["nbytes"](x, h, xo, ho, *tensors),
                         torch.bfloat16),
            plain_graph=kernel is band.bsrnn_stack_step)
        print(f"[24/30] time {kernel.__name__} {tag} {shape} bf16 (the "
              f"checkpoint's plan): kernel {rec['ms']:.4f} ms, plain "
              f"PyTorch {rec['plain_ms']:.4f} ms ({rec['plain_timing']}); "
              f"bound {1e3 * rec['bound_ms']:.3f} us, "
              f"{100 * rec['bound_ms'] / rec['ms']:.2f}% of the kernel's "
              f"time ({rec['bound_by']}; {rec['flops'] / 1e9:.4f} GFLOP, "
              f"{rec['bytes'] / 1e6:.4f} MB); max abs err "
              f"{rec['max_abs_err']:.3e}; on {card}")
    print(f"[24/30] phase wall {time.perf_counter() - t_phase:.1f} s")
    return paths


def _phase_24_child(rank, world, coordinator, spec_path, out_path):
    """Phase 24's fresh process, in which nothing sets a float flag: each
    (entry, argv) of spec_path through the entry point's `main`, the float
    samples of every output kept (the wavs are PCM16) and saved to
    out_path (npz, "<entry>__<file>"), with the TF32 flags at the start
    and after the mains."""
    del rank, world, coordinator
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import fastenhancer_tpu_torch.data as data_pkg
    from fastenhancer_tpu_torch.scripts import enhance, serve

    at_start = tf32_flags()
    with open(spec_path) as f:
        spec = json.load(f)
    written, write_wav, entry = {}, data_pkg.write_wav, [None]

    def keep_wav(path, x, sr):
        written[f"{entry[0]}__{os.path.basename(path)}"] = np.array(
            x, np.float32)
        write_wav(path, x, sr)

    data_pkg.write_wav, stdout = keep_wav, sys.stdout
    try:
        sys.stdout = io.StringIO()
        for entry[0], argv in spec:
            {"enhance": enhance, "serve": serve}[entry[0]].main(argv)
    finally:
        sys.stdout, data_pkg.write_wav = stdout, write_wav
    np.savez(out_path, tf32_at_start=np.array(at_start),
             tf32_after=np.array(tf32_flags()), **written)


# phase 25: the training CLI's summaries, showcase, histograms, profiler
# window and native decoder. FE-T on the shard recipe (phase 21's corpus
# writer, its valid batch): SUM_STEPS steps an epoch, 2 epochs, the
# profiler window of SUM_PROFILE (a copy of t.yaml with train.profile set:
# the config reader refuses keys a config lacks), SUM_FILES showcase files
# (the recipes name 4); then one more epoch of phase 23's 48 kHz FE-B run
SUM_STEPS = 5
SUM_PROFILE = {"start": 1, "steps": 2}
SUM_FILES = 4
# the showcase's float32 audio, card against the CPU on one checkpoint: of
# the peak (phase 24's enhance holds the same forward to 1e-4; measured
# 4.1e-07 there)
INFER_REL = 1e-5


def trace_kernels(path):
    """The CUDA kernel events of a torch.profiler Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"]


def phase_25(ctx, runs, root):
    """Phase 25 (see the module docstring), its files in `root`; -> the
    launches of its CLI runs: {kernel: launches}."""
    import numpy as np
    import torch

    from fastenhancer_tpu_torch import native
    from fastenhancer_tpu_torch.data import get_dataset_dataloader
    from fastenhancer_tpu_torch.data.shard import ShardSource
    from fastenhancer_tpu_torch.models import get_model
    from fastenhancer_tpu_torch.train import load_checkpoint
    from fastenhancer_tpu_torch.utils import tree_paths, yaml_subset
    from fastenhancer_tpu_torch.utils.event_file import (decode_png,
                                                         read_events)
    from fastenhancer_tpu_torch.utils.hparams import get_hparams
    from fastenhancer_tpu_torch.wrappers import get_wrapper
    from fastenhancer_tpu_torch.wrappers import ns as ns_wrapper

    card, dev = ctx["card"], ctx["dev"]
    repo = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    _check(native.available(), "the native decoder did not build (g++)")
    logs = os.path.join(root, "summaries_logs")
    names = [f"{i:02d}" for i in range(SUM_FILES)]
    files = [f"{i:03d}" for i in range(SUM_FILES)]

    # spies, restored after the phase: each step's wall (synchronised) and
    # whether the profiler's window was open at its dispatch; the launches
    # inside each infer_epoch
    step_ms, infer_counts = [], []
    step_and_account = ns_wrapper.ModelWrapper._step_and_account
    infer_epoch = ns_wrapper.ModelWrapper.infer_epoch

    def timed_step(self, dev_batch, rows):
        open_ = self.profiler is not None and self.profiler.active
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_and_account(self, dev_batch, rows)
        torch.cuda.synchronize()
        step_ms.append((open_, 1e3 * (time.perf_counter() - t0)))
        return out

    def counted_infer(self, loader):
        before = ctx["read_counts"]()
        t0 = time.perf_counter()
        out = infer_epoch(self, loader)
        after = ctx["read_counts"]()
        infer_counts.append(({k: after[k] - before[k] for k in after},
                             time.perf_counter() - t0))
        return out

    def run_cli(argv):
        ns_wrapper.ModelWrapper._step_and_account = timed_step
        ns_wrapper.ModelWrapper.infer_epoch = counted_infer
        try:
            return ctx["run_cli"](argv)
        finally:
            ns_wrapper.ModelWrapper._step_and_account = step_and_account
            ns_wrapper.ModelWrapper.infer_epoch = infer_epoch

    def events(run, part):
        """Every event of the run's `part` files (each record's CRCs
        checked by read_events) -> {step: [(tag, kind, value)]}."""
        out = {}
        for name in sorted(os.listdir(os.path.join(run, part))):
            for e in read_events(os.path.join(run, part, name)):
                if e["values"]:  # not the file_version event
                    out.setdefault(e["step"], []).extend(e["values"])
        return out

    def showcase_tags(values, epoch, interval):
        audio = sorted(t for t, k, _ in values if k == "audio")
        images = sorted(t for t, k, _ in values if k == "image")
        kinds = ("noisy", "clean", "enhanced") if epoch <= interval else (
            "enhanced",)
        _check(audio == sorted(f"{k}/{n}" for k in kinds for n in names),
               f"showcase audio tags at epoch {epoch}: {audio}")
        _check(images == sorted(f"{k}/{n}" for k in ("enhanced",
                                                     "enhanced_mel")
                                for n in names),
               f"showcase image tags at epoch {epoch}: {images}")
        sisdr = [v for t, k, v in values if t == "infer/sisdr"]
        _check(len(sisdr) == 1 and np.isfinite(sisdr[0]),
               f"infer/sisdr at epoch {epoch}: {sisdr}")
        shapes = {t: decode_png(v["encoded_image_string"]).shape
                  for t, k, v in values if k == "image"}
        for n in names:
            frames = shapes[f"enhanced/{n}"][1]
            _check(shapes[f"enhanced/{n}"] == (513, frames, 3)
                   and shapes[f"enhanced_mel/{n}"] == (80, frames, 3),
                   f"showcase images {n}: {shapes}")
        return sisdr[0], {t: v for t, k, v in values if k == "audio"}

    def card_vs_cpu(run, epoch, logged):
        """The showcase of the run's checkpoint `epoch` enhanced on the card
        and on the CPU: the float32 audio within INFER_REL of the peak, and
        the card's equal to what the event file holds (PCM16, one step)."""
        hps = get_hparams(None, run)
        out = {}
        for where in (dev, "cpu"):
            w = get_wrapper(hps.wrapper)(hps, train=False, device=where)
            w.load(epoch)
            w.epoch = epoch
            _, loader = get_dataset_dataloader(hps, "infer", w.infer_keys)
            out[str(where)] = w.infer_epoch(loader)
        worst = pcm_worst = 0.0
        for n in names:
            got = out[str(dev)]["audios"][f"enhanced/{n}"]
            want = out["cpu"]["audios"][f"enhanced/{n}"]
            peak = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            _check(got.shape == want.shape and err <= INFER_REL * peak,
                   f"{run} showcase {n} card vs CPU: {err:.3e} of a peak "
                   f"{peak:.3e}")
            worst = max(worst, err / peak)
            pcm = np.frombuffer(logged[f"enhanced/{n}"][
                "encoded_audio_string"][44:], "<i2").astype(np.int64)
            mine = np.clip(got / max(1.0, float(np.abs(got).max())) * 32768,
                           -32768, 32767).astype(np.int64)
            pcm_err = int(np.abs(pcm - mine).max())
            _check(pcm.shape == mine.shape and pcm_err <= 1,
                   f"{run} logged showcase {n} vs the card's: {pcm_err} "
                   "PCM steps")
            pcm_worst = max(pcm_worst, pcm_err)
        return worst, pcm_worst

    # -- 25a. FE-T on the shard recipe: summaries, histograms, profiler --------
    t0 = time.perf_counter()
    inputs, (clean_dir, noisy_dir), _ = ctx["write_corpus"](
        os.path.join(root, "fe_t"), seed=25)
    corpus_s = time.perf_counter() - t0
    cfg = get_hparams(os.path.join(repo, "configs", "fastenhancer_shard",
                                   "t.yaml")).to_dict()
    cfg["train"]["profile"] = dict(SUM_PROFILE)
    cfg_path = os.path.join(root, "t_profile.yaml")
    with open(cfg_path, "w") as f:
        f.write(yaml_subset.dump(cfg))
    argv = ["-n", "summaries", "-c", cfg_path, "--base_dir", logs, "-p",
            f"data.train.inputs={inputs!r}",
            f"data.valid.clean_dir={clean_dir!r}",
            f"data.valid.noisy_dir={noisy_dir!r}",
            f"data.pesq.clean_dir={clean_dir!r}",
            f"data.pesq.noisy_dir={noisy_dir!r}",
            f"data.infer.clean_dir={clean_dir!r}",
            f"data.infer.noisy_dir={noisy_dir!r}",
            f"data.infer.files={files!r}",
            f"train.steps_per_epoch={SUM_STEPS}", "train.max_epochs=2",
            "train.save_interval=1", "infer.interval=1",
            "train.plot_param_and_grad=True",
            f"valid.batch_size={CLI_VALID_BATCH}"]
    walks = native.shard_members.launches
    history, counts, _ = run_cli(argv)
    walks = native.shard_members.launches - walks
    _check(walks > 0, "the shard reader did not take the native decoder")
    run = os.path.join(logs, "summaries")
    _check(sorted(os.listdir(run)) == ["00001.ckpt", "00002.ckpt",
                                       "config.yaml", "profile", "train",
                                       "valid"],
           f"summaries run dir: {sorted(os.listdir(run))}")
    hps = get_hparams(None, run)
    blocks = hps.model_kwargs.rnnformer_kwargs.num_blocks
    valid_n = -(-CLI_WAVS // CLI_VALID_BATCH)
    want = {k: 0 for k in ctx["counters"]}
    want.update({"segmental_rms_fused": 2 * SUM_STEPS * 2,
                 "gru_scan": blocks * (valid_n + SUM_FILES) * 2,
                 GRU_TC: blocks * valid_n * 2})
    _check(counts == want, f"summaries CLI: launches {counts} != {want}")
    # #5 inside infer_epoch: once a time GRU a file, its float32 (scalar)
    # form, no other kernel
    per_infer = {k: 0 for k in ctx["counters"]}
    per_infer["gru_scan"] = blocks * SUM_FILES
    _check([c for c, _ in infer_counts] == [per_infer] * 2,
           f"launches in infer_epoch: {infer_counts} != {per_infer} x 2")
    leaves = ["/".join(p) for p, _ in tree_paths(load_checkpoint(
        os.path.join(run, "00002.ckpt"))["variables"]["params"])]
    train_ev, valid_ev = events(run, "train"), events(run, "valid")
    _check(sorted(train_ev) == sorted(valid_ev) == [1, 2],
           f"event steps {sorted(train_ev)}, {sorted(valid_ev)}")
    loss_tags = {f"loss/{n}" for n in hps.train.losses.keys()}
    for epoch in (1, 2):
        tv = train_ev[epoch]
        hists = sorted(t for t, k, _ in tv if k == "histo")
        _check(hists == sorted([f"param/{p}" for p in leaves]
                               + [f"grad/{p}" for p in leaves]),
               f"epoch {epoch}: {len(hists)} histograms for {len(leaves)} "
               "leaves")
        _check({t for t, k, _ in tv if k == "simple_value"}
               == loss_tags | {"lr"}, f"train scalars at epoch {epoch}")
        vv = valid_ev[epoch]
        _check(loss_tags <= {t for t, k, _ in vv if k == "simple_value"},
               f"valid scalars at epoch {epoch}")
        _, logged = showcase_tags(vv, epoch, 1)
    infer_err, pcm_err = card_vs_cpu(run, 2, logged)
    # the profiler's window: CUDA kernels, #4 twice a step inside it
    (trace,) = [os.path.join(run, "profile", f) for f in os.listdir(
        os.path.join(run, "profile")) if f.endswith(".pt.trace.json")]
    kernels = trace_kernels(trace)
    _check(kernels, f"no CUDA kernel event in the profiler's trace {trace}")
    window = [ms for open_, ms in step_ms if open_]
    outside = [ms for open_, ms in step_ms if not open_]
    rms_events = [e for e in kernels if "segmental_rms" in e.get("name", "")]
    _check(len(window) == SUM_PROFILE["steps"] - 1
           and len(rms_events) == 2 * len(window),
           f"profiler window: {len(window)} steps, {len(rms_events)} "
           "segmental_rms kernels in the trace")
    busy_ms = sum(e.get("dur", 0.0) for e in kernels) / 1e3
    # the native decoder against the Python walker on the run's speech
    speech_dir = inputs["speech"][0]["shard_dir"]
    tars = sorted(os.path.join(speech_dir, f) for f in os.listdir(speech_dir)
                  if f.startswith("recording.") and f.endswith(".tar"))
    mb = sum(os.path.getsize(t) for t in tars) / 1e6

    def walk(native_path):
        """All members of the speech tars and the walk's MB/s, natively
        or by the Python walker (FE_NATIVE=0)."""
        if not native_path:
            os.environ["FE_NATIVE"] = "0"
        try:
            t0 = time.perf_counter()
            got = [m for t in tars for m in ShardSource._iter_tar_audio(t)]
            return got, mb / (time.perf_counter() - t0)
        finally:
            os.environ.pop("FE_NATIVE", None)

    # in turns, native, Python, Python, native, on a warm page cache
    (nat, nat_a), (py, py_a), (_, py_b), (_, nat_b) = (
        walk(True), walk(False), walk(False), walk(True))
    nat_mbs, py_mbs = f"{nat_a:.1f}, {nat_b:.1f}", f"{py_a:.1f}, {py_b:.1f}"
    _check(len(nat) == len(py) and all(
        a[0] == b[0] and np.array_equal(a[1], b[1]) for a, b in zip(nat, py)),
        "native shard members != the Python walker's")
    for r in history:
        tm = r["timing"]
        print(f"[25/30] summaries CLI epoch {r['epoch']} (FE-T, shard "
              f"recipe, {SUM_STEPS} steps, bf16): wall {r['seconds']:.2f} "
              f"s; summarize {tm['summarize']:.3f} s ("
              f"{100 * tm['summarize'] / r['seconds']:.1f}% of the epoch; "
              f"{2 * len(leaves)} histograms, {len(loss_tags) + 1} train "
              f"and {len(loss_tags) + 1} valid scalars, the showcase's "
              f"audio and images); "
              f"infer_epoch {tm['infer']:.3f} s ("
              f"{100 * tm['infer'] / r['seconds']:.1f}%; {SUM_FILES} "
              f"files); infer/sisdr {r['infer']['infer/sisdr']:.3f} dB; "
              f"on {card}")
    print(f"[25/30] summaries CLI: step ms "
          f"{', '.join(f'{ms:.1f}' for _, ms in step_ms)}; inside the "
          f"profiler window ({SUM_PROFILE}: {len(window)} step) "
          f"{', '.join(f'{ms:.1f}' for ms in window)}, outside median "
          f"{statistics.median(outside):.1f}; the trace holds "
          f"{len(kernels)} CUDA kernel events, {busy_ms:.2f} ms of kernel "
          f"time ({100 * busy_ms / sum(window):.1f}% of the window's step "
          f"wall), segmental_rms {len(rms_events)} times; launches "
          f"segmental_rms {counts['segmental_rms_fused']}, gru_scan "
          f"{counts['gru_scan']} ({counts[GRU_TC]} tc in the bf16 valid "
          f"step, {blocks} scalar a file in each infer_epoch), no other "
          f"kernel; event files' CRCs and tags checked: a param/ and a "
          f"grad/ histogram for each of {len(leaves)} leaves an epoch; "
          f"showcase card vs CPU on "
          f"00002.ckpt max abs err {infer_err:.3e} of the peak (tol "
          f"{INFER_REL:g}), the logged PCM16 within {pcm_err:g} step of the "
          f"card's; on {card}")
    print(f"[25/30] native decoder: {walks} tars walked natively in the "
          f"run; {len(nat)} members of {len(tars)} speech tars ({mb:.1f} "
          f"MB) equal to the Python walker's bit for bit; decode MB/s in "
          f"turns (native, Python, Python, native; warm page cache): native "
          f"{nat_mbs}, Python {py_mbs}; corpus written in {corpus_s:.2f} s")

    # -- 25b. one more epoch of phase 23's 48 kHz FE-B run: mel at 48 kHz -------
    config = "fastenhancer_48khz/b.yaml"
    base, name = os.path.split(runs[config])
    hps48 = get_hparams(None, runs[config])
    eval_clean, eval_noisy = (hps48.data.valid.clean_dir,
                              hps48.data.valid.noisy_dir)
    infer_counts.clear()
    step_ms.clear()
    history48, counts48, out48 = run_cli(
        ["-n", name, "--base_dir", base, "-p", "train.max_epochs=2",
         "infer.interval=1", f"data.infer.clean_dir={eval_clean!r}",
         f"data.infer.noisy_dir={eval_noisy!r}", f"data.infer.files={files!r}",
         "-f"])
    (r48,) = history48
    _check(r48["epoch"] == 2 and "loaded checkpoint" in out48,
           f"48 kHz resume: {r48['epoch']}")
    model = get_model(hps48.model, **hps48.model_kwargs.to_dict())
    per = scans_per_forward(model)
    valid_n48 = -(-OTF_EVAL // hps48.valid.batch_size)
    pesq_n48 = -(-OTF_EVAL // hps48.pesq.batch_size)
    want = {k: 0 for k in ctx["counters"]}
    want.update({"gru_scan": per * (valid_n48 + pesq_n48 + SUM_FILES),
                 GRU_TC: per * valid_n48})
    _check(counts48 == want, f"48 kHz epoch: launches {counts48} != {want}")
    per_infer = {k: 0 for k in ctx["counters"]}
    per_infer["gru_scan"] = per * SUM_FILES
    _check([c for c, _ in infer_counts] == [per_infer],
           f"48 kHz infer_epoch launches {infer_counts}")
    sisdr48, logged48 = showcase_tags(events(runs[config], "valid")[2], 2, 1)
    infer_err48, pcm_err48 = card_vs_cpu(runs[config], 2, logged48)
    tm = r48["timing"]
    print(f"[25/30] 48 kHz FE-B (phase 23's run) epoch 2 with the showcase: "
          f"wall {r48['seconds']:.2f} s; summarize {tm['summarize']:.3f} s "
          f"({100 * tm['summarize'] / r48['seconds']:.1f}%), infer_epoch "
          f"{tm['infer']:.3f} s ({100 * tm['infer'] / r48['seconds']:.1f}%;"
          f" {SUM_FILES} files of "
          f"{OTF_EVAL_SECONDS[0]:g}-{OTF_EVAL_SECONDS[1]:g} s, 80-band mel at"
          f" 48 kHz); gru_scan {counts48['gru_scan']} launches ({per} a "
          f"file in infer_epoch, float32 scalar form); infer/sisdr "
          f"{sisdr48:.3f} dB; showcase card vs CPU max abs err "
          f"{infer_err48:.3e} of the peak, the logged PCM16 within "
          f"{pcm_err48:g} step; on {card}")
    print(f"[25/30] phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"gru_scan": counts["gru_scan"] + counts48["gru_scan"],
            "segmental_rms_fused": counts["segmental_rms_fused"]}



# phase 26: several devices. (a) the engine's slots split over the one card
# listed twice, against the engine on it at the same capacity: the stack
# kernel (#1) and the whole-frame kernel (#7), every output held to
# BF16_REL of the peak (phase 4's bound for the engine against an isolated
# run) and reported bitwise or not; (b) the training CLI with the multi-host
# flags at world size 1 over NCCL against the same run without them; (c) two
# gloo ranks on the card at DP_BATCH // 2 against one process at DP_BATCH
SHARD_DEVICES = 2
SHARD_REQUESTS = 320                 # the first 256 fill every slot
SHARD_SECONDS = (0.5, 2.0)
DP_CONFIG = "fastenhancer/b.yaml"
DP_BATCH, DP_EPOCHS = 64, 2          # the recipe's batch; 2 steps an epoch
DP_TRAIN_PAIRS, DP_EVAL_PAIRS = 128, 8
DP_SECONDS = (2.0, 2.5)
DP_WORLD = 2
# the final checkpoint of two ranks against one process: every param and
# BN statistic within DP_ATOL + DP_RTOL x its value (tests/test_multihost.py
# holds JAX's two processes so) plus DP_SPREAD_K x the leaf's largest
# difference between the two one-process runs of (b) (the card's run-to-run
# spread), a param also within twice the sum of the steps' learning rates
# (an element whose gradient is float noise may step either way: AdamP
# moves it by up to the learning rate); the epochs' losses within
# DP_LOSS_RTOL. The recipe's 500-step warmup keeps the learning rate small
DP_RTOL, DP_ATOL, DP_SPREAD_K, DP_LOSS_RTOL = 5e-4, 1e-6, 4.0, 1e-3
DP_TIMEOUT = 600


class WholeFrame:
    """A model's fused serving hooks on its whole-frame kernel (#7): the
    engine builds `build_frame_plan` where it builds the stack's plan and
    steps `streaming_step_fused_frame`; the carry is the same."""

    def __init__(self, model):
        self.model = model

    def __getattr__(self, name):
        return getattr(self.model, name)

    def build_stack_plan(self, variables, dtype=None):
        return self.model.build_frame_plan(variables, dtype=dtype)

    def streaming_step_fused(self, variables, plan, carry, hops):
        return self.model.streaming_step_fused_frame(variables, plan, carry,
                                                     hops)


def phase_26_rank(rank, world, coordinator, device, argv, out_path):
    """One rank of phase 26 (c), in a process of its own: joins the gloo
    group, trains through the CLI's `main` (stdout to out_path + ".log")
    and writes out_path (JSON): the history, each step's wall and its
    all-reduce wall (host clock, the card synchronised around each), the
    kernels' launches, and whether gloo reduced CUDA tensors itself."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fastenhancer_tpu_torch import parallel
    from fastenhancer_tpu_torch.ops import gru_scan as scan
    from fastenhancer_tpu_torch.train.__main__ import main as train_main
    from fastenhancer_tpu_torch.wrappers import ns as ns_wrapper

    # this process sets no float flag: the CLI's main turns TF32 off
    tf32_at_start = tf32_flags()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    parallel.init(coordinator, world, rank, backend="gloo", device=device)
    real_all_reduce = dist.all_reduce
    staged = False
    try:
        real_all_reduce(torch.ones(1, device=device))
    except RuntimeError:
        # gloo does not take this device's tensors: the phase (not the
        # port) stages them through the host
        staged = True
    reduce_s = [0.0]

    def all_reduce(t, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        if staged and t.is_cuda:
            host = t.cpu()
            out = real_all_reduce(host, *args, **kwargs)
            t.copy_(host)
        else:
            out = real_all_reduce(t, *args, **kwargs)
        sync()
        reduce_s[0] += time.perf_counter() - t0
        return out

    dist.all_reduce = all_reduce
    steps = []
    step_and_account = ns_wrapper.ModelWrapper._step_and_account

    def timed_step(self, dev_batch, rows):
        sync()
        t0, r0 = time.perf_counter(), reduce_s[0]
        out = step_and_account(self, dev_batch, rows)
        sync()
        steps.append((1e3 * (time.perf_counter() - t0),
                      1e3 * (reduce_s[0] - r0)))
        return out

    ns_wrapper.ModelWrapper._step_and_account = timed_step
    scan.gru_scan.launches = scan.gru_scan.tc_launches = 0
    stdout = sys.stdout
    try:
        with open(out_path + ".log", "w") as f:
            sys.stdout = f
            history = train_main(argv)
    finally:
        sys.stdout = stdout
        parallel.destroy()
    with open(out_path, "w") as f:
        json.dump({"history": [{k: r[k] for k in ("epoch", "train", "valid")}
                               for r in history],
                   "steps": steps, "staged": staged,
                   "tf32": [tf32_at_start, tf32_flags()],
                   "gru_scan": scan.gru_scan.launches,
                   "gru_scan_tc": scan.gru_scan.tc_launches}, f)


def phase_26(ctx):
    """Phase 26 (see the module docstring); -> {kernel: launches by
    path}."""
    import numpy as np
    import torch

    from fastenhancer_tpu_torch import parallel
    from fastenhancer_tpu_torch.data.audio_io import write_wav
    from fastenhancer_tpu_torch.models import get_model
    from fastenhancer_tpu_torch.models.fastenhancer import (default as
                                                            fe_default)
    from fastenhancer_tpu_torch.ops import fused_frame as frame
    from fastenhancer_tpu_torch.ops import rnnformer_stack as stack
    from fastenhancer_tpu_torch.presets import FE_B
    from fastenhancer_tpu_torch.serving import StreamingEngine
    from fastenhancer_tpu_torch.train import load_checkpoint
    from fastenhancer_tpu_torch.utils import cast_floating, tree_paths
    from fastenhancer_tpu_torch.utils.hparams import get_hparams
    from fastenhancer_tpu_torch.wrappers import ns as ns_wrapper

    card, dev = ctx["card"], ctx["dev"]
    zero_counts, read_counts = ctx["zero_counts"], ctx["read_counts"]
    repo = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    launches = {"rnnformer_stack_step": {}, "fused_frame_step": {},
                "gru_scan": {}}

    # -- (a) the engine's slots over [card, card] --------------------------------
    model = get_model("fastenhancer.default", **FE_B, stft_method="matmul")
    hop = model.hop_size
    folded = cast_floating(model.fold(model.init(
        torch.Generator().manual_seed(0), device=dev)), torch.bfloat16)
    rng = np.random.default_rng(26)
    wavs = [rng.uniform(-0.1, 0.1, int(rng.uniform(*SHARD_SECONDS) * SR)
                        ).astype(np.float32) for _ in range(SHARD_REQUESTS)]

    def serve(engine):
        """Every request through the engine, a request opening as soon as
        a slot is free, a stream closing once its delay is drained; ->
        ({request: output}, tick walls ms, ticks, slots that served two
        requests or more, counts)."""
        delay_ticks = -(-engine.delay_samples // hop)
        outs, handles, pos, slot_of = {}, {}, {}, {}
        waiting = list(range(len(wavs)))
        tick_ms, ticks = [], 0
        torch.cuda.synchronize()
        zero_counts()
        while waiting or handles:
            while waiting and len(handles) < engine.capacity:
                k = waiting.pop(0)
                handles[k] = engine.open_stream()
                slot_of[k] = engine._slot_of[handles[k]]
                pos[k], outs[k] = 0, []
            feed = {}
            for k, h in handles.items():
                seg = np.zeros(hop, np.float32)
                w = wavs[k][pos[k] * hop:(pos[k] + 1) * hop]
                seg[:len(w)] = w
                feed[h] = seg
            t0 = time.perf_counter()
            got = engine.tick(feed)
            tick_ms.append(1e3 * (time.perf_counter() - t0))
            ticks += 1
            for k in list(handles):
                outs[k].append(got[handles[k]])
                pos[k] += 1
                if pos[k] == -(-len(wavs[k]) // hop) + delay_ticks:
                    engine.close_stream(handles.pop(k))
        counts = read_counts()
        reused = len(slot_of) - len(set(slot_of.values()))
        shards = {s // (engine.capacity // len(engine.devices))
                  for k, s in slot_of.items() if k >= engine.capacity}
        out = {k: np.concatenate(v)[engine.delay_samples:
                                    engine.delay_samples + len(wavs[k])]
               for k, v in outs.items()}
        return out, tick_ms, ticks, (reused, shards), counts

    def spy(real, keep):
        """`real`, keeping the inputs and outputs of its first `keep`
        launches in `kept`."""
        def launch(plan, x, h, *args, **kwargs):
            out = real(plan, x, h, *args, **kwargs)
            if len(kept) < keep:
                kept.append((x.clone(), h.clone(), args, kwargs,
                             [o.clone() for o in out]))
            return out
        return launch

    kept = []
    for name, kernel, served, reference in (
            ("the block stack (#1)", "rnnformer_stack_step", model,
             lambda plan, x, h, heads: stack.rnnformer_stack_reference(
                 plan, x, h, heads)),
            ("the whole frame (#7)", "fused_frame_step", WholeFrame(model),
             lambda plan, x, h, num_blocks, **kw:
                 frame.fused_frame_reference(plan, x, h, **kw))):
        runs = {}
        for tag, where in (("sharded", {"devices": [dev] * SHARD_DEVICES}),
                           ("one device", {"device": dev})):
            engine = StreamingEngine(served, folded, capacity=STREAMS,
                                     dtype=torch.bfloat16, fused=True,
                                     **where)
            real = getattr(fe_default, kernel)
            kept.clear()
            setattr(fe_default, kernel, spy(real, 2 * len(engine.devices)))
            try:
                runs[tag] = serve(engine)
            finally:
                setattr(fe_default, kernel, real)
            # the first two ticks' launches, one a shard a tick, against
            # the plain version on the same inputs, at the shard's batch
            worst = 0.0
            plans = [shard.step.args[1] for shard in engine._shards]
            for i, (x, h, args, kwargs, outs) in enumerate(kept):
                plan = plans[i % len(plans)]
                errs = ctx["compare"](f"{kernel} in the {tag} engine",
                                      zip(outs, reference(plan, x, h, *args,
                                                          **kwargs)),
                                      torch.bfloat16)
                worst = max(worst, *(e for e, _ in errs))
            _check(len(kept) == 2 * len(engine.devices),
                   f"{tag} engine: {len(kept)} launches kept")
            print(f"[26/30] (a) {kernel} in the {tag} engine: its first "
                  f"{len(kept)} launches (batch {kept[0][0].shape}) against "
                  f"the plain version, max abs err {worst:.3e} (bound "
                  f"{BF16_REL:g} of each output's peak)")
            out, tick_ms, ticks, (reused, shards), counts = runs[tag]
            n = SHARD_DEVICES if tag == "sharded" else 1
            ctx["check_launches"](counts, kernel, n * ticks,
                                  f"{tag} engine, {name}")
            launches[kernel][f"{tag} engine (26a)"] = counts[kernel]
            _check(reused > 0 and shards == set(range(n)),
                   f"{tag} engine: the later requests reused slots "
                   f"{reused} on shards {shards}")
            _check(all(np.isfinite(y).all() and len(y) == len(wavs[k])
                       for k, y in out.items()), f"{tag} engine: outputs")
        (a, ms_a, ticks_a, _, _), (b, ms_b, ticks_b, _, _) = (
            runs["sharded"], runs["one device"])
        _check(ticks_a == ticks_b, f"ticks {ticks_a} != {ticks_b}")
        peak = max(float(np.abs(y).max()) for y in b.values())
        err = max(float(np.abs(a[k] - b[k]).max()) for k in b)
        bitwise = all(np.array_equal(a[k], b[k]) for k in b)
        _check(err <= BF16_REL * peak,
               f"sharded vs one device ({name}): {err} > {BF16_REL * peak}")
        print(f"[26/30] (a) FE_B bf16 fused engine, {name}, capacity "
              f"{STREAMS} over {SHARD_DEVICES} shards of "
              f"{STREAMS // SHARD_DEVICES} (the card listed twice) against "
              f"capacity {STREAMS} on one device: {SHARD_REQUESTS} requests "
              f"of {SHARD_SECONDS[0]:g}-{SHARD_SECONDS[1]:g} s in {ticks_a} "
              f"ticks, joins and leaves on both shards; {kernel} "
              f"{SHARD_DEVICES} launches a tick sharded, 1 on one device; "
              f"outputs {'bitwise equal' if bitwise else 'not bitwise equal'}"
              f", max abs err {err:.3e} (bound {BF16_REL:g} of the peak "
              f"{peak:.3e}); tick ms p50 / p99 sharded "
              f"{np.percentile(ms_a, 50):.3f} / {np.percentile(ms_a, 99):.3f}"
              f", one device {np.percentile(ms_b, 50):.3f} / "
              f"{np.percentile(ms_b, 99):.3f} (host clock, outputs read back "
              f"each tick); on {card}")
    del folded
    torch.cuda.empty_cache()

    # -- (b), (c): data-parallel training through the CLI ------------------------
    config = os.path.join(repo, "configs", DP_CONFIG)
    hps = get_hparams(config)
    optim_kw = dict(hps.train.optimizer_kwargs.to_dict(),
                    projection="disabled", eps=1e-4)
    blocks = hps.model_kwargs.rnnformer_kwargs.num_blocks
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    step_ms, step_lr = [], []
    step_and_account = ns_wrapper.ModelWrapper._step_and_account

    def timed_step(self, dev_batch, rows):
        step_lr.append(max(self._lrs()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_and_account(self, dev_batch, rows)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    backends = []
    init = parallel.init

    def recorded_init(*args, **kwargs):
        device = init(*args, **kwargs)
        backends.append(torch.distributed.get_backend())
        return device

    try:
        rng = np.random.default_rng(27)
        dirs = {}
        for part, n in (("train", DP_TRAIN_PAIRS), ("eval", DP_EVAL_PAIRS)):
            dirs[part] = [os.path.join(root, part, k)
                          for k in ("clean", "noisy")]
            for d in dirs[part]:
                os.makedirs(d)
            for i in range(n):
                t = int(rng.uniform(*DP_SECONDS) * SR)
                clean = ctx["speech_like"](rng, 1, t)[0]
                noisy = clean + rng.standard_normal(t) * 0.05
                for d, x in zip(dirs[part], (clean, noisy)):
                    write_wav(os.path.join(d, f"{i:04d}.wav"), x, SR)
        logs = os.path.join(root, "logs")

        def argv(name, batch):
            """The recipe at its width, float32, segment_size None (the
            length-sorted files: a random crop would draw from each
            process's own RNG), the de-chaos settings of
            tests/test_multihost.py, no PESQ and no showcase."""
            (tc, tn), (ec, en) = dirs["train"], dirs["eval"]
            return ["-n", name, "-c", config, "--base_dir", logs, "-p",
                    f"data.train.clean_dir={tc!r}",
                    f"data.train.noisy_dir={tn!r}",
                    f"data.valid.clean_dir={ec!r}",
                    f"data.valid.noisy_dir={en!r}",
                    f"data.pesq.clean_dir={ec!r}",
                    f"data.pesq.noisy_dir={en!r}",
                    "data.train.segment_size=None",
                    "data.valid.segment_size=None",
                    f"train.batch_size={batch}", f"valid.batch_size={batch}",
                    f"train.max_epochs={DP_EPOCHS}",
                    f"train.save_interval={DP_EPOCHS}", "train.fp16=False",
                    "train.seed=11", "train.num_workers=2",
                    f"train.optimizer_kwargs={optim_kw!r}",
                    "train.optimizer_groups=None",
                    "pesq.interval=99", "infer.interval=99"]

        valid_batches = -(-DP_EVAL_PAIRS // DP_BATCH)
        ns_wrapper.ModelWrapper._step_and_account = timed_step
        parallel.init = recorded_init
        results = {}
        try:
            for tag, extra in (
                    ("one process", []),
                    ("NCCL world 1", ["--coordinator",
                                      f"127.0.0.1:{free_port()}",
                                      "--num_processes", "1",
                                      "--process_id", "0"])):
                step_ms.clear()
                step_lr.clear()
                name = tag.split()[0].lower()
                history, counts, _ = ctx["run_cli"](
                    argv(name, DP_BATCH) + extra)
                want = {k: 0 for k in counts}
                want["gru_scan"] = blocks * valid_batches * DP_EPOCHS
                _check(counts == want, f"{tag}: launches {counts} != {want}")
                launches["gru_scan"][f"{tag} CLI valid (26b)"] = counts[
                    "gru_scan"]
                results[tag] = (history, list(step_ms), load_checkpoint(
                    os.path.join(logs, name, f"{DP_EPOCHS:05d}.ckpt")))
        finally:
            ns_wrapper.ModelWrapper._step_and_account = step_and_account
            parallel.init = init
        _check(backends == ["nccl"], f"the CLI's group: {backends}")
        _check(not torch.distributed.is_initialized(),
               "the CLI left its process group")

        def leaves(ckpt):
            v = ckpt["variables"]
            return {(part,) + p: np.asarray(a) for part in ("params", "stats")
                    for p, a in tree_paths(v[part])}

        one, nccl = (leaves(results[t][2]) for t in ("one process",
                                                     "NCCL world 1"))
        _check(one.keys() == nccl.keys(), "checkpoint paths")
        spread = {p: float(np.abs(nccl[p] - one[p]).max()) for p in one}
        _check(all(np.allclose(nccl[p], one[p], rtol=DP_RTOL, atol=DP_ATOL)
                   for p in one), f"NCCL world 1 vs one process: largest "
                                  f"difference {max(spread.values())}")
        for tag in results:
            history, ms, _ = results[tag]
            print(f"[26/30] (b) {tag}: the training CLI on {DP_CONFIG} "
                  f"(FE-B's width) float32, {DP_EPOCHS} epochs of "
                  f"{DP_TRAIN_PAIRS // DP_BATCH} steps at {DP_BATCH} x "
                  f"{DP_SECONDS[0]:g}-{DP_SECONDS[1]:g} s: step ms "
                  f"{', '.join(f'{x:.1f}' for x in ms)}; train losses by "
                  f"epoch {[round(r['train']['loss/mag_mse'], 6) for r in history]}"
                  f" (mag_mse); gru_scan {blocks * valid_batches * DP_EPOCHS}"
                  f" launches in the valid forwards; on {card}")
        bitwise = all(np.array_equal(nccl[p], one[p]) for p in one)
        print(f"[26/30] (b) the group's backend {backends[0]}; checkpoint "
              f"{DP_EPOCHS:05d}.ckpt with the flags against without: "
              f"{'bitwise equal' if bitwise else 'not bitwise equal'}, "
              f"largest difference {max(spread.values()):.3e} over "
              f"{len(one)} leaves")

        # (c) two ranks on the one card: NCCL refuses them (each rank's
        # init raises, nothing falls back to one rank), so they run over
        # gloo, at DP_BATCH // 2 each
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        refused = "not tried: no card"
        if dev.type == "cuda":
            nccl_paths = [os.path.join(root, f"nccl{r}.txt")
                          for r in range(DP_WORLD)]
            spawned(_phase_26_nccl_pair, DP_WORLD, str(dev), nccl_paths)
            said = []
            for path in nccl_paths:
                with open(path) as f:
                    said.append(f.read())
            _check(all(m.startswith("raised") for m in said),
                   f"two NCCL ranks on one card: {said}")
            refused = said[0]
        out_paths = [os.path.join(root, f"rank{r}.json")
                     for r in range(DP_WORLD)]
        rank_argv = argv("ranks", DP_BATCH // DP_WORLD)
        if dev.type != "cuda":
            rank_argv += ["--device", str(dev)]
        t0 = time.perf_counter()
        spawned(_phase_26_spawned, DP_WORLD, str(dev), rank_argv, out_paths)
        ranks_s = time.perf_counter() - t0
        rank_out = []
        for path in out_paths:
            with open(path) as f:
                rank_out.append(json.load(f))
        with open(out_paths[1] + ".log") as f:
            _check("Epoch" not in f.read(), "rank 1 printed an epoch")
        ranks = leaves(load_checkpoint(
            os.path.join(logs, "ranks", f"{DP_EPOCHS:05d}.ckpt")))
        _check(ranks.keys() == one.keys(), "checkpoint paths (c)")
        lr_sum = sum(step_lr)
        worst, flipped, n_el = 0.0, 0, 0
        for p in one:
            diff = np.abs(ranks[p] - one[p])
            tight = DP_ATOL + DP_RTOL * np.abs(one[p]) + DP_SPREAD_K * spread[p]
            excess = diff - tight - (2 * lr_sum if p[0] == "params" else 0.0)
            worst = max(worst, float(excess.max()))
            flipped += int((diff > tight).sum())
            n_el += diff.size
            _check(excess.max() <= 0, f"(c) {p}: two ranks vs one process "
                                      f"by {excess.max()} over the bound")
        largest = max(float(np.abs(ranks[p] - one[p]).max()) for p in one)
        for r_hist, o_hist in zip(rank_out[0]["history"],
                                  results["one process"][0]):
            for part in ("train", "valid"):
                for k, v in o_hist[part].items():
                    _check(abs(r_hist[part][k] - v) <= DP_LOSS_RTOL * abs(v),
                           f"(c) epoch {o_hist['epoch']} {part} {k}: "
                           f"{r_hist[part][k]} vs {v}")
        per_rank = -(-(-(-DP_EVAL_PAIRS // (DP_BATCH // DP_WORLD)))
                     // DP_WORLD)
        for r, out in enumerate(rank_out):
            _check(out["gru_scan"] == blocks * per_rank * DP_EPOCHS
                   and out["gru_scan_tc"] == 0,
                   f"rank {r}: gru_scan launches {out['gru_scan']}")
            launches["gru_scan"][f"rank {r} CLI valid (26c)"] = out[
                "gru_scan"]
            _check(out["tf32"][1] == [False, False],
                   f"rank {r}: TF32 flags {out['tf32'][1]} after the CLI")
            ms = [s for s, _ in out["steps"]]
            share = [a / s for s, a in out["steps"]]
            print(f"[26/30] (c) rank {r} of {DP_WORLD} (gloo, the one card,"
                  f" {'staged through the host by the phase' if out['staged'] else 'CUDA tensors reduced by gloo'}"
                  f"), batch {DP_BATCH // DP_WORLD}: step ms "
                  f"{', '.join(f'{x:.1f}' for x in ms)}; all-reduce share of"
                  f" the step {', '.join(f'{100 * x:.1f}%' for x in share)} "
                  f"(every all-reduce: the gradient bucket, each train-mode "
                  f"BN's sums forward and backward, the loss counts and "
                  f"values; host clock, the card synchronised around each); "
                  f"gru_scan {out['gru_scan']} launches; TF32 [matmul, "
                  f"cuDNN] {out['tf32'][0]} at the rank's start (the phase "
                  f"sets none), {out['tf32'][1]} after the CLI's main; on "
                  f"{card}")
        print(f"[26/30] (c) {DP_WORLD} ranks x batch {DP_BATCH // DP_WORLD}"
              f" against one process x {DP_BATCH}: {len(one)} params and BN "
              f"statistics of {DP_EPOCHS:05d}.ckpt, largest difference "
              f"{largest:.3e}, every one within {DP_ATOL:g} + {DP_RTOL:g} x "
              f"|value| + {DP_SPREAD_K:g} x (b)'s spread, a param also within"
              f" 2 x the steps' summed learning rate {lr_sum:.3e} (worst "
              f"margin {worst:.3e}; {flipped} of {n_el} elements beyond the "
              f"first three terms); losses of every epoch within "
              f"{DP_LOSS_RTOL:g};"
              f" rank 1 printed no epoch; the ranks' wall {ranks_s:.1f} s "
              f"(spawn and CUDA start included); two NCCL ranks on the one "
              f"card first: each init raised ({refused})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[26/30] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def _phase_26_spawned(rank, world, coordinator, device, argv, out_paths):
    phase_26_rank(rank, world, coordinator, device, argv, out_paths[rank])


def _phase_26_nccl_pair(rank, world, coordinator, device, out_paths):
    """Rank `rank` of two NCCL ranks on one card: writes "joined", or
    "raised" and the error's last line, to out_paths[rank]."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fastenhancer_tpu_torch import parallel

    try:
        parallel.init(coordinator, world, rank, device=device)
        said = "joined"
        parallel.destroy()
    except Exception as e:  # the outcome under test: recorded, not raised
        said = f"raised {type(e).__name__}: {str(e).strip().splitlines()[-1]}"
    with open(out_paths[rank], "w") as f:
        f.write(said)


# phase 27: the folded streaming step exported with torch.export and run
# with no model code. (what, phase 23's run or an untrained checkpoint's
# config, the export's flags, the kernel each frame launches, the slope's
# two run lengths: the CLI's are 128 and 640, cut here to keep the phase
# short, and BSRNN-XT's float32 frame takes ~70 ms on #3's scalar form)
EXPORT_UNTRAINED = ["ablation/dpt_b.yaml", "ablation/dprnn_b.yaml"]
EXPORT_CASES = [
    ("FE-B DNS wav2wav --fused", "fastenhancer_dns/b.yaml", ["--fused"],
     "rnnformer_stack_step", (16, 80)),
    ("FE-B DNS spec2spec --fused", "fastenhancer_dns/b.yaml",
     ["--spec2spec", "--fused"], "rnnformer_stack_step", (16, 80)),
    ("FE-B DNS wav2wav", "fastenhancer_dns/b.yaml", [], "gru_scan",
     (16, 80)),
    ("BSRNN-XT wav2wav --fused", "others_dns/bsrnn_xt.yaml", ["--fused"],
     "bsrnn_stack_step", (4, 12)),
    ("DPT-B wav2wav --fused", "ablation/dpt_b.yaml", ["--fused"],
     "dpt_stack_step", (16, 80)),
    ("DPRNN-B wav2wav --fused", "ablation/dprnn_b.yaml", ["--fused"],
     "dprnn_stack_step", (16, 80))]
EXPORT_FRAMES = 32         # the loaded artifact against the eager step
EXPORT_TICK_SECONDS = 0.25  # the export's per-tick line over 15 hops
EXPORT_WAV_SECONDS = 0.5    # the runner's input
EXPORT_REL = 1e-5          # float32, of the peak: artifact vs eager step
DISPATCH_CALLS = 1000      # the op route against the CUDA implementation
COPY_FRAMES = 64           # #2's artifact in place against functional
# each artifact's runner in a fresh process, and BSRNN-XT's again in
# RUNNER_REPEATS more: the runner's tick p50 (ticks 2 on) must stay within
# RUNNER_SLOW x the loaded program's graph on flat inputs (`loop_ms`) over
# RUNNER_LOOP_FRAMES frames in a loop in that process, each frame fetched
# (until the runner took the graph's flat inputs, BSRNN-XT's ticked at
# 5-15x its loop); the first slow repeat takes one profiler window of
# RUNNER_PROFILE_FRAMES
RUNNER_REPEATS, RUNNER_LOOP_FRAMES, RUNNER_SLOW = 2, 16, 3.0
RUNNER_PROFILE_FRAMES = 8


def tf32_flags():
    """[matmul, cuDNN] TF32 flags of this process."""
    import torch

    return [torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32]


def off_card(program, **trees):
    """The tensors of a loaded program that are not on a CUDA device: its
    parameters, buffers and constants, the values its graph's nodes were
    traced with (program None: none), and the leaves of `trees` (what it
    was fed, what it returned) -> a description of each."""
    import torch
    from torch.utils import _pytree as pytree

    off = []
    if program is not None:
        for kind, items in (("state", program.state_dict.items()),
                            ("constant", program.constants.items())):
            off += [f"{kind} {name} on {t.device}" for name, t in items
                    if torch.is_tensor(t) and t.device.type != "cuda"]
        for node in program.graph.nodes:
            devs = {str(t.device) for t in pytree.tree_leaves(
                node.meta.get("val")) if torch.is_tensor(t)
                and t.device.type != "cuda"}
            off += [f"node {node.name} ({node.target}) on {d}"
                    for d in sorted(devs)]
    for name, tree in trees.items():
        off += [f"{name} leaf {i} on {t.device}" for i, t in enumerate(
            pytree.tree_leaves(tree)) if torch.is_tensor(t)
            and t.device.type != "cuda"]
    return off


def _leaves(tree):
    from torch.utils import _pytree as pytree

    return [t.detach().float().cpu().numpy() for t in pytree.tree_leaves(tree)
            if hasattr(t, "detach")]


def phase_27(ctx, runs, root):
    """Phase 27 (see the module docstring) on phase 23's runs, its files in
    `root`; -> {kernel: {path: launches}}."""
    import numpy as np
    import torch

    from fastenhancer_tpu_torch.data.audio_io import write_wav
    from fastenhancer_tpu_torch.ops import gru_scan as scan
    from fastenhancer_tpu_torch.scripts import export, run_exported
    from fastenhancer_tpu_torch.utils.hparams import get_hparams
    from fastenhancer_tpu_torch.wrappers import get_wrapper

    card, dev = ctx["card"], ctx["dev"]
    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "export")
    run_dirs = dict(runs)
    for config in EXPORT_UNTRAINED:
        run = os.path.join(out_dir, "logs",
                           os.path.basename(config).replace(".yaml", ""))
        os.makedirs(run)
        shutil.copy(os.path.join(repo, "configs", config),
                    os.path.join(run, "config.yaml"))
        hps = get_hparams(None, base_dir=run)
        get_wrapper(hps.wrapper)(hps, train=False, device=dev).save(1)
        run_dirs[config] = run

    def after(text, key):
        """The number that follows `key` in text."""
        return float(text.split(key, 1)[1].split()[0].rstrip(")"))

    paths = {}
    specs, rows = [], []
    wavs = {}
    slope = export.SLOPE_FRAMES
    try:
        for i, case in enumerate(EXPORT_CASES):
            tag, config, flags, kernel, lengths = case
            base, name = os.path.split(run_dirs[config])
            art = os.path.join(out_dir, f"step{i}.pt2")
            export.SLOPE_FRAMES = lengths
            got, counts, out = ctx["run_cli"](
                ["-n", name, "--base_dir", base, "--streams", str(STREAMS),
                 "--save", art, "--seconds", str(EXPORT_TICK_SECONDS),
                 *flags], export.main)
            model, sr = got["model"], got["hps"].data.sampling_rate
            hop = model.hop_size
            per_frame = model.num_blocks if kernel == "gru_scan" else 1
            ticks = min(int(EXPORT_TICK_SECONDS * sr) // hop, 200)
            frames = 2 + ticks + 3 * sum(lengths)
            ctx["check_launches"](counts, kernel, per_frame * frames,
                                  f"export {tag}", tc=0)
            paths.setdefault(kernel, {})[f"export {tag} (27)"] = (
                per_frame * frames)
            row = dict(
                tag=tag, kernel=kernel, per_frame=per_frame, slope=lengths,
                export_s=after(out.split("streaming step:")[1], ", in "),
                bytes=int(after(out, f"{art} (")),
                nodes=out.split("kernel nodes: ")[1].split("\n")[0],
                tick_p50=after(out, "(sync each): p50"),
                tick_p99=after(out.split("(sync each): ")[1], "p99"),
                slope_us=after(out.split("per-tick slope")[1], "run): "))
            # the eager step the program was exported from, on the same
            # variables, carry and hops
            step, variables = got["step"], got["variables"]
            rng = np.random.default_rng(270 + i)
            feeds = (rng.standard_normal(
                (EXPORT_FRAMES,) + tuple(got["feed"].shape)) * 0.1
            ).astype(np.float32)
            with torch.no_grad():
                carry, ys = export.clone_tree(got["carry0"]), []
                for x in feeds:
                    carry, y = step(variables, carry,
                                    torch.from_numpy(x).to(dev))
                    ys.append(y)
                ys = torch.stack(ys).cpu().numpy()
            ref = os.path.join(out_dir, f"step{i}_ref.npz")
            np.savez(ref, feeds=feeds, ys=ys,
                     **{f"carry{j}": a for j, a in enumerate(_leaves(carry))})
            if sr not in wavs:
                wavs[sr] = os.path.join(out_dir, f"in_{sr}.wav")
                write_wav(wavs[sr], ctx["speech_like"](
                    np.random.default_rng(27), 1,
                    int(EXPORT_WAV_SECONDS * sr))[0], sr)
            n = int(EXPORT_WAV_SECONDS * sr)
            n_fft = model.stft_cfg.n_fft
            hops = ((n - n_fft) // hop + 1 if "--spec2spec" in flags
                    else n // hop)
            row["runner_launches"] = per_frame * (hops + min(hops - 1, 256))
            specs.append(dict(tag=tag, artifact=art,
                              params=art + ".params.pkl", ref=ref,
                              wav=wavs[sr], out=art + ".wav"))
            rows.append(row)
            del got, step, variables, carry
    finally:
        export.SLOPE_FRAMES = slope

    # every artifact in one fresh process through the runner: no model code
    spec_path = os.path.join(out_dir, "specs.json")
    with open(spec_path, "w") as f:
        json.dump(specs, f)
    res_path = os.path.join(out_dir, "results.json")
    t0 = time.perf_counter()
    spawned(_phase_27_child, 1, spec_path, res_path)
    child_s = time.perf_counter() - t0
    with open(res_path) as f:
        res = json.load(f)
    _check(not res["loaded"], f"the runner's process loaded {res['loaded']}")
    for row, got in zip(rows, res["results"]):
        tag, kernel, per_frame = row["tag"], row["kernel"], row["per_frame"]
        sys.stdout.write(got["lines"])
        for key in ("streamed ", "steady-state RTF", "per-tick latency ms",
                    "amortized (pipelined dispatch)"):
            _check(key in got["lines"], f"runner {tag}: no {key!r} line")
        ctx["check_launches"](got["counts"], kernel,
                              per_frame * EXPORT_FRAMES,
                              f"artifact {tag}, {EXPORT_FRAMES} frames",
                              tc=0)
        ctx["check_launches"](got["runner_counts"], kernel,
                              row["runner_launches"], f"runner {tag}", tc=0)
        for what, err, peak in got["errs"]:
            _check(err <= EXPORT_REL * peak, f"artifact {tag} {what} vs "
                   f"the eager step: {err:.3e} of a peak {peak:.3e}")
        worst = max(err / max(peak, 1e-30) for _, err, peak in got["errs"])
        paths.setdefault(kernel, {})[f"artifact {tag} (27)"] = (
            per_frame * EXPORT_FRAMES + row["runner_launches"])
        tick = got["lines"].split("per-tick latency ms:")[1]
        _check(got["tf32_after_main"] == [False, False],
               f"runner {tag}: TF32 flags {got['tf32_after_main']} after "
               "its main")
        print(f"[27/30] {tag} at {STREAMS} streams, float32: export "
              f"{row['export_s']:.2f} s, artifact {row['bytes']} bytes, "
              f"kernel nodes {row['nodes']}; export's per-tick p50 "
              f"{row['tick_p50']:.2f} ms, p99 {row['tick_p99']:.2f} ms, "
              f"slope {row['slope_us']:.1f} us/frame ({row['slope'][0]} vs "
              f"{row['slope'][1]} frames); runner tick p50 "
              f"{after(tick, 'p50')} ms, p99 {after(tick, 'p99')} ms, the "
              f"program's graph on flat inputs in a loop in its process "
              f"{got['loop_ms']:.3f} ms a frame (p50 / loop {got['p50'] / got['loop_ms']:.2f}, bound "
              f"{RUNNER_SLOW:g}); {EXPORT_FRAMES} "
              f"frames against the eager step: worst {worst:.2e} of the "
              f"peak (tol {EXPORT_REL:g}), output and {len(got['errs']) - 1}"
              f" carry leaves; {kernel} {per_frame} a frame and no other "
              f"kernel; on {card}")
        _check(got["p50"] <= RUNNER_SLOW * got["loop_ms"],
               f"runner {tag}: tick p50 {got['p50']:.3f} ms > {RUNNER_SLOW:g}"
               f" x its program's graph in a loop {got['loop_ms']:.3f} ms")
    off = {row["tag"]: got["off_card"]
           for row, got in zip(rows, res["results"]) if got["off_card"]}
    print(f"[27/30] the runner's process set no float flag (TF32 [matmul, "
          f"cuDNN] {res['results'][0]['tf32_at_start']} at its start, "
          f"[False, False] after each main); every loaded program's "
          f"parameters, constants, traced node values, variables, carry, "
          f"feed and returned carry on the card: "
          f"{'yes' if not off else off}")

    # BSRNN-XT's artifact again in RUNNER_REPEATS fresh runner processes
    i = [c[0] for c in EXPORT_CASES].index("BSRNN-XT wav2wav --fused")
    xt_spec = os.path.join(out_dir, "xt_spec.json")
    with open(xt_spec, "w") as f:
        json.dump(specs[i], f)
    repeats, profiled = [], None
    for k in range(RUNNER_REPEATS):
        out_k = os.path.join(out_dir, f"xt_runner{k}.json")
        spawned(_phase_27_runner, 1, xt_spec, out_k, profiled is None)
        with open(out_k) as f:
            repeats.append(json.load(f))
        if repeats[-1]["window"] is not None and profiled is None:
            profiled = k
        if repeats[-1]["off_card"]:
            off[f"BSRNN-XT runner process {k}"] = repeats[-1]["off_card"]
    p50 = [round(r["p50"], 3) for r in repeats]
    amort = [after(r["lines"], "(pipelined dispatch): ") for r in repeats]
    loops = [round(r["loop_ms"], 3) for r in repeats]
    print(f"[27/30] BSRNN-XT wav2wav --fused artifact in {RUNNER_REPEATS} "
          f"more fresh runner processes, float32, {STREAMS} streams, "
          f"{EXPORT_WAV_SECONDS:g} s of input: tick p50 ms {p50}, pipelined "
          f"ms a frame {amort}; the loaded program's graph on flat inputs "
          f"in a loop in the same process ({RUNNER_LOOP_FRAMES} frames, each fetched) ms a frame "
          f"{loops}; p50 / loop "
          f"{[round(a / b, 2) for a, b in zip(p50, loops)]} (bound "
          f"{RUNNER_SLOW:g}); on {card}")
    if profiled is not None:
        w = repeats[profiled]["window"]
        print(f"[27/30] BSRNN-XT runner process {profiled} (slow), one "
              f"profiler window of {RUNNER_PROFILE_FRAMES} ticks as the "
              f"runner's: host ms a frame {w['ms']:.3f} (inflated: the "
              f"profiler's CPU-activity tracing adds host time to each op); "
              f"costliest kernels, us a frame {w['top']['kernel']}; "
              f"costliest host ops (inclusive) {w['top']['cpu_op']}")
    for k, r in enumerate(repeats):
        _check(not r["slow"], f"BSRNN-XT runner process {k}: tick p50 "
               f"{r['p50']:.3f} ms > {RUNNER_SLOW:g} x its program's graph "
               f"in a loop {r['loop_ms']:.3f} ms")
    _check(not off, f"tensors off the card: {off}")

    # #2's artifact in place (the op writes kc/vc) against its functional
    # form (run_decompositions: the caches cloned and copied back a frame)
    i = [c[0] for c in EXPORT_CASES].index("DPT-B wav2wav --fused")
    program, variables, carry0, _ = run_exported.load(
        specs[i]["artifact"], specs[i]["params"], dev)
    forms = {"in place": program.module(),
             "functional": program.run_decompositions().module()}
    ref = np.load(specs[i]["ref"])
    xs = [torch.from_numpy(x).to(dev) for x in ref["feeds"]]
    xs = (xs * (COPY_FRAMES // len(xs) + 1))[:COPY_FRAMES]
    walls, outs = {k: [] for k in forms}, {}
    with torch.no_grad():
        for name in ["in place", "functional", "functional", "in place"]:
            carry = {k: v.clone() for k, v in carry0.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x in xs:
                carry, y = forms[name](variables, carry, x)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / len(xs) * 1e3)
            outs[name] = y.float().cpu()
    err = float((outs["functional"] - outs["in place"]).abs().max())
    peak = float(outs["in place"].abs().max())
    _check(err <= EXPORT_REL * peak, f"DPT-B's functional artifact: "
           f"{err:.3e} of a peak {peak:.3e} from the in-place one")
    cache_bytes = 2 * carry0["kc"].numel() * carry0["kc"].element_size()
    best = {k: min(v) for k, v in walls.items()}
    walls = {k: [round(w, 3) for w in v] for k, v in walls.items()}
    print(f"[27/30] #2's K/V caches ({cache_bytes} bytes, kc + vc) over "
          f"{COPY_FRAMES} frames at {STREAMS} streams, ms a frame (best of "
          f"two; runs in place, functional, functional, in place: "
          f"{walls}): the artifact (the op writes them in place) "
          f"{best['in place']:.3f}, its functional form (run_decompositions:"
          f" cloned and copied back each frame) {best['functional']:.3f}; "
          f"the copies {best['functional'] - best['in place']:.3f} (their "
          f"bytes, read and written twice, at 3.35 TB/s: "
          f"{4 * cache_bytes / PEAK_BYTES_S * 1e3:.4f}); outputs {err:.2e} "
          f"of the peak apart; on {card}")

    # the op route's cost per call on this host: the CUDA implementation
    # called directly, through torch.ops, and through the wrapper
    rng = np.random.default_rng(28)
    n, h = 16, 36
    args = [torch.from_numpy((rng.standard_normal(s) * 0.3).astype(
        np.float32)).to(dev) for s in ((1, n, 3 * h), (n, h), (3 * h, h),
                                       (3 * h,))]
    routes = {"direct": lambda: scan.cuda_impl(*args),
              "torch.ops": lambda: torch.ops.fastenhancer.gru_scan(*args),
              "wrapper": lambda: scan.gru_scan(*args)}
    per_call = {k: [] for k in routes}
    with torch.no_grad():
        for name in ["direct", "torch.ops", "wrapper", "wrapper",
                     "torch.ops", "direct"]:
            for _ in range(10):
                routes[name]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                routes[name]()
            torch.cuda.synchronize()
            per_call[name].append((time.perf_counter() - t0)
                                  / DISPATCH_CALLS * 1e6)
    best = {k: min(v) for k, v in per_call.items()}
    per_call = {k: [round(w, 2) for w in v] for k, v in per_call.items()}
    print(f"[27/30] gru_scan at [1, {n}, {3 * h}] float32, host us a call "
          f"over {DISPATCH_CALLS} calls (best of two; runs direct, "
          f"torch.ops, wrapper, wrapper, torch.ops, direct: {per_call}): "
          f"the CUDA implementation called directly {best['direct']:.2f}, "
          f"through torch.ops.fastenhancer.gru_scan {best['torch.ops']:.2f} "
          f"(+{best['torch.ops'] - best['direct']:.2f}), through the "
          f"wrapper gru_scan {best['wrapper']:.2f} "
          f"(+{best['wrapper'] - best['direct']:.2f}); on {card}")
    print(f"[27/30] phase wall {time.perf_counter() - t_phase:.1f} s (the "
          f"runner's process {child_s:.1f} s)")
    return paths


def loop_ms(step, variables, carry, feeds, dev):
    """The program's graph on flat inputs (`run_exported.flat_call`, the
    runner's steady tick without its upload) over RUNNER_LOOP_FRAMES of
    `feeds` uploaded first, each output fetched -> ms a frame: the
    yardstick of RUNNER_SLOW. The program's own forward is no yardstick:
    its per-call flatten of every input has cost BSRNN-XT 5-15x the
    graph's host time."""
    import torch

    from fastenhancer_tpu_torch.scripts import run_exported

    run = run_exported.flat_call(step, variables)
    xs = [torch.from_numpy(x).to(dev) for x in feeds[:RUNNER_LOOP_FRAMES]]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in xs:
            carry, y = run(carry, x)
            y.cpu()
    return (time.perf_counter() - t0) / len(xs) * 1e3


def _phase_27_child(rank, world, coordinator, spec_path, out_path):
    """Phase 27's fresh process: each artifact through the runner's main
    (its lines, launches and tick p50 kept), then loaded again and run
    over the eager step's hops from its zero carry (launches and errors
    kept), then its graph on flat inputs in a loop (`loop_ms`); which
    model, wrapper or trainer modules it loaded, written with the results
    to out_path."""
    del rank, world, coordinator
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch

    from fastenhancer_tpu_torch import require_cuda
    from fastenhancer_tpu_torch.scripts import run_exported

    dev = require_cuda()
    # this process sets no float flag: the runner's main turns TF32 off
    tf32_at_start = tf32_flags()
    counters = kernel_counters()

    def zero():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    with open(spec_path) as f:
        specs = json.load(f)
    results = []
    for s in specs:
        buf = io.StringIO()
        torch.cuda.synchronize()
        zero()
        stdout, sys.stdout = sys.stdout, buf
        try:
            ticks = run_exported.main([s["artifact"], "--params",
                                       s["params"], "-i", s["wav"], "-o",
                                       s["out"]])["ticks"]
        finally:
            sys.stdout = stdout
        torch.cuda.synchronize()
        runner_counts = read()
        tf32_after_main = tf32_flags()
        program, variables, carry, _ = run_exported.load(
            s["artifact"], s["params"], dev)
        step = program.module()
        ref = np.load(s["ref"])
        off = off_card(program, variables=variables, carry=carry)
        zero()
        with torch.no_grad():
            ys = []
            for i, x in enumerate(ref["feeds"]):
                feed = torch.from_numpy(x).to(dev)
                carry, y = step(variables, carry, feed)
                if i == 0:
                    off += off_card(None, feed=feed, returned=(carry, y))
                ys.append(y)
            ys = torch.stack(ys).cpu().numpy()
        counts = read()
        errs = [("output", float(np.abs(ys - ref["ys"]).max()),
                 float(np.abs(ref["ys"]).max()))]
        for j, got in enumerate(_leaves(carry)):
            want = ref[f"carry{j}"]
            errs.append((f"carry leaf {j}", float(np.abs(got - want).max()),
                         float(np.abs(want).max())))
        results.append(dict(lines=buf.getvalue(), counts=counts,
                            runner_counts=runner_counts, errs=errs,
                            off_card=off, tf32_at_start=tf32_at_start,
                            tf32_after_main=tf32_after_main,
                            p50=1e3 * float(np.median(ticks[1:])),
                            loop_ms=loop_ms(step, variables, carry,
                                            ref["feeds"], dev)))
    loaded = sorted(m for m in sys.modules if m.startswith(tuple(
        f"fastenhancer_tpu_torch.{p}" for p in ("models", "wrappers",
                                                "train"))))
    with open(out_path, "w") as f:
        json.dump({"results": results, "loaded": loaded}, f)


def _phase_27_runner(rank, world, coordinator, spec_path, out_path,
                     profile):
    """One of phase 27's repeated runner processes: the artifact through
    the runner's main (its lines kept, its tick p50), then the loaded
    program's graph on flat inputs (`loop_ms`); the process is slow at
    more than RUNNER_SLOW x that, and a slow one asked to `profile` runs
    RUNNER_PROFILE_FRAMES ticks through the runner's call (each uploaded
    from the host and fetched) inside one `utils/profiler.py` window;
    writes the
    lines, the tensors off the card, both times and the window's host ms
    a frame and five costliest kernels and host ops (us a frame) to
    out_path."""
    del rank, world, coordinator
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch

    from fastenhancer_tpu_torch import require_cuda
    from fastenhancer_tpu_torch.scripts import run_exported
    from fastenhancer_tpu_torch.utils.profiler import StepProfiler

    dev = require_cuda()
    with open(spec_path) as f:
        s = json.load(f)
    buf = io.StringIO()
    stdout, sys.stdout = sys.stdout, buf
    try:
        ticks = run_exported.main([s["artifact"], "--params", s["params"],
                                   "-i", s["wav"], "-o", s["out"]])["ticks"]
    finally:
        sys.stdout = stdout
    lines = buf.getvalue()
    p50 = 1e3 * float(np.median(ticks[1:]))
    program, variables, carry, _ = run_exported.load(
        s["artifact"], s["params"], dev)
    step = program.module()
    feeds = np.load(s["ref"])["feeds"]
    first = torch.from_numpy(feeds[0]).to(dev)
    off = off_card(program, variables=variables, carry=carry, feed=first)
    with torch.no_grad():
        carry, y = step(variables, carry, first)
        y.cpu()
    off += off_card(None, returned=(carry, y))
    loop = loop_ms(step, variables, carry, feeds[1:], dev)
    slow = p50 > RUNNER_SLOW * loop
    window = None
    if slow and profile:
        # call 1 opens the window and call RUNNER_PROFILE_FRAMES + 1
        # closes it: it holds ticks 2 .. RUNNER_PROFILE_FRAMES + 1 (from 0)
        prof = StepProfiler(os.path.join(os.path.dirname(out_path),
                                         f"profile_{os.getpid()}"), start=1,
                            steps=RUNNER_PROFILE_FRAMES + 1, cuda=True)
        call = run_exported.make_call(step, variables, dev)
        with torch.no_grad():
            for i, x in enumerate(feeds[:RUNNER_PROFILE_FRAMES + 2]):
                if i == 2:
                    t0 = time.perf_counter()
                carry, y = call(carry, x)
                y.cpu().numpy()
                prof.step()
        window = {"ms": (time.perf_counter() - t0) / RUNNER_PROFILE_FRAMES
                  * 1e3, "top": {}}
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
        for cat in ("kernel", "cpu_op"):
            total = {}
            for e in events:
                if e.get("cat") == cat:
                    total[e["name"]] = total.get(e["name"], 0.0) + e["dur"]
            window["top"][cat] = sorted(
                ((round(us / RUNNER_PROFILE_FRAMES, 2), name)
                 for name, us in total.items()), reverse=True)[:5]
    with open(out_path, "w") as f:
        json.dump({"lines": lines, "off_card": off, "p50": p50,
                   "loop_ms": loop, "slow": slow, "window": window}, f)


# phase 28: a reference PyTorch checkpoint served. Each family's seeded
# init written in the reference repo's state-dict layout (DDP-wrapped, as
# {"model": {"module." + key: tensor}}), saved as a .pth, loaded with
# weights_only and converted on the card; then the converted weights
# against the init's through the family's path. (tag, model, kwargs, the
# config the preset copies, [(path, kernel, launches a call, chunk)]);
# chunk None is the whole-frame step, 0 the offline forward
CKPT_FRAMES = 32                 # the streams' frames, 256 streams
CKPT_NC_STREAMS, CKPT_NC_SECONDS = 4, 4.0
CKPT_REL = 1e-7                  # converted vs init output, of the peak
CKPT_KEEP_AT = CKPT_FRAMES // 2  # the stack launch held to the plain one


def ckpt_families():
    from fastenhancer_tpu_torch.presets import (BSRNN_S, DPRNN_B, DPT_B,
                                                FE_B, FSPEN, LISENNET, LN_B,
                                                NONCAUSAL_HUGE,
                                                TIME_KERNEL_B)

    return [
        ("FE_B", "fastenhancer.default", FE_B, "fastenhancer/b.yaml",
         [("per frame", "rnnformer_stack_step", 1, 1),
          ("whole frame", "fused_frame_step", 1, None)]),
        ("LN_B", "fastenhancer.ln", LN_B, "ablation/ln_b.yaml",
         [("per frame", LN_KERNEL, 1, 1)]),
        ("TIME_KERNEL_B", "fastenhancer.time_kernel", TIME_KERNEL_B,
         "ablation/time_kernel_b.yaml",
         [("per frame", "rnnformer_stack_step", 1, 1)]),
        ("DPT-B", "fastenhancer.dptransformer", DPT_B, "ablation/dpt_b.yaml",
         [("per frame", "dpt_stack_step", 1, 1)]),
        ("DPRNN-B", "fastenhancer.dprnn", DPRNN_B, "ablation/dprnn_b.yaml",
         [("per frame", "dprnn_stack_step", 1, 1)]),
        ("BSRNN-S", "bsrnn", BSRNN_S, "others/bsrnn_s.yaml",
         [("per frame", "bsrnn_stack_step", 1, 1)]),
        ("FSPEN", "fspen", FSPEN, "others/fspen.yaml",
         [("per frame", "gru_scan", 30, 1), ("chunk of 4", "gru_scan", 30, 4)]),
        ("LiSenNet", "lisennet", LISENNET, "others/lisennet.yaml",
         [("per frame", "gru_scan", 6, 1), ("chunk of 4", "gru_scan", 6, 4)]),
        ("NONCAUSAL_HUGE", "fastenhancer.noncausal", NONCAUSAL_HUGE,
         "fastenhancer_dns/huge_noncausal.yaml",
         [("offline", "gru_scan", 2 * NONCAUSAL_HUGE["rnnformer_kwargs"][
             "num_blocks"], 0)]),
    ]


def phase_28(ctx):
    """Phase 28 (see the module docstring); -> {kernel: {path: launches}}."""
    import torch

    from fastenhancer_tpu_torch.models import bsrnn as bsrnn_mod
    from fastenhancer_tpu_torch.models import get_model
    from fastenhancer_tpu_torch.models.fastenhancer import default as fe_mod
    from fastenhancer_tpu_torch.models.fastenhancer import dprnn as dprnn_mod
    from fastenhancer_tpu_torch.models.fastenhancer import (
        dptransformer as dpt_mod)
    from fastenhancer_tpu_torch.models.fastenhancer import (
        time_kernel as tk_mod)
    from fastenhancer_tpu_torch.models.macs import macs_for_config
    from fastenhancer_tpu_torch.ops import bsrnn_stack as band
    from fastenhancer_tpu_torch.ops import dprnn_stack as dprnn
    from fastenhancer_tpu_torch.ops import dpt_stack as dpt
    from fastenhancer_tpu_torch.ops import fused_frame as frame
    from fastenhancer_tpu_torch.ops import gru_scan as scan
    from fastenhancer_tpu_torch.ops import rnnformer_stack as stack
    from fastenhancer_tpu_torch.utils import (cast_floating, convert_checkpoint,
                                              tree_map, tree_paths)

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(repo, "tests"))
    from _torch_reference_sd import reference_checkpoint

    card, dev = ctx["card"], ctx["dev"]
    t_phase = time.perf_counter()

    def frame_reference(plan, x, h, num_blocks, **kw):
        return frame.fused_frame_reference(plan, x, h, **kw)

    def dpt_reference(plan, x, kc, vc, ptr, heads):
        y, p = dpt.dpt_stack_reference(plan, x, kc, vc, ptr, heads)
        return y, p, kc, vc

    # the model module through whose global each family calls its stack
    # kernel, and kernel -> (that global's name, the plain version)
    stack_modules = {
        "fastenhancer.default": fe_mod, "fastenhancer.ln": fe_mod,
        "fastenhancer.time_kernel": tk_mod,
        "fastenhancer.dptransformer": dpt_mod,
        "fastenhancer.dprnn": dprnn_mod, "bsrnn": bsrnn_mod}
    plain = {"rnnformer_stack_step": ("rnnformer_stack_step",
                                      stack.rnnformer_stack_reference),
             LN_KERNEL: ("rnnformer_stack_step",
                         stack.rnnformer_stack_reference),
             "fused_frame_step": ("fused_frame_step", frame_reference),
             "dpt_stack_step": ("dpt_stack_step", dpt_reference),
             "dprnn_stack_step": ("dprnn_stack_step",
                                  dprnn.dprnn_stack_reference),
             "bsrnn_stack_step": ("bsrnn_stack_step",
                                  band.bsrnn_stack_reference)}

    def spy(real, kept, in_place):
        """`real`, keeping its inputs (cloned before the call) and outputs
        at launch CKPT_KEEP_AT; with in_place (#2, which writes its K/V
        caches, args 2 and 3, in place) the caches after it too."""
        def launch(*args, **kwargs):
            n = kept.setdefault("n", 0)
            kept["n"] = n + 1
            if n != CKPT_KEEP_AT:
                return real(*args, **kwargs)
            before = [a.clone() if torch.is_tensor(a) else a for a in args]
            out = real(*args, **kwargs)
            post = [a.clone() for a in args[2:4]] if in_place else []
            kept["launch"] = (before, kwargs,
                              [o.clone() for o in out] + post)
            return out
        return launch

    def run_path(model, variables, plan, wav, chunk):
        """The family's path on `variables` -> its output (bf16)."""
        hop = model.hop_size
        if chunk == 0:
            return model.forward(variables, wav)[0]
        if chunk is None:
            carry = model.init_streaming_carry(wav.shape[0], torch.bfloat16,
                                               dev, fused=True)
            outs = []
            for i in range(wav.shape[1] // hop):
                carry, y = model.streaming_step_fused_frame(
                    variables, plan, carry, wav[:, i * hop:(i + 1) * hop])
                outs.append(y)
            return torch.cat(outs, 1)
        if plan is not None:
            return model.stream(variables, wav, fused_plan=plan)
        return model.stream(variables, wav, chunk_frames=chunk)

    def flat(tree):
        return dict(tree_paths(tree))

    paths = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        for fam_i, (tag, name, kwargs, config, fam_paths) in enumerate(
                ckpt_families()):
            offline = name == "fastenhancer.noncausal"
            model = (get_model(name, **kwargs) if offline
                     else get_model(name, **kwargs, stft_method="matmul"))
            hop = model.hop_size
            init = model.init(torch.Generator().manual_seed(280 + fam_i),
                              device=dev)
            # the reference layout, saved and loaded as a user would
            ckpt = reference_checkpoint(
                tree_map(lambda t: t.detach().cpu(), init), name)
            pth = os.path.join(tmp, f"{name}.pth")
            torch.save(ckpt, pth)
            pth_bytes = os.path.getsize(pth)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded = torch.load(pth, map_location="cpu", weights_only=True)
            t1 = time.perf_counter()
            conv = convert_checkpoint(loaded, name, kwargs, device=dev)
            torch.cuda.synchronize()
            load_s, conv_s = t1 - t0, time.perf_counter() - t1
            want, got = flat(init), flat(conv)
            _check(want.keys() == got.keys(), f"{tag} converted tree paths "
                   f"differ: {sorted(want.keys() ^ got.keys())[:6]}")
            _check(all(got[k].dtype == want[k].dtype
                       and got[k].device == want[k].device
                       and torch.equal(got[k], want[k]) for k in want),
                   f"{tag}: a converted leaf differs from its init leaf")
            try:
                macs = macs_for_config(os.path.join(repo, "configs",
                                                    config))["total"]
            except ValueError:  # no calculator for this family
                macs = None
            folded = {}
            for which, tree in (("init", init), ("converted", conv)):
                folded[which] = cast_floating(model.fold(tree),
                                              torch.bfloat16)
            g = torch.Generator().manual_seed(28 + fam_i)
            if offline:
                streams, n_samples = CKPT_NC_STREAMS, int(CKPT_NC_SECONDS
                                                          * SR)
            else:
                streams, n_samples = STREAMS, CKPT_FRAMES * hop
            wav = (torch.randn(streams, n_samples, generator=g)
                   * 0.05).to(dev, torch.bfloat16)
            for what, kernel, per_call, chunk in fam_paths:
                plans = {}
                for which in folded:
                    if chunk is None:
                        plans[which] = model.build_frame_plan(folded[which])
                    elif kernel == "gru_scan":
                        plans[which] = None
                    else:
                        plans[which] = model.build_stack_plan(folded[which])
                y_init = run_path(model, folded["init"], plans["init"], wav,
                                  chunk)
                calls = (1 if chunk == 0 else
                         (CKPT_FRAMES if chunk is None else CKPT_FRAMES
                          // chunk))
                n = per_call * calls
                kept = {}
                attr, reference = plain.get(kernel, (None, None))
                module = stack_modules.get(name)
                if kernel == "gru_scan":
                    ctx["seen_scan"].clear()
                    ctx["record_inputs"](True)
                else:
                    real = getattr(module, attr)
                    setattr(module, attr, spy(real, kept,
                                              kernel == "dpt_stack_step"))
                torch.cuda.synchronize()
                ctx["zero_counts"]()
                try:
                    y = run_path(model, folded["converted"],
                                 plans["converted"], wav, chunk)
                    torch.cuda.synchronize()
                    counts = ctx["read_counts"]()
                finally:
                    if kernel == "gru_scan":
                        ctx["record_inputs"](False)
                    else:
                        setattr(module, attr, real)
                ctx["check_launches"](counts, kernel, n,
                                      f"converted {tag} {what}")
                paths.setdefault(LN_KERNEL if kernel == LN_KERNEL
                                 else kernel, {})[
                    f"{tag} checkpoint {what} (28)"] = n
                _check(tuple(y.shape) == tuple(wav.shape)
                       and bool(torch.isfinite(y).all()),
                       f"{tag} {what}: output {tuple(y.shape)}")
                peak = y_init.float().abs().max().item()
                err = (y.float() - y_init.float()).abs().max().item()
                _check(err <= CKPT_REL * peak, f"{tag} {what}: converted vs "
                       f"init {err:.3e} > {CKPT_REL:g} of the peak {peak:.3e}")
                # each kernel launched on the converted weights against its
                # plain version on the same inputs
                held = []
                if kernel == "gru_scan":
                    for (shape, dtype), (_, args) in ctx[
                            "seen_scan"].items():
                        ys, h_t = scan.gru_scan(*args)
                        torch.cuda.synchronize()
                        ys_r, h_r = scan.gru_scan_reference(*args)
                        held += ctx["compare"](
                            f"{tag} gru_scan {shape}",
                            ((ys, ys_r), (h_t, h_r)), dtype)
                    n_held = f"{len(ctx['seen_scan'])} input shapes"
                else:
                    _check("launch" in kept, f"{tag} {what}: launch "
                           f"{CKPT_KEEP_AT} not seen")
                    args, kw, outs = kept["launch"]
                    held = ctx["compare"](
                        f"{tag} {kernel}",
                        zip(outs, reference(*args, **kw)), torch.bfloat16)
                    n_held = f"launch {CKPT_KEEP_AT}"
                # device time of one call of the path (a frame, a chunk
                # or the forward): its few hundred launches fit the card's
                # launch queue behind the sleep kernel, a 32-frame stream's
                # thousands would not
                t_wav = wav if chunk == 0 else wav[:, :hop * (chunk or 1)]
                ms, host_ms = ctx["time_ms"](
                    lambda: run_path(model, folded["converted"],
                                     plans["converted"], t_wav, chunk),
                    reps=5, inner=2)
                frames = t_wav.shape[1] // hop
                audio_s = t_wav.shape[1] / SR * streams
                gmacs = ("no calculator" if macs is None else
                         f"{macs * audio_s / (ms / 1e3) / 1e9:.2f} GMAC/s "
                         f"({macs / 1e6:.2f} M MACs a second of audio x "
                         f"{audio_s:g} s of audio)")
                print(f"[28/30] checkpoint {tag} ({name}, {config}) {what}: "
                      f".pth {pth_bytes} bytes, {len(ckpt['model'])} keys; "
                      f"torch.load {load_s:.4f} s, convert_checkpoint on the "
                      f"card {conv_s:.4f} s; {len(want)} leaves bit-equal "
                      f"to the init; bf16 {streams} streams x {frames} "
                      f"frames{'' if chunk in (0, None, 1) else ' in chunks of ' + str(chunk)}: "
                      f"{kernel} {n} launches, no other kernel; converted vs "
                      f"init max abs diff {err:.3e} (tol "
                      f"{CKPT_REL * peak:.3e} = {CKPT_REL:g} of the peak); "
                      f"{n_held} held to the plain version (max abs err "
                      f"{max(e for e, _ in held):.3e}); device "
                      f"{ms:.4f} ms a call of {frames} frames "
                      f"({ms / frames:.4f} ms a frame; {host_ms:.4f} ms a "
                      f"call with the host's dispatch); {gmacs}; on {card}")
            del init, conv, loaded, ckpt, folded
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the configs written again without pyyaml (the card has none)
    t0 = time.perf_counter()
    gen = subprocess.run(
        [sys.executable, "-m", "fastenhancer_tpu_torch.scripts.gen_configs",
         "--check"], cwd=repo, capture_output=True, text=True, timeout=300)
    _check(gen.returncode == 0, f"gen_configs --check: rc {gen.returncode}"
           f"\n{gen.stdout}\n{gen.stderr}")
    print(f"[28/30] python -m fastenhancer_tpu_torch.scripts.gen_configs "
          f"--check: rc 0 on configs/ in "
          f"{time.perf_counter() - t0:.2f} s; phase 28 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return paths


# phase 29: the corpus tools (fastenhancer_tpu_torch/scripts/data/) on a
# synthetic raw corpus, their shards trained on and the frozen test set
# mixed. P29_RECORDINGS speech recordings of P29_RECORDING_SECONDS, each
# utterances of P29_UTTERANCE_SECONDS between P29_GAP_SECONDS of silence:
# segment_daps cuts an utterance and its pads (4-5.5 s, one or two of the
# recipe's 30 buckets; a recording's last piece under --max-dur whole),
# ~717 s in all, so the reader's two threads fill the recipe's 128 s
# batches; P29_NOISE_FILES stereo noise files of
# P29_NOISE_SECONDS (one source silent; shard_noise's 10 s chunks);
# P29_RIRS RIRs of RIR_SECONDS with a DNS-style CSV; one 4-channel .mat
# RIR bank at 48 kHz a BRUDEX room; a test set of P29_TEST_CUTS cuts.
# Every pooled tool runs at -j P29_JOBS (spawned workers), shards of
# P29_SHARD_SIZE cuts
P29_RECORDINGS, P29_RECORDING_SECONDS = 8, 90.0
P29_UTTERANCE_SECONDS, P29_GAP_SECONDS = (3.6, 3.9), 0.6
P29_NOISE_FILES, P29_NOISE_SECONDS = 3, 12.0
P29_RIRS = 8
P29_TEST_CUTS = 16
P29_JOBS, P29_SHARD_SIZE = 4, 20
P29_TOOL_TIMEOUT = 300
# the test set's mix on #4 against the same mix on its plain version, of
# the output's peak (phase 23's mixer bound, OTF_MIX_REL), and each mixed
# row's correlation with the direct convolution of its speech and RIR
# (tests/test_shard_test_builder.py's bound)
P29_MIX_REL = 1e-5
P29_CORR = 0.9999


def phase_29(ctx):
    """Phase 29 (see the module docstring); -> {kernel: {path: launches}}."""
    import numpy as np
    import torch
    from scipy.io import savemat

    from fastenhancer_tpu_torch import native
    from fastenhancer_tpu_torch.data import DynamicMixer, batch_convolve_rir
    from fastenhancer_tpu_torch.data.audio_io import write_wav
    from fastenhancer_tpu_torch.data.shard import ShardSource
    from fastenhancer_tpu_torch.ops import segmental_rms as seg
    from fastenhancer_tpu_torch.presets import FE_T_SHARD
    from fastenhancer_tpu_torch.utils import yaml_subset

    card, dev = ctx["card"], ctx["dev"]
    repo = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    rng = np.random.default_rng(29)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus_")

    def path(*parts):
        p = os.path.join(tmp, *parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def tool(name, *args):
        """python -m ...scripts.data.<name> ARGS in a process of its own;
        -> its wall seconds, process start and spawned pool included."""
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", f"fastenhancer_tpu_torch.scripts.data."
             f"{name}", *map(str, args)], cwd=repo, capture_output=True,
            text=True, timeout=P29_TOOL_TIMEOUT)
        wall = time.perf_counter() - t0
        _check(p.returncode == 0 and "error" not in p.stdout.lower(),
               f"{name} {args}: rc {p.returncode}\n{p.stdout[-3000:]}\n"
               f"{p.stderr[-3000:]}")
        return wall

    def shard_files(d):
        """{file: its bytes, a cut list decompressed} of one shard dir (a
        .gz header holds the time it was written)."""
        out = {}
        for f in sorted(os.listdir(d)):
            with open(os.path.join(d, f), "rb") as fh:
                data = fh.read()
            out[f] = gzip.decompress(data) if f.endswith(".gz") else data
        return out

    def cut_list(d):
        return [json.loads(line) for f, data in shard_files(d).items()
                if f.endswith(".jsonl.gz")
                for line in data.decode().splitlines()]

    rates = []

    def built(what, wall, d, jobs):
        cuts = cut_list(d)
        audio_s = sum(m["duration"] for m in cuts)
        tars = [f for f in os.listdir(d) if f.endswith(".tar")]
        _check(cuts and all(ShardSource._plain_ustar(os.path.join(d, f))
                            for f in tars),
               f"{what}: {len(cuts)} cuts; its tars plain ustar: "
               f"{[ShardSource._plain_ustar(os.path.join(d, f)) for f in tars]}")
        durs = [m["duration"] for m in cuts]
        rates.append(f"{what} -j {jobs}: {len(cuts)} cuts of "
                     f"{min(durs):.2f}-{max(durs):.2f} s ({audio_s:.1f} s "
                     f"of audio, {len(tars)} tars) in {wall:.2f} s wall, "
                     f"{len(cuts) / wall:.1f} cuts/s, {audio_s / wall:.1f} "
                     f"audio s per wall s")
        return d

    try:
        # 1. the raw corpus
        gap = np.zeros(int(P29_GAP_SECONDS * SR), np.float32)
        for i in range(P29_RECORDINGS):
            parts = [gap]
            while sum(map(len, parts)) < P29_RECORDING_SECONDS * SR:
                n = int(rng.uniform(*P29_UTTERANCE_SECONDS) * SR)
                parts += [ctx["speech_like"](rng, 1, n)[0], gap]
            write_wav(path("raw", "speech", f"s{i:02d}_script1_produced.wav"),
                      np.concatenate(parts), SR)
        for i in range(P29_NOISE_FILES):
            x = rng.standard_normal((int(P29_NOISE_SECONDS * SR), 2)) * 0.05
            if i == 0:
                x[:, 1] = 0.0  # a silent source
            write_wav(path("raw", "noise", f"n{i}.wav"), x, SR)
        t = np.arange(int(RIR_SECONDS * SR))
        rows = ["path,channel,t60,c50,is_real"]
        for i in range(P29_RIRS):
            t60, onset = 0.2 + 0.1 * (i % 4), int(rng.integers(0, 200))
            r = rng.standard_normal(len(t)) * np.exp(
                -6.9 * np.clip(t - onset, 0, None) / (t60 * SR))
            r[:onset] = 0.0
            r[onset] = 2.0 * np.abs(r).max()  # the direct path
            sub = ("real", "simulated")[i % 2]
            write_wav(path("raw", "rirs", sub, f"rir{i}.wav"),
                      0.9 * r / np.abs(r).max(), SR)
            rows.append(f"{sub}/rir{i}.wav,1,{t60:g},{5 + i},{1 - i % 2}")
        with open(path("raw", "rir.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
        t48 = np.arange(int(RIR_SECONDS * 48000))
        for i, room in enumerate(("rev_low", "rev_medium", "rev_high")):
            bank = rng.standard_normal((len(t48), 4)) * np.exp(
                -6.9 * t48 / ((0.3 + 0.4 * i) * 48000))[:, None]
            bank[0] = 1.0
            savemat(path("raw", "brudex", room, "bank.mat"),
                    {"data": bank, "fs": 48000})
        corpus_s = time.perf_counter() - t_phase

        # 2. the tools, each in its own process, pools spawned
        seg_dir, shards = path("daps_segmented", ""), path("shards", "")
        wall = tool("segment_daps", "--src-dir", path("raw", "speech"),
                    "--out-dir", seg_dir, "--num-workers", P29_JOBS)
        segs = sorted(os.listdir(seg_dir))
        rates.append(f"segment_daps --num-workers {P29_JOBS}: "
                     f"{P29_RECORDINGS} recordings of "
                     f"{P29_RECORDING_SECONDS:g} s -> {len(segs)} cuts in "
                     f"{wall:.2f} s wall, "
                     f"{P29_RECORDINGS * P29_RECORDING_SECONDS / wall:.1f} "
                     f"audio s per wall s")
        speech = {}
        for jobs in (P29_JOBS, 1):
            wall = tool("shard_speech", "-n", f"daps-j{jobs}", "-d", seg_dir,
                        "-s", os.path.join(shards, "speech"), "-j", jobs,
                        "--shard-size", P29_SHARD_SIZE)
            speech[jobs] = built("shard_speech", wall, os.path.join(
                shards, "speech", f"daps-j{jobs}"), jobs)
        wall = tool("shard_noise", "-n", "noise", "-d", path("raw", "noise"),
                    "-s", os.path.join(shards, "noise"), "-j", P29_JOBS)
        noise = built("shard_noise", wall,
                      os.path.join(shards, "noise", "noise"), P29_JOBS)
        wall = tool("shard_dns_rir", "-n", "dns-rir", "--csv",
                    path("raw", "rir.csv"), "-d", path("raw", "rirs"), "-s",
                    os.path.join(shards, "rir"), "-j", P29_JOBS)
        dns_rir = built("shard_dns_rir", wall,
                        os.path.join(shards, "rir", "dns-rir"), P29_JOBS)
        brudex_16k = path("brudex_16k", "")
        wall = tool("preprocess_brudex", "--from-dir", path("raw", "brudex"),
                    "--to-dir", brudex_16k, "--num-workers", P29_JOBS)
        rates.append(f"preprocess_brudex --num-workers {P29_JOBS}: 3 .mat "
                     f"banks (4 x {RIR_SECONDS:g} s at 48 kHz) -> 16 kHz "
                     f"wavs in {wall:.2f} s wall")
        wall = tool("shard_brudex", "-n", "brudex", "-b", brudex_16k, "-s",
                    os.path.join(shards, "rir"), "-j", P29_JOBS)
        brudex = built("shard_brudex", wall,
                       os.path.join(shards, "rir", "brudex"), P29_JOBS)
        for f in segs[:P29_TEST_CUTS]:
            shutil.copy(os.path.join(seg_dir, f), path("test_speech", f))
        test_cfg = path("se_test.yaml")
        with open(test_cfg, "w") as f:
            f.write(yaml_subset.dump({
                "fs": SR, "silence_length": 0.1,
                "activity_threshold_relative": -25.0,
                "activity_threshold_absolute": -50.0,
                "input": {
                    "nearend_speech": {"base_dir": path("test_speech"),
                                       "extension": ".wav"},
                    "nearend_noise": {"noise": {
                        "directories_to_include": [path("raw", "noise")],
                        "extension": "", "probability": 1.0}},
                    "rir": {"dns": {"csv": path("raw", "rir.csv"),
                                    "base_dir": path("raw", "rirs"),
                                    "prob": 1.0}}},
                "nearend": {"speech_dbFS": [-35.0, -15.0],
                            "noise": {"snr": [0, 20, 5]},
                            "rir": {"prob": 1.0}}}))
        wall = tool("shard_test", "-n", "test", "-c", test_cfg, "-s",
                    os.path.join(shards, "test"), "-j", P29_JOBS, "--seed",
                    29, "--shard-size", P29_TEST_CUTS // 2)
        test_dir = built("shard_test", wall,
                         os.path.join(shards, "test", "test"), P29_JOBS)

        # 3. one builder's -j 1 and -j 4 shards are the same
        got, want = shard_files(speech[P29_JOBS]), shard_files(speech[1])
        _check(got == want, f"shard_speech -j {P29_JOBS} != -j 1: "
               f"{sorted(k for k in want if got.get(k) != want[k])}")
        done = [open(os.path.join(shards, "speech", f".daps-j{j}.done")
                     ).read() for j in (P29_JOBS, 1)]
        _check(done[0] == done[1], f".done markers {done}")

        # 4. FE-T trained through the CLI on the built shards
        valid = [path("valid", k, "") for k in ("clean", "noisy")]
        for i in range(CLI_WAVS):
            clean = ctx["speech_like"](rng, 1, int(rng.uniform(2.0, 4.0)
                                                    * SR))[0]
            noisy = clean + rng.standard_normal(len(clean)) * 0.03
            for d, x in zip(valid, (clean, noisy)):
                write_wav(os.path.join(d, f"{i:03d}.wav"), x, SR)
        inputs = {"speech": [{"shard_dir": speech[P29_JOBS]}],
                  "noise": [{"shard_dir": noise}],
                  "rir": [{"shard_dir": dns_rir}, {"shard_dir": brudex}]}
        config = os.path.join(repo, "configs", "fastenhancer_shard",
                              "t.yaml")
        train_walks = native.shard_members.launches
        history, counts, _ = ctx["run_cli"](
            ["-n", "built", "-c", config, "--base_dir", path("logs", ""),
             "-p", f"data.train.inputs={inputs!r}",
             f"data.valid.clean_dir={valid[0]!r}",
             f"data.valid.noisy_dir={valid[1]!r}",
             f"data.pesq.clean_dir={valid[0]!r}",
             f"data.pesq.noisy_dir={valid[1]!r}",
             f"train.steps_per_epoch={CLI_STEPS}", "train.max_epochs=1",
             f"valid.batch_size={CLI_VALID_BATCH}"])
        train_walks = native.shard_members.launches - train_walks
        blocks = FE_T_SHARD["model_kwargs"]["rnnformer_kwargs"]["num_blocks"]
        valid_n = -(-CLI_WAVS // CLI_VALID_BATCH)
        want = {k: 0 for k in ctx["counters"]}
        want["segmental_rms_fused"] = 2 * CLI_STEPS
        want["gru_scan"] = want[GRU_TC] = blocks * valid_n
        _check(counts == want, f"CLI on the built shards: launches {counts} "
               f"!= {want}")
        _check(len(history) == 1 and all(
            np.isfinite(v) for r in history
            for v in list(r["train"].values()) + list(r["valid"].values())),
            f"CLI on the built shards: {history}")
        _check(train_walks > 0,
               "the shard reader never took the native walker")

        # 5. the frozen test set read back and mixed on the card (#4)
        walks = native.shard_members.launches
        cuts = sorted(ShardSource(test_dir, fields=("recording", "rir",
                                                     "noise")).iter_cuts(0),
                      key=lambda c: int(c.id))
        walks = native.shard_members.launches - walks
        n_tars = len([f for f in os.listdir(test_dir) if f.endswith(".tar")])
        _check(len(cuts) == P29_TEST_CUTS and walks == n_tars,
               f"test set: {len(cuts)} cuts, {walks} of {n_tars} tars "
               "walked natively")
        rir_tar = os.path.join(test_dir, "rir.000000.tar")
        nat = list(ShardSource._iter_tar_audio(rir_tar))
        os.environ["FE_NATIVE"] = "0"
        try:
            py = list(ShardSource._iter_tar_audio(rir_tar))
        finally:
            os.environ.pop("FE_NATIVE")
        _check(len(nat) == len(py) == P29_TEST_CUTS // 2 and all(
            a[0] == b[0] and np.array_equal(a[1], b[1])
            for a, b in zip(nat, py)),
            "the float32 RIR members: native != the Python walker")
        b_rows = len(cuts)
        t_len = min(len(c.audio) for c in cuts)
        t_rir = int(RIR_SECONDS * SR)
        rir = np.zeros((b_rows, 1, t_rir), np.float32)
        for i, c in enumerate(cuts):
            rir[i, 0, :len(c.extras["rir"])] = c.extras["rir"][:t_rir]

        def rows(key):
            return torch.from_numpy(np.stack(
                [(c.audio if key is None else c.extras[key])[:t_len]
                 for c in cuts])[:, None]).to(dev)

        batch = dict(
            speech=rows(None), noise=rows("noise"),
            rir=torch.from_numpy(rir).to(dev),
            rir_onset=torch.tensor([c.custom["rir_onset"] for c in cuts],
                                   device=dev),
            rir_t60=torch.tensor([c.custom["rir_t60"] for c in cuts],
                                 dtype=torch.float32, device=dev))
        batch["speech_clean"] = batch["speech"]
        kw = dict(speech_dbFS=(-20.0, -20.0), snr=(60.0, 60.0),
                  sampling_rate=SR, rir_target_type="early_rir")
        mixer, plain = DynamicMixer(**kw), DynamicMixer(**kw)
        plain._rms = lambda wav, thr: seg.segmental_rms(
            wav[:, 0], sr=plain.sr, window_ms=plain.seg_window_ms,
            relative_threshold_db=plain.seg_rel_thr,
            absolute_threshold_db=thr)
        torch.cuda.synchronize()
        ctx["zero_counts"]()
        t0 = time.perf_counter()
        out = mixer(torch.Generator().manual_seed(29), **batch)
        torch.cuda.synchronize()
        mix_ms = 1e3 * (time.perf_counter() - t0)
        mix_counts = ctx["read_counts"]()
        ctx["check_launches"](mix_counts, "segmental_rms_fused", 2,
                              "the test set's mix")
        ref = plain(torch.Generator().manual_seed(29), **batch)
        errs = {}
        for k in ("speech", "speech_clean"):
            peak = ref[k].abs().max().item()
            errs[k] = (out[k] - ref[k]).abs().max().item()
            _check(errs[k] <= P29_MIX_REL * peak, f"test-set mix {k}: "
                   f"{errs[k]} of a peak {peak}")
        dry = plain(torch.Generator().manual_seed(29), batch["speech"],
                    speech_clean=batch["speech"], noise=batch["noise"])
        direct = batch_convolve_rir(batch["speech"], batch["rir"])[:, 0]

        def corr(x):
            x, d = x[:, 0].double(), direct.double()
            return (x * d).sum(-1) / (x.norm(dim=-1) * d.norm(dim=-1))

        c_mix, c_dry = corr(out["speech"]), corr(dry["speech"])
        _check(c_mix.min().item() > P29_CORR, f"test-set mix against the "
               f"direct convolution: correlations {c_mix.tolist()}")
        _check(c_dry.max().item() <= P29_CORR, "control, the RIR dropped: "
               f"correlations {c_dry.tolist()}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(f"[29/30] raw corpus written in {corpus_s:.2f} s; the port's "
          f"tools, each `python -m fastenhancer_tpu_torch.scripts.data.*` in "
          f"its own process (host only; the card idle): "
          + "; ".join(rates) + f"; on {card}")
    print(f"[29/30] shard_speech -j {P29_JOBS} and -j 1: the same "
          f"{sum(f.endswith('.tar') for f in got)} tars byte for byte, the "
          f"same decompressed cut lists and .done text; every built tar "
          f"plain ustar")
    tm, ref_tm = history[0]["timing"], ctx["cli_history"][0]["timing"]
    print(f"[29/30] CLI on the built shards (FE-T, the recipe's width, "
          f"{CLI_STEPS} steps, 1 epoch): wall {history[0]['seconds']:.2f} "
          f"s; train_epoch load {tm['load']:.3f} s "
          f"({100 * tm['load'] / history[0]['seconds']:.1f}% of the epoch), "
          f"mix+step {tm['step']:.3f} s ({1e3 * tm['step'] / tm['steps']:.1f}"
          f" ms a step); valid {tm['valid']:.3f} s; phase 21's epoch 1 on "
          f"hand-written shards: load {ref_tm['load']:.3f} s, mix+step "
          f"{ref_tm['step']:.3f} s ({1e3 * ref_tm['step'] / ref_tm['steps']:.1f}"
          f" ms a step); train losses "
          f"{', '.join(f'{k} {v:.4g}' for k, v in history[0]['train'].items())}"
          f"; the reader walked {train_walks} tars natively; "
          f"launches: segmental_rms {counts['segmental_rms_fused']} (2 a "
          f"step), gru_scan {counts['gru_scan']} (tensor-core, {blocks} a "
          f"valid batch x {valid_n}), no other kernel; on {card}")
    print(f"[29/30] frozen test set ({P29_TEST_CUTS} cuts, fields recording/"
          f"rir/noise; the float32 RIR members natively equal to the Python "
          f"walker, {walks} tars walked natively) mixed on the card, "
          f"{b_rows} x {t_len / SR:.2f} s, RIR "
          f"{t_rir} taps, early_rir target: segmental_rms 2 launches, "
          f"{mix_ms:.2f} ms wall for the mix; against the plain version max "
          f"abs err speech {errs['speech']:.3e}, speech_clean "
          f"{errs['speech_clean']:.3e} (tol {P29_MIX_REL:g} of the peak); "
          f"correlation with the direct convolution min "
          f"{c_mix.min().item():.7f} (bound > {P29_CORR}), the RIR dropped "
          f"max {c_dry.max().item():.4f}; phase 29 in "
          f"{time.perf_counter() - t_phase:.1f} s; on {card}")
    return {"segmental_rms_fused": {
                "CLI on built shards (29)": counts["segmental_rms_fused"],
                "test-set mix (29)": mix_counts["segmental_rms_fused"]},
            "gru_scan": {"CLI on built shards valid (29)": counts["gru_scan"]}}



# phase 30: the training demo on a stand-in of its bundled recording, its
# two recipes at a few epochs each, its children counted through a shim
P30_SECONDS = 31.0          # the bundled recording's length
P30_SR = 48_000
P30_RUNS = [("paired", 4), ("shard", 2)]
P30_CHILD_TIMEOUT = 900
# runs `python -m MODULE ARGS` as `python -c P30_SHIM MODULE OUT ARGS`: the
# module as __main__, then, when the process exits, each kernel's launch
# count written to OUT as JSON (chip_smoke.kernel_counters, from the
# working directory, the repo root) and the kernels' first inputs to
# OUT.pt (chip_smoke.record_first_inputs)
P30_SHIM = """
import atexit, json, runpy, sys
module, out = sys.argv[1], sys.argv[2]
sys.argv = [module] + sys.argv[3:]
from chip_smoke import kernel_counters, record_first_inputs
first = record_first_inputs()

def dump():
    with open(out, "w") as f:
        json.dump({k: getattr(fn, a)
                   for k, (fn, a) in kernel_counters().items()}, f)
    import torch
    torch.save(first, out + ".pt")

atexit.register(dump)
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def record_first_inputs():
    """In a demo child: spies on #4 as the mixer calls it and on each of
    #5's two forms; -> {"segmental_rms": (wav, kwargs), "gru_scan tc" /
    "gru_scan scalar": [x_proj, h0, w_hh, b_hh]}, filled with host copies
    of each one's first input as the child runs."""
    from fastenhancer_tpu_torch.data.shard_mixer import DynamicMixer
    from fastenhancer_tpu_torch.ops import gru_scan as scan

    first = {}
    mixer_rms = DynamicMixer._rms

    def spy_rms(self, wav, absolute_threshold_db):
        if "segmental_rms" not in first:
            first["segmental_rms"] = (
                wav[:, 0].detach().to("cpu", copy=True),
                dict(sr=self.sr, window_ms=self.seg_window_ms,
                     relative_threshold_db=self.seg_rel_thr,
                     absolute_threshold_db=absolute_threshold_db))
        return mixer_rms(self, wav, absolute_threshold_db)

    def spy_scan(form, launch):
        def spied(*args):
            if f"gru_scan {form}" not in first:
                first[f"gru_scan {form}"] = [a.detach().to("cpu", copy=True)
                                             for a in args]
            return launch(*args)
        return spied

    DynamicMixer._rms = spy_rms
    scan.launch_tc = spy_scan("tc", scan.launch_tc)
    scan.launch_scalar = spy_scan("scalar", scan.launch_scalar)
    return first


def standin_recording(path, seconds=P30_SECONDS, sr=P30_SR, seed=30):
    """A seeded speech-like wav at `sr`: voiced stretches of 1-3 s with a
    gliding f0 (100-250 Hz), harmonics to 8 kHz on a falling tilt with two
    formant bumps that move at each syllable, 4 Hz syllable envelopes,
    a little breath noise, and pauses of 0.15-0.5 s between stretches."""
    import numpy as np

    from fastenhancer_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    knots = np.arange(0.0, seconds + 0.25, 0.25)   # a syllable a knot
    f0 = np.interp(t, knots, rng.uniform(100, 250, len(knots)))
    f1 = np.interp(t, knots, rng.uniform(300, 800, len(knots)))
    f2 = np.interp(t, knots, rng.uniform(900, 2300, len(knots)))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = np.zeros(n)
    for k in range(1, 64):
        fk = k * f0
        amp = (np.exp(-((fk - f1) / 120) ** 2)
               + 0.6 * np.exp(-((fk - f2) / 200) ** 2) + 0.1) / k ** 0.7
        x += np.where(fk < 8000, amp, 0.0) * np.sin(k * phase)
    x += 0.02 * rng.standard_normal(n)
    x *= 0.55 - 0.45 * np.cos(2 * np.pi * 4.0 * t + rng.uniform(0, 6.3))
    voiced = np.zeros(n, bool)
    at = 0.2
    while at < seconds:
        run = rng.uniform(1.0, 3.0)
        voiced[int(at * sr):int(min(at + run, seconds) * sr)] = True
        at += run + rng.uniform(0.15, 0.5)
    x *= voiced
    write_wav(path, (0.3 * x / np.abs(x).max()).astype(np.float32), sr)
    return path


def demo_run(argv, workdir):
    """The demo's `main(argv)` in this process, its children through
    P30_SHIM; -> {"rc", "lines" (what main printed), "baseline" (main's
    return), "children": [{"module", "rc", "seconds", "counts", "inputs"
    (record_first_inputs's), "stdout", "stderr"}], "seconds"}. The caller
    points `train_demo.BUNDLED` at its recording."""
    from fastenhancer_tpu_torch.scripts import train_demo

    children = []

    def run(cmd, **kwargs):
        _check(cmd[1] == "-m", f"the demo's child {cmd}")
        out = os.path.join(workdir, f"counts.{len(children)}.json")
        t0 = time.perf_counter()
        p = subprocess.run([cmd[0], "-c", P30_SHIM, cmd[2], out, *cmd[3:]],
                           capture_output=True, text=True,
                           timeout=P30_CHILD_TIMEOUT, **kwargs)
        counts = inputs = None
        if os.path.exists(out):
            with open(out) as f:
                counts = json.load(f)
        if os.path.exists(out + ".pt"):
            import torch
            inputs = torch.load(out + ".pt", map_location="cpu",
                                weights_only=True)
        children.append(dict(module=cmd[2], rc=p.returncode,
                             seconds=time.perf_counter() - t0, counts=counts,
                             inputs=inputs, stdout=p.stdout,
                             stderr=p.stderr))
        return p

    class Children:   # the demo's `subprocess`, with `run` above
        pass

    class Tee(io.TextIOBase):
        """What the demo prints, to this script's stdout and to `buf`."""

        def __init__(self, out):
            self.out, self.buf = out, io.StringIO()

        def write(self, text):
            self.out.write(text)
            return self.buf.write(text)

        def flush(self):
            self.out.flush()

    Children.run = staticmethod(run)
    saved = train_demo.subprocess, sys.stdout
    train_demo.subprocess, sys.stdout = Children, Tee(sys.stdout)
    buf = sys.stdout.buf
    rc, baseline = 0, None
    t0 = time.perf_counter()
    try:
        baseline = train_demo.main(argv)
    except SystemExit as e:
        rc = e.code
    finally:
        train_demo.subprocess, sys.stdout = saved
    return dict(rc=rc, lines=buf.getvalue().splitlines(), baseline=baseline,
                children=children, seconds=time.perf_counter() - t0)


def demo_scores(result):
    """{"before": the noisy baseline's SISDR, STOI, PESQ as printed,
    "after": metrics_ns's, "step_ms": the training child's mix+step ms a
    step over its epochs, "steps"} of a demo_run."""
    before = {}
    for ln in result["lines"]:
        if ln.startswith("noisy baseline: "):
            # noisy baseline: SISDR x dB, STOI y, PESQ z
            words = ln.replace(",", "").split()
            before = {k.lower(): float(words[words.index(k) + 1])
                      for k in ("SISDR", "STOI", "PESQ")}
    after, step_s, steps = {}, 0.0, 0
    for child in result["children"]:
        for ln in child["stdout"].splitlines():
            words = ln.split()
            if (child["module"].endswith("metrics_ns") and len(words) >= 2
                    and words[0] in ("SISDR:", "STOI:", "ESTOI:", "PESQ:")):
                after[words[0][:-1].lower()] = float(words[1])
            if ln.startswith("epoch ") and " timing: load " in ln:
                # epoch N timing: load Xs mix+step Ys (S steps)
                step_s += float(words[6].rstrip("s"))
                steps += int(words[7].lstrip("("))
    return dict(before=before, after=after, steps=steps,
                step_ms=1e3 * step_s / steps if steps else None)


def hold_first_inputs(ctx, child, what):
    """The kernels of a demo child on its recorded first inputs (#4 where
    it ran, each form of #5 it ran), each against its plain version at
    phase 3's tolerances; -> one description a kernel form."""
    import torch

    from fastenhancer_tpu_torch.ops import gru_scan as scan
    from fastenhancer_tpu_torch.ops import segmental_rms as seg

    counts, inputs, dev = child["counts"], child["inputs"] or {}, ctx["dev"]
    ran = {"segmental_rms": counts["segmental_rms_fused"],
           "gru_scan tc": counts[GRU_TC],
           "gru_scan scalar": counts["gru_scan"] - counts[GRU_TC]}
    _check(set(inputs) == {k for k, n in ran.items() if n},
           f"{what}: first inputs recorded for {sorted(inputs)}, launches "
           f"{counts}")
    held = []
    for key, val in sorted(inputs.items()):
        if key == "segmental_rms":
            x, kw = val[0].to(dev), val[1]
            got = seg.segmental_rms_fused(x, **kw)
            torch.cuda.synchronize()
            err, rel = ctx["rms_err"](got, seg.segmental_rms(x, **kw),
                                      x.dtype, f"{what} segmental_rms "
                                      f"{tuple(x.shape)}")
            held.append(f"segmental_rms B={x.shape[0]} T={x.shape[1]} "
                        f"{str(x.dtype)[6:]}, {seg.cluster_size(x.shape[0])} "
                        f"blocks a row: max abs err {err:.3e} (each within "
                        f"{rel:g} relative)")
            continue
        args = [a.to(dev) for a in val]
        ys, h_t = scan.gru_scan(*args)
        torch.cuda.synchronize()
        ys_r, h_r = scan.gru_scan_reference(*args)
        errs = ctx["compare"](f"{what} {key} {tuple(args[0].shape)}",
                              ((ys, ys_r), (h_t, h_r)), args[0].dtype)
        t, n, g = args[0].shape
        held.append(f"{key} form T={t} N={n} H={g // 3} "
                    f"{str(args[0].dtype)[6:]}: max abs err ys "
                    f"{errs[0][0]:.3e} (tol {errs[0][1]:.3e}), h_T "
                    f"{errs[1][0]:.3e} (tol {errs[1][1]:.3e})")
    return held


def phase_30(ctx, runs=P30_RUNS):
    """Phase 30 (see the module docstring); -> {kernel: {path: launches}}."""
    import numpy as np
    import torch

    from fastenhancer_tpu_torch.scripts import train_demo

    card, dev = ctx["card"], ctx["dev"]
    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()   # the children share the card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_demo_")
    saved = train_demo.BUNDLED
    launches = {"gru_scan": {}, "segmental_rms_fused": {}}
    try:
        train_demo.BUNDLED = standin_recording(os.path.join(tmp, "p232.wav"))
        for recipe, epochs in runs:
            work = os.path.join(tmp, recipe)
            os.makedirs(work)
            r = demo_run(["--workdir", work, "--recipe", recipe, "--epochs",
                          str(epochs), "--device", str(dev)], work)
            tails = "\n".join(f"{c['module']} rc {c['rc']}:\n"
                              f"{c['stdout'][-2000:]}\n{c['stderr'][-3000:]}"
                              for c in r["children"])
            _check(r["rc"] == 0 and len(r["children"]) == 2
                   and all(c["rc"] == 0 for c in r["children"]),
                   f"demo {recipe}: rc {r['rc']}\n{tails}")
            sc = demo_scores(r)
            _check(any(ln.startswith("corpus: 8 train / 2 held-out")
                       for ln in r["lines"]), f"demo {recipe}: {r['lines']}")
            scores = list(sc["before"].values()) + list(sc["after"].values())
            _check(len(sc["before"]) == 3 and len(sc["after"]) == 4
                   and np.isfinite(scores).all()
                   and np.isfinite(list(r["baseline"].values())).all(),
                   f"demo {recipe}: scores {sc}\n{tails}")
            for c in r["children"]:
                counts = c["counts"]
                _check(counts is not None, f"demo {recipe}: {c['module']} "
                       f"reported no counts\n{tails}")
                train = c["module"].endswith(".train")
                want_rms = recipe == "shard" and train
                others = {k: v for k, v in counts.items()
                          if k not in ("gru_scan", GRU_TC,
                                       "segmental_rms_fused")}
                _check(counts["gru_scan"] > 0
                       and (counts["segmental_rms_fused"] > 0) == want_rms
                       and not any(others.values()),
                       f"demo {recipe} {c['module']}: launches {counts}")
                what = "train" if train else "metrics_ns"
                held = hold_first_inputs(ctx, c, f"demo {recipe} {what}")
                print(f"[30/30] demo {recipe} {what}: each kernel on the "
                      f"child's first input, against its plain version: "
                      + "; ".join(held))
                launches["gru_scan"][f"demo {recipe} {what} (30)"] = \
                    counts["gru_scan"]
                if want_rms:
                    launches["segmental_rms_fused"][
                        f"demo {recipe} {what} (30)"] = counts[
                            "segmental_rms_fused"]
            walls = ", ".join(f"{c['module'].split('.')[-1]} "
                              f"{c['seconds']:.1f} s" for c in r["children"])
            print(f"[30/30] demo --recipe {recipe} --epochs {epochs} "
                  f"--device {dev}: rc 0 in {r['seconds']:.1f} s ({walls}); "
                  f"{sc['steps']} steps at {sc['step_ms']:.1f} ms a step "
                  f"(mix+step); SISDR {sc['before']['sisdr']:.2f} -> "
                  f"{sc['after']['sisdr']:.2f} dB, STOI "
                  f"{sc['before']['stoi']:.3f} -> {sc['after']['stoi']:.3f}, "
                  f"PESQ {sc['before']['pesq']:.2f} -> "
                  f"{sc['after']['pesq']:.2f} (noisy -> enhanced, held-out "
                  f"pair); launches by child: "
                  + "; ".join(f"{c['module'].split('.')[-1]} "
                              f"{ {k: v for k, v in c['counts'].items() if v} }"
                              for c in r["children"]) + f"; on {card}")
    finally:
        train_demo.BUNDLED = saved
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[30/30] phase 30 in {time.perf_counter() - t_phase:.1f} s on "
          f"a {P30_SECONDS:.0f} s stand-in of the demo's recording")
    return launches

def spawned(fn, world, *args):
    """fn(rank, world, coordinator, *args) in `world` spawned processes,
    each rank its own; fails if a rank raises or they are not all done
    within DP_TIMEOUT seconds (then every rank is killed)."""
    import torch.multiprocessing as mp

    procs = mp.start_processes(
        fn, args=(world, f"127.0.0.1:{free_port()}") + args, nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + DP_TIMEOUT
    try:
        while not procs.join(timeout=max(deadline - time.monotonic(), 1.0)):
            _check(time.monotonic() < deadline, f"{fn.__name__}: the "
                   f"ranks were not done in {DP_TIMEOUT} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()


def free_port():
    """A TCP port that is free on this host now: the one a store on port 0
    was given, closed again."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False)
    port = store.port
    del store
    return port


if __name__ == "__main__":
    sys.exit(main())
