#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises on failure:

1. print the card (``nvidia-smi`` name and power limit) and torch version;
   turn TF32 off so the plain versions and the projection are exact float32;
2. build the seven kernel libraries from ``audio_tpu_torch/csrc`` in parallel;
3. hold each of the ten kernel entries against its plain PyTorch version on the
   card, at its main path's shape and at ragged small shapes (K3 on both of its
   routes, "warp" and "block", paths equal: shared-memory and global
   backpointers, V past a warp, S 255, each in float32, float64, bfloat16 and
   float16 and again on a grid of 0.5 that makes the transitions tie;
   trellises without the CTC layout (holes in the valid states, skips into
   even states); float16 with -inf columns, float32 emissions of -inf that
   step the walk off state 0, the main shape and its bits over two runs; S
   257, 1201 and 3201 (a float64 front in global memory) and a non-contiguous
   view through the wrapper; K1 on its
   "chunked" route at orders 1, 2, 8, 12 and 16 by pb 1, 3, order + 1, 17 and
   129, C 1 and 3, T 1, 31, 1000 and 2100, poles at |z| = 0.977, the main
   shape, bitwise equal over two runs, and on its "serial" route at orders 17
   and 128; K8 on its "stream" route in f32 and bf16 at V 1, 2, 7, 8, 9, 33,
   4097 and 65537, every row start off the 16-byte grid, the blank and the
   targets at 0 and V - 1, rows whose first columns are -inf, the train
   step's full lattice and pruned band, bitwise equal over two runs; K6 on its
   "stream" route in f32 and bf16 at V 33, 4097, 58,114 and 65,537 and k 1, 8,
   10, 16 and 32 (each list capacity), every row start off the 16-byte grid, rows
   with exact ties and rows with fewer than k candidates above -inf (some -inf
   apart from the blank), bitwise equal over two runs, and on its "row" and
   "global" routes on the same rows and at every K5-K8 shape; K5's three
   routes on rows with fewer than k candidates above -inf (three, one and
   none, at V 300 and 4097): indices equal to top_k's and inside the row,
   lse, blank and values within 2e-2; K2 on both of its
   routes: mel, power and magnitude at n_fft 400, 512, 1024 and 2048 on "fft"
   and at 398 on "dft", the main shape on both, bitwise equal over two runs;
   K5 on its "wgmma" route at N 1, 40, 63, 65, 5120 and 5121, V 33 to 4097,
   the blank inside V and at V - 1, k 1, 10 and 32, rows of exact ties won by
   the lowest indices across column splits, and bitwise equal over two runs;
   K5 on its "wmma" route at the ragged bf16 shapes, the main shape, and k 33,
   100 and 256 through the wrapper; K7 on its "wgmma" route at N 1, 63, 65 and
   5121 by H 64, 256 and 512, the main shape, bitwise equal over two runs, and
   on its "wmma" and "simt" routes at the ragged shapes and the main shape;
   K9 forward and backward in f32 and bf16 on both of its routes, bf16 at the
   edges of the wgmma route, a fully masked row included, bitwise equal over
   two runs, and the "tiled" route's bf16 case (2, 2, 100, 70, 136) of seed
   25, its kernel and its plain version each also against float64, and the
   same bits again after the free device memory was filled with NaN; K4 on
   its "chunked" route at orders 1, 2, 8, 12 and 16 in both time directions,
   a signal shorter than a chunk, one not a multiple of it, poles at
   |z| = 0.977, the main shape, with the plan made on the card against its
   plain version, and on its "serial" route at orders 17 and 128), the public
   spectral functions on the card against the same calls on the CPU, and one
   call of each route the public functions take outside their kernels' limits
   (spectrogram at n_fft 4096 and at power 3, mel_spectrogram at hop 16,
   lfilter and filtfilt in float64 and lfilter with 130 taps, MelSpectrogram
   at power 1, the search's predictor at H 640, the tanh-joiner search's row
   statistics on float16 rows (no K6 launch) and at V 58,114 (K6 on
   "stream")) against the CPU, and
   forced_align in bfloat16, float16 and float64 and at L = 600, which now
   launch K3, against the CPU;
4. run the first main path, bench.py's chain, at full width (B=8192 streams
   of 1 s at 16 kHz, 80 mels, L=50, V=32): lowpass_biquad -> lfilter ->
   mel_spectrogram -> log1p -> projection -> log_softmax -> forced_align.
   The launch counters of K1-K3 must move in that run, K1 only on its
   "chunked" route, K2 only on its "fft" route and K3 only on its "warp"
   route; the paths must be
   valid CTC alignments of the targets; a small slice of the chain must agree
   with the plain versions on the CPU.  Then time the chain and each kernel
   with CUDA events, and break one chain step down by kernel with
   torch.profiler (device busy and idle share);
5. run the second main path, the streaming Emformer RNN-T beam search, at the
   full width of ``emformer_rnnt_base(4097)`` with seeded random weights in
   bf16: S=512 streams, beam 10, ``step_max_tokens`` 4, four consecutive
   ticks of ``RNNTBeamSearch.infer_batch`` from ``init_beams`` with carried
   state.  The counters of K5 and K7 must move, each only on its "wgmma" route;
   the beams must be well formed.  Time the tick for both forms of the inner
   loop and profile one.  Then the same model with a tanh joiner
   (``joiner.activation = "tanh"``), whose (S, K, V) logits exist: four ticks
   from ``init_beams``, K6 must move, only on "stream", and K5 not at all; the
   beams must be well formed; time the tick (early exit) and profile one;
6. the same search in f32 on the card against the CPU (which runs the plain
   versions): the ReLU joiner (K5) at S=4, a tanh joiner (K6 must move, only
   on "stream") and ``expansion="approx"`` (K8 must move, only on "stream") at
   S=32, two ticks each;
7. the pipeline: seeded noise -> streaming feature extractor (K2 must move)
   -> ``infer`` segment by segment (K5 must move);
8. the third main path, the Emformer RNN-T train step of
   ``examples/asr/emformer_rnnt/train_torch.py`` at full width
   (``emformer_rnnt_base(4097)``, features (B, 516, 80), 64 targets, bf16
   compute with f32 masters, dropout on, AdamW): the full-lattice loss at
   B=32 and the pruned loss (band 16) at B=64.  K9 must launch once a layer
   forward and once backward, on its wgmma route, and K8 at least once, on "stream"; the loss must be finite and
   fall.  Time the step, read its peak memory, profile one.  Then the loss and
   its gradients in f32 at B=2 on the card against the CPU;
9. the fourth main path, lfilter's gradient: the gradients of
   mean(log1p(mel_spectrogram(lfilter(x, a, b)))) with respect to x, a and b at
   B=8192 and orders 2, 8 and 12 (K1 and K2 forward, K1 only on "chunked", K2
   only on "fft", K4 backward must move, only on "chunked"), against the CPU at B=4;
10. the sox effects and the Griffin-Lim vocoder: gain -> contrast -> dcshift ->
   overdrive -> phaser -> dither on B=8192 rows of 1 s at 16 kHz (K4 must move
   in overdrive, only on "chunked"), flanger on (4096, 2, 16000) at its defaults
   (a gather, no time loop) and at regen 50 with quadratic interpolation, and
   the other branches (dcshift below zero, the triangular phaser, RPDF and GPDF
   dither from a CUDA generator); phaser and flanger under
   ``torch.cuda.set_sync_debug_mode("error")``; each effect's first rows
   against the CPU; each effect and the chain timed, one phaser call on 4,000
   samples and the flanger's loop on 1,000 profiled.  Then the TTS bundle's vocoder
   (22,050 Hz, n_fft 1024, hop 256, 32 iterations, momentum 0.99): griffinlim
   from random phases on 32 spectrograms of 5 s clips (the rebuilt magnitude's
   correlation at least 0.98 on every clip), in float64 at B=2 against the
   CPU, the inverse spectrogram, the phase vocoder at rate 1.3, decibels there
   and back, and the spectral centroid (K2 must move, only on "fft"), each
   against the CPU; griffinlim and the centroid timed;
11. the CTC augmentation front end at B=8192 rows of 1 s at 16 kHz: speed 1.1 with lengths ->
   add_noise at per-row SNRs of 0-20 dB -> preemphasis -> deemphasis (K1) -> loudness
   normalisation to -23 LUFS (K1) -> mel_spectrogram (K2) -> log1p -> sliding_window_cmn (600
   frames, variance too) -> compute_deltas -> SpecAugment's frequency (27) and time (40) masks from
   CUDA generators -> projection to the wav2letter recipe's 29 labels -> ctc_loss (mean) and its
   backward -> ctc_greedy_decode.  K1 must move, only on "chunked", and K2, only on "fft"; each
   stage's first rows against the CPU (masks against their formula on the generator's draws, the
   decoded tokens equal), the projection's gradient against the CPU, the step and each stage timed,
   one step and the loss alone profiled.  Then the other ported functions once each, the card
   against the CPU, timed: resample 48 -> 16 kHz on (8192, 48000) and 16 -> 44.1 kHz (kaiser) with
   their peak memory, and once with cuDNN's TF32 at PyTorch's default (the result must not move);
   pitch_shift by an octave either way at full width and by 4 steps at B=64 with its host-built
   resampling kernel timed apart; convolve (64 taps, again with cuDNN TF32 on) and fftconvolve
   (8,000 taps); detect_pitch_frequency at (8192, 16000) under 8 GB; vad on three (2, 64000)
   recordings (lengths equal); the beamformers on a (64, 6, 257, 200) complex64 STFT; the Frechet
   distance at dimension 128; mu-law at full width (every code equal); ctc_loss at the recipe's
   shape (8, 400, 29), L <= 150, against the CPU and against torch.nn.functional.ctc_loss, both timed;
12. the same front end built from the transform modules at B=8192: SpeedPerturbation (0.9, 1.0, 1.1; a
   CUDA generator's draw of 1.1) -> AddNoise -> Deemphasis (K1) -> Loudness normalisation (K1) -> MFCC
   (40 coefficients of 80 mels, K2) -> SlidingWindowCmn -> ComputeDeltas -> SpecAugment (two time masks
   of 40, two frequency masks of 27, per row) and LFCC (K2) on the waveforms MFCC reads.  K1 must move,
   only on "chunked", and K2, only on "fft"; each stage's first rows against the same module on the CPU
   (SpecAugment against its masks' formula on the generator's draws), MFCC and LFCC the same bits with
   cuBLAS's TF32 on; the step and each stage timed, one step profiled.  Then every other class once on
   1,024 rows, the card against the CPU, timed: the complex Spectrogram and InverseSpectrogram, MelScale
   and InverseMelScale (gels, gelsd), TimeStretch, GriffinLim (float64 at B=2), PitchShift an octave
   either way, Resample 48 -> 16 kHz, Fade's five shapes, Vol, Preemphasis, Convolve, FFTConvolve,
   mu-law (every code equal), the axis masks, SpectralCentroid (K2 must move, only on "fft"), Vad, PSD,
   RTFMVDR, SoudenMVDR, MVDR online over three calls, RNNTLoss (K8 must move).  Then Kaldi's features:
   fbank in the Audio Spectrogram Transformer's setting on 256 clips of 10 s, one call a clip (clips a
   second, idle share), mfcc and spectrogram on one 10-minute channel, each against the CPU;
13. wav2vec2/HuBERT and WavLM at full width, weights from CUDA generator seeds: (a) MMS_FA-shaped forced
   alignment, ``wav2vec2_model`` with the bundle's parameters (about 315M) on 16 clips of 10-15 s, each
   normalised alone -> log_softmax with a zero star column -> forced_align of 100 tokens a clip (K3 once a
   call, on "warp") -> merge_tokens per clip, the model in f32 and in bf16; (b) ``wav2vec2_base(aux 29)``
   in bf16 on 32 clips of 6-10 s -> ctc_greedy_decode; (c) ``wavlm_base_plus().extract_features`` (12
   layers) in bf16 on 32 clips of 10 s.  Every path a CTC alignment of its targets and equal to the CPU's
   forced_align on the same emission; each model in f32 at B=2 x 4 s within 1e-3 of the peak of the CPU's
   output, and the same bits with cuDNN's TF32 on; every bf16 output finite and within 0.05 of f32 in
   relative L2; WavLM's buckets on the card equal to the CPU's; each batch timed, profiled once, its peak
   memory and model FLOPs against the peak rate;
14. the SSL train steps at full width, weights from CUDA generator seeds, on one batch of 8 voiced clips of
   10-12 s (their sum under the recipe's 1,400,000 samples, padded to the longest): (a) HuBERT masked
   prediction (``hubert_pretrain_base``, 100 classes, labels from a seed) in f32 and in bf16 over f32
   masters; (b) wav2vec 2.0 contrastive pretraining (``wav2vec2_base``, final dim 256, 100 negatives) in f32;
   (c) HuBERT CTC fine-tuning (``hubert_base(aux 29)``, transcripts of 120-180 labels) in f32, one stage
   inside the frozen encoder's updates and one past them.  The span masks follow the static strategy and
   mask no padded frame, no negative comes from its own frame, the frozen parameters keep their bits, the
   losses and gradients are finite, the bf16 HuBERT loss is within 0.05 of f32; each step in f32 at B=2 x
   4 s against the CPU (loss 1e-4 relative, gradients 1e-3 of their peaks, the parameters after one update
   1e-5); each step timed, profiled once, its peak memory and model FLOPs (forward and backward) against
   the peak rate; ``ctc_loss`` alone against the fine-tune step, the positional convolution alone in f32
   and bf16.  No kernel is on this path: the counters are read around the phase and printed;
15. the Conformer RNN-T recipes at full width (``examples/asr/conformer_rnnt/train_torch.py`` and
   ``conformer_rnnt_biasing/train_torch.py``, weights drawn as the recipes' ``main`` draws them, ``flax_init_``,
   from CUDA generator seeds): (a) the Conformer RNN-T
   train step (80 mels, stride 4, width 256, 16 layers, FFN 1024, kernel 31, LSTM 512, joiner 256, V 1024)
   in f32 on 16 voiced clips of 5-10 s with up to 40 targets, SpecAugment and dropout on: K2 only on "fft",
   K8 only on "stream"; then at B=2 x 4 s against the CPU (features 1e-3, loss 1e-4 relative, every gradient
   1e-3 of its peak) and the f32 encoder's bits with cuDNN's TF32 on; (b) ``RNNTBeamSearch.forward_batch``
   on that model, beam 10, 16 clips of 10 s, in bf16 (K5 and K7 only on "wgmma") and once in f32, its real-
   time factor, and the f32 search on 2 clips of 2 s against the CPU (top-1 tokens equal, scores 1e-3);
   (c) the TCPGen-biased step (V 601, TCPGen 64, 16 distractors, a 256-node trie) in f32 on 8 clips of 10 s:
   K2 only on "fft", no K8 (the loss reads log-probabilities), then at B=2 against the CPU.  Each step and
   the bf16 search timed, profiled once, with its peak memory;
16. the AVSR recipe at full width (``examples/avsr/train_torch.py`` and ``eval_torch.py``, weights from CUDA
   generator seeds, ``AVConformerRNNT(1024)``: 45,637,440 parameters): (a) the train step (video ResNet-18
   and audio ResNet1D front ends, FFN fusion, 16-layer Conformer, LSTM predictor, ReLU joiner) in f32 on 8
   clips of 100-200 frames of 96x96 with 640 samples a frame and up to 40 targets, dropout on, at the
   schedule's peak: K8 only on "stream"; timed, profiled once, its peak memory, video frames a second and
   its operations (``step_flops``) against the FP32 peak; (b) at B=2 x 16 frames against the
   CPU (loss 1e-4 relative, every gradient 1e-3 of its peak); (c) ``fuse``'s bits with cuDNN's TF32 on;
   (d) ``eval_torch.py``'s greedy decode on 8 clips of 100-200 frames, timed and profiled, at B=2 its
   tokens and counts equal to the CPU's, then the recipe's ``--overfit`` gate on the card (the tiny model,
   400 steps, batch 8, lr 2e-3, warm-up 40) decoding every transcript exactly; the front ends' gradients with
   cuDNN's TF32 on in the backward (``check_grads_tf32``);
17. Wav2Letter, DeepSpeech and Conv-TasNet (``examples/asr/wav2letter/train_torch.py``,
   ``examples/source_separation/train_torch.py``, weights drawn as flax's ``init`` draws from CUDA seeds 220-249):
   (a) the Wav2Letter CTC step at full width (23.3M parameters) in f32 on 8 voiced clips of 4-8 s padded to 8 s
   with 10-15 characters a second (MFCC through K2, only on "fft"; ``ctc_loss`` at (8, 401, 29)), timed,
   profiled, its peak memory and ``ctc_loss``'s share (timed in turn with the step); at B=2 x 1-2 s the features
   and the greedy tokens against the CPU, the loss and every gradient in float64 and in float32
   (``compare_with_cpu_f32_f64``); the recipe's ``--overfit`` gate; (b) ``DeepSpeech(161, 2048, 29)`` on the power
   spectrogram (n_fft 320, K2 only on "fft") of 16 clips of 10 s: the forward, and the forward with ``ctc_loss``
   and its backward, timed; at B=2 x 2 s against the CPU likewise; (c) the Conv-TasNet step
   (``conv_tasnet_base(2)``, Adam, the clip) in f32 on 8 x 3 s at 8 kHz, timed, profiled, its peak memory and FLOPs;
   at B=2 x 0.5 s against the CPU likewise; the recipe's ``--overfit`` gate; the train steps of phases 14-17 also
   timed in turn with ``tf32_off`` made a plain call (``helper_cost``); (d) ``check_grads_tf32`` (each f32 gradient with TF32 on while the
   backward runs against two runs with it off, the same bits where those agree; the fault's size before the
   repair printed beside) on the three new models, wav2vec2_base's feature extractor and positional convolution at
   phase 14's batch, one Conformer layer at phase 15's, ``convolve`` and ``resample`` on phase 10's rows and
   ``exact_matmul`` (cuBLAS's flag).
18. Hybrid Demucs and SQUIM through their bundles (weights from CUDA seeds 250-269, injected as
   ``dl_kwargs={"state_dict": ...}``): (a) ``istft`` at n_fft 4096 on complex64 bins with imaginary DC and Nyquist
   parts against the CPU (1e-5 of the peak; the fault before the repair, cuFFT reading those parts, printed beside,
   and on ``hdemucs_high``'s float32 output below); ``HDEMUCS_HIGH_MUSDB_PLUS`` (``hdemucs_high``, four sources, stereo,
   44.1 kHz) in the Hybrid Demucs tutorial's ``separate_sources`` (``examples/tutorials/
   hybrid_demucs_tutorial_torch.py``: segments of 10 s, overlap 0.1 s) over a 30 s synthetic mixture in float32:
   its parameter count, ms a 10 s segment, the real-time factor, launches a segment and the idle share, sample 0 of
   every source 0 (the fade-in's first weight); one 2 s segment against the CPU in float64 (1e-9 of the output's
   peak) and float32 (1e-4), and ``hdemucs_low`` (8 kHz) and ``hdemucs_medium`` (16 kHz, the ``nfft == 2048`` plan)
   likewise; (b) ``SQUIM_OBJECTIVE`` and ``SQUIM_SUBJECTIVE`` on 8 voiced clips of 4 s at 16 kHz, clean and with
   noise at 3 dB, MOS against non-matching references of 3 s: ms a batch and the idle share, each score against the
   CPU in float64 (1e-9 of its peak over the batch) and float32 (1e-4); (c) the 10 s segment and both SQUIM batches
   with cuDNN's and cuBLAS's TF32 on, within two TF32-off runs' spread of each other; (d) the K1-K9 launch counters
   over the phase, which must stay at zero (no TPU kernel is on these paths).
19. Text-to-speech (weights from CUDA seeds 270-289): (a) ``TACOTRON2_WAVERNN_CHAR_LJSPEECH`` and
   ``TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH`` at full width on injected ``state_dict``s: the character processor on 4
   sentences, ``Tacotron2.infer`` over 2,000 steps in float32 (no host read inside; the two bundles' models the same
   bits), the Griffin-Lim vocoder on the whole mel, the WaveRNN vocoder on its first 40 frames (11,000 samples a
   row): parameter counts, ms, steps, ``out_len``, launches a step or a sample, idle shares; each with cuDNN's and
   cuBLAS's TF32 on against two runs with them off; (b) Tacotron2 teacher forced at B=2 on rows of unequal length
   against the CPU in float64 (1e-9 of each output's peak) and float32 (1e-4), its ``infer`` over 64 steps in
   float64 with ``out_len`` equal, WaveRNN's ``forward`` likewise and its ``infer`` over two frames in float64 with
   both samplers on the argmax, the samples equal; (c) the two recipes' train steps at full width
   (``examples/tts/*/train_torch.py``): Tacotron2 at B=8 with up to 128 tokens and 512 frames, WaveRNN at B=8 x 24
   frames of hop 200, their log-mel targets built from voiced waveforms by the recipes' ``MelSpectrogram`` (K2, only
   on "fft"): ms a step, launches, idle share, peak memory, the gradients with TF32 on in the backward, at B=2
   against the CPU in float64, the BatchNorms' statistics unmoved; both ``--overfit`` gates with the JAX slow tests'
   arguments; (d) the launch counters over the phase: K2 while the targets are built, no other kernel.
20. wav2vec2 ASR serving and bundle alignment: ``WAV2VEC2_ASR_BASE_960H.get_model`` at full width (12 layers, 768
   wide, 29 labels) from a seeded torchaudio-named ``state_dict`` with the published shapes (32 aux rows before the
   bundle drops three, the positional weight norm as ``weight_g``/``weight_v``) on 8 clips of 10 s, the emissions
   (8, 499, 29) against the same bundle on the CPU (1e-3 of the peak); their log-probs through ``cuda_ctc_decoder``
   (beam 10, nbest 1) on the card, the tokens equal to the CPU's on every row without a near tie (a row whose float64
   and float32 CPU decodes differ) and on peaked log-probs of seeded token paths, one batch timed and profiled; the
   same log-probs on the host through the lexicon ``ctc_decoder`` with a 3-gram LM the phase writes, native on the
   ARPA and on its KenLM binary (``build_binary_lm``) and the plain Python search, the words equal, ms a clip;
   ``MMS_FA.get_model(with_star=True)`` with its tokenizer and aligner on 2 clips of 10 s: K3 launches (on "warp"),
   the spans equal to the CPU aligner's on the same emissions.  No other kernel launches.

Then it times every kernel (``cuda_ms``) beside its bound, its plain version
and its library call; for K1 to K8 also the route each replaced ("serial",
"dft", "block", "serial", "wmma", "row", "wmma", "row"), for K6 also its route
"global", K1 at orders 8 and 12 on both routes, K8 on the train step's full
lattice and pruned band, for K2 the power spectra without the mel product,
for K5 and K7 the product alone (``torch.nn.functional.linear``) and for K6
``torch.topk`` of the candidates alone.
Prints one JSON line of per-kernel numbers, then, last,
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

B, SR, T, L, V = 8192, 16000, 16000, 50, 32
N_FFT, HOP, N_MELS = 400, 160, 80
CUTOFF = 4000.0

# the streaming RNN-T path: emformer_rnnt_base(4097), bench_models.py's serving point
RNNT_V, RNNT_BLANK, RNNT_BEAM, RNNT_SMT, RNNT_MAX_TOKENS = 4097, 4096, 10, 4, 200
RNNT_S, RNNT_SEG_T, RNNT_D_IN, RNNT_SEG_SECONDS, RNNT_TICKS = 512, 20, 80, 0.16, 4
RNNT_D, RNNT_H = 1024, 512  # joiner depth, predictor hidden size
RNNT_BLANK_BIAS = 4.0  # added to the searched models' blank logit, as the serving bench tilts it (bench_models.py:217)

# the train step: bench_models.py's shapes (5.12 s of features, 64 targets, V = 4097)
TRAIN_T, TRAIN_RC, TRAIN_U = 512, 4, 64
TRAIN_B_FULL, TRAIN_B_PRUNED, TRAIN_BAND = 32, 64, 16
TRAIN_HEADS, TRAIN_DH = 8, 64  # the encoder's attention: K9 runs at (B, 8, 160, 160, 64)
TRAIN_TQ = TRAIN_T // 4 + (TRAIN_T // 16) * (TRAIN_RC // 4)  # 128 frames + 32 right-context frames

# H100 SXM data sheet rates (dense): device memory, FP32 outside the tensor cores, and
# bf16 on the tensor cores
SPIN_CYCLES = 100_000_000  # about 50 ms of the card's clock: see cuda_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after a warm-up.

    The device first spins for some tens of milliseconds, during which the host queues the
    calls; the clock starts when the spin ends.  So a call made of several small launches
    (a backward behind the autograd engine) is timed at the device's pace even when the
    host is slower than the device, as on a machine whose cores are shared.  The spin is
    torch's own test helper; a torch without it times the calls at the pace the host sends them.
    """
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin = getattr(torch.cuda, "_sleep", None)
    if spin is not None:
        spin(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernel_rows(prof, reps: int) -> list:
    """(name, device ms a call, launches a call) of every kernel a profile saw, longest first;
    ranges that only annotate the timeline (the optimizer's step) are not kernels.  Summed from the
    profiler's raw events, the device events that ``key_averages`` sums by name (phase 16 holds the two
    to the same launches, kernel by kernel, on one profiled step: ``check_rows_against_key_averages``);
    ``key_averages`` first builds an object and a tree of every event, which takes tens of seconds for
    a call of 80,000 launches."""
    from torch.autograd import DeviceType

    rows = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() or name.startswith("Optimizer."):
            continue
        ms, n = rows.get(name, (0.0, 0))
        rows[name] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((k, ms / reps, n / reps) for k, (ms, n) in rows.items() if ms > 0), key=lambda r: -r[1])


def device_busy_union_ms(prof) -> float:
    """ms in which at least one kernel (or copy) ran on the device in a profile: the union of the intervals that
    ``device_kernel_rows`` sums.  cuDNN runs a bidirectional LSTM's two directions on streams of its own, so the sum
    of the kernels' times can exceed the call that holds them (phase 18's SQUIM batches)."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                   and not e.name().startswith("Optimizer.") and e.duration_ns() > 0)
    total, start, end = 0, None, None
    for a, b in spans:
        if end is None or a > end:
            total += 0 if end is None else end - start
            start, end = a, b
        else:
            end = max(end, b)
    return (total + (0 if end is None else end - start)) / 1e6


def check_rows_against_key_averages(prof, rows: list) -> int:
    """Raises unless ``rows`` (``device_kernel_rows`` of ``prof``, one call) count each kernel's launches as
    ``key_averages`` counts them; returns the launches."""
    from torch.autograd import DeviceType

    ref = {e.key: e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0
           and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")}
    got = {name: n for name, _, n in rows}
    differ = {k: (got.get(k, 0), ref.get(k, 0)) for k in set(got) | set(ref) if got.get(k, 0) != ref.get(k, 0)}
    print(f"  the raw events' launches against key_averages' on this profile: {sum(got.values()):g} and "
          f"{sum(ref.values())}, {len(ref)} kernels, {len(differ)} differ")
    if differ:
        raise AssertionError(f"device_kernel_rows and key_averages count launches differently: {differ}")
    return sum(ref.values())


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = PEAK_FP32_PER_S):
    """The least time for the work: its bytes at the memory rate or its operations at
    ``ops_per_s`` (the peak for their type), whichever is longer."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def template_args(mangled: str) -> list:
    """A kernel's template arguments from their mangled form: types, integers and booleans."""
    names = {"f": "float", "d": "double", "j": "uint32", "y": "uint64", "13__nv_bfloat16": "bf16", "6__half": "half"}
    return [m.group(1) or {"0": "false", "1": "true"}.get(m.group(2)) or names[m.group(0)]
            for m in re.finditer(r"Li(\d+)E?|Lb([01])E?|13__nv_bfloat16|6__half|[fdjy]", mangled)]


def ptxas_entries(log: str) -> list:
    """One line for each kernel in an ``nvcc -Xptxas=-v`` report: its name and template arguments,
    registers a thread and spilled bytes."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            if m is None:
                name = mangled
            else:
                end = m.end() + int(m.group(1))
                args = re.match(r"I(.*?)EE", mangled[end:])
                args = "" if args is None else ",".join(template_args(args.group(1)))
                name = mangled[m.end():end] + (f"<{args}>" if args else "")
        spilled = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spilled:
            spill = f", spills {spilled.group(1)}/{spilled.group(2)} bytes stored/loaded"
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out.append(f"{name}: {used.group(1)} registers{spill}")
            name, spill = "?", ""
    return out


def check_close(name: str, got, ref, atol: float, rtol: float, quiet: bool = False, finite: bool = True) -> float:
    """Max |got - ref|; raises unless |got - ref| <= atol + rtol |ref| everywhere.  ``quiet``
    prints only a failure; ``finite=False`` lets the two agree on infinities (equal entries
    count as no error)."""
    import torch

    got, ref = got.detach().double(), ref.detach().double()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if finite and not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    same = got == ref
    err = torch.where(same, torch.zeros_like(got), (got - ref).abs())
    over = torch.where(same, torch.full_like(got, -math.inf), (err - (atol + rtol * ref.abs())).nan_to_num(nan=math.inf))
    excess = float(over.max())
    max_err = float(err.max())
    if not quiet or excess > 0:
        print(f"  {name}: max_abs_err {max_err:.3e} (limit atol {atol:.1e} + rtol {rtol:.1e}·|ref|)"
              f" {'ok' if excess <= 0 else 'FAIL'}")
    if excess > 0:
        worst = int(over.argmax())
        where = tuple(int(i) for i in np.unravel_index(worst, tuple(ref.shape)))
        print(f"    worst entry {where}: got {float(got.flatten()[worst])!r}, ref {float(ref.flatten()[worst])!r}")
        raise AssertionError(f"{name}: outside tolerance (max_abs_err {max_err:.3e}) at {where}")
    return max_err


def check_equal(name: str, got, ref) -> int:
    """Max |got - ref| over integer paths; raises unless they are equal."""
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    diff = (got.long() - ref.long()).abs()
    mismatches, max_err = int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0
    print(f"  {name}: {mismatches} of {ref.numel()} path entries differ, max_abs_err {max_err} (limit 0)")
    if mismatches:
        raise AssertionError(f"{name}: paths differ from the plain version")
    return max_err


def stable_coeffs(rng, c: int, order: int):
    """Normalized (a, b) of the JAX IIR tests' kind: a = [1, 0.2 N(0,1) / k]."""
    a_tail = 0.2 * rng.standard_normal((c, order)) / np.arange(1, order + 1)
    a = np.concatenate([np.ones((c, 1)), a_tail], axis=1).astype(np.float32)
    b = (0.3 * rng.standard_normal((c, order + 1))).astype(np.float32)
    return a, b


def alignment_inputs(rng, b: int, t: int, v: int, l_max: int, dev):
    """Random emissions with varied lengths and repeated tokens: input lengths from 2 l_max + 2
    frames (all T frames where T is shorter) to T."""
    import torch

    lp = torch.log_softmax(torch.as_tensor(rng.standard_normal((b, t, v)), dtype=torch.float32), -1)
    tgt = rng.integers(1, v, (b, l_max)).astype(np.int64)
    tgt[::3, 1] = tgt[::3, 0]  # repeated tokens forbid the skip
    il = rng.integers(min(2 * l_max + 2, t), t + 1, (b,))
    tl = rng.integers(1, l_max + 1, (b,))
    return [torch.as_tensor(a).to(dev) for a in (lp, tgt, il, tl)]


def ctc_collapse(path: np.ndarray, blank: int = 0) -> list:
    out, prev = [], None
    for tok in path.tolist():
        if tok != prev and tok != blank:
            out.append(tok)
        prev = tok
    return out


def make_inputs(dev):
    """bench.py's inputs, from the same seed."""
    import torch

    import audio_tpu_torch.functional as F
    from audio_tpu_torch._internal.windows import hann_window

    rng = np.random.default_rng(0)
    wav = torch.as_tensor(rng.standard_normal((B, T)).astype(np.float32) * 0.1, device=dev)
    targets = torch.as_tensor(rng.integers(1, V, size=(B, L)).astype(np.int32), device=dev)
    proj = torch.as_tensor(rng.standard_normal((N_MELS, V)).astype(np.float32) * 0.1, device=dev)
    window = hann_window(N_FFT, device=dev)
    fb = F.melscale_fbanks(N_FFT // 2 + 1, 0.0, 8000.0, N_MELS, SR, device=dev)
    return wav, targets, proj, window, fb


def profile_chain(step, step_ms: float, reps: int = 3) -> dict:
    """Device time by kernel over ``reps`` chain steps (torch.profiler), and the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rows = device_kernel_rows(prof, reps)
    busy = sum(r[1] for r in rows)
    print(f"  profile: device busy {busy:.3f} ms per step against a {step_ms:.3f} ms step without the profiler "
          f"(idle share {1 - busy / step_ms:.3f}); by kernel:")
    for name, ms, count in rows[:12]:
        print(f"    {ms:8.3f} ms  x{count:g}  {name[:100]}")
    return {"busy_ms": busy, "idle_share": 1 - busy / step_ms, "by_kernel": rows}


def chain(wav, targets, proj, window, fb):
    """bench.py's chain through the port's public functions."""
    import torch

    import audio_tpu_torch.functional as F

    filtered = F.lowpass_biquad(wav, SR, CUTOFF)
    mel = F.mel_spectrogram(
        filtered, fb=fb, window=window, n_fft=N_FFT, hop_length=HOP,
        win_length=N_FFT, power=2.0, normalized=False, time_major=True,
    )
    emissions = torch.log_softmax(torch.log1p(mel) @ proj, dim=-1)
    paths, scores = F.forced_align(emissions, targets)
    return filtered, mel, emissions, paths, scores


# ------------------------------------------------------------------ slice 2: kernels K5-K8
def sum_tol(base: float, depth: int) -> float:
    """Tolerance of an f32 sum of ``depth`` terms taken in another order: the JAX kernel
    tests' bound (stated at depths up to 64), grown with the square root of the depth."""
    return base * max(1.0, math.sqrt(depth / 64.0))


def check_row_topk(name: str, got, ref, tol: float, quiet: bool = False, finite: bool = True) -> float:
    """K6: lse, blank and values within ``tol`` (atol + rtol), indices equal, ties included;
    ``finite=False`` for rows with -inf candidates, whose values agree on -inf."""
    err = 0.0
    for part, g, r in zip(("lse", "blank", "vals"), got[:3], ref[:3]):
        err = max(err, check_close(f"{name} {part}", g, r, tol, tol, quiet=quiet, finite=finite))
    if not quiet or not bool((got[3] == ref[3]).all()):
        check_equal(f"{name} idx", got[3], ref[3])
    return err


def check_join_topk(name: str, got, act, w, b, blank: int, k: int, tol: float) -> float:
    """K5 against the plain product.  The two sum in different orders, so an index may
    differ where the plain values at neighbouring ranks lie within the tolerance; the
    logit the kernel picked must still be within tolerance of the plain value at its rank.
    """
    import torch

    x = act.float() @ w.float() + b.float()  # (N, V) plain logits
    lse = torch.logsumexp(x[:, : blank + 1], dim=-1)
    ref_vals, ref_idx = torch.sort(x[:, :blank], dim=-1, descending=True, stable=True)
    ranked = ref_vals[:, : k + 1] if blank > k else torch.cat(
        [ref_vals[:, :k], torch.full_like(ref_vals[:, :1], -math.inf)], dim=1)
    ref_vals, ref_idx = ref_vals[:, :k], ref_idx[:, :k]
    err = check_close(f"{name} lse", got[0], lse, tol, tol)
    err = max(err, check_close(f"{name} blank", got[1], x[:, blank], tol, tol))
    err = max(err, check_close(f"{name} vals", got[2], ref_vals, tol, tol))
    picked = x.gather(1, got[3].long())
    err = max(err, check_close(f"{name} plain logit at the kernel's index", picked, ref_vals, tol, tol))
    limit = tol + tol * ref_vals.abs()
    gap_up = torch.cat([torch.full_like(ref_vals[:, :1], math.inf), ref_vals[:, :-1] - ref_vals[:, 1:]], dim=1)
    gap_down = ranked[:, :k] - ranked[:, 1 : k + 1]
    clear = (gap_up > limit) & (gap_down > limit)
    differ = got[3].long() != ref_idx
    print(f"  {name} idx: {int(differ.sum())} of {differ.numel()} indices differ from the plain version, "
          f"{int((differ & clear).sum())} of them at a rank whose neighbours are more than the tolerance away "
          "(limit 0)")
    if bool((differ & clear).any()):
        raise AssertionError(f"{name}: top-k indices differ from the plain version beyond near-ties")
    return err


def slice2_kernel_inputs(rng, dev, n: int, d: int, v: int, hd: int, dtype):
    """Seeded inputs of K5-K8 at one shape: activations as the joiner makes them
    (ReLU of a sum), Xavier-scaled weights, the blank bias raised by 4.  ``w`` and
    ``lstm["w_p2g"]`` lie row-major; ``w_linear`` and ``lstm_linear["w_p2g"]`` are the same
    matrices as the transposed views of (out, in) tensors, as the search passes a Linear's
    weight."""
    import torch

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dt)

    act = t(np.maximum(rng.standard_normal((n, d)) + rng.standard_normal((n, d)), 0.0))
    w = t(rng.standard_normal((d, v)) / math.sqrt(d))
    b = np.zeros((v,), np.float32)
    b[-1] = 4.0
    b = t(b + 0.1 * rng.standard_normal((v,)))
    logits = (act.float() @ w.float() + b.float()).to(dtype)
    tgt = torch.as_tensor(rng.integers(0, v, (n,)).astype(np.int32), device=dev)
    lstm = dict(
        gx=t(0.5 * rng.standard_normal((n, 4 * hd))), h=t(0.5 * rng.standard_normal((n, hd))),
        c=t(0.5 * rng.standard_normal((n, hd))), w_p2g=t(rng.standard_normal((hd, 4 * hd)) / math.sqrt(hd)),
        g_scale=t(1.0 + 0.1 * rng.standard_normal((4 * hd,))), g_bias=t(0.1 * rng.standard_normal((4 * hd,))),
        c_scale=t(1.0 + 0.1 * rng.standard_normal((hd,))), c_bias=t(0.1 * rng.standard_normal((hd,))),
    )
    lstm_linear = dict(lstm, w_p2g=lstm["w_p2g"].t().contiguous().t())
    return dict(act=act, w=w, w_linear=w.t().contiguous().t(), b=b, logits=logits, tgt=tgt, lstm=lstm,
                lstm_linear=lstm_linear)


def check_slice2_kernels(rng, dev, n: int, d: int, v: int, hd: int, k: int, dtype, label: str) -> dict:
    """Hold K5-K8 against their plain versions at one shape; returns each one's max abs error."""
    import torch

    from audio_tpu_torch.ops import cuda_lstm, cuda_rnnt_lps

    bf16 = dtype == torch.bfloat16
    inp = slice2_kernel_inputs(rng, dev, n, d, v, hd, dtype)
    blank = v - 1
    errs = {}
    # K6, K8: the kernel and the plain version read the same logits; only the order of the
    # sum of exponentials differs (JAX kernel tests: 1e-5 in f32, 1e-2 in bf16)
    tol = 1e-2 if bf16 else 1e-5
    x = inp["logits"]
    if bf16:  # force exact ties inside rows: repeated values at scattered columns
        x = x.clone()
        x[:, 1::7] = x[:, :1]
    before = dict(cuda_rnnt_lps.row_stats_route_launches)
    got = cuda_rnnt_lps.row_stats_topk(x, blank, k)
    torch.cuda.synchronize()
    if cuda_rnnt_lps.row_stats_route_launches["stream"] != before["stream"] + 1:
        raise AssertionError(f"K6 {label}: the wrapper did not launch route 'stream'")
    ref = cuda_rnnt_lps.row_stats_topk_plain(x, blank, k)
    errs["row_stats_topk"] = check_row_topk(f"K6 row_stats_topk [stream] {label}", got, ref, tol)
    # K6's routes "row" and "global" (the wrapper's past k = 32) on the same rows
    for route in ("row", "global"):
        got = cuda_rnnt_lps._row_stats_launch(route, x, blank, k)
        torch.cuda.synchronize()
        if cuda_rnnt_lps.row_stats_route_launches[route] != before[route] + 1:
            raise AssertionError(f"K6 {label}: route {route!r} was not counted")
        check_row_topk(f"K6 row_stats_topk [{route}] {label}", got, ref, tol)
    got = cuda_rnnt_lps.lattice_row_stats(x, inp["tgt"], blank)
    torch.cuda.synchronize()
    ref = cuda_rnnt_lps.lattice_row_stats_plain(x, inp["tgt"], blank)
    errs["lattice_row_stats"] = max(check_close(f"K8 lattice_row_stats {label} {part}", g, r, tol, tol)
                                    for part, g, r in zip(("lse", "blank", "label"), got, ref))
    # K5: JAX kernel tests 1e-5 in f32 and 2e-2 in bf16; the f32 sum over D in another order
    # both weight layouts: row-major (the FP32 pipes) and a Linear's (bf16: the tensor cores);
    # the error kept is the Linear layout's, which the search uses
    tol = 2e-2 if bf16 else sum_tol(1e-5, d)
    for layout, w in (("row-major W", inp["w"]), ("Linear W", inp["w_linear"])):
        route = cuda_rnnt_lps.join_route(dtype, d, k, layout == "Linear W")
        got = cuda_rnnt_lps.join_stats_topk(inp["act"], w, inp["b"], blank, k)
        torch.cuda.synchronize()
        errs["join_stats_topk"] = check_join_topk(f"K5 join_stats_topk {label}, {layout} [{route}]", got,
                                                  inp["act"], w, inp["b"], blank, k, tol)
    if bf16 and d % 8 == 0:
        # the wmma route, which the wgmma route took these shapes from, on the same inputs
        check_join_route("wmma", f"K5 join_stats_topk {label}, Linear W", inp["act"], inp["w_linear"], inp["b"],
                         blank, k)
    # K7: JAX kernel tests 1e-5 in f32 and 2e-2 in bf16 (the outputs round to bf16)
    tol = 2e-2 if bf16 else sum_tol(1e-5, hd)
    ref = cuda_lstm.lstm_gate_step_plain(**inp["lstm"], eps=1e-3)
    for layout, ls in (("row-major W", inp["lstm"]), ("Linear W", inp["lstm_linear"])):
        route = cuda_lstm.kernel_route(dtype, hd, cuda_lstm.weight_layout(ls["w_p2g"]))
        got = cuda_lstm.lstm_gate_step(**ls, eps=1e-3)
        torch.cuda.synchronize()
        errs["lstm_gate_step"] = max(
            check_close(f"K7 lstm_gate_step {label}, {layout} [{route}] {part}", g.float(), r.float(), tol, tol)
            for part, g, r in zip(("h", "c"), got, ref))
    if bf16 and hd % 16 == 0:
        # the wmma route, which the wgmma route took H 64 and 512 from, on the same inputs
        check_lstm_route("wmma", f"K7 lstm_gate_step {label}, Linear W", inp["lstm_linear"], ref)
    return errs


def check_lstm_route(route: str, label: str, inputs: dict, ref) -> float:
    """One launch of K7 on ``route`` against the plain version's (h', c') ``ref`` (bf16 2e-2, the JAX
    kernel tests' tolerance); the route's launch counter must move by one."""
    import torch

    from audio_tpu_torch.ops import cuda_lstm

    before = cuda_lstm.route_launches[route]
    got = cuda_lstm._launch(route, **inputs, eps=1e-3)
    torch.cuda.synchronize()
    if cuda_lstm.route_launches[route] != before + 1:
        raise AssertionError(f"{label}: the {route} route's counter did not move")
    return max(check_close(f"{label} [{route}] {part}", g.float(), r.float(), 2e-2, 2e-2)
               for part, g, r in zip(("h", "c"), got, ref))


def check_lstm_wgmma(rng, dev) -> float:
    """K7 on its "wgmma" route (bf16, W in a Linear's layout) against the plain version (JAX kernel
    tests, bf16: 2e-2): N 1, 63, 65 and 5121 (off and past the 128-row tile) by H 64, 256 and 512
    (clusters of 1, 4 and 8 blocks), then the main shape, twice: the same bits.  Returns the main
    shape's max abs error."""
    import torch

    from audio_tpu_torch.ops import cuda_lstm

    main = (RNNT_S * RNNT_BEAM, RNNT_H)
    err = 0.0
    for n, hd in [(n, hd) for hd in (64, 256, 512) for n in (1, 63, 65, 5121)] + [main]:
        ls = slice2_kernel_inputs(rng, dev, n, 8, 33, hd, torch.bfloat16)["lstm_linear"]
        route = cuda_lstm.kernel_route(torch.bfloat16, hd, cuda_lstm.weight_layout(ls["w_p2g"]))
        before = cuda_lstm.route_launches["wgmma"]
        got = cuda_lstm.lstm_gate_step(**ls, eps=1e-3)
        torch.cuda.synchronize()
        if route != "wgmma" or cuda_lstm.route_launches["wgmma"] != before + 1:
            raise AssertionError(f"K7 (N {n}, H {hd}) did not run on the wgmma route ({route})")
        ref = cuda_lstm.lstm_gate_step_plain(**ls, eps=1e-3)
        e = max(check_close(f"K7 lstm_gate_step [wgmma] (N {n}, H {hd}) {part}", g.float(), r.float(), 2e-2, 2e-2)
                for part, g, r in zip(("h", "c"), got, ref))
        if (n, hd) == main:
            err = e
            again = cuda_lstm.lstm_gate_step(**ls, eps=1e-3)
            torch.cuda.synchronize()
            same = [torch.equal(x, y) for x, y in zip(got, again)]
            print(f"  K7 bits (N {n}, H {hd}): h', c' equal over two runs: {same}")
            if not all(same):
                raise AssertionError(f"K7: two runs gave different bits {same}")
    return err


def check_join_route(route: str, label: str, act, w, b, blank: int, k: int) -> float:
    """One launch of K5 on ``route`` against the plain product (check_join_topk, bf16: 2e-2);
    the route's launch counter must move by one."""
    import torch

    from audio_tpu_torch.ops import cuda_rnnt_lps

    outs = cuda_rnnt_lps._stats_outputs(act.shape[:-1], k, act.device)
    before = cuda_rnnt_lps.join_route_launches[route]
    cuda_rnnt_lps._join_launch(route, act, w, b, blank, k, outs)
    torch.cuda.synchronize()
    if cuda_rnnt_lps.join_route_launches[route] != before + 1:
        raise AssertionError(f"{label}: the {route} route's counter did not move")
    return check_join_topk(f"{label} [{route}]", outs, act, w, b, blank, k, 2e-2)


def check_join_wmma(rng, dev) -> None:
    """K5 on its "wmma" route, which join_route gives bf16 with W in a Linear's layout and k past
    the wgmma route's 32, through the public wrapper at k 33, 100 and 256 (the kernel's limit),
    N off the 64-row block, the blank at V - 1 and inside V, D 64 and 1024; tolerances of
    check_join_topk (bf16: 2e-2)."""
    import torch

    from audio_tpu_torch.ops import cuda_rnnt_lps

    for n, d, v, blank, k in ((70, RNNT_D, RNNT_V, RNNT_BLANK, 33), (1, 512, 1000, 500, 100),
                              (130, 64, 300, 299, 256)):
        inp = slice2_kernel_inputs(rng, dev, n, d, v, 8, torch.bfloat16)
        act, w, b = inp["act"], inp["w_linear"], inp["b"]
        route = cuda_rnnt_lps.join_route(act.dtype, d, k, True)
        before = cuda_rnnt_lps.join_route_launches["wmma"]
        got = cuda_rnnt_lps.join_stats_topk(act, w, b, blank, k)
        torch.cuda.synchronize()
        if route != "wmma" or cuda_rnnt_lps.join_route_launches["wmma"] != before + 1:
            raise AssertionError(f"K5 (N {n}, D {d}, V {v}, k {k}) did not run on the wmma route ({route})")
        check_join_topk(f"K5 join_stats_topk [wmma] (N {n}, D {d}, V {v}, blank {blank}, k {k})", got, act, w, b,
                        blank, k, 2e-2)


def check_join_wgmma(rng, dev) -> float:
    """K5 on its "wgmma" route (bf16, W in a Linear's layout) against the plain product: N around
    the 128-row block and the column split (1, 40, 63, 65, 5120, 5121), V 33 to 4097, the blank at
    V - 1 and inside V, k 1, 10 and 32 (the route's limit).  Tolerances of check_join_topk (JAX
    kernel tests, bf16: 2e-2).  Row 0 of N 1 and of the main shape holds exact ties (a zero
    activation row, so its logits are the bias, raised by 1 at every 401st column, so that the
    k winners lie in several column splits: 8 at N 1, 3 at the main shape): its indices must be
    the plain version's, the lowest tied columns first.  The main shape also runs on the wmma
    route, which it replaced.  Phase 15's search shape (N 160, D 256, V 1024 with no column tail,
    blank 1023, k 10) with its ties row, timed beside its bound.  Two runs of the main shape and
    of the search shape: the same bits.  Returns the main shape's max abs error."""
    import torch

    from audio_tpu_torch.ops import cuda_rnnt_lps

    main = (RNNT_S * RNNT_BEAM, RNNT_D, RNNT_V, RNNT_BLANK, RNNT_BEAM)
    conformer = (CF_SEARCH_B * CF_BEAM, CF_JOINER_D, CF_V, CF_V - 1, CF_BEAM)
    err = 0.0
    for n, d, v, blank, k in ((1, RNNT_D, RNNT_V, RNNT_BLANK, RNNT_BEAM), (40, RNNT_D, RNNT_V, RNNT_BLANK, RNNT_BEAM),
                              (63, RNNT_D, 33, 32, 1), (65, RNNT_D, RNNT_V, 4000, RNNT_BEAM),
                              (70, 64, 300, 299, 32), (40, RNNT_D, RNNT_V, 2000, 1),
                              (5121, RNNT_D, RNNT_V, RNNT_BLANK, 1), conformer, main):
        inp = slice2_kernel_inputs(rng, dev, n, d, v, 8, torch.bfloat16)
        act, w, b = inp["act"], inp["w_linear"], inp["b"]
        ties = n == 1 or (n, d, v, blank, k) in (main, conformer)
        if ties:
            act[0] = 0
            b[:blank:401] = b.max() + 1
        route = cuda_rnnt_lps.join_route(act.dtype, d, k, True)
        before = cuda_rnnt_lps.join_route_launches["wgmma"]
        got = cuda_rnnt_lps.join_stats_topk(act, w, b, blank, k)
        torch.cuda.synchronize()
        if route != "wgmma" or cuda_rnnt_lps.join_route_launches["wgmma"] != before + 1:
            raise AssertionError(f"K5 (N {n}, D {d}, V {v}, k {k}) did not run on the wgmma route ({route})")
        label = f"K5 join_stats_topk [wgmma] (N {n}, D {d}, V {v}, blank {blank}, k {k})"
        e = check_join_topk(label, got, act, w, b, blank, k, 2e-2)
        if ties:
            ref = cuda_rnnt_lps.join_stats_topk_plain(act[:1], w, b, blank, k)
            check_equal(f"{label}: row 0 of exact ties, indices", got[3][:1].cpu(), ref[3].cpu())
        if (n, d, v, blank, k) == main:
            err = e
            check_join_route("wmma", f"K5 join_stats_topk (N {n}, D {d}, V {v}, blank {blank}, k {k})", act, w, b,
                             blank, k)
        if (n, d, v, blank, k) in (main, conformer):
            again = cuda_rnnt_lps.join_stats_topk(act, w, b, blank, k)
            torch.cuda.synchronize()
            same = [torch.equal(x, y) for x, y in zip(got, again)]
            print(f"  K5 bits (N {n}, D {d}, V {v}): lse, blank, values, indices equal over two runs: {same}")
            if not all(same):
                raise AssertionError(f"K5: two runs gave different bits {same}")
        if (n, d, v, blank, k) == conformer:
            ms = cuda_ms(lambda: cuda_rnnt_lps.join_stats_topk(act, w, b, blank, k), 50)
            bound = bound_ms(2 * (n * d + d * v + v) + n * (4 + 4 + k * 8), 2 * n * d * v, PEAK_BF16_PER_S)
            print(f"  {label}, phase 15's search shape: {ms:.4f} ms a launch, bound {bound[0]:.4f} ms "
                  f"({bound[1]})")
    return err


# ------------------------------------------------------------------ slice 3: kernels K9 and K4
def attention_inputs(rng, dev, b: int, h: int, tq: int, tk: int, dh: int, dtype, masked_row: bool = False):
    """Seeded q (pre-scaled), k, v in the model's layout, (T, B, H * dh) seen as (B, H, T, dh);
    a banded 0 / -1e8 mask; key padding on two batch entries; the cotangent of the output."""
    import torch

    def t(shape, scale=1.0):
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * scale, device=dev).to(dtype)
        return x.reshape(shape[0], b, h, dh).permute(1, 2, 0, 3)

    # past dh = 64 the cotangent shrinks so that dO V^T, which the backward rounds to the
    # inputs' type inside dS, keeps the scale it has at the depth the tolerances were stated for
    q, k, v = t((tq, b, h * dh), dh ** -0.5), t((tk, b, h * dh)), t((tk, b, h * dh))
    w = t((tq, b, h * dh), min(1.0, (64 / dh) ** 0.5))
    rows, cols = np.arange(tq)[:, None], np.arange(tk)[None, :]
    mask = np.where(np.abs(rows * tk // tq - cols) <= max(tk // 4, 8), 0.0, -1e8).astype(np.float32)
    if masked_row:
        mask[tq // 2] = -1e8
    kb = np.zeros((b, tk), np.float32)
    kb[0, -3:] = -1e8
    kb[b - 1, -1:] = -1e8
    return q, k, v, torch.as_tensor(mask, device=dev), torch.as_tensor(kb, device=dev), w


def attention_f64(q, k, v, mask_bias, key_bias):
    """The attention of K9 with every step in float64 (inputs cast): the reference that both the
    kernel and the plain version round away from."""
    import torch

    scores = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double())
    scores = scores + mask_bias.double()[None, None] + key_bias.double()[:, None, None, :]
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v.double())


def attention_outputs(fn, q, k, v, mask, kb, w, dtype=None):
    """[O, dQ, dK, dV] of ``fn`` on q, k, v cast to ``dtype`` (their own if None), the cotangent ``w``."""
    import torch

    with torch.enable_grad():
        leaves = [t.detach().to(dtype or t.dtype).requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, mask, kb)
        return [out.detach(), *torch.autograd.grad(out, leaves, w.to(dtype or w.dtype))]


def check_attention(rng, dev, shape, dtype, label: str, masked_row: bool = False, f64: bool = False) -> dict:
    """K9 forward and backward against the plain version and its autograd gradient.
    Tolerances of the JAX kernel's tests: f32 1e-5 forward, 2e-5 + 2e-4 |ref| gradients;
    bf16 0.05 (both products round their inputs to bf16 on either side).  With ``f64`` the
    kernel and the plain version are each also held against the plain version in float64 on
    the same inputs, at the same tolerance: which of the two a miss comes from."""
    import torch

    from audio_tpu_torch.ops import cuda_attention

    bf16 = dtype == torch.bfloat16
    label = f"{label} [{cuda_attention.kernel_route(dtype, *shape[2:])} route]"
    inputs = attention_inputs(rng, dev, *shape, dtype, masked_row)
    got = attention_outputs(cuda_attention.emformer_attention, *inputs)
    torch.cuda.synchronize()
    ref = attention_outputs(cuda_attention.emformer_attention_plain, *inputs)
    fwd_tol, (g_atol, g_rtol) = (0.05, (0.05, 0.05)) if bf16 else (1e-5, (2e-5, 2e-4))
    names = ("forward", "backward dq", "backward dk", "backward dv")
    if f64:
        exact = attention_outputs(attention_f64, *inputs, dtype=torch.float64)
        for who, outs in (("kernel", got), ("plain version", ref)):
            for name, g, r in zip(names, outs, exact):
                tol = (fwd_tol, fwd_tol) if name == "forward" else (g_atol, g_rtol)
                check_close(f"K9 {name} {label}: the {who} against float64", g.double(), r, *tol)
    fwd = check_close(f"K9 forward {label}", got[0].float(), ref[0].float(), fwd_tol, fwd_tol)
    bwd = max(check_close(f"K9 {name} {label}", g.float(), r.float(), g_atol, g_rtol)
              for name, g, r in zip(names[1:], got[1:], ref[1:]))
    return {"fwd": fwd, "bwd": bwd}


def poison_free_memory(dev) -> None:
    """Fills 2 GB of device memory with NaN and frees it to the caching allocator, so that the
    next allocations (outputs and scratch) start as NaN: a kernel that reads a word it did not
    write shows."""
    import torch

    junk = [torch.full((1 << 26,), float("nan"), device=dev) for _ in range(8)]
    torch.cuda.synchronize()
    del junk


def check_attention_bits(rng, dev, shape, label: str, poison: bool = False) -> None:
    """K9 forward and backward twice on the same bf16 inputs: O, dQ, dK and dV must be the same bits
    (no floating-point atomics, a fixed order of every sum).  With ``poison`` the free device memory
    is filled with NaN before the second run."""
    import torch

    from audio_tpu_torch.ops import cuda_attention

    inputs = attention_inputs(rng, dev, *shape, torch.bfloat16)
    runs = []
    for i in range(2):
        if poison and i == 1:
            poison_free_memory(dev)
        runs.append(attention_outputs(cuda_attention.emformer_attention, *inputs))
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    after = ", the second on NaN-filled memory" if poison else ""
    print(f"  K9 bits {label}: O, dQ, dK, dV equal over two runs{after}: {same}")
    if not all(same):
        raise AssertionError(f"K9 {label}: two runs gave different bits {same}")


def check_iir(rng, dev, b: int, c: int, t: int, order: int, label: str, a_tail=None) -> float:
    """K4 in both directions against its plain version, at K1's tolerance (the sequential
    recurrence against the blocked Toeplitz product), on the route kernel_route names, whose
    launch counter must move; the coefficients ``a_tail`` (C, order) or stable_coeffs'."""
    import torch

    from audio_tpu_torch.ops import cuda_iir

    if a_tail is None:
        a, _ = stable_coeffs(rng, c, order)
        a_tail = torch.as_tensor(a[:, 1:].copy(), device=dev)
    x = torch.as_tensor(rng.standard_normal((b, c, t)).astype(np.float32) * 0.1, device=dev)
    route = cuda_iir.kernel_route(order)
    err = 0.0
    for reverse in (False, True):
        before = cuda_iir.iir_route_launches[route]
        got = cuda_iir.iir_allpole(x, a_tail, reverse=reverse)
        torch.cuda.synchronize()
        if cuda_iir.iir_route_launches[route] != before + 1:
            raise AssertionError(f"K4 {label}: the {route} route's counter did not move")
        err = max(err, check_close(f"K4 iir [{route}] {label}{', reversed' if reverse else ''}", got,
                                   cuda_iir.iir_plain(x, a_tail, reverse=reverse), 2e-4, 1e-4))
    return err


def check_iir_routes(rng, dev) -> None:
    """K4's "chunked" route (order <= 16) at orders 1, 2, 8, 12 and 16, a signal shorter than one
    chunk (20 samples) and one that is no multiple of a chunk and spans passes (3001), with the plan
    that the card makes held against its plain version (float64, cast: 1e-6 of each table's peak);
    a resonant filter, poles at |z| = 0.977 (a 1 kHz resonance at 16 kHz) over 16000 samples; the
    "serial" route at orders 17 and 128.  Tolerances of check_iir."""
    import torch

    from audio_tpu_torch.ops import cuda_iir
    from audio_tpu_torch.ops.iir import chunk_plan

    for order in (1, 2, 8, 12, 16):
        a, _ = stable_coeffs(rng, 2, order)
        a_tail = torch.as_tensor(a[:, 1:].copy(), device=dev)
        plan = cuda_iir.chunk_plan_on_device(a_tail)
        torch.cuda.synchronize()
        ref = chunk_plan(a_tail.cpu().double())
        check_close(f"K4 chunk plan, order {order}", plan.cpu(), ref, 1e-6 * float(ref.abs().max()), 0.0)
        for b, t in ((5, 20), (9, 3001)):
            check_iir(rng, dev, b, 2, t, order, f"order {order} ({b}x2x{t})", a_tail)
    r, theta = 0.977, 2 * math.pi * 1000 / SR
    resonant = torch.tensor([[-2 * r * math.cos(theta), r * r]], dtype=torch.float32, device=dev)
    check_iir(rng, dev, 64, 1, T, 2, f"poles at |z| = {r} (64x1x{T})", resonant)
    for b, c, t, order in ((7, 2, 1500, 17), (5, 2, 700, 128)):
        check_iir(rng, dev, b, c, t, order, f"order {order} ({b}x{c}x{t})")


def check_lfilter(rng, dev, b: int, c: int, t: int, a_norm, b_norm, label: str, quiet: bool = False) -> float:
    """K1 through ``lfilter_fused`` against ``lfilter_plain`` (the FIR stage, then the recurrence
    in time order or as blocked Toeplitz products: the JAX IIR tests' long-signal tolerance,
    2e-4 + 1e-4 |ref|), on the route ``lfilter_route`` names, whose launch counter must move."""
    import torch

    from audio_tpu_torch.ops import cuda_iir

    x = torch.as_tensor(rng.standard_normal((b, c, t)).astype(np.float32), device=dev)
    route = cuda_iir.lfilter_route(a_norm.shape[1], b_norm.shape[1])
    before = cuda_iir.lfilter_route_launches[route]
    got = cuda_iir.lfilter_fused(x, a_norm, b_norm)
    torch.cuda.synchronize()
    if cuda_iir.lfilter_route_launches[route] != before + 1:
        raise AssertionError(f"K1 {label}: the {route} route's counter did not move")
    return check_close(f"K1 lfilter [{route}] {label}", got, cuda_iir.lfilter_plain(x, a_norm, b_norm), 2e-4, 1e-4,
                       quiet=quiet)


def check_lfilter_routes(rng, dev) -> None:
    """K1's "chunked" route (order <= 16, any pb) at orders 1, 2, 8, 12 and 16 by pb 1, 3, order + 1,
    17 and 129, C 1 and 3, T 1, 31, 1000 and 2100 (below a chunk, inside a pass, across two passes:
    the FIR history crosses chunk and pass boundaries); poles at |z| = 0.977 over 16000 samples; the
    "serial" route at orders 17 and 128.  Tolerances of check_lfilter."""
    import torch

    def coeffs(c, order, pb):
        a, _ = stable_coeffs(rng, c, order)
        b = (0.3 * rng.standard_normal((c, pb))).astype(np.float32)
        return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)

    for order in (1, 2, 8, 12, 16):
        for pb in sorted({1, 3, order + 1, 17, 129}):
            err = 0.0
            for c in (1, 3):
                a, b = coeffs(c, order, pb)
                for t in (1, 31, 1000, 2100):
                    err = max(err, check_lfilter(rng, dev, 3, c, t, a, b, f"order {order}, pb {pb} (3x{c}x{t})",
                                                 quiet=True))
            print(f"  K1 lfilter [chunked] order {order}, pb {pb}: C 1 and 3 by T 1, 31, 1000, 2100: max_abs_err "
                  f"{err:.3e} (limit atol 2.0e-04 + rtol 1.0e-04·|ref|) ok")
    r, theta = 0.977, 2 * math.pi * 1000 / SR
    resonant = torch.tensor([[1.0, -2 * r * math.cos(theta), r * r]], dtype=torch.float32, device=dev)
    b = torch.tensor([[0.3, -0.2, 0.1]], dtype=torch.float32, device=dev)
    check_lfilter(rng, dev, 64, 1, T, resonant, b, f"poles at |z| = {r} (64x1x{T})")
    for b_, c_, t_, order in ((7, 2, 1500, 17), (5, 2, 700, 128)):
        a, b = coeffs(c_, order, order + 1)
        check_lfilter(rng, dev, b_, c_, t_, a, b, f"order {order} ({b_}x{c_}x{t_})")


def check_lattice_stream(rng, dev) -> None:
    """K8's route "stream" through the wrapper, in f32 (1e-5, the JAX kernel tests') and bf16 (1e-2):
    V 1, 2, 7, 8, 9, 33, 4097 and 65537 (past the 58,112 columns of route "row"), the blank and the
    targets at 0 and V - 1, every third row's first 100 columns (all but the last at small V) -inf,
    each row start at every offset from the 16-byte grid (a view of a buffer whose first elements are
    skipped; odd V moves the offset from row to row); then the same bits over two runs."""
    import torch

    from audio_tpu_torch.ops import cuda_rnnt_lps

    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        elems = 16 // (4 if dtype == torch.float32 else 2)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for v in (1, 2, 7, 8, 9, 33, 4097, 65537):
            n = 9 if v > 5000 else 37
            x = torch.as_tensor(rng.standard_normal((n, v)).astype(np.float32) * 2.0, device=dev)
            if v > 1:
                x[::3, : min(100, v - 1)] = -math.inf
            x = x.to(dtype)
            tgt = torch.as_tensor(rng.integers(0, v, (n,)).astype(np.int32), device=dev)
            tgt[0], tgt[1] = 0, v - 1
            err = 0.0
            for offset in range(elems):
                buf = torch.empty(n * v + offset, dtype=dtype, device=dev)
                xo = buf[offset:].view(n, v)
                xo.copy_(x)
                for blank in (0, v - 1):
                    before = cuda_rnnt_lps.lattice_route_launches["stream"]
                    got = cuda_rnnt_lps.lattice_row_stats(xo, tgt, blank)
                    torch.cuda.synchronize()
                    if cuda_rnnt_lps.lattice_route_launches["stream"] != before + 1:
                        raise AssertionError("K8: the stream route's counter did not move")
                    ref = cuda_rnnt_lps.lattice_row_stats_plain(x, tgt, blank)
                    for part, g, r in zip(("lse", "blank", "label"), got, ref):
                        err = max(err, check_close(f"K8 lattice_row_stats [stream] {tag} V {v}, offset {offset}, "
                                                   f"blank {blank} {part}", g, r, tol, tol, quiet=True, finite=False))
            print(f"  K8 lattice_row_stats [stream] {tag} V {v} ({n} rows, every row start mod {elems}, blank 0 and "
                  f"V - 1, leading -inf rows): max_abs_err {err:.3e} (limit {tol:.0e} + {tol:.0e}·|ref|) ok")
    x = torch.as_tensor(rng.standard_normal((37, RNNT_V)).astype(np.float32), device=dev).to(torch.bfloat16)
    tgt = torch.as_tensor(rng.integers(0, RNNT_V, (37,)).astype(np.int32), device=dev)
    one, two = (cuda_rnnt_lps.lattice_row_stats(x[1:], tgt[1:], RNNT_BLANK) for _ in range(2))
    same = [torch.equal(a, b) for a, b in zip(one, two)]
    print(f"  K8 bits (36 rows of V {RNNT_V}, bf16, rows off the 16-byte grid): equal over two runs: {same}")
    if not all(same):
        raise AssertionError(f"K8: two runs gave different bits {same}")


def few_candidate_rows(rng, n: int, v: int):
    """Rows (n, v) whose candidates [0, v - 1) are -inf but at a few scattered columns: a third of
    the rows keep none (-inf apart from the blank), the others one to eight, some tied."""
    x = np.full((n, v), -np.inf, np.float32)
    x[:, -1] = rng.standard_normal(n)
    for r in range(n):
        if r % 3:
            cols = rng.choice(v - 1, size=min(v - 1, 1 + r % 8), replace=False)
            x[r, cols] = np.round(rng.standard_normal(len(cols)), 1)
    return x


def check_row_stats_stream(rng, dev) -> None:
    """K6's route "stream" through the wrapper, against the plain version (indices equal; lse, blank
    and values within 1e-5 in f32 and 1e-2 in bf16, the JAX kernel tests'): V 33, 4097, 58,114 and
    65,537 at k 1, 8, 10, 16 and 32 (every list capacity; 32-bit keys for bf16 below 65,536 columns,
    64-bit keys above and for f32), dense rows with exact ties and rows
    with fewer than k candidates above -inf (a third -inf apart from the blank), each row start at
    every offset from the 16-byte grid; routes "row" (within its 58,112 columns) and "global" on
    the same rows; then the same bits over two runs."""
    import torch

    from audio_tpu_torch.ops import cuda_rnnt_lps

    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        elems = 16 // (4 if dtype == torch.float32 else 2)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for v in (33, 4097, 58114, 65537):
            n = 9 if v > 5000 else 37
            dense = (2.0 * rng.standard_normal((n, v))).astype(np.float32)
            dense[:, 1::7] = dense[:, :1]
            x = torch.as_tensor(np.concatenate([dense, few_candidate_rows(rng, n, v)]), device=dev).to(dtype)
            for k in (1, 8, 10, 16, 32):
                if k > v - 1:
                    continue
                ref = cuda_rnnt_lps.row_stats_topk_plain(x, v - 1, k)
                err = 0.0
                for offset in range(elems):
                    buf = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
                    xo = buf[offset:].view(x.shape)
                    xo.copy_(x)
                    before = cuda_rnnt_lps.row_stats_route_launches["stream"]
                    got = cuda_rnnt_lps.row_stats_topk(xo, v - 1, k)
                    torch.cuda.synchronize()
                    if cuda_rnnt_lps.row_stats_route_launches["stream"] != before + 1:
                        raise AssertionError("K6: the stream route's counter did not move")
                    err = max(err, check_row_topk(f"K6 row_stats_topk [stream] {tag} V {v}, k {k}, offset {offset}",
                                                  got, ref, tol, quiet=True, finite=False))
                routes = ("row", "global") if v <= 58112 else ("global",)
                for route in routes:
                    got = cuda_rnnt_lps._row_stats_launch(route, x, v - 1, k)
                    torch.cuda.synchronize()
                    check_row_topk(f"K6 row_stats_topk [{route}] {tag} V {v}, k {k}", got, ref, tol, quiet=True,
                                   finite=False)
                print(f"  K6 row_stats_topk [stream] {tag} V {v}, k {k} ({n} dense rows, {n} with at most 8 "
                      f"candidates above -inf, a third none; every row start mod {elems}): max_abs_err {err:.3e} "
                      f"(limit {tol:.0e} + {tol:.0e}·|ref|), indices equal; routes {', '.join(routes)} on the same "
                      "rows: equal too")
    x = torch.as_tensor(rng.standard_normal((RNNT_S * RNNT_BEAM + 1, RNNT_V)).astype(np.float32),
                        device=dev).to(torch.bfloat16)
    x[:, 1::7] = x[:, :1]
    one, two = (cuda_rnnt_lps.row_stats_topk(x[1:], RNNT_BLANK, RNNT_BEAM) for _ in range(2))
    same = [torch.equal(a, b) for a, b in zip(one, two)]
    print(f"  K6 bits ({RNNT_S * RNNT_BEAM} rows of V {RNNT_V}, bf16 with ties, rows off the 16-byte grid): equal "
          f"over two runs: {same}")
    if not all(same):
        raise AssertionError(f"K6: two runs gave different bits {same}")


def check_join_few_candidates(rng, dev) -> dict:
    """K5 on rows with fewer than k candidates above -inf, on each of its three routes, against the
    plain version: indices equal to top_k's (past a row's last finite candidate the lowest -inf
    columns not yet taken) and inside [0, blank); lse, blank and values within check_join_topk's bf16
    tolerance (2e-2, -inf equal to -inf).  Biases of -inf but at three columns (in different column
    splits of the wgmma route), at one column, and at none (every candidate -inf, only the blank
    finite), at (N 70, D 64, V 300) and (N 40, D 1024, V 4097: eight column splits), k 10."""
    import torch

    from audio_tpu_torch.ops import cuda_rnnt_lps

    k, out = RNNT_BEAM, {}
    for n, d, v in ((70, 64, 300), (40, RNNT_D, RNNT_V)):
        act = torch.as_tensor(np.maximum(rng.standard_normal((n, d)), 0.0).astype(np.float32), device=dev)
        w = torch.as_tensor((rng.standard_normal((d, v)) / math.sqrt(d)).astype(np.float32), device=dev)
        act, w = act.to(torch.bfloat16), w.to(torch.bfloat16)
        w_linear = w.t().contiguous().t()
        for label, cols in (("three", [7, v // 2, v - 2]), ("one", [v // 3]), ("none", [])):
            b = np.full(v, -np.inf, np.float32)
            b[cols] = np.round(rng.standard_normal(len(cols)), 1)
            b[-1] = 4.0
            b = torch.as_tensor(b, device=dev).to(torch.bfloat16)
            ref = cuda_rnnt_lps.join_stats_topk_plain(act, w, b, v - 1, k)
            for route in ("wgmma", "wmma", "simt"):
                name = f"K5 join_stats_topk [{route}] (N {n}, D {d}, V {v}, k {k}) with {label} candidates above -inf"
                got = cuda_rnnt_lps._stats_outputs((n,), k, dev)
                before = cuda_rnnt_lps.join_route_launches[route]
                cuda_rnnt_lps._join_launch(route, act, w if route == "simt" else w_linear, b, v - 1, k, got)
                torch.cuda.synchronize()
                if cuda_rnnt_lps.join_route_launches[route] != before + 1:
                    raise AssertionError(f"{name}: the {route} route's counter did not move")
                inside = bool(((got[3] >= 0) & (got[3] < v - 1)).all())
                if not inside:
                    raise AssertionError(f"{name}: an index outside [0, {v - 1}): {got[3][0].tolist()}")
                check_equal(f"{name}, indices against top_k's", got[3].cpu(), ref[3].cpu())
                err = 0.0
                for part, g, r in zip(("lse", "blank", "vals"), got[:3], ref[:3]):
                    err = max(err, check_close(f"{name} {part}", g, r, 2e-2, 2e-2, quiet=True, finite=False))
                out[f"{route} N{n} V{v} {label}"] = dict(max_abs_err=err, row0_idx=got[3][0].tolist())
            print(f"  K5 (N {n}, D {d}, V {v}) with {label} candidates above -inf: the three routes give top_k's "
                  f"indices (row 0 {ref[3][0].tolist()}), all inside [0, {v - 1}); lse, blank and values within "
                  "2e-2 + 2e-2·|ref|")
    return out


def k3_inputs(lp, tgt, il, tl):
    """K3's arguments for emissions ``lp`` (B, T, V) and targets ``tgt`` (B, L) of lengths il and tl."""
    from audio_tpu_torch.ops.viterbi import _state_labels, _state_masks

    s = 2 * tgt.shape[1] + 1
    labels = _state_labels(tgt, 0, s)
    valid, skip = _state_masks(tgt, tl, s)
    return lp, labels, skip, valid, il, 2 * tl


def check_viterbi_route(route: str, name: str, args, ref=None) -> int:
    """K3 on ``route`` against its plain version on the same inputs: paths equal, and the route's
    counter moves."""
    import torch

    from audio_tpu_torch.ops import cuda_viterbi

    before = cuda_viterbi.route_launches[route]
    got = cuda_viterbi._launch(route, *args)
    torch.cuda.synchronize()
    if cuda_viterbi.route_launches[route] != before + 1:
        raise AssertionError(f"K3 {name}: route {route!r} was not counted")
    if ref is None:
        ref = cuda_viterbi.viterbi_paths_plain(*args)
    return check_equal(f"K3 viterbi [{route}] {name}", got, ref)


def check_viterbi_routes(rng, dev) -> None:
    """K3's two routes against the plain version, paths equal, at ragged shapes with input lengths
    below T and target lengths below L (alignment_inputs): each of the "warp" route's eight
    instances (4 or 8 states a lane, shuffled or gathered emissions, shared-memory or global
    backpointers), in every type the kernel takes, log-probs
    on a grid of 0.5 (ties of stay, skip-1 and skip-2), trellises without the CTC layout (the
    "warp" route without its fast path), float16 with -inf columns, emissions of -inf that step
    the walk off state 0, S past the "warp" route's cap, past 1024 threads and past a front that
    shared memory holds, and a non-contiguous view through the wrapper."""
    import torch

    from audio_tpu_torch.ops import cuda_viterbi

    both = ("warp", "block")
    # every instance of the "warp" route: 4 or 8 states a lane, emissions by __shfl_sync (V <= 32)
    # or gathered, backpointers in shared memory or in the global scratch
    instances = set()
    for (b_, t_, v_, l_), label in (((37, 130, 12, 9), "shared-memory backpointers"),
                                     ((5, 1500, 12, 20), "global backpointers"),
                                     ((23, 100, 40, 50), "V past a warp, shared-memory backpointers"),
                                     ((13, 300, 40, 25), "V past a warp, global backpointers"),
                                     ((19, 120, 12, 100), "8 states a lane, shared-memory backpointers"),
                                     ((11, 200, 12, 100), "8 states a lane, global backpointers"),
                                     ((15, 120, 40, 80), "V past a warp, 8 states a lane, shared-memory backpointers"),
                                     ((29, 300, 40, 100), "V past a warp, 8 states a lane"),
                                     ((17, 300, 33, 127), "S 255, the warp route's largest")):
        s_ = 2 * l_ + 1
        instance = (cuda_viterbi.warp_states_per_lane(s_), v_ <= 32, cuda_viterbi.warp_bp_on_chip(t_, s_))
        instances.add(instance)
        label = f"{label} [states a lane, shuffled, on chip: {instance}]"
        args = k3_inputs(*alignment_inputs(rng, b_, t_, v_, l_, dev))
        ref = cuda_viterbi.viterbi_paths_plain(*args)
        for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.float16):
            typed = [args[0].to(dtype)] + list(args[1:])
            ref_t = ref if dtype == torch.float32 else cuda_viterbi.viterbi_paths_plain(*typed)
            for route in both:
                check_viterbi_route(route, f"{label} ({b_}x{t_}, V {v_}, L {l_}, {dtype})", typed, ref_t)
            grid = [torch.round(args[0] * 2).div(2).to(dtype)] + list(args[1:])  # ties
            ref_g = cuda_viterbi.viterbi_paths_plain(*grid)
            for route in both:
                check_viterbi_route(route, f"{label}, ties on a grid of 0.5 ({b_}x{t_}, L {l_}, {dtype})", grid,
                                    ref_g)
    if len(instances) != 8:
        raise AssertionError(f"K3: the cases cover {sorted(instances)}, not all 8 instances of the warp route")
    # trellises without the CTC layout, which the "warp" route runs without its fast path: any label
    # at any state, valid states with holes, skips into even states, final states past the valid ones
    for (b_, t_, v_, l_), dtypes in (((37, 130, 12, 9), (torch.float32, torch.float64, torch.bfloat16, torch.float16)),
                                     ((29, 300, 40, 100), (torch.float32,))):
        lp, _, il, _ = alignment_inputs(rng, b_, t_, v_, l_, dev)
        s_ = 2 * l_ + 1
        labels = torch.as_tensor(rng.integers(0, v_, (b_, s_)), device=dev)
        valid = torch.as_tensor(rng.random((b_, s_)) < 0.8, device=dev)
        skip = torch.as_tensor(rng.random((b_, s_)) < 0.5, device=dev) & (torch.arange(s_, device=dev) >= 2)
        s_last = torch.as_tensor(rng.integers(0, s_ + 2, (b_,)), device=dev)
        for dtype in dtypes:
            args = (lp.to(dtype), labels, skip, valid, il, s_last)
            for route in both:
                check_viterbi_route(route, f"general trellis ({b_}x{t_}, V {v_}, S {s_}, {dtype})", args)
    # float16 with whole -inf columns (a target token's, the blank's) and float32 emissions of -inf
    # below the sentinel, which step the walk off state 0 (held there)
    lp, tgt, il, tl = alignment_inputs(rng, 8, 60, 7, 6, dev)
    lp = lp.clone()
    lp[0, :, int(tgt[0, 0])] = -math.inf
    lp[1, :, 0] = -math.inf
    lp[2, 0, 0] = -math.inf
    lp[3, :2, int(tgt[3, 0])] = -math.inf
    lp[3, 0, 0] = -math.inf
    for dtype in (torch.float16, torch.float32):
        args = k3_inputs(lp.to(dtype), tgt, il, tl)
        for route in both:
            check_viterbi_route(route, f"-inf columns (8x60, V 7, L 6, {dtype})", args)
    # past the warp route's cap (S 257), past 1024 threads (S 1201), and a float64 front past 48 KB of
    # shared memory (S 3201, in a global scratch): the block route, through the wrapper
    for b_, t_, l_, dtypes in ((6, 300, 128, (torch.float32, torch.bfloat16)),
                               (3, 1300, 600, (torch.float32, torch.bfloat16)), (2, 3300, 1600, (torch.float64,))):
        args = k3_inputs(*alignment_inputs(rng, b_, t_, 9, l_, dev))
        if cuda_viterbi.kernel_route(2 * l_ + 1, torch.float32) != "block":
            raise AssertionError(f"K3: S {2 * l_ + 1} should take the block route")
        for dtype in dtypes:
            typed = [args[0].to(dtype)] + list(args[1:])
            before = cuda_viterbi.route_launches["block"]
            got = cuda_viterbi.viterbi_paths(*typed)
            torch.cuda.synchronize()
            if cuda_viterbi.route_launches["block"] != before + 1:
                raise AssertionError(f"K3: S {2 * l_ + 1} did not launch the block route")
            check_equal(f"K3 viterbi [block] S {2 * l_ + 1} ({b_}x{t_}, V 9, L {l_}, {dtype})", got,
                        cuda_viterbi.viterbi_paths_plain(*typed))
    # a non-contiguous view of the log-probs, through the wrapper, on each route
    for l_ in (9, 130):
        lp, tgt, il, tl = alignment_inputs(rng, 11, 2 * l_ + 40, 12, l_, dev)
        view = lp.transpose(1, 2).contiguous().transpose(1, 2)
        args = k3_inputs(view, tgt, il, tl)
        route = cuda_viterbi.kernel_route(2 * l_ + 1, torch.float32)
        before = cuda_viterbi.route_launches[route]
        got = cuda_viterbi.viterbi_paths(*args)
        torch.cuda.synchronize()
        if view.is_contiguous() or cuda_viterbi.route_launches[route] != before + 1:
            raise AssertionError("K3: the non-contiguous case did not run as intended")
        check_equal(f"K3 viterbi [{route}] non-contiguous log_probs (11x{2 * l_ + 40}, L {l_})", got,
                    cuda_viterbi.viterbi_paths_plain(*args))


def check_fallback_routes(dev) -> None:
    """The public functions outside their kernels' limits take the plain versions on the card, as
    the JAX package computes outside its kernels' gates; each call against the same call on the CPU,
    launching no kernel (MelSpectrogram at power 1 composes the magnitude spectrogram, which K2
    takes, with the mel product: K2 alone).  Tolerances: the spectrograms 5e-4 of the peak (the JAX
    spectrogram tests'), the filters 1e-6 of the peak in float64 and 2e-4 + 1e-4 |ref| in float32
    (check_iir's), the predictor step 1e-4 in float32.  Then forced_align in bfloat16, float16 and
    float64 and at L = 600, which K3 now takes (paths equal, scores exactly), and the tanh-joiner
    search's row statistics on float16 rows, which take the plain version, and at V 58,114, past the
    columns K6's route "row" keeps in shared memory, which take K6's route "stream"."""
    import torch

    import audio_tpu_torch.functional as F
    from audio_tpu_torch.models import RNNTBeamSearch, emformer_rnnt_model
    from audio_tpu_torch.ops import cuda_rnnt_lps
    from audio_tpu_torch.transforms import MelSpectrogram

    rng = np.random.default_rng(11)
    wav = torch.as_tensor(rng.standard_normal((3, 9000)).astype(np.float32) * 0.3)
    wav64 = wav.double()
    a, b = stable_coeffs(rng, 1, 3)
    a64, b64 = torch.as_tensor(a[0], dtype=torch.float64), torch.as_tensor(b[0], dtype=torch.float64)
    taps = 130  # past the kernels' 129: the JAX package's plain route, whose blocks take T <= 256 here
    a_long = np.zeros(taps, np.float32)
    a_long[0], a_long[1], a_long[-1] = 1.0, -0.3, 0.05
    b_long = (0.1 * rng.standard_normal(taps)).astype(np.float32)
    fb = F.melscale_fbanks(201, 0.0, 8000.0, 40, SR, device="cpu")
    calls = {
        "spectrogram, n_fft 4096 (past 2048)": (
            lambda d: F.spectrogram(wav.to(d), n_fft=4096, hop_length=1024, power=2.0), 5e-4, 0.0, {}),
        "spectrogram, power 3": (
            lambda d: F.spectrogram(wav.to(d), n_fft=400, hop_length=160, power=3.0), 5e-4, 0.0, {}),
        "mel_spectrogram, hop 16 (below 32)": (
            lambda d: F.mel_spectrogram(wav.to(d), fb.to(d), n_fft=400, hop_length=16), 5e-4, 0.0, {}),
        "lfilter, float64": (lambda d: F.lfilter(wav64.to(d), a64.to(d), b64.to(d)), 1e-6, 0.0, {}),
        "filtfilt, float64": (lambda d: F.filtfilt(wav64.to(d), a64.to(d), b64.to(d)), 1e-6, 0.0, {}),
        "lfilter, 130 taps, 200 samples": (
            lambda d: F.lfilter(wav[:, :200].to(d), torch.as_tensor(a_long, device=d),
                                torch.as_tensor(b_long, device=d), clamp=False), 2e-4, 1e-4, {}),
        "MelSpectrogram, power 1": (
            lambda d: MelSpectrogram(n_fft=400, hop_length=160, n_mels=40, power=1.0, device=d)(wav.to(d)),
            5e-4, 0.0, {"power_spectrogram": 1, "power_spectrogram_fft": 1}),
    }
    for name, (call, atol, rtol, want) in calls.items():
        reset_kernel_counts()
        got = call(dev)
        torch.cuda.synchronize()
        launched = {k: c for k, c in kernel_counts().items() if c}
        if launched != want:
            raise AssertionError(f"{name}: launched {launched}, where the route launches {want}")
        ref = call(torch.device("cpu"))
        scale = float(ref.abs().max()) if rtol == 0.0 else 1.0
        check_close(f"{name} on the card against the CPU (launches {want})", got.cpu(), ref, atol * scale, rtol)
    # the search's predictor at H 640, past K7's routes: the module path, as the JAX search without its kernel
    cfg = dict(input_dim=16, encoding_dim=32, num_symbols=33, segment_length=8, right_context_length=4,
               time_reduction_input_dim=8, time_reduction_stride=4, transformer_num_heads=4, transformer_ffn_dim=64,
               transformer_num_layers=1, transformer_dropout=0.0, transformer_activation="gelu",
               transformer_left_context_length=6, transformer_max_memory_size=0,
               transformer_weight_init_scale_strategy="depthwise", transformer_tanh_on_mem=True,
               symbol_embedding_dim=640, num_lstm_layers=2, lstm_layer_norm=True, lstm_layer_norm_epsilon=1e-3,
               lstm_dropout=0.0)
    model = emformer_rnnt_model(**cfg, device=dev, generator=torch.Generator().manual_seed(5))
    tokens = torch.as_tensor(rng.integers(0, 32, (4, 3, 1)).astype(np.int32))
    state = [tuple(torch.as_tensor(rng.standard_normal((4, 3, 640)).astype(np.float32) * 0.5) for _ in range(2))
             for _ in range(2)]

    def predict(m, d):
        dec = RNNTBeamSearch(m, blank=32)
        if dec._can_fast_predict():
            raise AssertionError("a predictor of H 640 would take K7, whose routes end at H 594")
        out, new_state = dec._predict(tokens.to(d), [tuple(t.to(d) for t in hc) for hc in state])
        return [out] + [t for hc in new_state for t in hc]

    reset_kernel_counts()
    got = predict(model, dev)
    torch.cuda.synchronize()
    if kernel_counts()["lstm_gate_step"]:
        raise AssertionError("the H 640 predictor launched K7")
    ref = predict(copy.deepcopy(model).cpu(), torch.device("cpu"))
    for i, (g, r) in enumerate(zip(got, ref)):
        check_close(f"the search's predictor at H 640, output {i}, on the card against the CPU (no K7 launch)",
                    g.cpu(), r, 1e-4, 1e-4)

    # forced_align in the types past float32 and at L = 600 (S = 1201): K3 on the route kernel_route
    # names; paths equal to the CPU's, scores (gathered log-probs) exactly
    for dtype, l_, t_, want in ((torch.bfloat16, 9, 130, "warp"), (torch.float16, 9, 130, "warp"),
                                (torch.float64, 9, 130, "warp"), (torch.float32, 600, 1300, "block")):
        lp, tgt, il, tl = alignment_inputs(rng, 3, t_, 12, l_, torch.device("cpu"))
        lp = lp.to(dtype)
        reset_kernel_counts()
        paths, scores = F.forced_align(lp.to(dev), tgt.to(dev), il.to(dev), tl.to(dev))
        torch.cuda.synchronize()
        launched = {k: c for k, c in kernel_counts().items() if c}
        expect = {"viterbi": 1, f"viterbi_{want}": 1}
        if launched != expect:
            raise AssertionError(f"forced_align {dtype}, L {l_}: launched {launched}, where the route launches {expect}")
        ref_paths, ref_scores = F.forced_align(lp, tgt, il, tl)
        check_equal(f"forced_align {dtype}, L {l_} on the card against the CPU (launches {expect})", paths.cpu(),
                    ref_paths)
        check_close(f"forced_align {dtype}, L {l_} scores on the card against the CPU", scores.cpu(), ref_scores,
                    0.0, 0.0)
    # the tanh-joiner search's row statistics on float16 rows, outside K6's types (the plain version
    # on the card, no K6 launch), and at V 58,114, past the 58,112 columns K6's route "row" keeps in
    # shared memory (route "stream", which reads any V); indices and raw values exactly, lse to 1e-5
    # (the JAX kernel tests')
    dec = RNNTBeamSearch(model, blank=32)
    for dtype, v_, want in ((torch.float16, 33, {}),
                            (torch.float32, 58114, {"row_stats_topk": 1, "row_stats_topk_stream": 1}),
                            (torch.bfloat16, 58114, {"row_stats_topk": 1, "row_stats_topk_stream": 1})):
        route = cuda_rnnt_lps.row_stats_route(dtype, v_ - 1, 4)
        if route != ("stream" if want else None):
            raise AssertionError(f"row_stats_route gives {dtype} rows of V {v_} the route {route!r}")
        raw = torch.as_tensor(rng.standard_normal((3, 4, v_)).astype(np.float32) * 4).to(dtype)
        reset_kernel_counts()
        got = dec._row_stats(raw.to(dev), 4)
        torch.cuda.synchronize()
        launched = {k: c for k, c in kernel_counts().items() if c}
        if launched != want:
            raise AssertionError(f"_row_stats {dtype}, V {v_} launched {launched}, where its route launches {want}")
        ref = dec._row_stats(raw, 4)
        label = f"the tanh-joiner search's _row_stats, {dtype}, V {v_}, on the card against the CPU (launches {want})"
        check_close(f"{label}: lse", got[0].cpu(), ref[0], 1e-5, 0.0)
        check_close(f"{label}: blank logit", got[1].cpu(), ref[1], 0.0, 0.0)
        check_close(f"{label}: top-k values", got[2][0].cpu(), ref[2][0], 0.0, 0.0)
        check_equal(f"{label}: top-k indices", got[2][1].cpu(), ref[2][1])


def check_lattice_stats(rng, dev, card: str, shape, label: str) -> dict:
    """K8 as the transducer losses call it: a seeded 4-D bf16 lattice (B, T', rows, V), the blank
    raised as the joiner's, and each row's label from an int32 tensor of the lattice's leading
    shape (the full loss expands the padded targets over T', the pruned loss gathers them into
    its band).  The plain version runs a batch block at a time, so no f32 copy of the lattice
    is made.  Tolerance of the JAX kernel's bf16 tests, 1e-2; the same bits over two runs.  Also
    the kernel's time there, on its route "stream" and on the route it replaced, "row", and the bound."""
    import torch

    from audio_tpu_torch.ops import cuda_rnnt_lps

    b, t, rows, v = shape
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).mul_(2.0)
    x[..., RNNT_BLANK] += 4.0
    x = x.to(torch.bfloat16)
    if rows == TRAIN_U + 1:  # as ops/rnnt.py builds it: the targets, padded by the unused row U, over T'
        targets = torch.as_tensor(rng.integers(0, v, (b, TRAIN_U)).astype(np.int32), device=dev)
        tgt = torch.nn.functional.pad(targets, (0, 1))[:, None, :].expand(b, t, rows)
    else:  # as ops/rnnt_pruned.py builds it: one label a band slot
        tgt = torch.as_tensor(rng.integers(0, v, (b, t, rows)).astype(np.int64), device=dev)
    got = cuda_rnnt_lps.lattice_row_stats(x, tgt, RNNT_BLANK)
    torch.cuda.synchronize()
    block = 4
    ref = [torch.cat(part) for part in zip(*(cuda_rnnt_lps.lattice_row_stats_plain(x[i : i + block], tgt[i : i + block],
                                                                                    RNNT_BLANK)
                                             for i in range(0, b, block)))]
    err = max(check_close(f"K8 lattice_row_stats [stream] {label} {part}", g, r, 1e-2, 1e-2)
              for part, g, r in zip(("lse", "blank", "label"), got, ref))
    del ref
    again = cuda_rnnt_lps.lattice_row_stats(x, tgt, RNNT_BLANK)
    same = [torch.equal(a, b_) for a, b_ in zip(got, again)]
    print(f"  K8 bits {label}: equal over two runs: {same}")
    if not all(same):
        raise AssertionError(f"K8 {label}: two runs gave different bits {same}")
    n = b * t * rows
    ms = cuda_ms(lambda: cuda_rnnt_lps.lattice_row_stats(x, tgt, RNNT_BLANK), 5)
    row_ms = cuda_ms(lambda: cuda_rnnt_lps._lattice_launch("row", x, tgt, RNNT_BLANK), 5)
    # the lattice read once, tgt read and three f32 outputs written once a row
    bound = bound_ms(2 * n * v + n * (4 + 12), 3 * n * v)
    print(f"  K8 lattice_row_stats {label}: route stream {ms:.3f} ms, route row (the kernel it replaced) "
          f"{row_ms:.3f} ms (bound {bound[0]:.3f} ms by {bound[1]}) on {card}")
    return dict(err=err, ms=ms, row_ms=row_ms, bound_ms=bound[0], bound_by=bound[1])


def time_attention(rng, dev, shape, errs: dict, launches: dict) -> list:
    """The kernel table's two K9 entries at ``shape`` in bf16: each direction's time alone,
    the plain version's, the bound, and the library call's."""
    import torch
    import torch.nn.functional as nnF

    from audio_tpu_torch.ops import cuda_attention

    b, h, tq, tk, dh = shape
    q, k, v, mask, kb, w = attention_inputs(rng, dev, *shape, torch.bfloat16)
    combined = (mask[None, None] + kb[:, None, None, :]).to(torch.bfloat16)  # (B, 1, Tq, Tk)

    def directions(fn):
        """(forward ms, backward ms) of ``fn(q, k, v)``, the backward through a kept graph."""
        fwd = cuda_ms(lambda: fn(q, k, v), 20)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves)
            bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, w, retain_graph=True), 20)
        return fwd, bwd

    kernel = directions(lambda q_, k_, v_: cuda_attention.emformer_attention(q_, k_, v_, mask, kb))
    plain = directions(lambda q_, k_, v_: cuda_attention.emformer_attention_plain(q_, k_, v_, mask, kb))
    library = directions(lambda q_, k_, v_: nnF.scaled_dot_product_attention(q_, k_, v_, attn_mask=combined,
                                                                             scale=1.0))
    unit = b * h * tq * tk * dh
    tensor = 2 * b * h * tq * dh  # bytes of one bf16 (B, H, T, dh) tensor, Tq = Tk here
    stats = 2 * 4 * b * h * tq  # the saved f32 row maximum and log row sum
    masks = 4 * (tq * tk + b * tk)
    bounds = (bound_ms(4 * tensor + stats + masks, 4 * unit, PEAK_BF16_PER_S),  # q, k, v read, o written
              bound_ms(8 * tensor + stats + masks, 10 * unit, PEAK_BF16_PER_S))  # + o, dO read, dq, dk, dv written
    rows = []
    for i, (name, replaces) in enumerate((("emformer_attention_fwd", "audio_tpu/ops/pallas_attention.py:151"),
                                          ("emformer_attention_bwd", "audio_tpu/ops/pallas_attention.py:177"))):
        rows.append(dict(name=name, route="cuda", source="audio_tpu_torch/csrc/attention.cu", replaces=replaces,
                         launches=launches[name], max_abs_err=errs["fwd" if i == 0 else "bwd"], ms=kernel[i],
                         plain_ms=plain[i], bound_ms=bounds[i][0], bound_by=bounds[i][1], library_ms=library[i]))
    return rows


# ------------------------------------------------------------------ slice 2: the streaming search
def kernel_counts() -> dict:
    """The launch counters of all ten kernel entries, and of the routes of K1 to K8."""
    from audio_tpu_torch.ops import (cuda_attention, cuda_iir, cuda_lstm, cuda_rnnt_lps, cuda_spectrogram,
                                     cuda_viterbi)

    return {"lfilter": cuda_iir.launches, "iir": cuda_iir.iir_launches,
            "power_spectrogram": cuda_spectrogram.launches, "viterbi": cuda_viterbi.launches,
            "lstm_gate_step": cuda_lstm.launches, **cuda_rnnt_lps.launches, **cuda_attention.launches,
            **{f"power_spectrogram_{r}": c for r, c in cuda_spectrogram.route_launches.items()},
            **{f"join_stats_topk_{r}": c for r, c in cuda_rnnt_lps.join_route_launches.items()},
            **{f"lstm_gate_step_{r}": c for r, c in cuda_lstm.route_launches.items()},
            **{f"iir_{r}": c for r, c in cuda_iir.iir_route_launches.items()},
            **{f"lfilter_{r}": c for r, c in cuda_iir.lfilter_route_launches.items()},
            **{f"lattice_row_stats_{r}": c for r, c in cuda_rnnt_lps.lattice_route_launches.items()},
            **{f"row_stats_topk_{r}": c for r, c in cuda_rnnt_lps.row_stats_route_launches.items()},
            **{f"viterbi_{r}": c for r, c in cuda_viterbi.route_launches.items()}}


def reset_kernel_counts() -> None:
    from audio_tpu_torch.ops import (cuda_attention, cuda_iir, cuda_lstm, cuda_rnnt_lps, cuda_spectrogram,
                                     cuda_viterbi)

    for mod in (cuda_iir, cuda_spectrogram, cuda_viterbi, cuda_lstm):
        mod.launches = 0
    cuda_iir.iir_launches = 0
    for counters in (cuda_rnnt_lps.launches, cuda_attention.launches, cuda_attention.route_launches,
                     cuda_spectrogram.route_launches, cuda_rnnt_lps.join_route_launches, cuda_lstm.route_launches,
                     cuda_iir.iir_route_launches, cuda_iir.lfilter_route_launches,
                     cuda_rnnt_lps.lattice_route_launches, cuda_rnnt_lps.row_stats_route_launches,
                     cuda_viterbi.route_launches):
        for name in counters:
            counters[name] = 0


def require_launches(what: str, counts: dict, names) -> None:
    print(f"  launches in {what}: { {n: c for n, c in counts.items() if c} }")
    missing = [n for n in names if counts[n] < 1]
    if missing:
        raise AssertionError(f"{what}: kernels of the path that did not launch: {missing}")


def require_route(what: str, counts: dict, kernel: str, route: str) -> None:
    """Every launch of ``kernel`` counted in ``counts`` went to ``route``."""
    if counts[f"{kernel}_{route}"] != counts[kernel]:
        raise AssertionError(f"{what}: {kernel} launched {counts[kernel]} times, {counts[f'{kernel}_{route}']} of them "
                             f"on its {route!r} route")
    print(f"  {what}: all {counts[kernel]} launches of {kernel} on its {route!r} route")


def make_rnnt(dev, dtype, activation: str = "relu"):
    """emformer_rnnt_base(4097) with weights from seed 0 and the serving bench's blank bias, RNNT_BLANK_BIAS."""
    import torch

    from audio_tpu_torch.models import emformer_rnnt_base

    model = emformer_rnnt_base(RNNT_V, device=dev, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.joiner.linear.bias[-1] += RNNT_BLANK_BIAS
    model.joiner.activation = activation
    return model.to(dtype)


def rnnt_segments(dev, dtype, n_streams: int, n_ticks: int):
    """Feature segments (S, 20, 80) a tick, from bench_models.py's seed, and their lengths."""
    import torch

    rng = np.random.default_rng(7)
    feats = [torch.as_tensor(rng.standard_normal((n_streams, RNNT_SEG_T, RNNT_D_IN)).astype(np.float32),
                             device=dev).to(dtype) for _ in range(n_ticks)]
    return feats, torch.full((n_streams,), RNNT_SEG_T, dtype=torch.int32, device=dev)


def make_decoder(model, expansion: str = "exact"):
    from audio_tpu_torch.models import RNNTBeamSearch

    return RNNTBeamSearch(model, RNNT_BLANK, step_max_tokens=RNNT_SMT, max_tokens=RNNT_MAX_TOKENS,
                          expansion=expansion)


def run_ticks(dec, feats, lengths):
    """Consecutive ticks of ``infer_batch`` from ``init_beams`` with carried state and beams."""
    hypos, state = dec.init_beams(RNNT_BEAM, feats[0].shape[0]), None
    for f in feats:
        hypos, state = dec.infer_batch(f, lengths, RNNT_BEAM, state, hypos)
    return hypos, state


def check_beams(name: str, tokens, counts, scores, max_tokens: int = RNNT_MAX_TOKENS, blank: int = RNNT_BLANK) -> None:
    """Every live hypothesis of beams (S, K, ...) is well formed and each stream's beam is
    in ranking order."""
    import torch

    counts, scores, tokens = counts.cpu(), scores.cpu(), tokens.cpu()
    live = counts >= 0
    if not bool(live[:, 0].all()):
        raise AssertionError(f"{name}: a stream has no live top hypothesis")
    if not bool((counts <= max_tokens)[live].all()):
        raise AssertionError(f"{name}: a live count is outside [0, {max_tokens}]")
    if not bool(torch.isfinite(scores[live]).all()) or not bool((scores[live] > -1e29).all()):
        raise AssertionError(f"{name}: a live score is not finite")
    below = torch.arange(tokens.shape[-1])[None, None, :] < counts[:, :, None]
    emitted = tokens[below & live[:, :, None]]
    if not bool(((emitted >= 0) & (emitted < blank)).all()):
        raise AssertionError(f"{name}: an emitted token is outside [0, {blank})")
    key = torch.where(live, scores / (counts + 2.0), torch.tensor(-1.0e30))
    if not bool((key[:, :-1] >= key[:, 1:]).all()):
        raise AssertionError(f"{name}: a beam is not ordered by its length-normalised score")
    print(f"  {name}: {int(live.sum())} live hypotheses of {live.numel()}, counts {int(counts[live].min())}.."
          f"{int(counts[live].max())}, top-1 scores {float(scores[:, 0].min()):.3f}..{float(scores[:, 0].max()):.3f}, "
          "all well formed and in ranking order")


def compare_with_cpu(name: str, model, n_streams: int, expansion: str, counter: str) -> dict:
    """Two ticks in f32 on the card, through the kernels, against the same model on the
    CPU, through the plain versions: top-1 tokens equal, top-1 scores within 1e-3 (the
    JAX decoder tests' bound).  Returns the launch counts of the card's run."""
    import torch

    feats, lengths = rnnt_segments(next(model.parameters()).device, torch.float32, n_streams, 2)
    reset_kernel_counts()
    got, _ = run_ticks(make_decoder(model, expansion), feats, lengths)
    torch.cuda.synchronize()
    counts = kernel_counts()
    require_launches(name, counts, [counter, "lstm_gate_step"])
    check_beams(name, got.tokens, got.counts, got.scores)
    ref, _ = run_ticks(make_decoder(copy.deepcopy(model).cpu(), expansion), [f.cpu() for f in feats], lengths.cpu())
    g_counts, g_tokens, g_scores = got.counts.cpu(), got.tokens.cpu(), got.scores.cpu()
    live = ref.counts >= 0
    same = (g_counts == ref.counts) & (g_tokens == ref.tokens).all(dim=-1) & ((g_scores - ref.scores).abs() <= 1e-3)
    top1_err = float((g_scores[:, 0] - ref.scores[:, 0]).abs().max())
    print(f"  {name}: {int((same & live).sum())} of {int(live.sum())} live beams agree with the CPU run in count, "
          f"tokens and score (1e-3); top-1 score max_abs_err {top1_err:.3e}")
    if not bool(same[:, 0].all()):
        raise AssertionError(f"{name}: a stream's top-1 hypothesis differs from the CPU plain run")
    return counts


def time_tick(dec, feat, lengths, state, hypos, reps: int = 5):
    """Median ms of one ``infer_batch`` tick from a fixed carried state (CUDA events), after a warm-up."""
    import torch

    def tick():
        return dec.infer_batch(feat, lengths, RNNT_BEAM, state, hypos)

    tick()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tick()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    return statistics.median(runs), runs, tick


# ------------------------------------------------------------------ slice 3: the two gradient paths
def load_example(name: str, *parts: str):
    """An example script of the repository, loaded by path as module ``name``."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", *parts)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_train_recipe():
    """The train step's module, examples/asr/emformer_rnnt/train_torch.py, loaded by path."""
    return load_example("emformer_rnnt_train_torch", "asr", "emformer_rnnt", "train_torch.py")


def timed_steps(step, warmup: int, reps: int):
    """Median ms of ``step()`` over ``reps`` runs (CUDA events) after ``warmup`` runs; also the
    runs and every returned value."""
    import torch

    values = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        values.append(step())
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    return statistics.median(runs), runs, values


def run_train_path(recipe, model, dev, card: str, loss: str, batch: int) -> dict:
    """Path A at full width in bf16 with f32 masters, dropout on: the first step with the
    launch counters read around it, a second warm-up, five timed steps, one profiled step."""
    import torch

    name = f"train step, {loss} loss, B={batch}, bf16"
    torch.manual_seed(3)  # dropout draws from the card's default generator
    heads = None
    if loss == "pruned":
        heads = recipe.init_simple_heads(RNNT_D, RNNT_V, dev, torch.Generator().manual_seed(1))
    step = recipe.make_train_step(model.train(), loss, TRAIN_BAND, torch.bfloat16, heads=heads)
    data = recipe.synthetic_batch(np.random.default_rng(2), batch, TRAIN_T, TRAIN_RC, TRAIN_U, RNNT_V, dev)

    def one():
        with torch.enable_grad():
            return step(*data)

    enc, enc_lengths = model.transcriber(data[0], data[1])
    if enc.shape[1] != TRAIN_T // 4 or int(enc_lengths.max()) != enc.shape[1]:
        raise AssertionError(f"{name}: the encoder gives {enc.shape[1]} frames, lengths up to {int(enc_lengths.max())}; "
                             f"the kernels were held at {TRAIN_T // 4}")
    del enc
    reset_kernel_counts()
    first = one()
    torch.cuda.synchronize()
    counts = kernel_counts()
    require_launches(f"one {name}", counts, ["emformer_attention_fwd", "emformer_attention_bwd",
                                              "lattice_row_stats"])
    require_route(f"one {name}", counts, "lattice_row_stats", "stream")
    n_layers = len(model.transcriber.transformer.emformer_layers)
    if counts["emformer_attention_fwd"] != n_layers or counts["emformer_attention_bwd"] != n_layers:
        raise AssertionError(f"{name}: K9 launched {counts['emformer_attention_fwd']} forward and "
                             f"{counts['emformer_attention_bwd']} backward for {n_layers} layers")
    from audio_tpu_torch.ops import cuda_attention

    routes = dict(cuda_attention.route_launches)
    print(f"  K9 routes in one {name}: {routes}")
    if routes["wgmma_fwd"] != n_layers or routes["wgmma_bwd"] != n_layers:
        raise AssertionError(f"{name}: K9 ran {routes}, not the wgmma route once a layer each way")
    grads = [p.grad for p in step.params.values()]
    if any(g is None or g.dtype != torch.float32 or not bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError(f"{name}: a master parameter has no finite float32 gradient")
    torch.cuda.reset_peak_memory_stats()
    step_ms, runs, losses = timed_steps(one, 1, 5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(first)] + [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"{name}: losses {losses} are not finite and falling")
    tokens = batch * TRAIN_U / (step_ms / 1e3)
    print(f"  {name}: median {step_ms:.3f} ms (runs {[round(m, 3) for m in runs]}); {tokens:.1f} target tokens/s; "
          f"peak memory {peak_gb:.3f} GB; losses {[round(v, 3) for v in losses]}; launches a step "
          f"{ {n: c for n, c in counts.items() if c} } on {card}")
    profile = profile_chain(one, step_ms, reps=1)
    return dict(ms=step_ms, runs_ms=runs, tokens_per_s=tokens, peak_gb=peak_gb, losses=losses, launches=counts,
                profile=profile)


def compare_train_with_cpu(recipe, model, dev, loss: str) -> None:
    """The loss and its gradients in f32 at B=2, dropout off, on the card through the kernels
    against the same model on the CPU through the plain versions: loss within 1e-4
    (relative), the gradient norm of each top-level module within 1e-3 (relative).

    The pruned loss picks its band a frame by an argmax over window sums of posteriors,
    which random weights leave nearly flat: rounding moves some frames' bands, and the
    loss then differs by what the moved band excludes, not by rounding.  So for the loss
    and the norms the CPU run takes the bands the card chose, and the two sides score the
    same lattice cells.  The card's choice is held on its own: its simple-loss posteriors
    against the CPU's (1e-3), its ``get_rnnt_prune_ranges`` against the CPU's on the same
    posteriors rounded so that their sums are exact (equal), and every band's start must lie
    between the lowest and the highest that the CPU's posteriors allow when window sums within
    1e-3 of a frame's best count as tied."""
    import torch

    import audio_tpu_torch.functional as F

    choose_ranges, card_side = F.get_rnnt_prune_ranges, []

    def start_bounds(post, logit_lengths, target_lengths, s, tol):
        """The lowest and the highest band start a frame that ``get_rnnt_prune_ranges`` may give
        when window sums within ``tol`` of a frame's best count as tied: its steps after the
        choice of the window (the cap, start 0, non-decreasing, steps of at most s - 1, the
        climb to the last target) never lower a start when a choice rises, so the two
        extreme choices bound every other.  Sums in float64."""
        t_max, u1 = post.shape[1:]
        csum = torch.nn.functional.pad(torch.cumsum(post.double(), dim=-1), (1, 0))
        w = max(u1 - s + 1, 1)
        win = csum[:, :, torch.clamp(torch.arange(w) + s, max=u1)] - csum[:, :, :w]
        tied = win >= win.max(dim=-1, keepdim=True).values - tol
        cap = torch.clamp(target_lengths.long() + 1 - s, min=0)[:, None]
        t_idx = torch.arange(t_max)[None, :]
        climb = torch.clamp(cap - torch.clamp(logit_lengths.long()[:, None] - 1 - t_idx, min=0) * (s - 1), min=0)

        def finish(raw):
            raw = torch.minimum(raw, cap)
            raw[:, 0] = 0
            start = torch.cummax(raw, dim=1).values
            start = torch.cummin(start - t_idx * (s - 1), dim=1).values + t_idx * (s - 1)
            return torch.maximum(start, climb)

        return (finish(torch.where(tied, torch.arange(w), w).min(dim=-1).values),
                finish(torch.where(tied, torch.arange(w), -1).max(dim=-1).values))

    def record(post, logit_lengths, target_lengths, s):
        card_side.append((post, choose_ranges(post, logit_lengths, target_lengths, s)))
        return card_side[-1][1]

    def replay(post, logit_lengths, target_lengths, s):
        card_post, given = (t.cpu() for t in card_side[0])
        own = choose_ranges(post, logit_lengths, target_lengths, s)
        check_close("pruned loss: the card's simple-loss posteriors vs the CPU's", card_post, post, 1e-3, 1e-3)
        # rounded to 2^-10 the posteriors' f32 sums are exact in any order, so the two sides see the
        # same window sums, exact ties included, and must choose the same integers
        exact = torch.round(post * 1024) / 1024
        check_equal("pruned loss: get_rnnt_prune_ranges on the card vs the CPU, both on the CPU's posteriors "
                    "rounded to 2^-10",
                    choose_ranges(exact.to(dev), logit_lengths.to(dev), target_lengths.to(dev), s).cpu(),
                    choose_ranges(exact, logit_lengths, target_lengths, s))
        live = torch.arange(post.shape[1])[None, :] < logit_lengths[:, None]
        lo, hi = start_bounds(post, logit_lengths, target_lengths, s, 1e-3)
        start, consecutive = given[:, :, 0].long(), (given - given[:, :, :1] == torch.arange(s)).all(dim=-1)
        outside = ((start < lo) | (start > hi) | ~consecutive) & live
        moved = (own != given).any(dim=-1) & live
        print(f"  prune ranges: {int(outside.sum())} of {int(live.sum())} frames' bands on the card lie outside what the "
              f"CPU's posteriors allow with window sums within 1e-3 counted as ties (limit 0; {int(((hi > lo) & live).sum())}"
              f" frames have such a tie); {int(moved.sum())} frames' bands differ from the CPU's own choice; the card's "
              "bands are used on both sides for the loss")
        if bool(outside.any()):
            raise AssertionError("pruned loss: the card chose a band that no near-tie of the CPU's window sums explains")
        return given

    def loss_and_norms(mdl, device):
        heads = None
        if loss == "pruned":
            heads = recipe.init_simple_heads(RNNT_D, RNNT_V, device, torch.Generator().manual_seed(1))
        step = recipe.make_train_step(mdl.eval(), loss, TRAIN_BAND, None, heads=heads)
        data = recipe.synthetic_batch(np.random.default_rng(2), 2, TRAIN_T, TRAIN_RC, TRAIN_U, RNNT_V, device)
        step.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            value = step.loss(step.params, *data)
            value.backward()
        norms = {}
        for pname, p in step.params.items():
            group = ".".join(pname.split(".")[:2]) if pname.startswith("model.") else pname
            norms[group] = norms.get(group, 0.0) + float(p.grad.double().pow(2).sum())
        step.optimizer.zero_grad(set_to_none=True)
        return float(value), {g: math.sqrt(v) for g, v in norms.items()}

    reset_kernel_counts()
    try:
        F.get_rnnt_prune_ranges = record
        got, got_norms = loss_and_norms(model, dev)
        torch.cuda.synchronize()
        require_launches(f"the f32 {loss}-loss step at B=2", kernel_counts(),
                         ["emformer_attention_fwd", "emformer_attention_bwd", "lattice_row_stats"])
        F.get_rnnt_prune_ranges = replay
        ref, ref_norms = loss_and_norms(copy.deepcopy(model).cpu(), torch.device("cpu"))
    finally:
        F.get_rnnt_prune_ranges = choose_ranges
    diffs = {g: abs(got_norms[g] - ref_norms[g]) / ref_norms[g] for g in ref_norms}
    worst = max(diffs.values())
    print(f"  f32 {loss}-loss step at B=2, card vs CPU: loss {got:.6f} vs {ref:.6f} (relative "
          f"{abs(got - ref) / abs(ref):.3e}, limit 1e-4); gradient norms "
          f"{ {g: round(v, 6) for g, v in got_norms.items()} }, relative differences "
          f"{ {g: float(f'{v:.3e}') for g, v in diffs.items()} } (limit 1e-3)")
    if not abs(got - ref) <= 1e-4 * abs(ref) or not worst <= 1e-3:
        raise AssertionError(f"the f32 {loss}-loss step on the card disagrees with the CPU")


def filter_grad_step(x, a, b, fb, window):
    """Path B: mean(log1p(mel_spectrogram(lfilter(x, a, b, clamp=False)))) and its gradients."""
    import torch

    import audio_tpu_torch.functional as F

    leaves = [t.detach().requires_grad_() for t in (x, a, b)]
    with torch.enable_grad():
        y = F.lfilter(leaves[0], leaves[1], leaves[2], clamp=False)
        mel = F.mel_spectrogram(y, fb=fb, window=window, n_fft=N_FFT, hop_length=HOP, win_length=N_FFT, power=2.0,
                                normalized=False, time_major=True)
        loss = torch.log1p(mel).mean()
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), *grads)


def check_short_filter(rng, dev) -> None:
    """A signal of 200 samples, below the fused kernel's length: on the card ``lfilter`` runs the
    plain FIR stage and K4 forward and backward; output and gradients against the CPU (1e-4)."""
    import torch

    import audio_tpu_torch.functional as F

    a_np, b_np = stable_coeffs(rng, 1, 3)
    x = torch.as_tensor(rng.standard_normal((4, 200)).astype(np.float32) * 0.1)
    w = torch.as_tensor(rng.standard_normal((4, 200)).astype(np.float32))

    def run(device):
        leaves = [torch.as_tensor(v, device=device).requires_grad_() for v in (x, a_np[0], b_np[0])]
        with torch.enable_grad():
            y = F.lfilter(*leaves, clamp=False)
            return (y.detach(), *torch.autograd.grad((y * w.to(device)).sum(), leaves))

    reset_kernel_counts()
    got = run(dev)
    torch.cuda.synchronize()
    counts = kernel_counts()
    if counts["iir"] != 2 or counts["lfilter"] != 0:
        raise AssertionError(f"short lfilter: expected K4 forward and backward, launches {counts}")
    for part, g, r in zip(("y", "dx", "da", "db"), got, run(torch.device("cpu"))):
        check_close(f"lfilter of 200 samples through K4: {part} vs CPU", g.cpu(), r, 1e-4 * float(r.abs().max()), 1e-4)


def run_filter_grad(rng, dev, card: str, wav, fb, window, order: int, reps: int) -> dict:
    """Path B at full width for one filter order: counters around one step, the step's
    gradients at B=4 against the CPU (1e-4 of each gradient's peak), the step's time."""
    import torch

    a_np, b_np = stable_coeffs(rng, 1, order)
    a, b = torch.as_tensor(a_np[0], device=dev), torch.as_tensor(b_np[0], device=dev)
    name = f"lfilter gradient, order {order}, B={wav.shape[0]}"
    reset_kernel_counts()
    out = filter_grad_step(wav, a, b, fb, window)
    torch.cuda.synchronize()
    counts = kernel_counts()
    require_launches(f"one step of the {name}", counts, ["lfilter", "power_spectrogram", "iir"])
    require_route(f"one step of the {name}", counts, "power_spectrogram", "fft")
    require_route(f"one step of the {name}", counts, "iir", "chunked")
    require_route(f"one step of the {name}", counts, "lfilter", "chunked")
    if not all(bool(torch.isfinite(t).all()) for t in out):
        raise AssertionError(f"{name}: non-finite loss or gradient")
    got = filter_grad_step(wav[:4], a, b, fb, window)
    ref = filter_grad_step(wav[:4].cpu(), a.cpu(), b.cpu(), fb.cpu(), window.cpu())
    for part, g, r in zip(("loss", "dx", "da", "db"), got, ref):
        check_close(f"{name}: {part} at B=4 vs CPU", g.cpu(), r, 1e-4 * float(r.abs().max()), 1e-4)
    del out, got, ref
    step_ms, runs, _ = timed_steps(lambda: filter_grad_step(wav, a, b, fb, window), 1, reps)
    print(f"  {name}: median {step_ms:.3f} ms forward + backward (runs {[round(m, 3) for m in runs]}); launches "
          f"a step { {n: c for n, c in counts.items() if c} } on {card}")
    return dict(ms=step_ms, runs_ms=runs, launches=counts, a=a, b=b)


# ------------------------------------------------------------------ phase 10: effects and the vocoder
FX_B, FX_FLANGER_B = 8192, 4096  # the effects chain at phase 4's width; flanger's (batch, 2 channels)
VOC_SR, VOC_N_FFT, VOC_HOP, VOC_ITERS, VOC_MOMENTUM = 22050, 1024, 256, 32, 0.99  # the TTS bundle's
VOC_B, VOC_T = 32, 5 * 22050


def median_call_ms(fn, reps: int = 5):
    """Median ms of ``fn()`` over ``reps`` calls (CUDA events around each) after a warm-up, and the
    calls; the outputs are dropped."""
    ms, runs, _ = timed_steps(lambda: (fn(), None)[1], 1, reps)
    return ms, runs


def no_host_sync(fn):
    """``fn`` run under torch.cuda.set_sync_debug_mode("error"): a host read inside it raises."""
    import torch

    def run(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    return run


PROFILED_STEPS = 4000  # the delay lines' profiles cover this many of their steps (phaser; flanger a quarter)


def profile_call(name: str, fn, call_ms: float) -> dict:
    """One call of ``fn`` under torch.profiler: its kernel launches, device busy time and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_kernel_rows(prof, 1)
    busy, n = sum(r[1] for r in rows), sum(r[2] for r in rows)
    print(f"  profile of one {name} call: {n:g} kernel launches, device busy {busy:.3f} ms against a "
          f"{call_ms:.3f} ms call (idle share {1 - busy / call_ms:.3f})")
    return {"launches": n, "busy_ms": busy, "idle_share": 1 - busy / call_ms}


def run_effects(dev, card: str) -> dict:
    """Phase 10 (a): gain -> contrast -> dcshift -> overdrive -> phaser -> dither through the public
    functions on B = 8192 rows of 1 s of seeded noise at 16 kHz, then flanger on (4096, 2, 16000) at
    its defaults and with feedback, and the other branches (dcshift below zero, the triangular
    phaser, RPDF and GPDF from a CUDA generator).  K4 must launch in overdrive, only on "chunked";
    phaser and flanger run with host reads made errors.  Each effect's first 4 rows against the
    port's CPU result on the same inputs; each effect and the chain timed (median of 5)."""
    import torch

    import audio_tpu_torch.functional as F
    from audio_tpu_torch.functional._filtering import _dither_noise

    x = torch.as_tensor(np.random.default_rng(30).standard_normal((FX_B, T)).astype(np.float32) * 0.3, device=dev)
    try:  # the guard is live: a host read under it raises
        no_host_sync(lambda: float(x[0, 0]))()
        raise AssertionError("torch.cuda.set_sync_debug_mode('error') let a host read through")
    except RuntimeError:
        print("  a host read under set_sync_debug_mode('error') raises: phaser and flanger run under it")
    recurrence = (1e-5, 1e-4)  # the JAX overdrive test's atol and rtol
    stages = [("gain 6 dB", lambda y: F.gain(y, 6.0), (1e-5, 0.0)),
              ("contrast 75", lambda y: F.contrast(y, 75.0), (1e-5, 0.0)),
              ("dcshift 0.2, limiter 0.05", lambda y: F.dcshift(y, 0.2, 0.05), (1e-5, 0.0)),
              ("overdrive 20, 20", lambda y: F.overdrive(y, 20.0, 20.0), recurrence),
              ("phaser", no_host_sync(lambda y: F.phaser(y, SR)), recurrence),
              ("dither TPDF", lambda y: F.dither(y), None)]
    out, y = {}, x
    for name, fn, tol in stages:
        if name == "phaser":
            phaser_in = y
        if name.startswith("overdrive"):
            reset_kernel_counts()
        z = fn(y)
        torch.cuda.synchronize()
        if name.startswith("overdrive"):
            counts = kernel_counts()
            require_launches("overdrive (phase 10)", counts, ["iir"])
            require_route("overdrive (phase 10)", counts, "iir", "chunked")
            out["overdrive_launches"] = {"iir": counts["iir"], "iir_chunked": counts["iir_chunked"]}
        ref = fn(y[:4].cpu())
        if tol is None:
            if not torch.equal(z[:4].cpu(), ref):
                raise AssertionError(f"{name}: the card's first 4 rows differ from the CPU's")
            print(f"  {name} (first 4 of {FX_B} rows): equal to the CPU's")
            err = 0.0
        else:
            err = check_close(f"{name} (first 4 of {FX_B} rows) against the CPU", z[:4].cpu(), ref, *tol)
        ms, runs = median_call_ms(lambda: fn(y))
        out[name] = {"ms": ms, "runs_ms": runs, "max_abs_err": err}
        print(f"  {name} at ({FX_B}, {T}) f32: {ms:.3f} ms on {card}")
        y = z

    def chain(w):
        for _, fn, _ in stages:
            w = fn(w)
        return w

    out["chain_ms"], out["chain_runs_ms"] = median_call_ms(lambda: chain(x))
    print(f"  effects chain (gain -> contrast -> dcshift -> overdrive -> phaser -> dither) at ({FX_B}, {T}) f32: "
          f"{out['chain_ms']:.3f} ms on {card}")
    # one phaser call profiled on the first 4,000 samples of its rows: the profiler's own work grows
    # with the launches (32,000 a full call), the launches a step and the idle share do not
    head = phaser_in[:, :PROFILED_STEPS].contiguous()
    phaser_head = lambda: stages[4][1](head)  # noqa: E731
    out["phaser_profile"] = profile_call(f"phaser on ({FX_B}, {PROFILED_STEPS})", phaser_head,
                                         median_call_ms(phaser_head, 3)[0])

    # the other branches
    neg = F.dcshift(x, -0.3, 0.05)
    check_close("dcshift -0.3, limiter 0.05 (first 4 rows) against the CPU", neg[:4].cpu(),
                F.dcshift(x[:4].cpu(), -0.3, 0.05), 1e-5, 0.0)
    triangle = no_host_sync(lambda y: F.phaser(y, SR, sinusoidal=False))
    check_close("phaser triangular (first 4 rows) against the CPU", triangle(x)[:4].cpu(),
                triangle(x[:4].cpu()), *recurrence)
    for density in ("RPDF", "GPDF"):
        got = F.dither(x, density, generator=torch.Generator(device=dev).manual_seed(5))
        noise = _dither_noise(density, torch.Generator(device=dev).manual_seed(5), torch.float32, dev)
        want = torch.round(x * (2**15 - 2) + noise) / 2**15
        q = got.double() * 2**15
        if not (torch.equal(got, want) and torch.equal(q, torch.round(q))):
            raise AssertionError(f"dither {density}: not round(x (2^15 - 2) + n) / 2^15 with the drawn n")
        print(f"  dither {density} from a CUDA generator (n = {float(noise):.6f}): on the 2^-15 grid and equal to "
              "round(x (2^15 - 2) + n) / 2^15")

    xf = torch.as_tensor(np.random.default_rng(32).standard_normal((FX_FLANGER_B, 2, T)).astype(np.float32) * 0.3,
                         device=dev)
    for label, kw in (("flanger (defaults: no feedback)", {}),
                      ("flanger (regen 50, quadratic)", dict(regen=50.0, interpolation="quadratic"))):
        fn = no_host_sync(lambda w, kw=kw: F.flanger(w, SR, **kw))
        got = fn(xf)
        torch.cuda.synchronize()
        err = check_close(f"{label} (first 4 of {FX_FLANGER_B} rows) against the CPU", got[:4].cpu(),
                          fn(xf[:4].cpu()), *recurrence)
        ms, runs = median_call_ms(lambda: fn(xf))
        out[label] = {"ms": ms, "runs_ms": runs, "max_abs_err": err}
        print(f"  {label} at ({FX_FLANGER_B}, 2, {T}) f32: {ms:.3f} ms on {card}")
    head = xf[..., :PROFILED_STEPS // 4].contiguous()
    loop = lambda: F.flanger(head, SR, regen=50.0, interpolation="quadratic")  # noqa: E731
    out["flanger_loop_profile"] = profile_call(
        f"flanger (regen 50, quadratic) on ({FX_FLANGER_B}, 2, {PROFILED_STEPS // 4})", loop, median_call_ms(loop, 3)[0])
    return out


def vocoder_clips(rng, b: int, n: int, sr: int) -> np.ndarray:
    """Clips of seeded sums of two to five decaying tones (80 Hz - 4 kHz)."""
    t = np.arange(n) / sr
    x = np.zeros((b, n))
    for i in range(b):
        for _ in range(rng.integers(2, 6)):
            f, a, d, ph = rng.uniform(80, 4000), rng.uniform(0.05, 0.3), rng.uniform(0.2, 3.0), rng.uniform(0, 6.283)
            x[i] += a * np.sin(2 * np.pi * f * t + ph) * np.exp(-d * t)
    return x.astype(np.float32)


def run_vocoder(dev, card: str) -> dict:
    """Phase 10 (b): the TTS bundle's Griffin-Lim vocoder (22,050 Hz, n_fft 1024, hop 256, Hann,
    power 1, 32 iterations, momentum 0.99) from random phases on 32 magnitude spectrograms of 5 s
    clips: the rebuilt magnitude spectrogram's correlation with the target at least 0.98 on every
    clip (the JAX test's criterion).  Then at B = 2 in float64 without random phases the card
    against the CPU (1e-6 of the peak); the inverse spectrogram of the complex one (1e-5); the
    phase vocoder at rate 1.3; decibels there and back; the spectral centroid, which must launch K2,
    only on "fft" (1e-4 relative).  griffinlim and spectral_centroid timed (median of 5)."""
    import torch

    import audio_tpu_torch.functional as F
    from audio_tpu_torch._internal.windows import hann_window

    out = {}
    x = torch.as_tensor(vocoder_clips(np.random.default_rng(31), VOC_B, VOC_T, VOC_SR), device=dev)
    w = hann_window(VOC_N_FFT, device=dev)
    kw = dict(n_fft=VOC_N_FFT, hop_length=VOC_HOP, win_length=VOC_N_FFT)
    spec = F.spectrogram(x, window=w, power=1.0, **kw)

    def vocoder():
        return F.griffinlim(spec, window=w, power=1.0, n_iter=VOC_ITERS, momentum=VOC_MOMENTUM, length=VOC_T,
                            rand_init=True, generator=torch.Generator(device=dev).manual_seed(7), **kw)

    rec = vocoder()
    got = F.spectrogram(rec, window=w, power=1.0, **kw).flatten(1).double()
    tgt = spec.flatten(1).double()
    got, tgt = got - got.mean(1, keepdim=True), tgt - tgt.mean(1, keepdim=True)
    corr = (got * tgt).sum(1) / (got.norm(dim=1) * tgt.norm(dim=1))
    out["correlation_min"], out["correlation_median"] = float(corr.min()), float(corr.median())
    print(f"  griffinlim ({VOC_B} clips of {VOC_T} samples, {tuple(spec.shape[1:])} bins x frames, {VOC_ITERS} "
          f"iterations from random phases): magnitude correlation min {out['correlation_min']:.4f}, median "
          f"{out['correlation_median']:.4f} (limit 0.98)")
    if out["correlation_min"] < 0.98:
        raise AssertionError(f"griffinlim: a clip's magnitude correlation {out['correlation_min']:.4f} < 0.98")
    out["griffinlim_ms"], out["griffinlim_runs_ms"] = median_call_ms(vocoder)
    print(f"  griffinlim at B {VOC_B}: {out['griffinlim_ms']:.3f} ms on {card}")

    # float64, no random phases: the card against the CPU on the same spectrograms
    w64 = w.double().cpu()
    spec64 = F.spectrogram(x[:2].double().cpu(), window=w64, power=1.0, **kw)
    args = dict(power=1.0, n_iter=VOC_ITERS, momentum=VOC_MOMENTUM, length=VOC_T, rand_init=False, **kw)
    on_cpu = F.griffinlim(spec64, window=w64, **args)
    on_card = F.griffinlim(spec64.to(dev), window=w64.to(dev), **args).cpu()
    peak = float(on_cpu.abs().max())
    out["griffinlim_f64_err"] = check_close("griffinlim f64, B 2, no random phases: card against the CPU", on_card,
                                            on_cpu, 1e-6 * peak, 0.0)

    cs = F.spectrogram(x, window=w, power=None, **kw)
    back = F.inverse_spectrogram(cs, VOC_T, window=w, **kw)
    covered = VOC_HOP * (VOC_T // VOC_HOP)  # the last frame's centre; past it the inverse is zero
    out["inverse_err"] = check_close(f"inverse_spectrogram of spectrogram(power=None) against the waveform "
                                     f"(first {covered} samples)", back[:, :covered], x[:, :covered], 1e-5, 0.0)

    advance = torch.linspace(0, math.pi * VOC_HOP, VOC_N_FFT // 2 + 1, device=dev)[:, None]
    stretched = F.phase_vocoder(cs, 1.3, advance)
    want_frames = math.ceil(cs.shape[-1] / 1.3)
    ref = F.phase_vocoder(cs[:2].cpu(), 1.3, advance.cpu())
    err = (stretched[:2].cpu() - ref).abs()
    frames = torch.arange(1, ref.shape[-1] + 1, dtype=torch.float64)
    # the accumulated phase's float32 rounding grows with the frame (tests/test_torch_spectral_inverse.py)
    bound = 1e-5 + 4 * ref.abs().double() * torch.finfo(torch.float32).eps * frames * (math.pi * VOC_HOP + 2 * math.pi)
    ok = stretched.shape[-1] == want_frames and bool((err <= bound).all())
    print(f"  phase_vocoder rate 1.3: {stretched.shape[-1]} frames (ceil({cs.shape[-1]} / 1.3) = {want_frames}); "
          f"first 2 clips against the CPU: max_abs_err {float(err.max()):.3e}, within the float32 phase bound: {ok}")
    if not ok:
        raise AssertionError("phase_vocoder: frames or values differ from the CPU's")
    out["phase_vocoder_err"] = float(err.max())

    per_clip = spec[:, None]  # (clip, 1 channel, freq, time): top_db over each clip
    db = F.amplitude_to_DB(per_clip, 20.0, 1e-10, 0.0, 80.0)
    amp = F.DB_to_amplitude(db, 1.0, 0.5)
    out["db_err"] = max(check_close("amplitude_to_DB (top_db 80) against the CPU", db.cpu(),
                                    F.amplitude_to_DB(per_clip.cpu(), 20.0, 1e-10, 0.0, 80.0), 1e-5, 1e-5),
                        check_close("DB_to_amplitude of it against the CPU", amp.cpu(),
                                    F.DB_to_amplitude(db.cpu(), 1.0, 0.5), 1e-5, 1e-5))

    def centroid(w_=w, x_=x):
        return F.spectral_centroid(x_, VOC_SR, 0, w_, VOC_N_FFT, VOC_HOP, VOC_N_FFT)

    reset_kernel_counts()
    sc = centroid()
    torch.cuda.synchronize()
    counts = kernel_counts()
    require_launches("spectral_centroid (phase 10)", counts, ["power_spectrogram"])
    require_route("spectral_centroid (phase 10)", counts, "power_spectrogram", "fft")
    out["centroid_launches"] = {"power_spectrogram": counts["power_spectrogram"],
                                "power_spectrogram_fft": counts["power_spectrogram_fft"]}
    out["centroid_err"] = check_close("spectral_centroid (first 2 clips) against the CPU", sc[:2].cpu(),
                                      centroid(w.cpu(), x[:2].cpu()), 0.0, 1e-4)
    out["centroid_ms"], out["centroid_runs_ms"] = median_call_ms(centroid)
    print(f"  spectral_centroid at ({VOC_B}, {VOC_T}): {out['centroid_ms']:.3f} ms on {card}")
    return out


# ------------------------------------------------------------------ phase 11: the CTC augmentation front end
FE_SPEED, FE_LUFS, FE_CMN = 1.1, -23.0, 600  # speed perturbation, loudness target (EBU R 128), CMN window
FE_V, FE_L = 29, 20  # the wav2letter recipe's LABELS (examples/asr/wav2letter/train.py:37); targets a row
FE_FREQ_MASK, FE_TIME_MASK = 27, 40  # SpecAugment's LibriSpeech policy F = 27; T scaled down to 101 frames
FE_ROWS = 4  # rows held against the CPU
CTC_B, CTC_T, CTC_L = 8, 400, 150  # the recipe's ctc_loss shape: batch, frames, targets up to
F32_TOL = (1e-5, 1e-4)  # the port's float32 tolerance where the JAX package's tests give none
PITCH_GB = 8.0  # detect_pitch_frequency's limit at (8192, 16000), its input included


def voiced_rows(dev, b: int, n: int, seed: int):
    """``b`` rows of ``n`` samples at 16 kHz made on the device from a generator seeded ``seed``: a
    harmonic tone (100-300 Hz fundamental, five harmonics, random phases) in a little noise."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.arange(n, device=dev, dtype=torch.float64) / SR
    f0 = 100 + 200 * torch.rand((b, 1), generator=g, device=dev, dtype=torch.float64)
    x = torch.zeros((b, n), device=dev, dtype=torch.float64)
    for h in range(1, 6):
        phase = 2 * math.pi * torch.rand((b, 1), generator=g, device=dev, dtype=torch.float64)
        x += torch.sin(2 * math.pi * h * f0 * t + phase) / h
    return (0.1 * x).float() + 0.01 * torch.randn((b, n), generator=g, device=dev)


def peak_call(fn):
    """``fn()`` and the device memory it held at its peak above what was allocated before it (GB)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - before) / 1e9


def front_end_state(dev, b: int) -> dict:
    """The front end's inputs, made on the device: voiced rows, their lengths (12,000 to 16,000
    samples), noise and per-row SNRs of 0-20 dB, targets of 5 to 20 labels of 1-28."""
    import torch

    g = torch.Generator(device=dev).manual_seed(41)
    return {"wav": voiced_rows(dev, b, T, 40),
            "lengths": torch.randint(12000, T + 1, (b,), generator=g, device=dev),
            "noise": 0.1 * torch.randn((b, T), generator=g, device=dev),
            "snr": 20 * torch.rand((b,), generator=g, device=dev),
            "targets": torch.randint(1, FE_V, (b, FE_L), generator=g, device=dev),
            "target_lengths": torch.randint(5, FE_L + 1, (b,), generator=g, device=dev)}


PARAMS = ("proj", "fb", "window")  # state entries that are not rows


def rows_of(state: dict, n: int, dev) -> dict:
    """The first ``n`` rows of every row tensor of ``state`` on ``dev``, the parameters whole."""
    import torch

    return {k: (v if k in PARAMS else v[:n]).to(dev) for k, v in state.items()
            if isinstance(v, torch.Tensor) and v.dim()}


def front_end_stages():
    """Phase 11's front end as (name, stage, output key) triples; each stage maps the state dict to
    the next: speed -> add_noise -> preemphasis -> deemphasis (K1) -> loudness normalisation (K1) ->
    mel_spectrogram (K2) -> log1p + sliding_window_cmn -> compute_deltas -> two SpecAugment masks ->
    projection to the wav2letter labels -> ctc_loss (mean) -> ctc_greedy_decode."""
    import torch

    import audio_tpu_torch.functional as F
    from audio_tpu_torch.ops.ctc import ctc_greedy_decode, ctc_loss

    def speed(s):
        y, lengths = F.speed(s["wav"], SR, FE_SPEED, s["lengths"])
        return {**s, "wav": torch.nn.functional.pad(y, (0, T - y.shape[-1])), "lengths": lengths}

    def loudness(s):
        lufs = F.loudness(s["wav"][:, None], SR)
        return {**s, "lufs": lufs, "wav": s["wav"] * (10 ** ((FE_LUFS - lufs) / 20))[:, None]}

    def features(s):
        feats = F.sliding_window_cmn(torch.log1p(s["mel"]), FE_CMN, norm_vars=True)  # (B, frames, 80)
        return {**s, "feats": feats.transpose(1, 2)}  # (B, 80, frames)

    def mask(param, axis, seed):
        def run(s):
            g = torch.Generator(device=s["spec"].device).manual_seed(seed)
            return {**s, "spec": F.mask_along_axis_iid(s["spec"], param, 0.0, axis, generator=g)}
        return run

    def loss(s):
        il = torch.clamp(s["lengths"] // HOP + 1, max=s["lp"].shape[1])
        return {**s, "input_lengths": il, "loss": ctc_loss(s["lp"], s["targets"], il, s["target_lengths"])}

    return [
        ("speed 1.1", speed, "wav"),
        ("add_noise 0-20 dB", lambda s: {**s, "wav": F.add_noise(s["wav"], s["noise"], s["snr"], s["lengths"])},
         "wav"),
        ("preemphasis 0.97", lambda s: {**s, "wav": F.preemphasis(s["wav"], 0.97)}, "wav"),
        ("deemphasis 0.97", lambda s: {**s, "wav": F.deemphasis(s["wav"], 0.97)}, "wav"),
        ("loudness to -23 LUFS", loudness, "wav"),
        ("mel_spectrogram", lambda s: {**s, "mel": F.mel_spectrogram(
            s["wav"], s["fb"], s["window"], N_FFT, HOP, N_FFT, power=2.0, time_major=True)}, "mel"),
        ("log1p + sliding_window_cmn", features, "feats"),
        ("compute_deltas", lambda s: {**s, "spec": torch.cat([s["feats"], F.compute_deltas(s["feats"])], dim=1)},
         "spec"),
        ("frequency mask", mask(FE_FREQ_MASK, 1, 42), "spec"),
        ("time mask", mask(FE_TIME_MASK, 2, 43), "spec"),
        ("projection + log_softmax",
         lambda s: {**s, "lp": torch.log_softmax(s["spec"].transpose(1, 2) @ s["proj"], -1)}, "lp"),
        ("ctc_loss", loss, "loss"),
        ("ctc_greedy_decode", lambda s: {**s, "decoded": ctc_greedy_decode(s["lp"], s["input_lengths"])}, "decoded"),
    ]


def check_front_end_stage(name: str, key: str, stage, card_in: dict, card_out: dict) -> float:
    """A stage's first FE_ROWS rows on the card against the same call on the CPU, on the card's
    input rows: the float32 tolerances of the CPU parity tests (preemphasis the JAX test's 1e-7,
    deltas 1e-6, K2's mel 5e-4 of the peak as phase 3), the masks equal to their formula on the
    card generator's draws, the decoded tokens and counts and speed's lengths equal."""
    import torch

    from audio_tpu_torch.functional._misc import _mask_draws, _span_mask
    from audio_tpu_torch.ops.ctc import ctc_loss

    cpu_in = rows_of(card_in, FE_ROWS, "cpu")
    label = f"{name} (first {FE_ROWS} rows) against the CPU"
    if key == "decoded":
        (tok, cnt), (tok_ref, cnt_ref) = card_out["decoded"], stage(cpu_in)["decoded"]
        return float(check_equal(f"{label}: tokens", tok[:FE_ROWS].cpu(), tok_ref)
                     + check_equal(f"{label}: counts", cnt[:FE_ROWS].cpu(), cnt_ref))
    if key == "loss":  # the rows' own losses, and the mean over all rows finite
        if not math.isfinite(float(card_out["loss"].detach())):
            raise AssertionError(f"{name}: the mean loss {float(card_out['loss'].detach())} is not finite")
        il = card_out["input_lengths"][:FE_ROWS]
        got = ctc_loss(card_in["lp"][:FE_ROWS], card_in["targets"][:FE_ROWS], il,
                       card_in["target_lengths"][:FE_ROWS], reduction="none")
        ref = ctc_loss(cpu_in["lp"], cpu_in["targets"], il.cpu(), cpu_in["target_lengths"], reduction="none")
        return check_close(label, got.cpu(), ref, *F32_TOL)
    if name.endswith("mask"):
        axis, seed = (1, 42) if name.startswith("frequency") else (2, 43)
        param = FE_FREQ_MASK if axis == 1 else FE_TIME_MASK
        spec = card_in["spec"]
        shape = [1, 1, 1]
        shape[axis] = spec.shape[axis]
        u_value, u_min = _mask_draws(spec.shape[:1], torch.Generator(device=spec.device).manual_seed(seed),
                                     spec.device)
        m = _span_mask(u_value[:FE_ROWS, None, None].cpu(), u_min[:FE_ROWS, None, None].cpu(), param,
                       spec.shape[axis], shape, "cpu")
        if not torch.equal(card_out["spec"][:FE_ROWS].cpu(), torch.where(m, 0.0, cpu_in["spec"])):
            raise AssertionError(f"{label}: not the mask of the generator's draws")
        print(f"  {label}: equal to the mask of the CUDA generator's draws ({int(m.sum())} entries masked)")
        return 0.0
    ref = stage(cpu_in)
    tol = {"preemphasis 0.97": (1e-7, 0.0), "compute_deltas": (1e-6, 1e-6)}.get(name, F32_TOL)
    if key == "mel":
        tol = (5e-4 * float(ref["mel"].abs().max()), 0.0)
    if name.startswith("speed"):
        check_equal(f"{label}: lengths", card_out["lengths"][:FE_ROWS].cpu(), ref["lengths"])
    if name.startswith("loudness"):
        check_close(f"{label}: LUFS", card_out["lufs"][:FE_ROWS].cpu(), ref["lufs"], 0.01, 0.0)  # the JAX test's
    return check_close(label, card_out[key][:FE_ROWS].cpu(), ref[key], *tol)


def run_front_end(dev, card: str, fb, window) -> dict:
    """Phase 11 (a): the CTC augmentation front end at B = 8192 rows of 1 s at 16 kHz.  One step
    (every stage, then the mean loss's backward to the projection) with the launch counters read
    around it: K1 must move, only on "chunked", and K2, only on "fft".  Each stage's first rows
    against the CPU; the step and each stage timed (median of 5), one step and the loss alone
    profiled."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(44)
    proj = (0.1 * torch.randn((2 * N_MELS, FE_V), generator=gen, device=dev)).requires_grad_(True)
    stages = front_end_stages()
    by_name = {name: fn for name, fn, _ in stages}
    s0 = {**front_end_state(dev, B), "proj": proj, "fb": fb, "window": window}

    def step():
        with torch.enable_grad():
            proj.grad = None
            s = s0
            for _, fn, _ in stages:
                s = fn(s)
            s["loss"].backward()
        return s

    reset_kernel_counts()
    final = step()
    torch.cuda.synchronize()
    counts = kernel_counts()
    require_launches("one front-end step (phase 11)", counts, ["lfilter", "power_spectrogram"])
    require_route("one front-end step (phase 11)", counts, "lfilter", "chunked")
    require_route("one front-end step (phase 11)", counts, "power_spectrogram", "fft")
    out = {"launches": {k: counts[k] for k in ("lfilter", "lfilter_chunked", "power_spectrogram",
                                               "power_spectrogram_fft")}}
    grad = proj.grad
    if grad is None or not bool(torch.isfinite(grad).all()) or float(grad.abs().max()) == 0:
        raise AssertionError("front end: the projection has no finite, non-zero gradient")
    out["loss"] = float(final["loss"])
    print(f"  front end: mean CTC loss {out['loss']:.4f}, the projection's gradient finite (max |g| "
          f"{float(grad.abs().max()):.3e}); {int(final['decoded'][1].sum())} tokens decoded over {B} rows")

    # each stage on the card's own input, its first rows against the CPU, then timed
    s, stage_ms = s0, {}
    with torch.enable_grad():
        for name, fn, key in stages:
            nxt = fn(s)
            err = check_front_end_stage(name, key, fn, s, nxt)
            ms, runs = median_call_ms(lambda: fn(s))
            stage_ms[name] = {"ms": ms, "runs_ms": runs, "max_abs_err": err}
            print(f"  {name} at B={B}: {ms:.3f} ms on {card}")
            s = nxt
        # the gradient of the first rows' mean loss to the projection, card against CPU
        grads = []
        for dv in (dev, torch.device("cpu")):
            st = {**rows_of(s, FE_ROWS, dv), "proj": proj.detach().to(dv).requires_grad_(True)}
            by_name["ctc_loss"](by_name["projection + log_softmax"](st))["loss"].backward()
            grads.append(st["proj"].grad.cpu())
        out["grad_err"] = check_close(f"the projection's gradient of the first {FE_ROWS} rows' loss against the CPU",
                                      grads[0], grads[1], *F32_TOL)
    out["stages"] = stage_ms

    out["step_ms"], out["step_runs_ms"] = median_call_ms(step)
    print(f"  front-end step (forward and the loss's backward) at B={B}: {out['step_ms']:.3f} ms on {card}")
    out["step_profile"] = profile_call(f"front-end step at B={B}", step, out["step_ms"])

    def ctc_fwd_bwd():
        with torch.enable_grad():
            lp = s["lp"].detach().requires_grad_(True)
            by_name["ctc_loss"]({**s, "lp": lp})["loss"].backward()

    ctc_ms = median_call_ms(ctc_fwd_bwd)[0]
    out["ctc_profile"] = profile_call(f"ctc_loss forward + backward at B={B}, T={s['lp'].shape[1]}", ctc_fwd_bwd,
                                      ctc_ms)
    out["ctc_fwd_bwd_ms"] = ctc_ms
    return out


def run_front_end_functions(dev, card: str) -> dict:
    """Phase 11 (b): the other ported functions once each at the sizes their users run, the card
    against the CPU on the first rows (the parity tests' tolerances), timed (median of 5)."""
    import torch

    import audio_tpu_torch.functional as F
    from audio_tpu_torch.functional._resample import get_sinc_resample_kernel
    from audio_tpu_torch.ops.ctc import ctc_loss

    out = {}

    def timed(label, fn, **extra):
        ms, runs = median_call_ms(fn)
        out[label] = {"ms": ms, "runs_ms": runs, **extra}
        print(f"  {label}: {ms:.3f} ms on {card}")
        return ms

    def with_cudnn_tf32(fn):
        """``fn()`` with cuDNN's TF32 at PyTorch's default (on)."""
        torch.backends.cudnn.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cudnn.allow_tf32 = False

    # resample: 48 -> 16 kHz on (8192, 48000), and 16 -> 44.1 kHz (kaiser) on the front end's rows
    x48 = voiced_rows(dev, B, 48000, 50)
    y, peak = peak_call(lambda: F.resample(x48, 48000, 16000))
    err = check_close("resample 48 -> 16 kHz (first 2 rows) against the CPU", y[:2].cpu(),
                      F.resample(x48[:2].cpu(), 48000, 16000), *F32_TOL)
    tf32 = check_close("resample 48 -> 16 kHz with cuDNN TF32 at its default (on) against it off",
                       with_cudnn_tf32(lambda: F.resample(x48, 48000, 16000)), y, *F32_TOL)
    timed(f"resample 48 -> 16 kHz at ({B}, 48000)", lambda: F.resample(x48, 48000, 16000), peak_gb=peak,
          max_abs_err=err, tf32_err=tf32)
    print(f"    its peak device memory above its input: {peak:.3f} GB")
    del x48, y
    x16 = voiced_rows(dev, B, T, 51)
    kw = dict(resampling_method="sinc_interp_kaiser")
    y, peak = peak_call(lambda: F.resample(x16, 16000, 44100, **kw))
    err = check_close("resample 16 -> 44.1 kHz kaiser (first 2 rows) against the CPU", y[:2].cpu(),
                      F.resample(x16[:2].cpu(), 16000, 44100, **kw), *F32_TOL)
    timed(f"resample 16 -> 44.1 kHz kaiser at ({B}, {T})", lambda: F.resample(x16, 16000, 44100, **kw),
          peak_gb=peak, max_abs_err=err)
    del y

    # pitch_shift: an octave either way at full width; 4 steps at B = 64 with the host's kernel build apart
    hop = 512 // 4
    for steps in (12, -12):
        y, peak = peak_call(lambda: F.pitch_shift(x16, SR, steps))
        ref = F.pitch_shift(x16[:2].cpu(), SR, steps)
        frames = 2 * T // hop + 2  # the float32 phase accumulation bound of the parity test
        bound = 4 * float(torch.finfo(torch.float32).eps) * frames * (math.pi * hop + 2 * math.pi) * float(
            x16[:2].abs().max())
        err = check_close(f"pitch_shift {steps:+d} steps (first 2 rows) against the CPU", y[:2].cpu(), ref, bound, 0.0)
        timed(f"pitch_shift {steps:+d} steps at ({B}, {T})", lambda: F.pitch_shift(x16, SR, steps), peak_gb=peak,
              max_abs_err=err)
        del y
    x64 = x16[:64]
    y = F.pitch_shift(x64, SR, 4)
    err = check_close("pitch_shift +4 steps (first 2 of 64 rows) against the CPU", y[:2].cpu(),
                      F.pitch_shift(x64[:2].cpu(), SR, 4), 4 * float(torch.finfo(torch.float32).eps) * (2 * T // hop)
                      * (math.pi * hop + 2 * math.pi) * float(x64[:2].abs().max()), 0.0)
    rate = 2.0 ** (-4 / 12)
    t0 = time.perf_counter()
    kernel, _ = get_sinc_resample_kernel(int(SR / rate), SR, dtype=torch.float32)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    F.pitch_shift(x64, SR, 4)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    out["pitch_shift +4 steps at (64, 16000)"] = {"call_s": call_s, "kernel_build_s": build_s,
                                                  "kernel_shape": list(kernel.shape), "max_abs_err": err}
    print(f"  pitch_shift +4 steps at (64, {T}): {call_s * 1e3:.1f} ms a call (host clock); building its "
          f"{tuple(kernel.shape)} resampling kernel on the host alone, in another call, {build_s * 1e3:.1f} ms "
          f"on {card}")
    del kernel, y

    # convolve with a 64-tap FIR (cuDNN TF32 off and at its default), fftconvolve with a 0.5 s room response
    g = torch.Generator(device=dev).manual_seed(52)
    fir = torch.randn((1, 64), generator=g, device=dev) / 8
    room = torch.randn((1, 8000), generator=g, device=dev) * torch.exp(-torch.arange(8000, device=dev) / 1600.0)
    y = F.convolve(x16, fir)
    err = check_close("convolve, 64 taps (first 2 rows) against the CPU", y[:2].cpu(),
                      F.convolve(x16[:2].cpu(), fir.cpu()), *F32_TOL)
    tf32 = check_close("convolve with cuDNN TF32 at its default (on) against it off",
                       with_cudnn_tf32(lambda: F.convolve(x16, fir)), y, *F32_TOL)
    timed(f"convolve 64 taps at ({B}, {T})", lambda: F.convolve(x16, fir), max_abs_err=err, tf32_err=tf32)
    y = F.fftconvolve(x16, room)
    err = check_close("fftconvolve, 8,000 taps (first 2 rows) against the CPU", y[:2].cpu(),
                      F.fftconvolve(x16[:2].cpu(), room.cpu()), *F32_TOL)
    timed(f"fftconvolve 8000 taps at ({B}, {T})", lambda: F.fftconvolve(x16, room), max_abs_err=err)
    del y

    # detect_pitch_frequency at full width: under PITCH_GB with its input, lags equal to the CPU's
    freq, peak = peak_call(lambda: F.detect_pitch_frequency(x16, SR))
    peak += x16.numel() * 4 / 1e9
    ref = F.detect_pitch_frequency(x16[:FE_ROWS].cpu(), SR)
    differ = int((freq[:FE_ROWS].cpu() != ref).sum())
    print(f"  detect_pitch_frequency (first {FE_ROWS} rows) against the CPU: {differ} of {ref.numel()} frames' "
          "frequencies differ (limit 0)")
    if differ:
        raise AssertionError("detect_pitch_frequency: the card's frequencies differ from the CPU's")
    print(f"  detect_pitch_frequency at ({B}, {T}): peak device memory {peak:.3f} GB with its input "
          f"(limit {PITCH_GB})")
    if peak >= PITCH_GB:
        raise AssertionError(f"detect_pitch_frequency: {peak:.3f} GB at its peak, past {PITCH_GB} GB")
    timed(f"detect_pitch_frequency at ({B}, {T})", lambda: F.detect_pitch_frequency(x16, SR), peak_gb=peak)
    del freq

    # vad on three two-channel recordings of 4 s: the same trimmed lengths and samples as the CPU
    lengths = []
    for i, onset in enumerate((0.5, 1.5, 2.5)):
        g = torch.Generator(device=dev).manual_seed(60 + i)
        rec = 0.005 * torch.randn((2, 4 * SR), generator=g, device=dev)
        start = int(onset * SR)
        rec[:, start:start + SR] += voiced_rows(dev, 2, SR, 70 + i) * 3
        got = F.vad(rec, SR)
        want = F.vad(rec.cpu(), SR)
        if got.shape != want.shape or not torch.equal(got.cpu(), want):
            raise AssertionError(f"vad, onset {onset} s: the card gives {tuple(got.shape)}, the CPU {tuple(want.shape)}")
        lengths.append(got.shape[-1])
        if i == 2:
            timed("vad on (2, 64000)", lambda: F.vad(rec, SR))
    out["vad_lengths"] = lengths
    print(f"  vad on three (2, {4 * SR}) recordings (onsets 0.5, 1.5, 2.5 s): trimmed to {lengths} samples, "
          "equal to the CPU's")

    # beamforming on a 6-channel complex64 STFT (64, 6, 257, 200)
    g = torch.Generator(device=dev).manual_seed(53)
    shp = (64, 6, 257, 200)
    src = torch.randn((64, 1, 257, 200), generator=g, device=dev, dtype=torch.complex64)
    h = torch.randn((64, 6, 257, 1), generator=g, device=dev, dtype=torch.complex64)
    spec = src * h + 0.3 * torch.randn(shp, generator=g, device=dev, dtype=torch.complex64)
    mask = torch.rand((64, 257, 200), generator=g, device=dev)

    def beamform(sp, m):
        psd_s, psd_n = F.psd(sp, m), F.psd(sp, 1 - m)
        w_souden = F.mvdr_weights_souden(psd_s, psd_n, 0)
        rtf_e, rtf_p = F.rtf_evd(psd_s), F.rtf_power(psd_s, psd_n, 0)
        w_evd, w_power = F.mvdr_weights_rtf(rtf_e, psd_n, 0), F.mvdr_weights_rtf(rtf_p, psd_n, 0)
        return {"psd_s": psd_s, "souden": w_souden, "rtf_evd": rtf_e, "rtf_power": rtf_p, "mvdr_evd": w_evd,
                "mvdr_power": w_power, "out": F.apply_beamforming(w_evd, sp)}

    # complex64 solves on these PSDs lose cond * eps: each output is held against the CPU's complex128
    # result on the same inputs, the card's error within four times the CPU's own complex64 error + 1e-6
    got = beamform(spec, mask)
    ref32 = beamform(spec[:2].cpu(), mask[:2].cpu())
    ref = beamform(spec[:2].cpu().to(torch.complex128), mask[:2].cpu().double())
    for r in (got, ref32):  # the eigensolver's unit factor, frequency by frequency
        v = r["rtf_evd"][:2].cpu().to(torch.complex128)
        inner = torch.sum(ref["rtf_evd"].conj() * v, dim=-1, keepdim=True)
        r["rtf_evd"] = v * (inner / inner.abs()).conj()
    berr = {}
    for k in ref:
        peak_k = float(ref[k].abs().max())
        card_err = float((got[k][:2].cpu().to(torch.complex128) - ref[k]).abs().max()) / peak_k
        cpu_err = float((ref32[k].to(torch.complex128) - ref[k]).abs().max()) / peak_k
        ok = card_err <= 4 * cpu_err + 1e-6
        print(f"  beamforming {k} (first 2 of 64) against the CPU's complex128, relative to its peak: card "
              f"{card_err:.3e}, the CPU's complex64 {cpu_err:.3e} (limit four times that + 1e-6) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"beamforming {k}: the card's complex64 error {card_err:.3e} exceeds the CPU's")
        berr[k] = card_err
    timed(f"beamforming (psd, souden, evd, power, 2 x rtf, apply) at {shp}", lambda: beamform(spec, mask),
          max_abs_err=max(berr.values()))
    del spec, src, got

    # frechet_distance at dimension 128 (FAD's VGGish embeddings; statistics in float64)
    g = torch.Generator(device=dev).manual_seed(54)
    a, b = torch.randn((2, 128, 128), generator=g, device=dev, dtype=torch.float64) / 4
    eye = torch.eye(128, device=dev, dtype=torch.float64)
    args = [torch.randn(128, generator=g, device=dev, dtype=torch.float64), a @ a.T + eye,
            torch.randn(128, generator=g, device=dev, dtype=torch.float64), b @ b.T + eye]
    fd = F.frechet_distance(*args)
    # both cast the eigenvalues to complex64: a float32 sum of 128 square roots
    err = check_close("frechet_distance, dimension 128, against the CPU", fd.cpu(),
                      F.frechet_distance(*(v.cpu() for v in args)), 1e-4, 1e-5)
    lib = torch.backends.cuda.preferred_linalg_library()
    timed("frechet_distance at dimension 128", lambda: F.frechet_distance(*args), max_abs_err=err,
          linalg_library=str(lib), value=float(fd))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.linalg.eigvals(args[1] @ args[3])
        torch.cuda.synchronize()
    eig_kernels = sorted({r[0][:60] for r in device_kernel_rows(prof, 1)})
    out["frechet_distance at dimension 128"]["eigvals_kernels"] = eig_kernels
    print(f"    frechet_distance = {float(fd):.6f}; torch.backends.cuda.preferred_linalg_library(): {lib}; the "
          f"kernels of one torch.linalg.eigvals call on the card: {eig_kernels}")

    # mu-law at full width: every code equal to the CPU's
    codes = F.mu_law_encoding(x16, 256)
    mismatches = int((codes.cpu() != F.mu_law_encoding(x16.cpu(), 256)).sum())
    print(f"  mu_law_encoding at ({B}, {T}): {mismatches} of {codes.numel()} codes differ from the CPU's (limit 0)")
    if mismatches:
        raise AssertionError("mu_law_encoding: codes differ from the CPU's")
    dec = F.mu_law_decoding(codes, 256)
    err = check_close("mu_law_decoding (first 4 rows) against the CPU", dec[:4].cpu(),
                      F.mu_law_decoding(codes[:4].cpu(), 256), *F32_TOL)
    timed(f"mu_law_encoding at ({B}, {T})", lambda: F.mu_law_encoding(x16, 256))
    timed(f"mu_law_decoding at ({B}, {T})", lambda: F.mu_law_decoding(codes, 256), max_abs_err=err)
    del codes, dec, x16

    # ctc_loss at the wav2letter recipe's shape, against the CPU and torch.nn.functional.ctc_loss
    g = torch.Generator(device=dev).manual_seed(55)
    lp = torch.log_softmax(torch.randn((CTC_B, CTC_T, FE_V), generator=g, device=dev), -1)
    tl = torch.randint(CTC_L // 2, CTC_L + 1, (CTC_B,), generator=g, device=dev)
    il = torch.randint(CTC_T - 50, CTC_T + 1, (CTC_B,), generator=g, device=dev)
    tgt = torch.randint(1, FE_V, (CTC_B, CTC_L), generator=g, device=dev)
    mine = ctc_loss(lp, tgt, il, tl, reduction="none")
    lib_loss = torch.nn.functional.ctc_loss(lp.transpose(0, 1), tgt, il, tl, reduction="none")
    err = check_close(f"ctc_loss at ({CTC_B}, {CTC_T}, {FE_V}), L <= {CTC_L}, against the CPU", mine.cpu(),
                      ctc_loss(lp.cpu(), tgt.cpu(), il.cpu(), tl.cpu(), reduction="none"), *F32_TOL)
    lib_err = check_close("ctc_loss against torch.nn.functional.ctc_loss on the card", mine, lib_loss, *F32_TOL)

    def fwd_bwd(fn):
        def run():
            with torch.enable_grad():
                x = lp.detach().requires_grad_(True)
                fn(x).backward()
        return run

    port = lambda x: ctc_loss(x, tgt, il, tl)  # noqa: E731
    library = lambda x: torch.nn.functional.ctc_loss(x.transpose(0, 1), tgt, il, tl)  # noqa: E731
    out["ctc_loss recipe shape"] = {
        "ms": median_call_ms(lambda: port(lp))[0], "library_ms": median_call_ms(lambda: library(lp))[0],
        "fwd_bwd_ms": median_call_ms(fwd_bwd(port))[0], "library_fwd_bwd_ms": median_call_ms(fwd_bwd(library))[0],
        "max_abs_err": err, "library_err": lib_err}
    r = out["ctc_loss recipe shape"]
    print(f"  ctc_loss at ({CTC_B}, {CTC_T}, {FE_V}): the port {r['ms']:.3f} ms (forward + backward "
          f"{r['fwd_bwd_ms']:.3f}), torch.nn.functional.ctc_loss {r['library_ms']:.3f} ms (forward + backward "
          f"{r['library_fwd_bwd_ms']:.3f}) on {card}")
    return out


# ------------------------------------------------------------------ phase 12: transforms and Kaldi features
TR_FACTORS = (0.9, 1.0, 1.1)  # SpeedPerturbation's factors, the LibriSpeech recipes'
TR_MFCC, TR_MASK_SEED = 40, 45
TR_ROWS = 1024  # phase 12 (b): rows of 1 s for each waveform class
AST = dict(htk_compat=True, window_type="hanning", num_mel_bins=128, frame_shift=10.0, use_energy=False,
           dither=0.0, sample_frequency=SR)  # the Audio Spectrogram Transformer's fbank (src/dataloader.py)
AST_CLIPS, AST_SECONDS, KALDI_MINUTES = 256, 10, 10
KALDI_SPEC_TOL, KALDI_FEAT_TOL = (2e-4, 1e-4), (3e-3, 1e-4)  # tests/compliance/test_kaldi.py's


def transform_modules(dev) -> dict:
    """Phase 12 (a)'s modules, their buffers on ``dev``."""
    import audio_tpu_torch.transforms as TT

    return {"speed": TT.SpeedPerturbation(SR, list(TR_FACTORS), device=dev), "noise": TT.AddNoise(),
            "deemphasis": TT.Deemphasis(0.97), "loudness": TT.Loudness(SR),
            "mfcc": TT.MFCC(SR, n_mfcc=TR_MFCC, melkwargs=dict(n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS),
                            device=dev),
            "cmn": TT.SlidingWindowCmn(FE_CMN), "deltas": TT.ComputeDeltas(),
            "specaugment": TT.SpecAugment(2, FE_TIME_MASK, 2, FE_FREQ_MASK, iid_masks=True),
            "lfcc": TT.LFCC(SR, n_lfcc=TR_MFCC, speckwargs=dict(n_fft=N_FFT, hop_length=HOP), device=dev)}


def speed_seed(card) -> int:
    """The first seed whose card generator makes SpeedPerturbation draw factor 1.1, phase 11's speed."""
    import torch

    return next(s for s in range(100) if TR_FACTORS[int(torch.randint(
        0, len(TR_FACTORS), (), device=card, generator=torch.Generator(device=card).manual_seed(s)))] == 1.1)


def transform_stages(card, seed: int):
    """Phase 12 (a)'s front end as (name, stage, output key) triples; a stage maps (state, modules) to
    the next state: SpeedPerturbation -> AddNoise -> Deemphasis (K1) -> Loudness normalisation (K1) ->
    MFCC (K2) -> SlidingWindowCmn -> ComputeDeltas -> SpecAugment, and LFCC (K2) on the waveforms
    MFCC reads.  The random stages draw from generators on ``card``, whichever device computes."""
    import torch

    def speed(s, m):
        y, lengths = m["speed"](s["wav"], s["lengths"], torch.Generator(device=card).manual_seed(seed))
        y = torch.nn.functional.pad(y[..., :T], (0, max(0, T - y.shape[-1])))
        return {**s, "wav": y, "lengths": lengths.clamp(max=T)}

    def loudness(s, m):
        lufs = m["loudness"](s["wav"][:, None])
        return {**s, "lufs": lufs, "wav": s["wav"] * (10 ** ((FE_LUFS - lufs) / 20))[:, None]}

    def augment(s, m):
        return {**s, "spec": m["specaugment"](s["spec"], torch.Generator(device=card).manual_seed(TR_MASK_SEED))}

    return [
        ("SpeedPerturbation", speed, "wav"),
        ("AddNoise 0-20 dB", lambda s, m: {**s, "wav": m["noise"](s["wav"], s["noise"], s["snr"], s["lengths"])},
         "wav"),
        ("Deemphasis 0.97", lambda s, m: {**s, "wav": m["deemphasis"](s["wav"])}, "wav"),
        ("Loudness to -23 LUFS", loudness, "wav"),
        ("MFCC", lambda s, m: {**s, "mfcc": m["mfcc"](s["wav"][:, None])[:, 0]}, "mfcc"),  # top_db a clip
        ("SlidingWindowCmn", lambda s, m: {**s, "feats": m["cmn"](s["mfcc"].transpose(1, 2)).transpose(1, 2)},
         "feats"),
        ("ComputeDeltas", lambda s, m: {**s, "spec": torch.cat([s["feats"], m["deltas"](s["feats"])], dim=1)},
         "spec"),
        ("SpecAugment", augment, "spec"),
        ("LFCC", lambda s, m: {**s, "lfcc": m["lfcc"](s["wav"][:, None])[:, 0]}, "lfcc"),
    ]


def check_transform_stage(name: str, key: str, stage, card_in: dict, card_out: dict, cpu_modules: dict,
                          card) -> float:
    """A stage's first FE_ROWS rows on the card against the same module on the CPU, on the card's input
    rows: the CPU parity tests' float32 tolerances (CMN 1e-5 and deltas 1e-6 of their input's peak),
    MFCC and LFCC at K2's 5e-4 of the peak, SpeedPerturbation's lengths equal; SpecAugment equal to
    its four masks' formula on the card generator's draws, filled with the mean of the card's whole
    batch."""
    import torch

    from audio_tpu_torch.functional._misc import _mask_draws, _span_mask

    cpu_in = rows_of(card_in, FE_ROWS, "cpu")
    label = f"{name} (first {FE_ROWS} rows) against the CPU"
    if name == "SpecAugment":
        spec = card_in["spec"]
        want = cpu_in["spec"]
        fill = spec.mean().cpu()
        g = torch.Generator(device=card).manual_seed(TR_MASK_SEED)
        masked = torch.zeros_like(want, dtype=torch.bool)
        for axis, param in ((2, FE_TIME_MASK), (2, FE_TIME_MASK), (1, FE_FREQ_MASK), (1, FE_FREQ_MASK)):
            u_value, u_min = _mask_draws(spec.shape[:1], g, card)
            shape = [1, 1, 1]
            shape[axis] = spec.shape[axis]
            m = _span_mask(u_value[:FE_ROWS, None, None].cpu(), u_min[:FE_ROWS, None, None].cpu(), param,
                           spec.shape[axis], shape, "cpu")
            want = torch.where(m, fill, want)
            masked |= m
        if not torch.equal(card_out["spec"][:FE_ROWS].cpu(), want):
            raise AssertionError(f"{label}: not the masks of the generator's draws")
        print(f"  {label}: equal to the four masks of the CUDA generator's draws ({int(masked.sum())} entries "
              f"masked, filled with the batch mean {float(fill):.4f})")
        return 0.0
    ref = stage(cpu_in, cpu_modules)
    tol = F32_TOL
    if name in ("SlidingWindowCmn", "ComputeDeltas"):
        # both subtract values of the cepstra's scale (decibels, up to hundreds): the rounding of the
        # running sums and differences scales with the input's peak, not with the small result
        peak = float(card_in["mfcc" if name == "SlidingWindowCmn" else "feats"][:FE_ROWS].abs().max())
        tol = (1e-5 * peak, 1e-4) if name == "SlidingWindowCmn" else (1e-6 * peak, 1e-6)
    if key in ("mfcc", "lfcc"):
        tol = (5e-4 * float(ref[key].abs().max()), 0.0)
    if name == "SpeedPerturbation":
        check_equal(f"{label}: lengths", card_out["lengths"][:FE_ROWS].cpu(), ref["lengths"])
    if name.startswith("Loudness"):
        check_close(f"{label}: LUFS", card_out["lufs"][:FE_ROWS].cpu(), ref["lufs"], 0.01, 0.0)  # the JAX test's
    return check_close(label, card_out[key][:FE_ROWS].cpu(), ref[key], *tol)


def run_transform_front_end(dev, card: str) -> dict:
    """Phase 12 (a): the front end built from the port's transform modules at B = 8192 rows of 1 s at
    16 kHz.  One step with the launch counters read around it: K1 must move, only on "chunked", and
    K2, only on "fft".  Each stage's first rows against the same module on the CPU; MFCC and LFCC the
    same bits with cuBLAS's TF32 on; the step and each stage timed (median of 5), one step profiled."""
    import torch

    modules, cpu_modules = transform_modules(dev), transform_modules("cpu")
    seed = speed_seed(dev)
    stages = transform_stages(dev, seed)
    s0 = {k: v for k, v in front_end_state(dev, B).items() if k in ("wav", "lengths", "noise", "snr")}

    def step():
        s = s0
        for _, fn, _ in stages:
            s = fn(s, modules)
        return s

    reset_kernel_counts()
    final = step()
    torch.cuda.synchronize()
    counts = kernel_counts()
    what = "one transform front-end step (phase 12)"
    require_launches(what, counts, ["lfilter", "power_spectrogram"])
    require_route(what, counts, "lfilter", "chunked")
    require_route(what, counts, "power_spectrogram", "fft")
    out = {"speed_seed": seed, "launches": {k: counts[k] for k in ("lfilter", "lfilter_chunked",
                                                                       "power_spectrogram", "power_spectrogram_fft")}}
    for key, shape in (("mfcc", (B, TR_MFCC, T // HOP + 1)), ("spec", (B, 2 * TR_MFCC, T // HOP + 1)),
                       ("lfcc", (B, TR_MFCC, T // HOP + 1))):
        if tuple(final[key].shape) != shape or not bool(torch.isfinite(final[key]).all()):
            raise AssertionError(f"phase 12: {key} is {tuple(final[key].shape)} (want {shape}) or not finite")
    print(f"  transform front end at B={B}: speed factor 1.1 drawn (seed {seed}), MFCC {tuple(final['mfcc'].shape)}, "
          f"features with deltas {tuple(final['spec'].shape)}, LFCC {tuple(final['lfcc'].shape)}, all finite")

    s, stage_ms = s0, {}
    for name, fn, key in stages:
        nxt = fn(s, modules)
        err = check_transform_stage(name, key, fn, s, nxt, cpu_modules, dev)
        ms, runs = median_call_ms(lambda: fn(s, modules))
        stage_ms[name] = {"ms": ms, "runs_ms": runs, "max_abs_err": err}
        print(f"  {name} at B={B}: {ms:.3f} ms on {card}")
        if key in ("mfcc", "lfcc"):  # the filterbank and DCT products ignore cuBLAS's TF32 flag
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                same = torch.equal(fn(s, modules)[key], nxt[key])
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            print(f"  {name} with cuBLAS TF32 on: the same bits as with it off: {same}")
            if not same:
                raise AssertionError(f"{name}: cuBLAS's TF32 flag changed the result")
        s = nxt
    out["stages"] = stage_ms
    out["step_ms"], out["step_runs_ms"] = median_call_ms(step)
    print(f"  transform front-end step at B={B}: {out['step_ms']:.3f} ms on {card}")
    out["step_profile"] = profile_call(f"transform front-end step at B={B}", step, out["step_ms"])
    return out


def beam_check(name: str, card_out, cpu64, cpu128) -> float:
    """A complex64 beamforming output on the card against the CPU's complex128 result on the same inputs,
    relative to its peak: within four times the CPU's own complex64 error + 1e-6 (phase 11's rule)."""
    import torch

    peak = float(cpu128.abs().max())
    card_err = float((card_out.cpu().to(torch.complex128) - cpu128).abs().max()) / peak
    cpu_err = float((cpu64.to(torch.complex128) - cpu128).abs().max()) / peak
    ok = card_err <= 4 * cpu_err + 1e-6
    print(f"  {name} against the CPU's complex128, relative to its peak: card {card_err:.3e}, the CPU's complex64 "
          f"{cpu_err:.3e} (limit four times that + 1e-6) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the card's complex64 error {card_err:.3e} exceeds the CPU's")
    return card_err


def run_transform_classes(dev, card: str) -> dict:
    """Phase 12 (b): every other transform class once, on TR_ROWS rows of 1 s (the spectral, resampling,
    effect and decision classes), a (8, 6, 257, 200) STFT (the beamformers) and a (8, 100, 21, 1024)
    lattice (RNNTLoss): the card's first rows against the same module on the CPU at the CPU parity
    tests' tolerances, each timed (median of 5).  RNNTLoss must launch K8 and SpectralCentroid K2,
    only on "fft"."""
    import torch

    import audio_tpu_torch.functional as F
    import audio_tpu_torch.transforms as TT
    from audio_tpu_torch._internal.windows import hann_window

    out = {}

    def both(make):
        return make(dev), make("cpu")

    def timed(label, fn, **extra):
        ms, runs = median_call_ms(fn)
        out[label] = {"ms": ms, "runs_ms": runs, **extra}
        print(f"  {label}: {ms:.3f} ms on {card}")

    x = voiced_rows(dev, TR_ROWS, T, 90)
    x2 = x[:2].cpu()
    rows = f"({TR_ROWS}, {T})"

    # the complex spectrogram and its inverse; MelScale and its inverse (gels and gelsd) on its power
    spec_t, spec_c = both(lambda d: TT.Spectrogram(power=None, device=d))
    inv_t, inv_c = both(lambda d: TT.InverseSpectrogram(device=d))
    cs = spec_t(x)
    peak = float(cs.abs().max())
    err = check_close("Spectrogram(power=None) (first 2 rows, real and imaginary parts) against the CPU",
                      torch.view_as_real(cs[:2].cpu()), torch.view_as_real(spec_c(x2)), F32_TOL[0] * peak, F32_TOL[1])
    timed(f"Spectrogram(power=None) at {rows}", lambda: spec_t(x), max_abs_err=err)
    back = inv_t(cs, T)
    err = check_close("InverseSpectrogram (first 2 rows) against the CPU", back[:2].cpu(), inv_c(cs[:2].cpu(), T),
                      *F32_TOL)
    timed(f"InverseSpectrogram at {rows}", lambda: inv_t(cs, T), max_abs_err=err)
    power = cs.abs() ** 2
    mel_t, mel_c = both(lambda d: TT.MelScale(n_mels=40, sample_rate=SR, n_stft=N_FFT // 2 + 1, device=d))
    mel = mel_t(power)
    err = check_close("MelScale, 40 mels (first 2 rows) against the CPU", mel[:2].cpu(), mel_c(power[:2].cpu()),
                      *F32_TOL)
    timed(f"MelScale 40 mels at {rows}", lambda: mel_t(power), max_abs_err=err)
    for driver in ("gels", "gelsd"):
        im_t, im_c = both(lambda d: TT.InverseMelScale(N_FFT // 2 + 1, 40, SR, driver=driver, device=d))
        rec = im_t(mel)
        ref = im_c(mel[:2].cpu())
        err = check_close(f"InverseMelScale {driver} (first 2 rows) against the CPU", rec[:2].cpu(), ref,
                          F32_TOL[0] * float(ref.abs().max()), F32_TOL[1])
        timed(f"InverseMelScale {driver} at {rows}", lambda: im_t(mel), max_abs_err=err)

    # TimeStretch at rate 1.3: the accumulated phase's float32 rounding bound of phase 10
    ts_t, ts_c = both(lambda d: TT.TimeStretch(hop_length=N_FFT // 2, n_freq=N_FFT // 2 + 1, fixed_rate=1.3,
                                               device=d))
    stretched = ts_t(cs)
    ref = ts_c(cs[:2].cpu())
    frames = torch.arange(1, ref.shape[-1] + 1, dtype=torch.float64)
    bound = 1e-5 + 4 * ref.abs().double() * torch.finfo(torch.float32).eps * frames * (
        math.pi * (N_FFT // 2) + 2 * math.pi)
    terr = (stretched[:2].cpu() - ref).abs()
    if stretched.shape[-1] != math.ceil(cs.shape[-1] / 1.3) or not bool((terr <= bound).all()):
        raise AssertionError("TimeStretch: frames or values differ from the CPU's")
    print(f"  TimeStretch rate 1.3 (first 2 rows) against the CPU: max_abs_err {float(terr.max()):.3e}, within the "
          "float32 phase bound")
    timed(f"TimeStretch 1.3 at {rows}", lambda: ts_t(cs), max_abs_err=float(terr.max()))

    # GriffinLim: float64 at B = 2 without random phases, card against the CPU; timed at B = 32 from
    # random phases drawn by a card generator
    gl_t, gl_c = both(lambda d: TT.GriffinLim(n_iter=32, length=T, rand_init=False, device=d).double())
    p64 = power[:2].double()
    ref = gl_c(p64.cpu())
    err = check_close("GriffinLim f64, B 2, no random phases: card against the CPU", gl_t(p64).cpu(), ref,
                      1e-6 * float(ref.abs().max()), 0.0)
    gl_rand = TT.GriffinLim(n_iter=32, length=T, device=dev)
    p32 = power[:32]
    timed("GriffinLim 32 iterations at (32, 201, 81), random phases",
          lambda: gl_rand(p32, torch.Generator(device=dev).manual_seed(8)), max_abs_err=err)

    # PitchShift an octave either way (the pitch_shift parity test's float32 phase bound)
    for steps in (12, -12):
        ps_t, ps_c = both(lambda d: TT.PitchShift(SR, steps, device=d))
        y = ps_t(x)
        hop = ps_t.hop_length
        bound = 4 * float(torch.finfo(torch.float32).eps) * (2 * T // hop + 2) * (math.pi * hop + 2 * math.pi) * float(
            x2.abs().max())
        err = check_close(f"PitchShift {steps:+d} (first 2 rows) against the CPU", y[:2].cpu(), ps_c(x2), bound, 0.0)
        timed(f"PitchShift {steps:+d} at {rows}", lambda: ps_t(x), max_abs_err=err)

    # Resample 48 -> 16 kHz with its kernel built once
    x48 = voiced_rows(dev, TR_ROWS, 48000, 91)
    rs_t, rs_c = both(lambda d: TT.Resample(48000, 16000, device=d))
    err = check_close("Resample 48 -> 16 kHz (first 2 rows) against the CPU", rs_t(x48)[:2].cpu(),
                      rs_c(x48[:2].cpu()), *F32_TOL)
    timed(f"Resample 48 -> 16 kHz at ({TR_ROWS}, 48000)", lambda: rs_t(x48), max_abs_err=err)
    del x48

    # effects: Fade's five shapes, Vol's three gains, Preemphasis, the convolutions, mu-law
    g = torch.Generator(device=dev).manual_seed(92)
    fir = torch.randn((1, 64), generator=g, device=dev) / 8
    room = torch.randn((1, 8000), generator=g, device=dev) * torch.exp(-torch.arange(8000, device=dev) / 1600.0)
    effects = [(f"Fade {shape}", lambda d, sh=shape: TT.Fade(1600, 3200, sh), F32_TOL, ())
               for shape in ("linear", "exponential", "logarithmic", "quarter_sine", "half_sine")]
    effects += [("Vol 0.5 amplitude", lambda d: TT.Vol(0.5), F32_TOL, ()),
                ("Vol +6 dB", lambda d: TT.Vol(6.0, "db"), F32_TOL, ()),
                ("Vol 2 power", lambda d: TT.Vol(2.0, "power"), F32_TOL, ()),
                ("Preemphasis 0.97", lambda d: TT.Preemphasis(0.97), (1e-7, 0.0), ()),
                ("Convolve 64 taps", lambda d: TT.Convolve("same"), F32_TOL, (fir,)),
                ("FFTConvolve 8000 taps", lambda d: TT.FFTConvolve("full"), F32_TOL, (room,))]
    for name, make, tol, extra in effects:
        m_t, m_c = both(make)
        err = check_close(f"{name} (first 2 rows) against the CPU", m_t(x, *extra)[:2].cpu(),
                          m_c(x2, *(e.cpu() for e in extra)), *tol)
        timed(f"{name} at {rows}", lambda: m_t(x, *extra), max_abs_err=err)
    enc_t, dec_t = TT.MuLawEncoding(256), TT.MuLawDecoding(256)
    codes = enc_t(x)
    differ = int((codes.cpu() != enc_t(x.cpu())).sum())
    print(f"  MuLawEncoding at {rows}: {differ} of {codes.numel()} codes differ from the CPU's (limit 0)")
    if differ:
        raise AssertionError("MuLawEncoding: codes differ from the CPU's")
    err = check_close("MuLawDecoding (first 2 rows) against the CPU", dec_t(codes)[:2].cpu(), dec_t(codes[:2].cpu()),
                      *F32_TOL)
    timed(f"MuLawEncoding at {rows}", lambda: enc_t(x))
    timed(f"MuLawDecoding at {rows}", lambda: dec_t(codes), max_abs_err=err)

    # the axis masks on (rows, 80, frames) features: a card generator's draws, the CPU module given the same
    feats = torch.log1p(F.mel_spectrogram(x, F.melscale_fbanks(N_FFT // 2 + 1, 0.0, SR / 2, N_MELS, SR, device=dev),
                                          hann_window(N_FFT, device=dev), N_FFT, HOP, N_FFT))
    for name, make in (("FrequencyMasking 27", lambda: TT.FrequencyMasking(FE_FREQ_MASK)),
                       ("TimeMasking 40", lambda: TT.TimeMasking(FE_TIME_MASK))):
        m = make()
        got = m(feats, 0.0, torch.Generator(device=dev).manual_seed(93))
        want = m(feats[:2].cpu(), 0.0, torch.Generator(device=dev).manual_seed(93))
        if not torch.equal(got[:2].cpu(), want):
            raise AssertionError(f"{name}: the card's span differs from the CPU's on the same draws")
        print(f"  {name} (first 2 rows) on the card generator's draws: equal to the CPU's "
              f"({int((want == 0).all(0).sum())} entries of a row masked)")
        timed(f"{name} at {tuple(feats.shape)}", lambda: m(feats, 0.0, torch.Generator(device=dev).manual_seed(93)))

    # SpectralCentroid: K2 must launch, only on "fft"
    sc_t, sc_c = both(lambda d: TT.SpectralCentroid(SR, device=d))
    reset_kernel_counts()
    sc = sc_t(x)
    torch.cuda.synchronize()
    counts = kernel_counts()
    require_launches("SpectralCentroid (phase 12)", counts, ["power_spectrogram"])
    require_route("SpectralCentroid (phase 12)", counts, "power_spectrogram", "fft")
    out["centroid_launches"] = {k: counts[k] for k in ("power_spectrogram", "power_spectrogram_fft")}
    err = check_close("SpectralCentroid (first 2 rows) against the CPU", sc[:2].cpu(), sc_c(x2), 0.0, 1e-4)
    timed(f"SpectralCentroid at {rows}", lambda: sc_t(x), max_abs_err=err)

    # Vad on three two-channel recordings of 4 s: the same trimmed samples as the CPU
    vad = TT.Vad(SR)
    lengths = []
    for i, onset in enumerate((0.5, 1.5, 2.5)):
        g = torch.Generator(device=dev).manual_seed(94 + i)
        rec = 0.005 * torch.randn((2, 4 * SR), generator=g, device=dev)
        start = int(onset * SR)
        rec[:, start:start + SR] += voiced_rows(dev, 2, SR, 97 + i) * 3
        got, want = vad(rec), vad(rec.cpu())
        if got.shape != want.shape or not torch.equal(got.cpu(), want):
            raise AssertionError(f"Vad, onset {onset} s: the card gives {tuple(got.shape)}, the CPU "
                                 f"{tuple(want.shape)}")
        lengths.append(got.shape[-1])
    timed(f"Vad on (2, {4 * SR})", lambda: vad(rec))
    out["vad_lengths"] = lengths
    print(f"  Vad on three (2, {4 * SR}) recordings: trimmed to {lengths} samples, equal to the CPU's")
    del x, cs, power, feats, codes

    # beamforming on a 6-channel complex64 STFT: PSD, MVDR online over three calls, RTFMVDR, SoudenMVDR
    g = torch.Generator(device=dev).manual_seed(100)
    shp = (8, 6, 257, 200)
    specs, masks = [], []
    for _ in range(3):
        src = torch.randn((8, 1, 257, 200), generator=g, device=dev, dtype=torch.complex64)
        h = torch.randn((8, 6, 257, 1), generator=g, device=dev, dtype=torch.complex64)
        specs.append(src * h + 0.3 * torch.randn(shp, generator=g, device=dev, dtype=torch.complex64))
        masks.append(torch.rand((8, 257, 200), generator=g, device=dev))
    sp, mk = specs[0], masks[0]
    runs = [(sp, mk), (sp[:2].cpu(), mk[:2].cpu()), (sp[:2].cpu().to(torch.complex128), mk[:2].cpu().double())]
    psd = TT.PSD()
    outs = [psd(s_, m_) for s_, m_ in runs]
    berr = {"PSD": beam_check("PSD (first 2 of 8)", outs[0][:2], outs[1], outs[2])}
    timed(f"PSD at {shp}", lambda: psd(sp, mk), max_abs_err=berr["PSD"])
    rtf = [F.rtf_power(psd(s_, m_), psd(s_, 1 - m_), 0) for s_, m_ in runs]
    for name, module, args in (
            ("RTFMVDR", TT.RTFMVDR(), lambda i: (rtf[i], psd(runs[i][0], 1 - runs[i][1]), 0)),
            ("SoudenMVDR", TT.SoudenMVDR(),
             lambda i: (psd(runs[i][0], runs[i][1]), psd(runs[i][0], 1 - runs[i][1]), 0))):
        outs = [module(runs[i][0], *args(i)) for i in range(3)]
        berr[name] = beam_check(f"{name} (first 2 of 8)", outs[0][:2], outs[1], outs[2])
        card_args = args(0)
        timed(f"{name} at {shp}", lambda: module(sp, *card_args), max_abs_err=berr[name])
    mvdrs = [TT.MVDR(ref_channel=0, solution="stv_power", online=True) for _ in range(3)]
    for call, (s_, m_) in enumerate(zip(specs, masks)):
        ins = [(s_, m_), (s_[:2].cpu(), m_[:2].cpu()), (s_[:2].cpu().to(torch.complex128), m_[:2].cpu().double())]
        outs = [mv(a, b, 1 - b) for mv, (a, b) in zip(mvdrs, ins)]
        berr[f"MVDR online call {call + 1}"] = beam_check(f"MVDR online, call {call + 1} (first 2 of 8)", outs[0][:2],
                                                           outs[1], outs[2])
    mvdr = TT.MVDR(ref_channel=0, solution="stv_power")
    timed(f"MVDR stv_power at {shp}", lambda: mvdr(sp, mk, 1 - mk), max_abs_err=max(berr.values()))
    out["beamforming_err"] = berr
    del specs, masks, runs, outs, rtf

    # RNNTLoss: K8 must launch
    g = torch.Generator(device=dev).manual_seed(101)
    logits = torch.randn((8, 100, 21, 1024), generator=g, device=dev)
    tgt = torch.randint(1, 1024, (8, 20), generator=g, device=dev, dtype=torch.int32)
    lg = torch.randint(80, 101, (8,), generator=g, device=dev, dtype=torch.int32)
    tg = torch.randint(10, 21, (8,), generator=g, device=dev, dtype=torch.int32)
    loss = TT.RNNTLoss(blank=0, reduction="none")
    reset_kernel_counts()
    got = loss(logits, tgt, lg, tg)
    torch.cuda.synchronize()
    counts = kernel_counts()
    require_launches("RNNTLoss (phase 12)", counts, ["lattice_row_stats"])
    out["rnnt_launches"] = {"lattice_row_stats": counts["lattice_row_stats"]}
    err = check_close("RNNTLoss at (8, 100, 21, 1024) against the CPU", got.cpu(),
                      loss(logits.cpu(), tgt.cpu(), lg.cpu(), tg.cpu()), *F32_TOL)
    timed("RNNTLoss at (8, 100, 21, 1024)", lambda: loss(logits, tgt, lg, tg), max_abs_err=err)
    return out


def run_kaldi(dev, card: str) -> dict:
    """Phase 12 (c): ``compliance.kaldi`` on the card.  ``fbank`` in the Audio Spectrogram Transformer's
    setting on AST_CLIPS clips of 10 s at 16 kHz, one call a clip as the API takes one channel (the
    calls a second, the first 2 clips against the CPU, the loop's idle share from a profile of 32
    calls); ``mfcc`` (defaults) and ``spectrogram`` once each on one 10-minute channel, against the CPU.
    The tolerances are the JAX package's test's: 3e-3 abs + 1e-4 rel for fbank and mfcc, 2e-4 + 1e-4
    for the log power spectrogram."""
    import torch

    import audio_tpu_torch.compliance.kaldi as K

    out = {}
    n = AST_SECONDS * SR
    clips = voiced_rows(dev, AST_CLIPS, n, 110)

    def clip_loop(count=AST_CLIPS):
        return [K.fbank(clips[i:i + 1], **AST) for i in range(count)]

    feats = clip_loop()
    want = (1 + (n - 400) // 160, AST["num_mel_bins"])
    if any(tuple(f.shape) != want or not bool(torch.isfinite(f).all()) for f in feats):
        raise AssertionError(f"kaldi.fbank: a clip's features are not finite {want}")
    out["fbank_err"] = max(check_close(f"kaldi.fbank AST setting, clip {i} against the CPU", feats[i].cpu(),
                                       K.fbank(clips[i:i + 1].cpu(), **AST), *KALDI_FEAT_TOL) for i in range(2))
    loops = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip_loop()
        torch.cuda.synchronize()
        loops.append(time.perf_counter() - t0)
    out["fbank_loop_s"] = statistics.median(loops)
    out["fbank_clips_per_s"] = AST_CLIPS / out["fbank_loop_s"]
    print(f"  kaldi.fbank (AST: 128 bins, hanning, htk_compat) over {AST_CLIPS} clips of {AST_SECONDS} s, one call a "
          f"clip: {out['fbank_clips_per_s']:.1f} clips/s ({out['fbank_loop_s'] * 1e3:.1f} ms a loop, median of 3, "
          f"host clock) on {card}")
    profiled = min(32, AST_CLIPS)
    out["fbank_profile"] = profile_call(f"fbank loop of {profiled} clips", lambda: clip_loop(profiled),
                                        out["fbank_loop_s"] * 1e3 * profiled / AST_CLIPS)
    del clips, feats

    long = voiced_rows(dev, 1, KALDI_MINUTES * 60 * SR, 111)
    long_cpu = long.cpu()
    for name, fn, tol in (("mfcc", K.mfcc, KALDI_FEAT_TOL), ("spectrogram", K.spectrogram, KALDI_SPEC_TOL)):
        got = fn(long)
        ref = fn(long_cpu)
        err = check_close(f"kaldi.{name} on one {KALDI_MINUTES}-minute channel {tuple(got.shape)} against the CPU",
                          got.cpu(), ref, *tol)
        ms, runs = median_call_ms(lambda: fn(long))
        out[name] = {"ms": ms, "runs_ms": runs, "max_abs_err": err, "shape": list(got.shape)}
        print(f"  kaldi.{name} on ({KALDI_MINUTES * 60 * SR},): {ms:.3f} ms on {card}")
    return out


# ------------------------------------------------------------------ phase 13: wav2vec2/HuBERT and WavLM
# the MMS_FA bundle's model (audio_tpu/pipelines/_wav2vec2/_bundle_data.py, "MMS_FA"): 28 outputs once the
# bundle drops 3 of the checkpoint's 31, then a zero star column (audio_tpu/pipelines/_wav2vec2/impl.py:70-76)
MMS_FA = dict(extractor_mode="layer_norm", extractor_conv_layer_config=None, extractor_conv_bias=True,
              encoder_embed_dim=1024, encoder_projection_dropout=0.0, encoder_pos_conv_kernel=128,
              encoder_pos_conv_groups=16, encoder_num_layers=24, encoder_num_heads=16,
              encoder_attention_dropout=0.0, encoder_ff_interm_features=4096, encoder_ff_interm_dropout=0.1,
              encoder_dropout=0.0, encoder_layer_norm_first=True, encoder_layer_drop=0.1, aux_num_out=28)
FA_B, FA_SECONDS, FA_MIN_SECONDS, FA_L = 16, 15, 10, 100  # clips, padded length, shortest clip, tokens a clip
ASR_B, ASR_SECONDS, ASR_MIN_SECONDS, ASR_V = 32, 10, 6, 29  # WAV2VEC2_ASR_BASE_960H's 29 labels
SSL_B, SSL_SECONDS = 32, 10  # SUPERB-style features: wavlm_base_plus, every layer
CMP_B, CMP_SECONDS, CMP_MIN_SECONDS = 2, 4, 3  # each model in f32 on the card against the CPU
CMP_TOL, BF16_REL_L2 = 1e-3, 0.05  # of the CPU output's peak; bf16 against f32 on the card, relative L2


def model_flops(model, n_samples: int, batch: int, backward: str = "none") -> float:
    """Operations (2 a multiply-add) of ``model`` on ``batch`` clips of ``n_samples``, counted from its
    modules' shapes: the convolutions, projections, attention's two products, the feed-forwards, WavLM's
    gate and the head.  Every frame of the padded batch is computed, so all are counted.  ``backward``
    adds a train step's backward, twice the forward of each part it runs through (the gradients of the
    part's inputs and of its weights): "all" parts, "encoder" all but the conv stack (frozen, run
    without a graph), "head" the aux head alone; "none" counts the forward."""
    conv, t = 0.0, n_samples
    for block in model.feature_extractor.conv_layers:
        c = block.conv
        t = (t - c.kernel_size[0]) // c.stride[0] + 1
        conv += 2 * c.in_channels * c.out_channels * c.kernel_size[0] * t
    if t != frames_of(model, n_samples):
        raise AssertionError("model_flops: frame count")
    proj = model.encoder.feature_projection.projection
    d = proj.out_features
    pos = model.encoder.transformer.pos_conv_embed.conv
    encoder = 2 * proj.in_features * d * t + 2 * d * (d // pos.groups) * pos.kernel_size[0] * t
    for layer in model.encoder.transformer.layers:
        f = layer.feed_forward.intermediate_dense.out_features
        encoder += 2 * t * (4 * d * d + 2 * d * f) + 4 * t * t * d
        if getattr(layer.attention, "gru_rel_pos", False):
            encoder += 2 * t * d * 8
    head = 0.0 if model.aux is None else 2 * t * d * model.aux.out_features
    scale = {"none": (1, 1, 1), "all": (3, 3, 3), "encoder": (1, 3, 3), "head": (1, 1, 3)}[backward]
    return batch * (scale[0] * conv + scale[1] * encoder + scale[2] * head)


def frames_of(model, n_samples: int) -> int:
    """The feature extractor's frames for ``n_samples``."""
    for block in model.feature_extractor.conv_layers:
        n_samples = (n_samples - block.kernel_size) // block.stride + 1
    return n_samples


def padded_clips(dev, b: int, seconds: int, min_seconds: int, seed: int):
    """``b`` voiced clips padded to ``seconds``, their lengths drawn from ``min_seconds`` to ``seconds`` (the
    first clip full), zero past each length."""
    import torch

    n = seconds * SR
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    lengths = torch.randint(min_seconds * SR, n + 1, (b,), generator=g, device=dev)
    lengths[0] = n
    valid = torch.arange(n, device=dev)[None, :] < lengths[:, None]
    return voiced_rows(dev, b, n, seed) * valid, lengths


def normalise_clips(wav, lengths):
    """Each clip to zero mean and unit variance over its own samples (eps 1e-5), as the MMS_FA bundle
    normalises the clip it is called on (audio_tpu/pipelines/_wav2vec2/impl.py:62-67); padding stays zero."""
    import torch

    valid = torch.arange(wav.shape[1], device=wav.device)[None, :] < lengths[:, None]
    n = lengths[:, None].to(wav.dtype)
    mean = (wav * valid).sum(1, keepdim=True) / n
    var = (((wav - mean) * valid) ** 2).sum(1, keepdim=True) / n
    return torch.where(valid, (wav - mean) * torch.rsqrt(var + 1e-5), torch.zeros_like(wav))


def rel_l2(got, ref) -> float:
    return float((got.double() - ref.double()).norm() / ref.double().norm())


def compare_model_with_cpu(name: str, model, run, dev, seed: int) -> dict:
    """``run(model, wav, lengths)`` (a list of outputs) in f32 on CMP_B clips of CMP_SECONDS on the card
    against the same model on the CPU: each output's max error within CMP_TOL of its peak; and the
    same bits again with cuDNN's TF32 on."""
    import torch

    wav, lengths = padded_clips(dev, CMP_B, CMP_SECONDS, CMP_MIN_SECONDS, seed)
    got = run(model, wav, lengths)
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with_tf32 = run(model, wav, lengths)
    finally:
        torch.backends.cudnn.allow_tf32 = previous
    moved = [i for i, (a, b) in enumerate(zip(got, with_tf32)) if not torch.equal(a, b)]
    if moved:
        raise AssertionError(f"{name}: f32 outputs {moved} moved with cuDNN's TF32 on")
    ref = run(copy.deepcopy(model).cpu(), wav.cpu(), lengths.cpu())
    worst = 0.0
    for i, (a, r) in enumerate(zip(got, ref)):
        peak = float(r.abs().max())
        err = check_close(f"{name} f32, B={CMP_B} x {CMP_SECONDS} s, output {i} against the CPU", a.cpu(), r,
                          CMP_TOL * peak, 0.0, quiet=len(got) > 1)
        worst = max(worst, err / peak)
    print(f"  {name} f32 against the CPU: worst max error {worst:.3e} of the output's peak over {len(got)} "
          f"output(s) (limit {CMP_TOL:g}); the same bits with cuDNN's TF32 on")
    return {"max_err_of_peak": worst}


def check_bf16(name: str, got: list, ref: list) -> float:
    """Every bf16 output finite and within BF16_REL_L2 of the f32 output in relative L2; the worst."""
    import torch

    errs = []
    for a, r in zip(got, ref):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: a bf16 output is not finite")
        errs.append(rel_l2(a, r))
    worst = max(errs)
    print(f"  {name}: bf16 against f32 on the card, relative L2 {worst:.4e} at worst over {len(errs)} output(s) "
          f"(limit {BF16_REL_L2:g})")
    if worst > BF16_REL_L2:
        raise AssertionError(f"{name}: bf16 output {errs.index(worst)} off f32 by {worst:.4e} relative L2")
    return worst


def profile_batch(name: str, fn, against_key_averages: bool = False) -> dict:
    """One call of ``fn`` under torch.profiler: its launches, the kernels' summed time (``busy_ms``), the time the
    device was busy (the union of the kernels' intervals, ``device_busy_union_ms``) and the idle share it leaves of
    the profiled call's own elapsed time (CUDA events inside the profile: the tracing lengthens the kernels, so busy
    time can exceed an untraced call), and the longest kernels; with ``against_key_averages``, the launches held to
    ``key_averages``' count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    call_ms = start.elapsed_time(end)
    rows = device_kernel_rows(prof, 1)
    if against_key_averages:
        check_rows_against_key_averages(prof, rows)
    busy, n = sum(r[1] for r in rows), sum(r[2] for r in rows)
    union = device_busy_union_ms(prof)
    print(f"  profile of one {name} call: {n:g} kernel launches, {busy:.3f} ms of kernel time, device busy "
          f"{union:.3f} ms in a {call_ms:.3f} ms profiled call (idle share {1 - union / call_ms:.3f}); the longest "
          "kernels:")
    for kernel, ms, count in rows[:8]:
        print(f"    {ms:8.3f} ms  x{count:g}  {kernel[:100]}")
    return {"launches": n, "busy_ms": busy, "busy_union_ms": union, "profiled_call_ms": call_ms,
            "idle_share": 1 - union / call_ms, "by_kernel": rows[:12]}


def time_batch(name: str, fn, card: str, audio_s: float, flops: float, peak_rate: float) -> dict:
    """ms a batch (CUDA events, median of 5 after a warm-up), seconds of audio a second, one profiled
    call, the peak memory and the model's share of the peak rate."""
    ms, runs = median_call_ms(fn)
    _, peak_gb = peak_call(fn)
    out = {"ms": ms, "runs_ms": runs, "audio_s_per_s": audio_s / (ms / 1e3), "peak_gb": peak_gb,
           "model_tflop": flops / 1e12, "share_of_peak": flops / (ms / 1e3) / peak_rate}
    print(f"  {name}: {ms:.3f} ms a batch (runs {', '.join(f'{r:.3f}' for r in runs)}), {out['audio_s_per_s']:.1f} s "
          f"of audio a second, peak memory {peak_gb:.3f} GB, model {out['model_tflop']:.3f} TFLOP = "
          f"{out['share_of_peak']:.3f} of {peak_rate / 1e12:g} TFLOP/s on {card}")
    out["profile"] = profile_batch(name, fn)
    return out


def check_paths(name: str, paths, scores, frames, targets, emission) -> None:
    """Every path a CTC alignment of its targets (merge_tokens per clip gives the targets), and the paths
    equal to the port's CPU forced_align on the same emission copied to the host."""
    import audio_tpu_torch.functional as F

    paths_h, scores_h, frames_h, targets_h = (t.cpu().numpy() for t in (paths, scores, frames, targets))
    bad = []
    for i in range(len(paths_h)):
        n = int(frames_h[i])
        spans = F.merge_tokens(paths_h[i, :n], scores_h[i, :n])
        want = targets_h[i].tolist()
        if [s.token for s in spans] != want or ctc_collapse(paths_h[i, :n]) != want:
            bad.append(i)
    print(f"  {name}: {len(paths_h) - len(bad)} of {len(paths_h)} paths are CTC alignments of their targets, "
          f"merge_tokens gives the {targets_h.shape[1]} tokens (limit: all)")
    if bad:
        raise AssertionError(f"{name}: clips {bad} are not aligned to their targets")
    cpu_paths, cpu_scores = F.forced_align(emission.cpu(), targets.cpu(), frames.cpu())
    check_equal(f"{name} paths against the CPU forced_align", paths.cpu(), cpu_paths)
    check_close(f"{name} scores against the CPU forced_align", scores.cpu(), cpu_scores, 1e-6, 0.0, finite=False)


def run_forced_alignment(dev, card: str) -> dict:
    """Phase 13 (a): MMS_FA-shaped forced alignment.  ``wav2vec2_model`` with the bundle's parameters
    (about 315M, weights from CUDA generator seed 60) on FA_B clips of 10-15 s, each normalised alone ->
    log_softmax (f32) with a zero star column -> ``forced_align`` of FA_L tokens a clip (K3 once a call,
    on "warp") -> ``merge_tokens`` per clip; the model in f32 and in bf16."""
    import torch

    import audio_tpu_torch.functional as F
    from audio_tpu_torch.models import wav2vec2_model
    from audio_tpu_torch.ops import cuda_viterbi

    model = wav2vec2_model(**MMS_FA, device=dev, generator=torch.Generator(device=dev).manual_seed(60))
    n_params = sum(p.numel() for p in model.parameters())
    wav, lengths = padded_clips(dev, FA_B, FA_SECONDS, FA_MIN_SECONDS, 61)
    wav = normalise_clips(wav, lengths)
    g = torch.Generator(device=dev).manual_seed(63)
    targets = torch.randint(1, MMS_FA["aux_num_out"], (FA_B, FA_L), generator=g, device=dev)
    if cuda_viterbi.kernel_route(2 * FA_L + 1, torch.float32) != "warp":
        raise AssertionError(f"K3's route for S = {2 * FA_L + 1} is not 'warp'")

    def emission(m, x):
        out, frames = m(x, lengths)
        lp = torch.log_softmax(out.float(), dim=-1)
        return torch.cat([lp, torch.zeros_like(lp[..., :1])], dim=-1), frames

    def align(m, x):
        em, frames = emission(m, x)
        return F.forced_align(em, targets, frames)

    out = {"params": n_params, "k3_launches": 0}
    outputs = {}
    for dtype, peak_rate in ((torch.float32, PEAK_FP32_PER_S), (torch.bfloat16, PEAK_BF16_PER_S)):
        label = f"MMS_FA alignment, {str(dtype)[6:]}, B={FA_B} x {FA_SECONDS} s"
        m = model if dtype == torch.float32 else copy.deepcopy(model).to(dtype)
        x = wav.to(dtype)
        em, frames = emission(m, x)
        reset_kernel_counts()
        paths, scores = F.forced_align(em, targets, frames)
        torch.cuda.synchronize()
        counts = kernel_counts()
        if counts["viterbi"] != 1 or counts["viterbi_warp"] != 1:
            raise AssertionError(f"{label}: K3 launched {counts['viterbi']} times, {counts['viterbi_warp']} on 'warp' "
                                 "(want once, on 'warp')")
        print(f"  {label}: K3 launched once, on its 'warp' route")
        out["k3_launches"] += counts["viterbi"]
        check_paths(label, paths, scores, frames, targets, em)
        outputs[dtype] = m(x, lengths)[0]
        out[str(dtype)[6:]] = time_batch(
            label, lambda: align(m, x), card,
            float(lengths.sum()) / SR, model_flops(model, wav.shape[1], FA_B), peak_rate)
        out[str(dtype)[6:]]["model_ms"] = median_call_ms(lambda: m(x, lengths))[0]
        print(f"  {label}: the model alone {out[str(dtype)[6:]]['model_ms']:.3f} ms on {card}")
        del m
    out["bf16_rel_l2"] = check_bf16("MMS_FA model output", [outputs[torch.bfloat16]], [outputs[torch.float32]])
    out["cpu"] = compare_model_with_cpu("MMS_FA model", model, lambda m, w, l: [m(normalise_clips(w, l), l)[0]],
                                        dev, 64)
    return out


def run_ctc_emissions(dev, card: str) -> dict:
    """Phase 13 (b): WAV2VEC2_ASR_BASE_960H's shape, ``wav2vec2_base(aux_num_out=29)`` (weights from seed 70)
    in bf16 on ASR_B clips of 6-10 s -> log_softmax (f32) -> ``ctc_greedy_decode``, the tokens equal to the
    CPU's decode of the same log-probabilities."""
    import torch

    from audio_tpu_torch.models import wav2vec2_base
    from audio_tpu_torch.ops.ctc import ctc_greedy_decode

    model = wav2vec2_base(aux_num_out=ASR_V, device=dev, generator=torch.Generator(device=dev).manual_seed(70))
    wav, lengths = padded_clips(dev, ASR_B, ASR_SECONDS, ASR_MIN_SECONDS, 71)
    f32 = model(wav, lengths)[0]
    bf16 = copy.deepcopy(model).to(torch.bfloat16)

    def batch():
        logits, frames = bf16(wav.to(torch.bfloat16), lengths)
        lp = torch.log_softmax(logits.float(), dim=-1)
        return lp, frames, ctc_greedy_decode(lp, frames)

    lp, frames, (tokens, counts) = batch()
    want_tokens, want_counts = ctc_greedy_decode(lp.cpu(), frames.cpu())
    check_equal("base CTC greedy decode against the CPU's (tokens)", tokens.cpu(), want_tokens)
    check_equal("base CTC greedy decode against the CPU's (counts)", counts.cpu(), want_counts)
    out = {"params": sum(p.numel() for p in model.parameters()),
           "bf16_rel_l2": check_bf16("wav2vec2_base CTC logits", [bf16(wav.to(torch.bfloat16), lengths)[0]], [f32])}
    out["bf16"] = time_batch(f"wav2vec2_base CTC emissions + greedy decode, bf16, B={ASR_B} x {ASR_SECONDS} s", batch,
                             card, float(lengths.sum()) / SR, model_flops(model, wav.shape[1], ASR_B), PEAK_BF16_PER_S)
    out["cpu"] = compare_model_with_cpu("wav2vec2_base(aux 29)", model, lambda m, w, l: [m(w, l)[0]], dev, 72)
    return out


def run_wavlm_features(dev, card: str) -> dict:
    """Phase 13 (c): SUPERB-style features, ``wavlm_base_plus().extract_features`` (all 12 layers; weights
    from seed 80) in bf16 on SSL_B clips of 10 s; WavLM's buckets on the card equal to the CPU's up to
    T = 1500."""
    import torch

    from audio_tpu_torch.models import wavlm_base_plus
    from audio_tpu_torch.models.wavlm import _relative_positions_bucket

    p = torch.arange(1500, device=dev)
    card_buckets = _relative_positions_bucket(p[None, :] - p[:, None], 320, 800)
    cpu_buckets = _relative_positions_bucket((p[None, :] - p[:, None]).cpu(), 320, 800)
    differ = int((card_buckets.cpu() != cpu_buckets).sum())
    print(f"  WavLM buckets (320, 800) at T = 1500: {differ} of {cpu_buckets.numel()} differ from the CPU's (limit 0)")
    if differ:
        raise AssertionError("WavLM's buckets on the card differ from the CPU's")

    model = wavlm_base_plus(device=dev, generator=torch.Generator(device=dev).manual_seed(80))
    wav = voiced_rows(dev, SSL_B, SSL_SECONDS * SR, 81)
    f32 = model.extract_features(wav)[0]
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    x = wav.to(torch.bfloat16)
    feats = bf16.extract_features(x)[0]
    want = (SSL_B, frames_of(model, wav.shape[1]), model.encoder.feature_projection.projection.out_features)
    if len(feats) != 12 or any(tuple(f.shape) != want or f.dtype != torch.bfloat16 for f in feats):
        raise AssertionError(f"wavlm_base_plus features: {len(feats)} layers of {tuple(feats[0].shape)} (want 12 of "
                             f"{want}, bf16)")
    out = {"params": sum(p.numel() for p in model.parameters()),
           "bf16_rel_l2": check_bf16("wavlm_base_plus features (12 layers)", feats, f32)}
    del f32, feats
    out["bf16"] = time_batch(f"wavlm_base_plus features, bf16, B={SSL_B} x {SSL_SECONDS} s",
                             lambda: bf16.extract_features(x), card, SSL_B * SSL_SECONDS,
                             model_flops(model, wav.shape[1], SSL_B), PEAK_BF16_PER_S)
    out["cpu"] = compare_model_with_cpu("wavlm_base_plus", model, lambda m, w, l: m.extract_features(w, l)[0], dev, 82)
    return out


# ------------------------------------------------------------------ phase 14: the SSL train steps
SSL_TRAIN_B, SSL_TRAIN_MIN_S, SSL_TRAIN_MAX_S = 8, 10, 12  # clips, their shortest and longest lengths
FOLDED_KERNEL, FOLDED_ULP = "pos_conv_embed.conv.weight", 16  # the folded kernel, card against CPU, in ulp
SSL_TOKEN_CAP = 1_400_000  # the recipe's samples a card a step, 87.5 s (train_wav2vec2.py:172-173)
SSL_LENGTH_SEED = 140  # numpy seed of the clip lengths; the CUDA seeds of phase 14 are 141-159
FT_LABELS_PER_S = (12, 15)  # transcript lengths a second of clip: 120-180 labels for 10-12 s
HUBERT_CLASSES, W2V_FINAL_DIM, W2V_NEGATIVES = 100, 256, 100
SSL_LOSS_TOL, SSL_GRAD_TOL, SSL_PARAM_TOL = 1e-4, 1e-3, 1e-5  # card against the CPU in f32 at B=2 x 4 s
BF16_LOSS_REL = 0.05
# updates made before the measured ones: the pretraining schedules at their peak, and the fine-tune
# step inside its frozen stage (at the peak rate) and past freeze_encoder_updates (10,000)
HUBERT_START, W2V_START, FT_FROZEN_START, FT_THAWED_START = 32_000, 32_000, 5_000, 10_000


def conv_frames(n):
    """The frames of the default conv stack (kernels 10, 3, 3, 3, 3, 2, 2; strides 5, 2, ...) for ``n``
    samples, an int or a tensor of them."""
    for k, stride in ((10, 5),) + ((3, 2),) * 4 + ((2, 2),) * 2:
        n = (n - k) // stride + 1
    return n


class SSLCase:
    """One of the three SSL train steps at full width: its model (weights from a CUDA seed), its step
    and its batch (voiced clips, and HuBERT's labels or the fine-tune step's transcripts, from seeds)."""

    def __init__(self, kind: str, recipe, dev, seed: int):
        self.kind, self.recipe, self.dev, self.seed = kind, recipe, dev, seed

    def model(self):
        import torch

        from audio_tpu_torch.models import hubert_base, hubert_pretrain_base

        g = torch.Generator(device=self.dev).manual_seed(self.seed)
        if self.kind == "hubert":
            return hubert_pretrain_base(num_classes=HUBERT_CLASSES, device=self.dev, generator=g)
        if self.kind == "wav2vec2":
            return self.recipe.build_model(False, "wav2vec2_base", self.dev, g)
        return hubert_base(aux_num_out=len(self.recipe.LABELS), device=self.dev, generator=g)

    def backbone(self, model):
        return {"hubert": lambda: model.wav2vec2, "wav2vec2": lambda: model.backbone}.get(self.kind, lambda: model)()

    def step(self, model, start: int, compute_dtype=None):
        if self.kind == "hubert":
            return self.recipe.make_train_step(model, compute_dtype, step=start)
        if self.kind == "wav2vec2":
            return self.recipe.make_train_step(model, num_negatives=W2V_NEGATIVES, step=start)
        return self.recipe.make_train_step(model, step=start)

    def batch(self, b: int, min_s: int, max_s: int, seed: int) -> tuple:
        """The step's arguments but the generator: ``b`` voiced clips of ``min_s`` to ``max_s`` seconds (lengths
        from numpy seed ``seed``, their sum under SSL_TOKEN_CAP), zero past each length and padded to the
        longest; HuBERT's labels or the transcripts from CUDA seed ``seed + 2``."""
        import torch

        rng = np.random.default_rng(seed)
        lengths = rng.integers(min_s * SR, max_s * SR + 1, b)
        while lengths.sum() >= SSL_TOKEN_CAP:  # drawn again until the batch fits the recipe's samples a card
            lengths = rng.integers(min_s * SR, max_s * SR + 1, b)
        n = int(lengths.max())
        lengths = torch.as_tensor(lengths, device=self.dev)
        wav = voiced_rows(self.dev, b, n, seed + 1) * (torch.arange(n, device=self.dev)[None, :] < lengths[:, None])
        g = torch.Generator(device=self.dev).manual_seed(seed + 2)
        if self.kind == "hubert":
            frames = conv_frames(n)
            return wav, torch.randint(0, HUBERT_CLASSES, (b, frames), generator=g, device=self.dev), lengths
        if self.kind == "wav2vec2":
            return wav, lengths
        rate = np.random.default_rng(seed + 3).integers(*FT_LABELS_PER_S, endpoint=True)
        n_labels = (lengths.cpu().numpy() * rate) // SR
        targets = torch.randint(1, len(self.recipe.LABELS), (b, int(n_labels.max())), generator=g, device=self.dev)
        return wav, lengths, targets, torch.as_tensor(n_labels, device=self.dev)

    def loss(self, step, batch: tuple, g):
        out = step.loss(step.params, *batch, generator=g) if self.kind == "hubert" else step.loss(*batch, generator=g)
        return out if self.kind == "finetune" else out[0]

    def __call__(self, step, batch: tuple, g):
        """One update; the loss."""
        import torch

        with torch.enable_grad():
            out = step(*batch, generator=g)
        return out if self.kind == "finetune" else out[0]

    def flops(self, model, n_samples: int, batch: int, frozen: bool = False) -> float:
        """Model FLOPs of one step: the backbone and its backward (``model_flops``), plus the recipe's head
        three times over (forward and two backward products): HuBERT's projection and cosine logits,
        wav2vec2's two projections and its logits over 101 targets."""
        backbone = self.backbone(model)
        if self.kind == "finetune":
            return model_flops(backbone, n_samples, batch, backward="head" if frozen else "encoder")
        t = frames_of(backbone, n_samples)
        d = backbone.encoder.feature_projection.projection.out_features
        if self.kind == "hubert":
            head = 2 * t * d * W2V_FINAL_DIM + 2 * t * W2V_FINAL_DIM * HUBERT_CLASSES
        else:
            head = 2 * 2 * t * d * W2V_FINAL_DIM + 2 * (W2V_NEGATIVES + 1) * t * W2V_FINAL_DIM
        return model_flops(backbone, n_samples, batch, backward="all") + 3 * batch * head


def check_ssl_grads(name: str, got: dict, ref: dict, tol: float = SSL_GRAD_TOL) -> float:
    """Each card gradient within ``tol`` (SSL_GRAD_TOL) of its largest CPU entry.  The attention's key bias, whose
    gradient is zero in exact arithmetic (the softmax ignores it), is held to 1e-6 of the model's largest
    gradient entry on both sides; a gradient not computed (None) must be so on both sides.  The worst error
    over its peak."""
    import torch

    present = {k for k, g in ref.items() if g is not None}
    if present != {k for k, g in got.items() if g is not None}:
        raise AssertionError(f"{name}: the card and the CPU computed gradients of different parameters")
    top = max(float(ref[k].abs().max()) for k in present)
    worst = 0.0
    for k in sorted(present):
        g, r = got[k].cpu().double(), ref[k].double()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: the gradient of {k} is not finite")
        peak = float(r.abs().max())
        if k.endswith("attention.k_proj.bias") and peak <= 1e-6 * top:
            if float(g.abs().max()) > 1e-6 * top:
                raise AssertionError(f"{name}: the key bias's gradient {k} is {float(g.abs().max()):.3e} on the card, "
                                     f"past 1e-6 of the largest entry {top:.3e}")
            continue
        err = float((g - r).abs().max())
        if err > tol * peak:
            raise AssertionError(f"{name}: the gradient of {k} is off the CPU's by {err:.3e}, past {tol:g} "
                                 f"of its peak {peak:.3e}")
        worst = max(worst, err / peak)
    return worst


def check_ssl_params(name: str, got: dict, ref: dict, got_before: dict, before: dict, grads: dict, lr: float) -> float:
    """The parameters after one update on the card against the CPU's: within SSL_PARAM_TOL where the CPU's
    gradient stands clear of rounding noise (above 1e-3 of its peak, the peak above 1e-6 of the largest),
    elsewhere within two Adam steps of ``lr`` (the normalisation makes a noise entry's sign arbitrary on
    either side, as ``tests/test_torch_train_step.py`` allows); a parameter without a gradient the CPU's
    bits from before the update (``before``), but the folded positional kernel: each side folds it on its
    own device, so it is held to each side's own bits from before (``got_before`` the card's) and to
    within FOLDED_ULP of the CPU's value.  The worst error on the clear entries."""
    import torch

    top = max(float(g.abs().max()) for g in grads.values() if g is not None)
    worst, n_clear, n_all = 0.0, 0, 0
    for k, r in ref.items():
        g, now = grads[k], got[k].detach().cpu()
        if g is None:
            if not k.endswith(FOLDED_KERNEL):
                if not torch.equal(now, before[k]):
                    raise AssertionError(f"{name}: {k} has no gradient but differs from the CPU's bits before the "
                                         f"update")
                continue
            ref_w = r.detach()
            ulp = torch.nextafter(ref_w.abs(), torch.tensor(math.inf)) - ref_w.abs()
            ulps = float(((now.double() - ref_w.double()).abs() / ulp.double()).max())
            print(f"  {name}: the folded {k} (no gradient) is {ulps:.1f} ulp off the CPU's (limit {FOLDED_ULP})")
            if not (torch.equal(now, got_before[k]) and torch.equal(ref_w, before[k])):
                raise AssertionError(f"{name}: {k} has no gradient but moved")
            if not ulps <= FOLDED_ULP:
                raise AssertionError(f"{name}: the folded {k} is {ulps:.1f} ulp off the CPU's (limit {FOLDED_ULP})")
            continue
        diff = (now.double() - r.detach().double()).abs()
        peak = float(g.abs().max())
        clear = (g.abs() > 1e-3 * peak) & (peak > 1e-6 * top)
        err_clear = float(diff[clear].max()) if bool(clear.any()) else 0.0
        if err_clear > SSL_PARAM_TOL or float(diff.max()) > 2.1 * lr:
            raise AssertionError(f"{name}: {k} after one update is off the CPU's by {err_clear:.3e} on its clear "
                                 f"entries (limit {SSL_PARAM_TOL:g}), {float(diff.max()):.3e} anywhere (limit "
                                 f"{2.1 * lr:.3e})")
        worst = max(worst, err_clear)
        n_clear, n_all = n_clear + int(clear.sum()), n_all + clear.numel()
    if n_clear < 0.8 * n_all:
        raise AssertionError(f"{name}: only {n_clear} of {n_all} entries have a gradient clear of noise")
    return worst


def compare_ssl_with_cpu(case: SSLCase, model, start: int, seed: int) -> dict:
    """The step in f32 at CMP_B clips of up to CMP_SECONDS on the card against the same module on the CPU:
    eval mode (no dropout, no layer drop), the same weights, the span masks and negatives from one CUDA
    generator seed on both sides.  The loss within SSL_LOSS_TOL (relative), each gradient within
    SSL_GRAD_TOL of its peak, the parameters after one update within SSL_PARAM_TOL."""
    import torch

    name = f"{case.kind} step at {start}, f32, B={CMP_B} x {CMP_SECONDS} s"
    batch = case.batch(CMP_B, CMP_MIN_SECONDS, CMP_SECONDS, seed)
    sides = {}
    for side, m in (("card", copy.deepcopy(model).eval()), ("cpu", copy.deepcopy(model).cpu().eval())):
        args = batch if side == "card" else tuple(t.cpu() for t in batch)
        step = case.step(m, start)
        with torch.enable_grad():
            loss = case.loss(step, args, torch.Generator(device=case.dev).manual_seed(seed + 5))
            loss.backward()
        grads = grads_of(step.params)
        step.optimizer.zero_grad(set_to_none=True)
        before = {k: p.detach().cpu().clone() for k, p in step.params.items()}
        case(step, args, torch.Generator(device=case.dev).manual_seed(seed + 5))
        sides[side] = dict(loss=float(loss), grads=grads, params=step.params, before=before,
                           lr=step.schedule(start))
    card, cpu = sides["card"], sides["cpu"]
    rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_err = check_ssl_grads(name, card["grads"], cpu["grads"])
    param_err = check_ssl_params(name, card["params"], cpu["params"], card["before"], cpu["before"], cpu["grads"],
                                 cpu["lr"])
    print(f"  {name}, card against the CPU: loss {card['loss']:.6f} vs {cpu['loss']:.6f} (relative {rel:.3e}, "
          f"limit {SSL_LOSS_TOL:g}); gradients within {grad_err:.3e} of their peaks (limit {SSL_GRAD_TOL:g}); the "
          f"parameters after one update within {param_err:.3e} on clear entries (limit {SSL_PARAM_TOL:g}, lr "
          f"{cpu['lr']:.3e})")
    if not rel <= SSL_LOSS_TOL:
        raise AssertionError(f"{name}: the loss on the card is off the CPU's by {rel:.3e} relative")
    return {"loss_rel": rel, "grad_err_of_peak": grad_err, "param_err": param_err}


def grads_of(params: dict) -> dict:
    """Each parameter's gradient, None where its backward was not run."""
    return {k: None if p.grad is None else p.grad.detach().clone() for k, p in params.items()}


def check_finite_step(name: str, loss, params: dict) -> None:
    import torch

    bad = [k for k, p in params.items() if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    if not math.isfinite(float(loss)) or bad:
        raise AssertionError(f"{name}: loss {float(loss)}, gradients not finite: {bad[:5]}")
    if any(p.grad is not None and p.grad.dtype != torch.float32 for p in params.values()):
        raise AssertionError(f"{name}: a master parameter's gradient is not float32")


def check_span_masks(name: str, model, mask, wav_lengths, starts_fn) -> dict:
    """The masked frames of each row against the static strategy: the mask equal to the spans of the starts
    drawn again from the same generator state (their count max(2, int(p * T / L)), T the padded frame
    count), no padded frame masked; each row's count."""
    import torch

    from audio_tpu_torch.models.wav2vec2.components import span_mask

    b, t = mask.shape
    mg = model.mask_generator
    starts = starts_fn(b, t)
    n_spans = max(2, int(mg.mask_prob * t / mg.mask_length))
    frames = conv_frames(wav_lengths)
    pad = torch.arange(t, device=mask.device)[None, :] >= frames[:, None]
    want = span_mask(starts, mg.mask_length, t) & ~pad
    counts = mask.sum(1).tolist()
    print(f"  {name}: {n_spans} spans of {mg.mask_length} a row over T = {t} (mask_prob {mg.mask_prob}); masked "
          f"frames a row {counts}; padded frames masked {int((mask & pad).sum())} (limit 0)")
    if starts.shape != (b, n_spans) or not torch.equal(mask, want) or bool((mask & pad).any()):
        raise AssertionError(f"{name}: the span mask does not follow the static strategy")
    if any(c > n_spans * mg.mask_length for c in counts):
        raise AssertionError(f"{name}: a row masks more than {n_spans} spans of {mg.mask_length}")
    return {"spans": n_spans, "masked_frames": counts}


def time_ssl_step(name: str, case: SSLCase, step, batch: tuple, g, card: str, flops: float, peak_rate: float,
                  helper_ab: bool = False) -> dict:
    """``time_train_step`` of the update, and the model FLOPs' share of the peak rate."""
    lengths = batch[-1] if case.kind == "hubert" else batch[1]
    out = time_train_step(name, lambda: case(step, batch, g), float(lengths.sum()) / SR, card, helper_ab=helper_ab)
    out.update(model_tflop=flops / 1e12, share_of_peak=flops / (out["ms"] / 1e3) / peak_rate)
    print(f"  {name}: model {out['model_tflop']:.3f} TFLOP a step = {out['share_of_peak']:.3f} of "
          f"{peak_rate / 1e12:g} TFLOP/s on {card}")
    return out


def run_hubert_pretrain(recipe, dev, card: str) -> dict:
    """Phase 14 (a): HuBERT masked prediction, ``hubert_pretrain_base(num_classes=100)`` (weights from CUDA
    seed 141), labels 0-99 a frame, at the schedule's peak; in f32 and in bf16 over f32 masters."""
    import torch

    case = SSLCase("hubert", recipe, dev, 141)
    model = case.model()
    batch = case.batch(SSL_TRAIN_B, SSL_TRAIN_MIN_S, SSL_TRAIN_MAX_S, SSL_LENGTH_SEED)
    wav, labels, lengths = batch
    out = {"params": sum(p.numel() for p in model.parameters()), "samples": int(lengths.sum()),
           "padded_samples": int(wav.shape[1])}
    g = torch.Generator(device=dev).manual_seed(143)
    state = g.get_state()
    with torch.no_grad():
        _, _, mask_m, _, _ = model.train()(wav, labels, lengths, generator=g)

    def redraw(b, t):
        again = torch.Generator(device=dev)
        again.set_state(state)
        return model.mask_generator.draw_starts(b, t, dev, again)

    out["masks"] = check_span_masks("HuBERT span masks, full width", model, mask_m, lengths, redraw)
    # bf16 against f32 on the same batch and masks: eval mode, the same generator seed
    losses = {}
    for dtype in (None, torch.bfloat16):
        step = case.step(copy.deepcopy(model).eval(), HUBERT_START, dtype)
        with torch.enable_grad():
            loss = case.loss(step, batch, torch.Generator(device=dev).manual_seed(144))
            loss.backward()
        check_finite_step(f"HuBERT step, {dtype or 'f32'}", loss, step.params)
        losses[dtype] = float(loss)
        del step
    rel = abs(losses[torch.bfloat16] - losses[None]) / abs(losses[None])
    print(f"  HuBERT loss at full width, eval mode: f32 {losses[None]:.6f}, bf16 compute {losses[torch.bfloat16]:.6f} "
          f"(relative {rel:.3e}, limit {BF16_LOSS_REL:g}); the bf16 step's gradients are finite float32")
    if not rel <= BF16_LOSS_REL:
        raise AssertionError(f"HuBERT: the bf16 loss is off the f32 loss by {rel:.3e} relative")
    out["bf16_loss_rel"] = rel
    flops = case.flops(model, wav.shape[1], SSL_TRAIN_B)
    for label, dtype, rate in (("f32", None, PEAK_FP32_PER_S), ("bf16", torch.bfloat16, PEAK_BF16_PER_S)):
        name = f"HuBERT pretraining step, {label}, B={SSL_TRAIN_B} x {SSL_TRAIN_MIN_S}-{SSL_TRAIN_MAX_S} s"
        torch.manual_seed(145)
        m = copy.deepcopy(model).train()
        step = case.step(m, HUBERT_START, dtype)
        first = case(step, batch, g)
        check_finite_step(name, first, step.params)
        out[label] = time_ssl_step(name, case, step, batch, g, card, flops, rate, helper_ab=label == "f32")
        del m, step
        torch.cuda.empty_cache()
    out["pos_conv"] = time_pos_conv(model.wav2vec2, SSL_TRAIN_B, frames_of(model.wav2vec2, wav.shape[1]), card)
    out["cpu"] = compare_ssl_with_cpu(case, model, HUBERT_START, 146)
    return out


def time_pos_conv(backbone, b: int, t: int, card: str) -> dict:
    """The positional convolution (weight norm, 16 groups, kernel 128) forward and backward alone on
    (b, t, D) in f32 and bf16: the bf16 step's profile puts a cuDNN bf16 dgrad kernel, 16 launches a
    step, at the head of its device time."""
    import torch

    out = {}
    d = backbone.encoder.feature_projection.projection.out_features
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        conv = copy.deepcopy(backbone.encoder.transformer.pos_conv_embed).to(dtype)
        x = torch.randn((b, t, d), device=next(conv.parameters()).device, dtype=dtype, requires_grad=True)

        def fwd_bwd():
            with torch.enable_grad():
                conv(x).float().sum().backward()

        out[label], _ = median_call_ms(fwd_bwd)
    print(f"  the positional convolution alone, forward and backward at ({b}, {t}, {d}): f32 {out['f32']:.3f} ms, "
          f"bf16 {out['bf16']:.3f} ms on {card}")
    return out


def run_wav2vec2_pretrain(recipe, dev, card: str) -> dict:
    """Phase 14 (b): wav2vec 2.0 contrastive pretraining, ``wav2vec2_base`` with final dim 256 (weights from
    CUDA seed 150), 100 negatives, f32, at the schedule's peak."""
    import torch

    case = SSLCase("wav2vec2", recipe, dev, 150)
    model = case.model()
    batch = case.batch(SSL_TRAIN_B, SSL_TRAIN_MIN_S, SSL_TRAIN_MAX_S, SSL_LENGTH_SEED)
    wav, lengths = batch
    out = {"params": sum(p.numel() for p in model.parameters()), "samples": int(lengths.sum())}
    g = torch.Generator(device=dev).manual_seed(152)
    state = g.get_state()
    with torch.no_grad():
        _, targets, mask, _, _ = model.train()(wav, lengths, generator=g)

    def redraw(b, t):
        again = torch.Generator(device=dev)
        again.set_state(state)
        return model.mask_generator.draw_starts(b, t, dev, again)

    out["masks"] = check_span_masks("wav2vec2 span masks, full width", model, mask, lengths, redraw)
    # each negative's source frame, read through sample_negatives from frames that carry their own index
    b, t, _ = targets.shape
    codes = torch.arange(t, device=dev, dtype=torch.float32)[None, :, None].expand(b, t, 1).contiguous()
    source = recipe.sample_negatives(codes, W2V_NEGATIVES, g)[..., 0]
    own = int((source == torch.arange(t, device=dev)).sum())
    print(f"  wav2vec2 negatives at full width ({W2V_NEGATIVES}, {b}, {t}): {own} drawn from their own frame (limit "
          f"0); sources span {int(source.min())}-{int(source.max())}")
    if own or int(source.min()) < 0 or int(source.max()) >= t:
        raise AssertionError("wav2vec2: a negative was drawn from its own frame or outside the clip")
    name = f"wav2vec2 contrastive step, f32, B={SSL_TRAIN_B} x {SSL_TRAIN_MIN_S}-{SSL_TRAIN_MAX_S} s"
    torch.manual_seed(153)
    m = copy.deepcopy(model).train()
    step = case.step(m, W2V_START)
    first = case(step, batch, g)
    check_finite_step(name, first, step.params)
    out["f32"] = time_ssl_step(name, case, step, batch, g, card, case.flops(model, wav.shape[1], SSL_TRAIN_B),
                               PEAK_FP32_PER_S)
    del m, step
    torch.cuda.empty_cache()
    out["cpu"] = compare_ssl_with_cpu(case, model, W2V_START, 154)
    return out


def run_hubert_finetune(recipe, dev, card: str) -> dict:
    """Phase 14 (c): HuBERT CTC fine-tuning, ``hubert_base(aux_num_out=29)`` (weights from CUDA seed 155),
    transcripts of 120-180 labels in 1..28, f32: one stage inside the frozen encoder's updates and one past
    them.  The frozen modules keep their bits; ``ctc_loss``'s forward and backward timed alone on the
    step's log-probabilities for its share of the step."""
    import torch

    from audio_tpu_torch.ops.ctc import ctc_loss

    case = SSLCase("finetune", recipe, dev, 155)
    model = case.model()
    batch = case.batch(SSL_TRAIN_B, SSL_TRAIN_MIN_S, SSL_TRAIN_MAX_S, SSL_LENGTH_SEED)
    wav, lengths, targets, target_lengths = batch
    out = {"params": sum(p.numel() for p in model.parameters()), "samples": int(lengths.sum()),
           "target_lengths": target_lengths.tolist()}
    g = torch.Generator(device=dev).manual_seed(157)
    for stage, start in (("frozen", FT_FROZEN_START), ("thawed", FT_THAWED_START)):
        name = (f"HuBERT CTC fine-tune step, encoder {stage} (update {start}), f32, B={SSL_TRAIN_B} x "
                f"{SSL_TRAIN_MIN_S}-{SSL_TRAIN_MAX_S} s")
        torch.manual_seed(158)
        m = copy.deepcopy(model).train()
        step = case.step(m, start)
        if step.encoder_frozen != (stage == "frozen"):
            raise AssertionError(f"{name}: encoder_frozen is {step.encoder_frozen}")
        before = {k: p.detach().clone() for k, p in step.params.items()}
        first = case(step, batch, g)
        check_finite_step(name, first, step.params)
        kept = [k for k in before if torch.equal(before[k], step.params[k].detach())]
        must_keep = [k for k in before if k.startswith("feature_extractor.")
                     or (stage == "frozen" and k.startswith("encoder."))]
        moved = [k for k in before if k not in kept]
        print(f"  {name}: {len(kept)} of {len(before)} parameters kept their bits (the feature extractor"
              f"{' and the encoder' if stage == 'frozen' else ''} must: {len(must_keep)}), {len(moved)} moved")
        if set(must_keep) - set(kept) or not any(k.startswith("aux.") for k in moved) or (
                stage == "thawed" and not any(k.startswith("encoder.") for k in moved)):
            raise AssertionError(f"{name}: the frozen parameters moved, or the trained ones did not")
        out[stage] = time_ssl_step(name, case, step, batch, g, card,
                                   case.flops(model, wav.shape[1], SSL_TRAIN_B, frozen=stage == "frozen"),
                                   PEAK_FP32_PER_S)
        del m, step
        torch.cuda.empty_cache()
    with torch.no_grad():
        logits, frames = model.eval()(wav, lengths)
    logp = torch.log_softmax(logits, dim=-1).detach()

    def loss_alone():
        lp = logp.clone().requires_grad_()
        with torch.enable_grad():
            ctc_loss(lp, targets, frames, target_lengths, blank=0, reduction="mean").backward()

    ctc_ms, ctc_runs = median_call_ms(loss_alone)
    out["ctc_loss_ms"], out["ctc_loss_runs_ms"] = ctc_ms, ctc_runs
    for stage in ("frozen", "thawed"):
        out[stage]["ctc_share"] = ctc_ms / out[stage]["ms"]
    print(f"  ctc_loss forward and backward alone at ({SSL_TRAIN_B}, {logp.shape[1]}, {logp.shape[2]}), L <= "
          f"{targets.shape[1]}: {ctc_ms:.3f} ms = {out['frozen']['ctc_share']:.3f} of the frozen step, "
          f"{out['thawed']['ctc_share']:.3f} of the thawed step on {card}")
    out["frozen_cpu"] = compare_ssl_with_cpu(case, model, FT_FROZEN_START, 159)
    out["thawed_cpu"] = compare_ssl_with_cpu(case, model, FT_THAWED_START, 159)
    return out


# ------------------------------------------------------------------ phase 15: the Conformer RNN-T recipes
# examples/asr/conformer_rnnt/train.py at its defaults (80 mels, stride 4, width 256, 16 layers, 4 heads, FFN 1024,
# kernel 31, LSTM 512, joiner 256) with --num-symbols 1024; the biasing recipe's 600 pieces and blank
CF_V, CF_BIASED_V = 1024, 601
CF_TRAIN_B, CF_MIN_S, CF_MAX_S, CF_U = 16, 5, 10, 40  # clips, their shortest and longest lengths, most targets
CF_SEARCH_B, CF_SEARCH_S, CF_BEAM, CF_SMT, CF_MAX_TOKENS = 16, 10, 10, 4, 256
CF_JOINER_D = 256  # the joiner's width, K5's depth in the search
CF_BIASED_B, CF_BIASED_S = 8, 10
CF_CMP_B, CF_CMP_S, CF_CMP_MIN_S, CF_CMP_U = 2, 4, 3, 20  # the card against the CPU in f32
CF_SEARCH_CMP_S = 2  # the f32 search against the CPU: CF_CMP_B clips of this many seconds
CF_LOSS_TOL, CF_GRAD_TOL = 1e-4, 1e-3  # loss (relative) and each gradient (of its peak), card against CPU
CF_SEED = 160  # the CUDA and numpy seeds of phase 15 are 160-189
TF32_GRAD_TOL = 1e-4  # f32 gradients with TF32 on in the backward against off, of each peak, where two runs differ


def flax_drawn(model, dev, seed: int):
    """``model`` with its parameters drawn as the recipes' ``main`` draws them (``flax_init_``: flax's default
    initialisers), from CUDA seed ``seed``."""
    import torch

    from audio_tpu_torch._internal.init import flax_init_

    flax_init_(model, torch.Generator(device=dev).manual_seed(seed))
    return model


def conformer_targets(dev, b: int, u: int, v: int, seed: int):
    """(B, u) targets in [1, v - 1) zero-padded past lengths drawn from u // 2 to u (the first u), from a CUDA
    generator seeded ``seed``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(u // 2, u + 1, (b,), generator=g, device=dev)
    lengths[0] = u
    tgt = torch.randint(1, v - 1, (b, u), generator=g, device=dev)
    return (tgt * (torch.arange(u, device=dev)[None, :] < lengths[:, None])).to(torch.int32), lengths.to(torch.int32)


def conformer_step_data(dev, b: int, seconds: int, min_seconds: int, u: int, v: int, seed: int):
    """Voiced clips padded to ``seconds`` (zero past each length, the first full), their lengths and targets."""
    import torch

    wav, lengths = padded_clips(dev, b, seconds, min_seconds, seed)
    tgt, tgt_lens = conformer_targets(dev, b, u, v, seed + 3)
    return wav, lengths.to(torch.int32), tgt, tgt_lens


def loss_and_grads(step, loss_fn) -> tuple:
    """(loss, {name: gradient}) of ``loss_fn(step)`` with a fresh backward."""
    import torch

    step.optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss = loss_fn(step)
        loss.backward()
    grads = grads_of(step.params)
    step.optimizer.zero_grad(set_to_none=True)
    return float(loss), grads


def compare_step_with_cpu(name: str, model, make_step, card_batch, loss_fn) -> dict:
    """The step's loss and every gradient in f32, dropout off, on the card (through the kernels) against a
    copy of the model on the CPU (the plain versions), on the same batch: the loss within CF_LOSS_TOL
    (relative), each gradient within CF_GRAD_TOL of its peak (``check_ssl_grads``)."""
    sides = {}
    for side, m in (("card", copy.deepcopy(model).eval()), ("cpu", copy.deepcopy(model).cpu().eval())):
        batch = card_batch if side == "card" else tuple(t.cpu() for t in card_batch)
        sides[side] = loss_and_grads(make_step(m), lambda s, b=batch: loss_fn(s, b))
    (got, got_grads), (ref, ref_grads) = sides["card"], sides["cpu"]
    rel = abs(got - ref) / abs(ref)
    grad_err = check_ssl_grads(name, got_grads, ref_grads)
    print(f"  {name}, card against the CPU: loss {got:.6f} vs {ref:.6f} (relative {rel:.3e}, limit {CF_LOSS_TOL:g}); "
          f"{len(ref_grads)} gradients within {grad_err:.3e} of their peaks (limit {CF_GRAD_TOL:g})")
    if not rel <= CF_LOSS_TOL or not grad_err <= CF_GRAD_TOL:
        raise AssertionError(f"{name}: the card disagrees with the CPU")
    return {"loss": got, "cpu_loss": ref, "loss_rel": rel, "grad_err_of_peak": grad_err}


def time_train_step(name: str, one, audio_s: float, card: str, against_key_averages: bool = False,
                    helper_ab: bool = False) -> dict:
    """Five timed steps (CUDA events, median) after a warm-up, the peak memory over them, seconds of audio a
    second, and one profiled step (see ``profile_batch``); with ``helper_ab``, then ``helper_cost``."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    ms, runs, losses = timed_steps(one, 1, 5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: losses {losses}")
    out = {"ms": ms, "runs_ms": runs, "losses": losses, "audio_s": audio_s, "audio_s_per_s": audio_s / (ms / 1e3),
           "peak_gb": peak_gb}
    print(f"  {name}: {ms:.3f} ms a step (runs {', '.join(f'{r:.3f}' for r in runs)}), {out['audio_s_per_s']:.1f} s "
          f"of audio a second ({audio_s:.2f} s a step), peak memory {peak_gb:.3f} GB; losses "
          f"{[round(v, 4) for v in losses]} on {card}")
    out["profile"] = profile_batch(name, one, against_key_averages)
    if helper_ab:
        out["helper"] = helper_cost(name, one, card)
    return out


def run_conformer_rnnt_train(recipe, dev, card: str) -> dict:
    """Phase 15 (a): the Conformer RNN-T train step at the recipe's full width (weights drawn as flax's ``init`` draws, ``flax_init_``, from CUDA seed 160),
    f32, dropout and SpecAugment on, at the schedule's peak: featurizer (K2) -> model -> ``rnnt_loss`` (K8) ->
    backward -> clip -> AdamW, on 16 clips of 5-10 s with up to 40 targets.  Then at B=2 x 4 s against the CPU,
    and the encoder's bits with cuDNN's TF32 on."""
    import torch

    model = flax_drawn(recipe.ConformerRNNT(CF_V, device=dev), dev, CF_SEED)
    n_params = sum(p.numel() for p in model.parameters())
    melspec = recipe.MelSpectrogram(sample_rate=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS, power=2.0, device=dev)
    stride = model.time_reduction_stride
    wav, lengths, tgt, tgt_lens = conformer_step_data(dev, CF_TRAIN_B, CF_MAX_S, CF_MIN_S, CF_U, CF_V,
                                                      CF_SEED + 1)
    name = f"Conformer RNN-T train step, f32, B={CF_TRAIN_B} x {CF_MIN_S}-{CF_MAX_S} s, U <= {CF_U}, V={CF_V}"
    print(f"  ConformerRNNT({CF_V}): {n_params} parameters ({n_params / 1e6:.2f}M), from CUDA seed {CF_SEED}")
    torch.manual_seed(CF_SEED + 5)
    step = recipe.make_train_step(model.train(), step=recipe.WARMUP_STEPS)  # at the schedule's peak
    masks = torch.Generator(device=dev).manual_seed(CF_SEED + 6)

    def one():
        feats, feat_lens = recipe.featurize(melspec, wav, lengths, stride, masks)
        with torch.enable_grad():
            return step(feats, feat_lens, tgt, tgt_lens)

    feats, feat_lens = recipe.featurize(melspec, wav, lengths, stride, train=False)
    enc_frames = int(feat_lens.max()) // stride
    print(f"  features {tuple(feats.shape)}, the encoder's frames up to {enc_frames}; the lattice "
          f"({CF_TRAIN_B}, {feats.shape[1] // stride}, {CF_U + 1}, {CF_V}) f32")
    reset_kernel_counts()
    first = one()
    torch.cuda.synchronize()
    counts = kernel_counts()
    require_launches(f"one {name}", counts, ["power_spectrogram", "lattice_row_stats"])
    require_route(f"one {name}", counts, "power_spectrogram", "fft")
    require_route(f"one {name}", counts, "lattice_row_stats", "stream")
    check_finite_step(name, first, step.params)
    out = {"params": n_params, "launches": {n: c for n, c in counts.items() if c}, "first_loss": float(first),
           "encoder_frames": enc_frames}
    out.update(time_train_step(name, one, float(lengths.sum()) / SR, card, helper_ab=True))
    del step
    torch.cuda.empty_cache()

    # the card against the CPU at B=2 x 4 s, SpecAugment and dropout off, seeded weights
    model = flax_drawn(recipe.ConformerRNNT(CF_V, device=dev), dev, CF_SEED)
    wav2, len2, tgt2, tl2 = conformer_step_data(dev, CF_CMP_B, CF_CMP_S, CF_CMP_MIN_S, CF_CMP_U, CF_V,
                                                CF_SEED + 8)
    reset_kernel_counts()
    feats2, fl2 = recipe.featurize(melspec, wav2, len2, stride, train=False)
    cpu_mel = copy.deepcopy(melspec).cpu()
    ref_feats, ref_fl = recipe.featurize(cpu_mel, wav2.cpu(), len2.cpu(), stride, train=False)
    out["features_err"] = check_close("Conformer RNN-T features (K2) vs the CPU, B=2", feats2.cpu(), ref_feats, 1e-3, 0.0)
    check_equal("Conformer RNN-T feature lengths vs the CPU", fl2.cpu(), ref_fl)
    batch = (feats2, fl2, tgt2, tl2)
    out["cpu"] = compare_step_with_cpu(f"Conformer RNN-T step, f32, B={CF_CMP_B} x {CF_CMP_S} s", model,
                                       lambda m: recipe.make_train_step(m, step=recipe.WARMUP_STEPS),
                                       batch, lambda s, b: s.loss(*b))
    require_launches("the f32 Conformer RNN-T step at B=2", kernel_counts(), ["power_spectrogram", "lattice_row_stats"])
    # the encoder's bits with cuDNN's TF32 on: its depthwise convolution turns TF32 off inside the call
    with torch.no_grad():
        enc_off, _ = model.eval().transcribe(feats2, fl2)
        previous = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            enc_on, _ = model.transcribe(feats2, fl2)
        finally:
            torch.backends.cudnn.allow_tf32 = previous
    print(f"  the f32 encoder with cuDNN's TF32 on gives the same bits as with it off: {torch.equal(enc_on, enc_off)}")
    if not torch.equal(enc_on, enc_off):
        raise AssertionError("Conformer: cuDNN's TF32 changed the f32 encoder's output")
    del model
    torch.cuda.empty_cache()
    return out


def conformer_search_model(recipe, dev, dtype):
    """The recipe's model (weights drawn by ``flax_init_`` from CUDA seed 170) in eval mode and ``dtype``, the blank (V - 1, the
    search's convention) raised by RNNT_BLANK_BIAS, as ``make_rnnt`` raises the Emformer's."""
    import torch

    model = flax_drawn(recipe.ConformerRNNT(CF_V, device=dev), dev, CF_SEED + 10)
    with torch.no_grad():
        model.joiner.linear.bias[-1] += RNNT_BLANK_BIAS
    return model.to(dtype).eval()


def run_conformer_search(recipe, dev, card: str) -> dict:
    """Phase 15 (b): ``RNNTBeamSearch.forward_batch`` on the recipe's model, beam 10, step_max_tokens 4, over
    16 clips of 10 s: in bf16 (K5 and K7 on "wgmma", the weights in a Linear's layout), once in f32, and
    the f32 search on 2 clips of 2 s against the CPU (top-1 tokens equal, scores within 1e-3)."""
    import torch

    from audio_tpu_torch.models import RNNTBeamSearch

    melspec = recipe.MelSpectrogram(sample_rate=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS, power=2.0, device=dev)
    wav, lengths = padded_clips(dev, CF_SEARCH_B, CF_SEARCH_S, CF_SEARCH_S, CF_SEED + 11)
    feats, feat_lens = recipe.featurize(melspec, wav, lengths, 4, train=False)
    audio_s = float(lengths.sum()) / SR
    out = {"audio_s": audio_s}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = conformer_search_model(recipe, dev, dtype)
        dec = RNNTBeamSearch(model, CF_V - 1, step_max_tokens=CF_SMT, max_tokens=CF_MAX_TOKENS)
        name = f"Conformer RNN-T beam search, {label}, forward_batch B={CF_SEARCH_B} x {CF_SEARCH_S} s, beam {CF_BEAM}"
        x = feats.to(dtype)
        reset_kernel_counts()
        hyp = dec.forward_batch(x, feat_lens, CF_BEAM)
        torch.cuda.synchronize()
        counts = kernel_counts()
        require_launches(name, counts, ["join_stats_topk", "lstm_gate_step"])
        if dtype == torch.bfloat16:
            require_route(name, counts, "join_stats_topk", "wgmma")
            require_route(name, counts, "lstm_gate_step", "wgmma")
        check_beams(name, hyp.tokens, hyp.counts, hyp.scores, CF_MAX_TOKENS, blank=CF_V - 1)
        if dtype == torch.bfloat16:
            torch.cuda.reset_peak_memory_stats()
            ms, runs = median_call_ms(lambda: dec.forward_batch(x, feat_lens, CF_BEAM), reps=3)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            rtf = ms / 1e3 / audio_s
            print(f"  {name}: {ms:.3f} ms a batch (runs {', '.join(f'{r:.3f}' for r in runs)}), real-time factor "
                  f"{rtf:.5f} ({audio_s:.1f} s of audio), peak memory {peak_gb:.3f} GB (the model's weights "
                  f"included); launches a batch { {n: c for n, c in counts.items() if c} } on {card}")
            out[label] = {"ms": ms, "runs_ms": runs, "rtf": rtf, "peak_gb": peak_gb,
                          "launches": {n: c for n, c in counts.items() if c},
                          "profile": profile_batch(name, lambda: dec.forward_batch(x, feat_lens, CF_BEAM))}
        else:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dec.forward_batch(x, feat_lens, CF_BEAM)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            print(f"  {name}: one batch {ms:.3f} ms, real-time factor {ms / 1e3 / audio_s:.5f}; launches "
                  f"{ {n: c for n, c in counts.items() if c} } on {card}")
            out[label] = {"ms": ms, "rtf": ms / 1e3 / audio_s, "launches": {n: c for n, c in counts.items() if c}}
        del model, dec
        torch.cuda.empty_cache()

    # the f32 search on a short subset against the CPU's plain versions
    model = conformer_search_model(recipe, dev, torch.float32)
    wav2, len2 = padded_clips(dev, CF_CMP_B, CF_SEARCH_CMP_S, 1, CF_SEED + 12)
    x2, n2 = recipe.featurize(melspec, wav2, len2, 4, train=False)
    reset_kernel_counts()
    got = RNNTBeamSearch(model, CF_V - 1, step_max_tokens=CF_SMT, max_tokens=CF_MAX_TOKENS).forward_batch(x2, n2, CF_BEAM)
    torch.cuda.synchronize()
    require_launches("the f32 search against the CPU", kernel_counts(), ["join_stats_topk", "lstm_gate_step"])
    cpu_model = copy.deepcopy(model).cpu()
    ref = RNNTBeamSearch(cpu_model, CF_V - 1, step_max_tokens=CF_SMT, max_tokens=CF_MAX_TOKENS).forward_batch(
        x2.cpu(), n2.cpu(), CF_BEAM)
    g_counts, g_tokens, g_scores = got.counts.cpu(), got.tokens.cpu(), got.scores.cpu()
    same = (g_counts[:, 0] == ref.counts[:, 0]) & (g_tokens[:, 0] == ref.tokens[:, 0]).all(dim=-1)
    top1_err = float((g_scores[:, 0] - ref.scores[:, 0]).abs().max())
    print(f"  the f32 search on {CF_CMP_B} clips of {CF_SEARCH_CMP_S} s against the CPU: top-1 counts "
          f"{g_counts[:, 0].tolist()} vs {ref.counts[:, 0].tolist()}, {int(same.sum())} of {CF_CMP_B} top-1 token "
          f"sequences equal, top-1 score max_abs_err {top1_err:.3e} (limit 1e-3)")
    if not bool(same.all()) or not top1_err <= 1e-3:
        raise AssertionError("Conformer RNN-T search: the card's top-1 hypothesis differs from the CPU's")
    out["cpu"] = {"top1_equal": int(same.sum()), "top1_score_err": top1_err, "counts": g_counts[:, 0].tolist()}
    del model, cpu_model
    torch.cuda.empty_cache()
    return out


def run_biased_train(recipe, dev, card: str) -> dict:
    """Phase 15 (c): the TCPGen-biased Conformer RNN-T train step at full width (V 601, TCPGen 64, weights from
    CUDA seed 180 through ``flax_init_``), f32, dropout on: featurizer (K2) -> trie of the batch's biasing list (16 distractors, 256
    nodes) -> model -> TCPGen -> ``rnnt_loss(fused_log_softmax=False)`` (no K8) -> backward -> clip -> AdamW, on
    8 clips of 10 s with up to 40 targets; then at B=2 x 4 s against the CPU."""
    import torch

    model = flax_drawn(recipe.BiasedConformerRNNT(CF_BIASED_V, device=dev), dev, CF_SEED + 20)
    n_params = sum(p.numel() for p in model.parameters())
    melspec = recipe.MelSpectrogram(sample_rate=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS, power=2.0, device=dev)
    wav, lengths, tgt, tgt_lens = conformer_step_data(dev, CF_BIASED_B, CF_BIASED_S, CF_BIASED_S, CF_U,
                                                      CF_BIASED_V, CF_SEED + 21)
    rng = np.random.default_rng(CF_SEED + 22)
    tgt_np, tl_np = tgt.cpu().numpy(), tgt_lens.cpu().numpy()
    name = (f"biased Conformer RNN-T train step, f32, B={CF_BIASED_B} x {CF_BIASED_S} s, U <= {CF_U}, "
            f"V={CF_BIASED_V}, {recipe.N_DISTRACTORS} distractors, {recipe.MAX_TRIE_NODES} trie nodes")
    print(f"  BiasedConformerRNNT({CF_BIASED_V}): {n_params} parameters ({n_params / 1e6:.2f}M, TCPGen included), "
          f"from CUDA seed {CF_SEED + 20}")
    torch.manual_seed(CF_SEED + 23)
    step = recipe.make_train_step(model.train(), step=recipe.conformer_rnnt.WARMUP_STEPS)

    def one():
        trie = torch.as_tensor(recipe.make_trie(tgt_np, tl_np, rng, CF_BIASED_V), device=dev)
        feats, feat_lens = recipe.featurize(melspec, wav, lengths)
        with torch.enable_grad():
            return step(feats, feat_lens, tgt, tgt_lens, trie)

    reset_kernel_counts()
    first = one()
    torch.cuda.synchronize()
    counts = kernel_counts()
    require_launches(f"one {name}", counts, ["power_spectrogram"])
    require_route(f"one {name}", counts, "power_spectrogram", "fft")
    if counts["lattice_row_stats"]:
        raise AssertionError(f"{name}: K8 launched {counts['lattice_row_stats']} times on the log-probability route")
    check_finite_step(name, first, step.params)
    out = {"params": n_params, "launches": {n: c for n, c in counts.items() if c}, "first_loss": float(first)}
    out.update(time_train_step(name, one, float(lengths.sum()) / SR, card))
    del step
    torch.cuda.empty_cache()

    model = flax_drawn(recipe.BiasedConformerRNNT(CF_BIASED_V, device=dev), dev, CF_SEED + 20)
    wav2, len2, tgt2, tl2 = conformer_step_data(dev, CF_CMP_B, CF_CMP_S, CF_CMP_MIN_S, CF_CMP_U, CF_BIASED_V,
                                                CF_SEED + 24)
    trie2 = torch.as_tensor(recipe.make_trie(tgt2.cpu().numpy(), tl2.cpu().numpy(), np.random.default_rng(CF_SEED + 25),
                                             CF_BIASED_V), device=dev)
    feats2, fl2 = recipe.featurize(melspec, wav2, len2)
    nodes = recipe.biasing.trie_states(trie2, tgt2)
    ref_nodes = recipe.biasing.trie_states(trie2.cpu(), tgt2.cpu())
    check_equal("the trie's nodes on the card vs the CPU", nodes.cpu(), ref_nodes)
    out["cpu"] = compare_step_with_cpu(f"biased Conformer RNN-T step, f32, B={CF_CMP_B} x {CF_CMP_S} s", model,
                                       lambda m: recipe.make_train_step(m), (feats2, fl2, tgt2, tl2, trie2),
                                       lambda s, b: s.loss(*b))
    del model
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 16: the AVSR recipe
# examples/avsr/train.py at its defaults with --num-symbols 1024: 8 clips of up to 200 frames of 96x96 (the
# preprocessing's --resize default) with 640 samples a frame, 8 x 200 = 1600 frames (the recipe's --max-frames)
AV_V, AV_PARAMS = 1024, 45_637_440
AV_B, AV_FRAMES, AV_MIN_FRAMES, AV_SIZE, AV_U = 8, 200, 100, 96, 40
AV_CMP_B, AV_CMP_FRAMES, AV_CMP_MIN_FRAMES, AV_CMP_U = 2, 16, 8, 10  # the card against the CPU in f32
AV_SEED = 190  # the CUDA and numpy seeds of phase 16 are 190-219
AV_FPS = 25
# the recipe's memorization gate with the arguments of the JAX package's slow test of it
AV_OVERFIT = ["--synthetic", "--tiny", "--steps", "400", "--global-batch", "8", "--overfit", "--learning-rate", "2e-3",
              "--warmup-steps", "40"]


def av_batch(dev, b: int, frames: int, min_frames: int, u: int, v: int, seed: int):
    """Lip crops in [0, 1) of AV_SIZE x AV_SIZE and 0.1-scaled noise audio at 640 samples a frame, from a CUDA
    generator seeded ``seed``, zero past each clip's frames (the first at full length, the others ``min_frames``
    to ``frames``) as ``LRS3Batches`` pads, and up to ``u`` targets in [1, v - 1)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(min_frames, frames + 1, (b,), generator=g, device=dev)
    lengths[0] = frames
    spf = SR // AV_FPS
    videos = torch.rand((b, frames, AV_SIZE, AV_SIZE), generator=g, device=dev)
    videos *= (torch.arange(frames, device=dev)[None, :] < lengths[:, None])[:, :, None, None]
    audios = 0.1 * torch.randn((b, frames * spf), generator=g, device=dev)
    audios *= torch.arange(frames * spf, device=dev)[None, :] < lengths[:, None] * spf
    tgt, tgt_lens = conformer_targets(dev, b, u, v, seed + 1)
    return videos, audios, lengths.to(torch.int32), tgt, tgt_lens


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed,
                         output_padding, groups, output_mask, out_shape, **kwargs) -> int:
    """``torch.utils.flop_counter``'s count of a convolution's backward with the weight gradient's term divided
    by ``groups``: torch's formula pairs every input channel with every output channel there, so a depthwise
    convolution of C channels counted C times its operations."""
    from torch.utils.flop_counter import conv_backward_flop

    count = conv_backward_flop.__wrapped__  # on shapes, as this function is called
    conf = (grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed, output_padding, groups)
    grad_input = count(*conf, [output_mask[0], False], out_shape=out_shape)
    grad_weight = count(*conf, [False, output_mask[1]], out_shape=out_shape)
    return grad_input + grad_weight // groups


def step_flops(step, batch) -> float:
    """Floating-point operations of one forward and backward of ``step.loss`` on ``batch`` (convolutions,
    products and attention, as ``torch.utils.flop_counter`` counts them from the shapes, a grouped convolution's
    weight gradient by ``_conv_backward_flops``; K8 and the element-wise work are not counted)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    step.optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad(), FlopCounterMode(
            display=False, custom_mapping={torch.ops.aten.convolution_backward: _conv_backward_flops}) as counter:
        step.loss(*batch).backward()
    step.optimizer.zero_grad(set_to_none=True)
    return float(counter.get_total_flops())


def check_step_lattice(recipe, step, batch, card: str) -> dict:
    """K8 on the lattice the AVSR step gives it: the model's f32 logits (B, t, U+1, V) on the step's ``batch``
    (dropout off), blank 0, each row's label the targets padded by the unused row U and expanded over t as
    ``ops/rnnt.py`` builds them.  Held to the plain version, a batch block at a time, at the f32 limit of the JAX
    kernel's tests, 1e-5; the same bits over two runs; the kernel's time there beside the plain version's and
    the bound."""
    import torch

    from audio_tpu_torch.ops import cuda_rnnt_lps

    videos, audios, lengths, targets, tgt_lens = batch
    blank = recipe.BLANK_FIRST_TOKEN
    training = step.model.training
    with torch.no_grad():
        x = step.model.eval()(videos, audios, lengths, torch.nn.functional.pad(targets, (1, 0), value=blank),
                              tgt_lens + 1)[0]
    step.model.train(training)
    tgt = torch.nn.functional.pad(targets, (0, 1))[:, None, :].expand(x.shape[:-1])
    b, t, rows, v = x.shape
    label = f"f32 AVSR step lattice {tuple(x.shape)}, blank {blank}"
    got = cuda_rnnt_lps.lattice_row_stats(x, tgt, blank)
    torch.cuda.synchronize()
    block = 2
    ref = [torch.cat(part) for part in zip(*(cuda_rnnt_lps.lattice_row_stats_plain(x[i : i + block], tgt[i : i + block],
                                                                                    blank)
                                             for i in range(0, b, block)))]
    err = max(check_close(f"K8 lattice_row_stats [stream] {label} {part}", g, r, 1e-5, 1e-5)
              for part, g, r in zip(("lse", "blank", "label"), got, ref))
    del ref
    again = cuda_rnnt_lps.lattice_row_stats(x, tgt, blank)
    same = [torch.equal(a, b_) for a, b_ in zip(got, again)]
    print(f"  K8 bits {label}: equal over two runs: {same}")
    if not all(same):
        raise AssertionError(f"K8 {label}: two runs gave different bits {same}")
    n = b * t * rows
    ms = cuda_ms(lambda: cuda_rnnt_lps.lattice_row_stats(x, tgt, blank), 5)
    plain_ms = cuda_ms(lambda: cuda_rnnt_lps.lattice_row_stats_plain(x, tgt, blank), 3)
    # the lattice read once, tgt read and three f32 outputs written once a row
    bound = bound_ms(4 * n * v + n * (4 + 12), 3 * n * v)
    print(f"  K8 lattice_row_stats {label}: route stream {ms:.4f} ms, plain {plain_ms:.4f} ms (bound {bound[0]:.4f} "
          f"ms by {bound[1]}) on {card}")
    del x, tgt, got, again
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1])


@contextlib.contextmanager
def tf32_on(flag: str):
    """cuDNN's ("cudnn") or cuBLAS's ("cublas") TF32 at PyTorch's default, on, inside the block (phase 1 turned
    both off for the whole process)."""
    import torch

    backend = torch.backends.cudnn if flag == "cudnn" else torch.backends.cuda.matmul
    previous = backend.allow_tf32
    backend.allow_tf32 = True
    try:
        yield
    finally:
        backend.allow_tf32 = previous


def check_grads_tf32(name: str, loss_fn, leaves: dict, flag: str = "cudnn") -> dict:
    """The f32 gradients of ``loss_fn()`` with respect to ``leaves`` ({name: tensor}) with TF32 (cuDNN's or
    cuBLAS's, ``flag``, or ``"both"``) on while the backward runs, against two runs with it off.  Autograd runs a backward under
    the flags of that moment; ``utils.precision.tf32_off`` (every convolution of the port, cuDNN's RNN and
    ``exact_matmul``) turns TF32 off in the backward too.  Equal bits where the two runs with TF32 off agree bit for
    bit; else (cuDNN's weight gradients may add in any order) within TF32_GRAD_TOL of each gradient's peak: TF32
    rounds each operand to 2^-11 of itself.  The fault's size before the repair is the same call with
    ``tf32_off``'s switch made a no-op in the backward (the forward alone ran with TF32 off, as every helper did
    before): printed, not gated."""
    from unittest import mock

    import torch

    from audio_tpu_torch.utils import precision

    names = list(leaves)

    def tf32(on: bool):
        stack = contextlib.ExitStack()
        for f in (("cudnn", "cublas") if flag == "both" else (flag,)) if on else ():
            stack.enter_context(tf32_on(f))
        return stack

    def grads(on: bool, repaired: bool = True) -> dict:
        with torch.enable_grad():
            loss = loss_fn()
            switch = (contextlib.nullcontext() if repaired
                      else mock.patch.object(precision, "_no_tf32", contextlib.nullcontext))
            with tf32(on), switch:
                got = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        return {n: g.detach().clone() for n, g in zip(names, got) if g is not None}

    def worst(got: dict, ref: dict) -> float:
        return max(float((got[n] - r).abs().max()) / max(float(r.abs().max()), 1e-30) for n, r in ref.items())

    off, again, on, before = grads(False), grads(False), grads(True), grads(True, repaired=False)
    repeat_err, tf32_err, before_err = worst(again, off), worst(on, off), worst(before, off)
    limit = 0.0 if repeat_err == 0 else TF32_GRAD_TOL
    print(f"  {name}: {len(off)} f32 gradients with {'cuDNN and cuBLAS' if flag == 'both' else flag}'s TF32 on in "
          f"the backward: {tf32_err:.3e} of their peaks "
          f"off those with it off (two runs with it off: {repeat_err:.3e}; limit "
          f"{'0, the same bits' if limit == 0 else f'{limit:g}'}); before the repair (TF32 off in the forward "
          f"alone): {before_err:.3e}")
    if tf32_err > limit:
        raise AssertionError(f"{name}: TF32 ({flag}) changed the f32 gradients")
    return {"tf32_err_of_peak": tf32_err, "repeat_err_of_peak": repeat_err, "before_repair_err_of_peak": before_err,
            "gradients": len(off)}


def run_avsr_train(recipe, dev, card: str) -> dict:
    """Phase 16 (a)-(c): the AVSR train step at the recipe's full width (weights from CUDA seed 190), f32,
    dropout on, at the schedule's peak: video and audio front ends -> fusion -> Conformer -> ``rnnt_loss`` (K8)
    -> backward -> clip -> AdamW, on 8 clips of 100-200 frames with up to 40 targets.  Then at B=2 x 16 frames
    against the CPU, and ``fuse``'s bits with cuDNN's TF32 on."""
    import torch

    model = recipe.AVConformerRNNT(AV_V, device=dev, generator=torch.Generator(device=dev).manual_seed(AV_SEED))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  AVConformerRNNT({AV_V}): {n_params} parameters ({n_params / 1e6:.2f}M), from CUDA seed {AV_SEED}")
    if n_params != AV_PARAMS:
        raise AssertionError(f"AVConformerRNNT({AV_V}) has {n_params} parameters, not the JAX recipe's {AV_PARAMS}")
    batch = av_batch(dev, AV_B, AV_FRAMES, AV_MIN_FRAMES, AV_U, AV_V, AV_SEED + 1)
    frames = int(batch[2].sum())
    name = (f"AVSR train step, f32, B={AV_B} x {AV_MIN_FRAMES}-{AV_FRAMES} frames of {AV_SIZE}x{AV_SIZE}, "
            f"U <= {AV_U}, V={AV_V}")
    print(f"  the lattice ({AV_B}, {AV_FRAMES}, {AV_U + 1}, {AV_V}) f32, "
          f"{AV_B * AV_FRAMES * (AV_U + 1) * AV_V * 4 / 1e6:.1f} MB; {frames} valid frames")
    torch.manual_seed(AV_SEED + 3)  # dropout
    step = recipe.make_train_step(model.train(), step=recipe.WARMUP_STEPS)  # at the schedule's peak

    def one():
        with torch.enable_grad():
            return step(*batch)

    reset_kernel_counts()
    first = one()
    torch.cuda.synchronize()
    counts = kernel_counts()
    require_launches(f"one {name}", counts, ["lattice_row_stats"])
    require_route(f"one {name}", counts, "lattice_row_stats", "stream")
    check_finite_step(name, first, step.params)
    out = {"params": n_params, "launches": {n: c for n, c in counts.items() if c}, "first_loss": float(first),
           "frames": frames}
    out.update(time_train_step(name, one, frames / AV_FPS, card, against_key_averages=True, helper_ab=True))
    out["frames_per_s"] = frames / (out["ms"] / 1e3)
    flops = step_flops(step, batch)
    out.update(model_tflop=flops / 1e12, share_of_fp32_peak=flops / (out["ms"] / 1e3) / PEAK_FP32_PER_S)
    print(f"  {name}: {out['frames_per_s']:.1f} video frames a second; forward and backward "
          f"{out['model_tflop']:.3f} TFLOP (step_flops), {out['share_of_fp32_peak']:.3f} of the "
          f"{PEAK_FP32_PER_S / 1e12:g} TFLOP/s FP32 peak on {card}")
    out["k8"] = check_step_lattice(recipe, step, batch, card)
    del step
    torch.cuda.empty_cache()

    # the card against the CPU at B=2 x 16 frames, dropout off, seeded weights
    model = recipe.AVConformerRNNT(AV_V, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(AV_SEED + 5))
    batch2 = av_batch(dev, AV_CMP_B, AV_CMP_FRAMES, AV_CMP_MIN_FRAMES, AV_CMP_U, AV_V, AV_SEED + 6)
    reset_kernel_counts()
    out["cpu"] = compare_step_with_cpu(f"AVSR step, f32, B={AV_CMP_B} x {AV_CMP_FRAMES} frames", model,
                                       lambda m: recipe.make_train_step(m, step=recipe.WARMUP_STEPS), batch2,
                                       lambda s, b: s.loss(*b))
    require_launches(f"the f32 AVSR step at B={AV_CMP_B}", kernel_counts(), ["lattice_row_stats"])
    # fuse's bits with cuDNN's TF32 on: every front-end convolution turns TF32 off inside the call
    with torch.no_grad():
        fused_off, lens_off = model.eval().fuse(*batch2[:3])
        previous = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            fused_on, lens_on = model.fuse(*batch2[:3])
        finally:
            torch.backends.cudnn.allow_tf32 = previous
    same = torch.equal(fused_on, fused_off) and torch.equal(lens_on, lens_off)
    print(f"  the f32 fuse (front ends and fusion) with cuDNN's TF32 on gives the same bits as with it off: {same}")
    if not same:
        raise AssertionError("AVSR: cuDNN's TF32 changed the f32 fuse output")
    out["front_end_grads_tf32"] = check_grads_tf32(
        "the AVSR front ends", lambda: model.fuse(*batch2[:3])[0].square().mean(),
        {n: p for n, p in model.named_parameters() if n.startswith(("video_frontend.", "audio_frontend."))})
    del model
    torch.cuda.empty_cache()
    return out


def run_avsr_eval(evaluate, dev, card: str) -> dict:
    """Phase 16 (d): ``eval_torch.py``'s decode (``fuse`` -> ``rnnt_greedy_decode(blank 0, max_tokens 64)``) on
    8 clips of 100-200 frames at full width (weights from CUDA seed 200), timed and profiled; at B=2 x 16 frames
    the tokens and counts equal to the CPU's; then the recipe's ``--overfit`` gate on the card."""
    import torch

    recipe = evaluate.train
    model = recipe.AVConformerRNNT(AV_V, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(AV_SEED + 10)).eval()
    videos, audios, lengths, _, _ = av_batch(dev, AV_B, AV_FRAMES, AV_MIN_FRAMES, AV_U, AV_V, AV_SEED + 11)
    name = f"AVSR greedy decode, f32, B={AV_B} x {AV_MIN_FRAMES}-{AV_FRAMES} frames, max_tokens {recipe.MAX_TOKENS}"

    def one():
        return evaluate.decode(model, videos, audios, lengths)

    reset_kernel_counts()
    tokens, counts = one()
    torch.cuda.synchronize()
    launches = {n: c for n, c in kernel_counts().items() if c}
    print(f"  launches of the port's kernels in one {name}: {launches} (the greedy loop runs the plain predictor "
          f"and joiner)")
    tokens, counts = tokens.cpu(), counts.cpu()
    emitted = torch.arange(recipe.MAX_TOKENS)[None, :] < counts[:, None]
    if not (bool(((counts >= 0) & (counts <= recipe.MAX_TOKENS)).all()) and bool((tokens[~emitted] == -1).all())
            and bool(((tokens[emitted] > recipe.BLANK_FIRST_TOKEN) & (tokens[emitted] < AV_V)).all())):
        raise AssertionError(f"{name}: counts {counts.tolist()} or the tokens are not well formed")
    torch.cuda.reset_peak_memory_stats()
    ms, runs, _ = timed_steps(lambda: (one(), None)[1], 0, 2)  # the call above was the warm-up
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    frames = int(lengths.sum())
    print(f"  {name}: {ms:.3f} ms a batch (runs {', '.join(f'{r:.3f}' for r in runs)}), {frames / (ms / 1e3):.1f} "
          f"video frames a second, peak memory {peak_gb:.3f} GB; tokens a clip {counts.tolist()} on {card}")
    out = {"ms": ms, "runs_ms": runs, "frames_per_s": frames / (ms / 1e3), "peak_gb": peak_gb,
           "counts": counts.tolist(), "kernel_launches": launches, "profile": profile_batch(name, one)}

    # the decode at B=2 x 16 frames against the CPU's: tokens and counts equal
    v2, a2, l2, _, _ = av_batch(dev, AV_CMP_B, AV_CMP_FRAMES, AV_CMP_MIN_FRAMES, AV_CMP_U, AV_V, AV_SEED + 12)
    got = [t.cpu() for t in evaluate.decode(model, v2, a2, l2)]
    ref = evaluate.decode(copy.deepcopy(model).cpu(), v2.cpu(), a2.cpu(), l2.cpu())
    check_equal(f"AVSR greedy counts at B={AV_CMP_B} vs the CPU", got[1], ref[1])
    check_equal(f"AVSR greedy tokens at B={AV_CMP_B} vs the CPU", got[0], ref[0])
    out["cpu_counts"] = got[1].tolist()
    del model
    torch.cuda.empty_cache()

    # the memorization gate: the tiny model on one fixed batch, 400 steps, every transcript decoded exactly
    print(f"  the recipe's --overfit gate on the card: train_torch.py {' '.join(AV_OVERFIT)} --device cuda")
    t0 = time.perf_counter()
    reset_kernel_counts()
    with torch.enable_grad():
        recipe.main(AV_OVERFIT + ["--device", "cuda"])
    torch.cuda.synchronize()
    out["overfit_s"] = time.perf_counter() - t0
    out["overfit_launches"] = {n: c for n, c in kernel_counts().items() if c}
    require_launches("the --overfit gate's 400 steps", kernel_counts(), ["lattice_row_stats"])
    print(f"  the --overfit gate passed in {out['overfit_s']:.1f} s on {card}")
    return out


# ------------------------------------------------------------------ phase 17: Wav2Letter, DeepSpeech, Conv-TasNet
# examples/asr/wav2letter/train.py: B=8 clips padded to the JAX LibriSpeechBatches' max_seconds (8 s, 128,000
# samples: 801 MFCC frames, 401 output frames), each valid for 4-8 s, 10-15 characters a second of valid audio, V 29
W2L_B, W2L_SECONDS, W2L_MIN_S, W2L_CHARS_PER_S = 8, 8, 4, (10, 15)
W2L_CMP_B, W2L_CMP_S, W2L_CMP_MIN_S = 2, 2, 1  # the card against the CPU in f32
DS_B, DS_SECONDS, DS_HIDDEN, DS_N_FFT = 16, 10, 2048, 320  # DeepSpeech on a power spectrogram of 161 bins
DS_CMP_B, DS_CMP_S = 2, 2
TN_SR, TN_B, TN_SECONDS, TN_SOURCES = 8000, 8, 3.0, 2  # the JAX recipe's --global-batch and --seconds defaults
TN_CMP_B, TN_CMP_S = 2, 0.5
TN_PARAMS = 4_984_881  # conv_tasnet_base(2), as the JAX package's flax tree counts it
P17_SEED = 220  # the CUDA and numpy seeds of phase 17 are 220-249
# the three models' steps against the CPU (compare_with_cpu_f32_f64).  In float64 the card and the CPU compute one
# function to rounding of 2^-53: 1e-10 of the loss, 1e-9 of each gradient's peak.  In float32 each side is held to
# the CPU's float64 on the same batch and weights and on that side's own side of every kink (a float32 run of
# Wav2Letter put one input of 5.7e-7 of its layer's peak on the other side, and the gradients below it moved by up to
# 1.6e-2 of their peaks), and the card's error to F32_VS_CPU_FACTOR times the CPU's own float32 error, or to
# F32_FLOOR of the peak (the port's CPU tests' float32 gradient limit) where the CPU's is smaller
F64_LOSS_TOL, F64_GRAD_TOL = 1e-10, 1e-9
F32_VS_CPU_FACTOR, F32_FLOOR, F32_LOSS_FLOOR = 8.0, 1e-4, 1e-6
# the recipes' memorization gates with the arguments of the JAX package's slow tests of them
W2L_OVERFIT = ["--synthetic", "--tiny", "--steps", "120", "--global-batch", "8", "--overfit", "--decode-every", "50"]
TN_OVERFIT = ["--synthetic", "--tiny", "--steps", "150", "--global-batch", "8", "--overfit", "--learning-rate", "2e-3"]


def transcript_batch(dev, b: int, seconds: int, min_seconds: int, seed: int):
    """``b`` voiced clips at 16 kHz padded to ``seconds`` (the first full, the others valid for ``min_seconds`` to
    ``seconds``), and for each 10-15 characters in [1, 29) a second of its valid audio, zero-padded."""
    import torch

    wav, lengths = padded_clips(dev, b, seconds, min_seconds, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    rate = torch.randint(W2L_CHARS_PER_S[0], W2L_CHARS_PER_S[1] + 1, (b,), generator=g, device=dev)
    tgt_lens = lengths * rate // SR
    u = int(tgt_lens.max())
    tgt = torch.randint(1, 29, (b, u), generator=g, device=dev) * (torch.arange(u, device=dev)[None, :]
                                                                  < tgt_lens[:, None])
    return wav, lengths.to(torch.int32), tgt.to(torch.int32), tgt_lens.to(torch.int32)


class GradsOnly:
    """A model's parameters by name and an optimizer that is never stepped: what ``compare_with_cpu_f32_f64`` reads
    of a step, for a model that has no recipe step.  The model in training mode: cuDNN's RNN has no backward in
    eval mode (DeepSpeech's dropout is 0, so the two modes compute the same)."""

    def __init__(self, model):
        import torch

        self.model = model.train()
        self.params = dict(model.named_parameters())
        self.optimizer = torch.optim.SGD(self.params.values(), lr=0.0)


@contextlib.contextmanager
def kink_sides(record: list = None, replay: list = None):
    """``F.relu``, ``F.prelu`` and ``torch.clamp`` of floating tensors (the kinks of phase 17's models outside
    cuDNN's RNN) with which side of each kink every input lies on appended to ``record``, or taken, call by call in
    the same order, from ``replay``: a float64 run then follows a float32 run's side of every kink.  Inputs within
    rounding of a kink may fall on either side in float32, and the gradient jumps there by the whole incoming
    gradient of that entry."""
    from unittest import mock

    import torch
    import torch.nn.functional as F

    relu, prelu, clamp = F.relu, F.prelu, torch.clamp
    calls = None if replay is None else iter(replay)

    def side(inside):
        if calls is None:
            if record is not None:
                record.append(inside.cpu())
            return inside
        got = next(calls).to(inside.device)
        if got.shape != inside.shape:
            raise AssertionError(f"kink_sides: a replayed side of shape {tuple(got.shape)} for {tuple(inside.shape)}")
        return got

    def relu_(x, inplace=False):
        above = side(x.detach() > 0)
        return relu(x) if calls is None else x * above.to(x.dtype)

    def prelu_(x, weight):
        above = side(x.detach() > 0)
        if calls is None:
            return prelu(x, weight)
        return torch.where(above, x, weight * x)  # the models' PReLUs have one slope

    def clamp_(x, min=None, max=None):
        if not (torch.is_tensor(x) and x.is_floating_point()):
            return clamp(x, min, max)
        above = None if min is None else side(x.detach() > min)
        below = None if max is None else side(x.detach() < max)
        if calls is None:
            return clamp(x, min, max)
        for inside, bound in ((below, max), (above, min)):
            if inside is not None:
                x = torch.where(inside, x, torch.as_tensor(bound, dtype=x.dtype, device=x.device))
        return x

    with mock.patch.object(F, "relu", relu_), mock.patch.object(F, "prelu", prelu_), \
            mock.patch.object(torch, "clamp", clamp_):
        yield


def compare_with_cpu_f32_f64(name: str, model, make_step, card_batch, loss_fn, witness: str) -> dict:
    """The step's loss and every gradient (dropout off) on one batch and one set of weights.  The card and the CPU
    in float64, held to each other (F64_LOSS_TOL, F64_GRAD_TOL).  The card and the CPU in float32, each against
    the CPU's float64 run on that side's own side of every kink (``kink_sides``): the card's error of each gradient
    within F32_VS_CPU_FACTOR times the CPU's or F32_FLOOR of the peak, of the loss within F32_VS_CPU_FACTOR times
    the CPU's or F32_LOSS_FLOOR (relative).  ``model`` is the float32 model on the card; the gradient ``witness``
    names is printed on both sides, and beside it the card's error against float64 on float64's own sides."""
    import torch

    dev = card_batch[0].device

    def side(device, dtype, record=None, replay=None):
        m = copy.deepcopy(model).to(device=device, dtype=dtype).eval()
        batch = tuple(t.to(device=device, dtype=dtype) if t.is_floating_point() else t.to(device)
                      for t in card_batch)
        with kink_sides(record, replay):
            return loss_and_grads(make_step(m), lambda s, b=batch: loss_fn(s, b))

    f64_sides = []
    ref, ref_grads = side("cpu", torch.float64, record=f64_sides)
    got, got_grads = side(dev, torch.float64)
    rel = abs(got - ref) / abs(ref)
    grad_err = check_ssl_grads(f"{name}, f64", got_grads, ref_grads, F64_GRAD_TOL)
    print(f"  {name}, f64, card against the CPU: loss {got:.12f} vs {ref:.12f} (relative {rel:.3e}, limit "
          f"{F64_LOSS_TOL:g}); {len(ref_grads)} gradients within {grad_err:.3e} of their peaks (limit "
          f"{F64_GRAD_TOL:g})")
    if not rel <= F64_LOSS_TOL or not grad_err <= F64_GRAD_TOL:
        raise AssertionError(f"{name}: the card disagrees with the CPU in float64")

    present = {k for k, g in ref_grads.items() if g is not None}

    def err(g, r) -> float:
        return float((g.cpu().double() - r).abs().max()) / max(float(r.abs().max()), 1e-300)

    f32, flips, leaves, loss_err = {}, {}, {}, {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        sides = []
        f32[where] = side(device, torch.float32, record=sides)
        if {k for k, g in f32[where][1].items() if g is not None} != present:
            raise AssertionError(f"{name}: the {where}'s float32 step computed gradients of other parameters")
        own, own_grads = side("cpu", torch.float64, replay=sides)
        flips[where] = sum(int((a != b).sum()) for a, b in zip(sides, f64_sides))
        loss_err[where] = abs(f32[where][0] - own) / abs(own)
        leaves[where] = {k: err(f32[where][1][k], own_grads[k]) for k in present}
    for k, e in leaves["card"].items():
        if not math.isfinite(e):
            raise AssertionError(f"{name}: the card's float32 gradient of {k} is not finite")
    limit = {k: max(F32_VS_CPU_FACTOR * leaves["cpu"][k], F32_FLOOR) for k in present}
    loss_limit = max(F32_VS_CPU_FACTOR * loss_err["cpu"], F32_LOSS_FLOOR)
    nearest = max(present, key=lambda k: leaves["card"][k] / limit[k])
    worst = {where: max(present, key=lambda k, w=where: leaves[w][k]) for where in leaves}
    plain = err(f32["card"][1][witness], ref_grads[witness])
    print(f"  {name}, f32, each side against the CPU's f64 on its own kink sides (the card took {flips['card']}, the "
          f"CPU {flips['cpu']} other than f64's): loss relative error card {loss_err['card']:.3e}, CPU "
          f"{loss_err['cpu']:.3e} (limit {loss_limit:.3e}); of {len(present)} gradients the card's largest error "
          f"{leaves['card'][worst['card']]:.3e} of the peak ({worst['card']}), the CPU's "
          f"{leaves['cpu'][worst['cpu']]:.3e} ({worst['cpu']}); nearest its limit {nearest}: card "
          f"{leaves['card'][nearest]:.3e}, CPU {leaves['cpu'][nearest]:.3e}, limit {limit[nearest]:.3e}; {witness}: card {leaves['card'][witness]:.3e}, "
          f"CPU {leaves['cpu'][witness]:.3e}, the card on f64's own sides {plain:.3e} (limit {F32_VS_CPU_FACTOR:g} x "
          f"the CPU's or {F32_FLOOR:g} of each peak)")
    bad = [k for k in present if not leaves["card"][k] <= limit[k]]
    if bad or not loss_err["card"] <= loss_limit:
        raise AssertionError(f"{name}: the card's float32 step is further from float64 than the CPU's allows: "
                             f"{[(k, leaves['card'][k], leaves['cpu'][k], limit[k]) for k in bad]}, loss {loss_err}")
    return {"loss_rel_f64": rel, "grad_err_of_peak_f64": grad_err, "f32_kink_flips": flips,
            "f32_loss_rel_err": loss_err, "f32_card_worst": [worst["card"], leaves["card"][worst["card"]]],
            "f32_cpu_worst": [worst["cpu"], leaves["cpu"][worst["cpu"]]],
            "f32_nearest_limit": [nearest, leaves["card"][nearest], leaves["cpu"][nearest], limit[nearest]],
            "f32_witness": [witness, leaves["card"][witness], leaves["cpu"][witness], plain]}


def interleaved_ms(first, second, reps: int = 5) -> dict:
    """``first()`` and ``second()`` timed in turn (CUDA events around each, one warm-up each): their medians and
    the median over the pairs of second / first.  The two calls meet the same pace of the host, which moves by up
    to twice between calls taken apart."""
    import torch

    first(), second()
    torch.cuda.synchronize()
    runs = ([], [])
    for _ in range(reps):
        for fn, got in zip((first, second), runs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            got.append(start.elapsed_time(end))
    return {"first_ms": statistics.median(runs[0]), "second_ms": statistics.median(runs[1]),
            "ratio": statistics.median(b / a for a, b in zip(*runs)), "first_runs_ms": runs[0],
            "second_runs_ms": runs[1]}


def ctc_share(name: str, one, step_profile: dict, logp, targets, lengths, target_lengths, card: str) -> dict:
    """``ctc_loss``'s forward and backward alone on the log-probabilities ``logp`` against the step ``one`` that
    contains it: timed in turn with the step (``interleaved_ms``), and one profiled call's launches and busy time
    against the step's profile (``step_profile``)."""
    import torch

    from audio_tpu_torch.ops.ctc import ctc_loss

    def loss_alone():
        lp = logp.clone().requires_grad_()
        with torch.enable_grad():
            ctc_loss(lp, targets, lengths, target_lengths, blank=0, reduction="mean").backward()

    label = f"ctc_loss forward and backward alone at {tuple(logp.shape)}, L <= {targets.shape[1]}"
    turns = interleaved_ms(one, loss_alone)
    prof = profile_batch(label, loss_alone)
    share = {"ms": turns["ratio"], "launches": prof["launches"] / step_profile["launches"],
             "busy": prof["busy_ms"] / step_profile["busy_ms"]}
    print(f"  {label}, timed in turn with the {name}: {turns['second_ms']:.3f} ms against {turns['first_ms']:.3f} ms "
          f"(runs {', '.join(f'{a:.1f}/{b:.1f}' for a, b in zip(turns['second_runs_ms'], turns['first_runs_ms']))}); "
          f"its share: {share['ms']:.3f} of the time (median over the pairs), {share['launches']:.3f} of the "
          f"launches, {share['busy']:.3f} of the device's busy time on {card}")
    return {"alone": turns, "profile": prof, "share": share}


def helper_cost(name: str, one, card: str, reps: int = 5) -> dict:
    """``one()`` as it runs, every convolution, cuDNN RNN and ``exact_matmul`` through ``utils.precision.tf32_off``'s
    autograd function, timed in turn with ``one()`` where ``tf32_off`` is a plain call of its function: the cost
    of the helper's recorded graph and nested backward.  The two compute the same numbers here, since phase 1 turned
    TF32 off for the whole process."""
    from unittest import mock

    from audio_tpu_torch.utils import precision

    def plain(fn, *args):
        return fn(*args)

    users = [m for n, m in list(sys.modules.items())
             if n.startswith("audio_tpu_torch") and getattr(m, "tf32_off", None) is precision.tf32_off]

    def without():
        with contextlib.ExitStack() as stack:
            for module in users:
                stack.enter_context(mock.patch.object(module, "tf32_off", plain))
            return one()

    turns = interleaved_ms(one, without, reps)
    pairs = ", ".join(f"{a:.1f}/{b:.1f}" for a, b in zip(turns["first_runs_ms"], turns["second_runs_ms"]))
    print(f"  {name}: {turns['first_ms']:.3f} ms through tf32_off, {turns['second_ms']:.3f} ms with plain calls in "
          f"its place (runs {pairs}; plain over helper, median over the pairs, {turns['ratio']:.4f}) on {card}")
    return {"helper_ms": turns["first_ms"], "plain_ms": turns["second_ms"], "plain_over_helper": turns["ratio"]}


def run_overfit_gate(name: str, recipe, argv: list, card: str) -> dict:
    """A recipe's ``--overfit`` gate on the card (its ``main`` raises if the gate fails; every recipe's gate trains
    under ``deterministic_cudnn``, so that cuDNN's sums do not move its verdict between runs): seconds and launches."""
    import torch

    print(f"  the {name} recipe's --overfit gate on the card: train_torch.py {' '.join(argv)} --device cuda")
    t0 = time.perf_counter()
    reset_kernel_counts()
    with torch.enable_grad():
        recipe.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    out = {"overfit_s": time.perf_counter() - t0, "overfit_launches": {n: c for n, c in kernel_counts().items() if c}}
    print(f"  the {name} --overfit gate passed in {out['overfit_s']:.1f} s on {card}")
    return out


def run_wav2letter(recipe, dev, card: str) -> dict:
    """Phase 17 (a): the Wav2Letter CTC train step at full width (``Wav2Letter(29, "mfcc", 13)``, weights drawn as
    flax's ``init`` draws from CUDA seed 220), f32: MFCC (K2, only on "fft") -> normalisation -> the stack ->
    ``ctc_loss`` (8, 401, 29) -> backward -> clip -> Adadelta, on 8 clips of 4-8 s padded to 8 s.  Timed, profiled,
    its peak memory, ``helper_cost`` and ``ctc_share``; at B=2 x 1-2 s the features against the CPU, the loss and
    every gradient in float64 and float32 (``compare_with_cpu_f32_f64``), the greedy tokens equal to the CPU's, the
    gradients with cuDNN's TF32 on in the backward; the ``--overfit`` gate."""
    import torch

    from audio_tpu_torch.ops.ctc import ctc_loss

    model = recipe.make_model(dev, torch.Generator(device=dev).manual_seed(P17_SEED))
    n_params = sum(p.numel() for p in model.parameters())
    mfcc = recipe.make_mfcc(dev)
    wav, lengths, tgt, tgt_lens = transcript_batch(dev, W2L_B, W2L_SECONDS, W2L_MIN_S, P17_SEED + 1)
    feats, feat_lens = recipe.featurize(mfcc, wav, lengths)
    with torch.no_grad():
        t_out = recipe.log_probs(model, feats[:1], feat_lens[:1])[0].shape[1]
    name = (f"Wav2Letter CTC train step, f32, B={W2L_B} x {W2L_MIN_S}-{W2L_SECONDS} s, L <= {tgt.shape[1]}, "
            f"({W2L_B}, {t_out}, {len(recipe.LABELS)}) log-probabilities")
    print(f"  Wav2Letter(29, mfcc, 13): {n_params} parameters ({n_params / 1e6:.2f}M), from CUDA seed {P17_SEED}; "
          f"MFCC {tuple(feats.shape)}; targets {tgt_lens.tolist()}")
    step = recipe.TrainStep(model.train())

    def one():
        f, fl = recipe.featurize(mfcc, wav, lengths)
        with torch.enable_grad():
            return step(f, fl, tgt, tgt_lens)[0]

    reset_kernel_counts()
    first = one()
    torch.cuda.synchronize()
    counts = kernel_counts()
    require_launches(f"one {name}", counts, ["power_spectrogram"])
    require_route(f"one {name}", counts, "power_spectrogram", "fft")
    check_finite_step(name, first, step.params)
    out = {"params": n_params, "launches": {n: c for n, c in counts.items() if c}, "first_loss": float(first),
           "log_probs_shape": [W2L_B, t_out, len(recipe.LABELS)]}
    out.update(time_train_step(name, one, float(lengths.sum()) / SR, card, helper_ab=True))
    with torch.no_grad():
        logp, in_lens = recipe.log_probs(model, feats, feat_lens)
    out["ctc_loss"] = ctc_share("step", one, out["profile"], logp, tgt, in_lens, tgt_lens, card)
    del step, logp
    torch.cuda.empty_cache()

    # the card against the CPU at B=2 x 1-2 s
    model = recipe.make_model(dev, torch.Generator(device=dev).manual_seed(P17_SEED + 3))
    wav2, len2, tgt2, tl2 = transcript_batch(dev, W2L_CMP_B, W2L_CMP_S, W2L_CMP_MIN_S, P17_SEED + 4)
    reset_kernel_counts()
    feats2, fl2 = recipe.featurize(mfcc, wav2, len2)
    require_route("the B=2 MFCC features", kernel_counts(), "power_spectrogram", "fft")
    ref_feats, ref_fl = recipe.featurize(recipe.make_mfcc("cpu"), wav2.cpu(), len2.cpu())
    out["features_err"] = check_close("Wav2Letter's normalised MFCC features (K2) vs the CPU, B=2", feats2.cpu(),
                                      ref_feats, 1e-3, 0.0)
    check_equal("Wav2Letter feature lengths vs the CPU", fl2.cpu(), ref_fl)
    out["cpu"] = compare_with_cpu_f32_f64(f"Wav2Letter step, B={W2L_CMP_B} x {W2L_CMP_MIN_S}-{W2L_CMP_S} s", model,
                                          recipe.TrainStep, (feats2, fl2, tgt2, tl2), lambda s, b: s.loss(*b)[0],
                                          "acoustic_model.0.bias")
    with torch.no_grad():
        got = [t.cpu() for t in recipe.decode(*recipe.log_probs(model, feats2, fl2))]
        ref = recipe.decode(*recipe.log_probs(copy.deepcopy(model).cpu(), feats2.cpu(), fl2.cpu()))
    check_equal(f"Wav2Letter greedy counts at B={W2L_CMP_B} vs the CPU", got[1], ref[1])
    check_equal(f"Wav2Letter greedy tokens at B={W2L_CMP_B} vs the CPU", got[0], ref[0])
    out["cpu_counts"] = got[1].tolist()

    def loss_fn():
        lp, il = recipe.log_probs(model, feats2, fl2)
        return ctc_loss(lp, tgt2, il, tl2, blank=0, reduction="mean")

    out["grads_tf32"] = check_grads_tf32(f"Wav2Letter, B={W2L_CMP_B}", loss_fn, dict(model.named_parameters()))
    del model
    torch.cuda.empty_cache()
    out.update(run_overfit_gate("Wav2Letter", recipe, W2L_OVERFIT, card))
    if out["overfit_launches"].get("power_spectrogram", 0) < 1:
        raise AssertionError("the Wav2Letter --overfit gate did not launch K2")
    return out


def deepspeech_flops(n_frames: int, n_feature: int, h: int, n_class: int) -> float:
    """Forward FLOPs of DeepSpeech on ``n_frames`` frames (the batch's): fc1, fc2-fc4, both directions' input and
    recurrent products, the output layer."""
    return 2.0 * n_frames * (n_feature * h + 3 * h * h + 2 * (h * h + h * h) + h * n_class)


def run_deepspeech(recipe, dev, card: str) -> dict:
    """Phase 17 (b): ``DeepSpeech(161, 2048, 29)`` (weights drawn as flax's ``init`` draws, an orthogonal recurrent
    matrix, from CUDA seed 230) on the power spectrogram (n_fft 320, hop 160: K2, only on "fft") of 16 clips of
    10 s: the forward timed, then the forward with ``ctc_loss`` and its backward (``helper_cost``, ``ctc_share``); at
    B=2 x 2 s the features against the CPU, the loss and every gradient in float64 and float32
    (``compare_with_cpu_f32_f64``), and the gradients with cuDNN's TF32 on in the backward (cuDNN's RNN reads it)."""
    import torch

    from audio_tpu_torch.models import DeepSpeech
    from audio_tpu_torch.ops.ctc import ctc_loss
    from audio_tpu_torch.transforms import Spectrogram

    n_feature, n_class = DS_N_FFT // 2 + 1, len(recipe.LABELS)

    def make(seed):
        model = DeepSpeech(n_feature, DS_HIDDEN, n_class, device=dev)
        return flax_drawn(model, dev, seed)

    def features(spec, wav, lengths):
        return spec(wav).transpose(1, 2)[:, None], torch.div(lengths, HOP, rounding_mode="floor") + 1

    model = make(P17_SEED + 10)
    n_params = sum(p.numel() for p in model.parameters())
    spec = Spectrogram(n_fft=DS_N_FFT, hop_length=HOP, power=2.0, device=dev)
    wav, lengths, tgt, tgt_lens = transcript_batch(dev, DS_B, DS_SECONDS, DS_SECONDS, P17_SEED + 11)
    reset_kernel_counts()
    x, frames = features(spec, wav, lengths)
    torch.cuda.synchronize()
    counts = kernel_counts()
    name = f"DeepSpeech({n_feature}, {DS_HIDDEN}, {n_class}), f32, B={DS_B} x {DS_SECONDS} s, input {tuple(x.shape)}"
    require_launches(f"the power spectrogram of {name}", counts, ["power_spectrogram"])
    require_route(f"the power spectrogram of {name}", counts, "power_spectrogram", "fft")
    print(f"  {name}: {n_params} parameters ({n_params / 1e6:.2f}M), from CUDA seed {P17_SEED + 10}")
    out = {"params": n_params, "launches": {n: c for n, c in counts.items() if c}}
    logp = model(x)
    if tuple(logp.shape) != (DS_B, x.shape[2], n_class) or not bool(torch.isfinite(logp).all()):
        raise AssertionError(f"{name}: log-probabilities {tuple(logp.shape)} or not finite")
    flops = deepspeech_flops(DS_B * x.shape[2], n_feature, DS_HIDDEN, n_class)
    out["forward"] = time_batch(f"{name} forward", lambda: model(x), card, DS_B * DS_SECONDS, flops, PEAK_FP32_PER_S)

    def one():
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = ctc_loss(model(x), tgt, frames, tgt_lens, blank=0, reduction="mean")
            loss.backward()
        return loss.detach()

    out["train"] = time_train_step(f"{name} forward, ctc_loss and backward", one, DS_B * DS_SECONDS, card,
                                   helper_ab=True)
    check_finite_step(name, out["train"]["losses"][-1], dict(model.named_parameters()))
    out["ctc_loss"] = ctc_share("forward and backward", one, out["train"]["profile"], logp.detach(), tgt, frames,
                                tgt_lens, card)
    del model, x, logp
    torch.cuda.empty_cache()

    # the card against the CPU at B=2 x 2 s
    model = make(P17_SEED + 13)
    wav2, len2, tgt2, tl2 = transcript_batch(dev, DS_CMP_B, DS_CMP_S, DS_CMP_S, P17_SEED + 14)
    x2, fr2 = features(spec, wav2, len2)
    ref_x, ref_fr = features(copy.deepcopy(spec).cpu(), wav2.cpu(), len2.cpu())
    out["features_err"] = check_close("DeepSpeech's power spectrogram (K2) vs the CPU, B=2", x2.cpu(), ref_x,
                                      5e-4 * float(ref_x.abs().max()), 0.0)
    check_equal("DeepSpeech frame counts vs the CPU", fr2.cpu(), ref_fr)

    def loss_of(step, batch):
        return ctc_loss(step.model(batch[0]), *batch[1:], blank=0, reduction="mean")

    out["cpu"] = compare_with_cpu_f32_f64(f"DeepSpeech forward and ctc_loss, B={DS_CMP_B} x {DS_CMP_S} s", model,
                                          GradsOnly, (x2, tgt2, fr2, tl2), loss_of, "fc1.fc.bias")
    out["grads_tf32"] = check_grads_tf32(f"DeepSpeech, B={DS_CMP_B}",
                                         lambda: loss_of(GradsOnly(model), (x2, tgt2, fr2, tl2)),
                                         dict(model.named_parameters()))
    del model
    torch.cuda.empty_cache()
    return out


def run_conv_tasnet(recipe, dev, card: str) -> dict:
    """Phase 17 (c): the Conv-TasNet separation step at full width (``conv_tasnet_base(2)``, weights drawn as
    flax's ``init`` draws from CUDA seed 240), f32: mixture -> encoder -> 3 x 8 blocks -> masks -> the transposed
    decoder -> permutation-invariant negative Si-SNR -> backward -> clip -> Adam, on the recipe's synthetic
    sources, 8 x 3 s at 8 kHz.  Timed, profiled, its peak memory and its operations (``step_flops``) against the
    FP32 peak; at B=2 x 0.5 s the loss and every gradient against the CPU in float64 and float32, and the gradients
    with cuDNN's TF32 on in the backward (the decoder's among them); the ``--overfit`` gate."""
    import torch

    model = recipe.make_model(False, TN_SOURCES, dev, torch.Generator(device=dev).manual_seed(P17_SEED + 20))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  conv_tasnet_base({TN_SOURCES}): {n_params} parameters ({n_params / 1e6:.2f}M), from CUDA seed "
          f"{P17_SEED + 20}")
    if n_params != TN_PARAMS:
        raise AssertionError(f"conv_tasnet_base({TN_SOURCES}) has {n_params} parameters, not the JAX model's "
                             f"{TN_PARAMS}")
    sources = torch.as_tensor(next(iter(recipe.SyntheticMixtures(TN_B, TN_SOURCES, TN_SECONDS, P17_SEED + 21))),
                              device=dev)
    name = f"Conv-TasNet separation step, f32, B={TN_B} x {TN_SECONDS:g} s at {TN_SR} Hz, {TN_SOURCES} sources"
    step = recipe.TrainStep(model.train())

    def one():
        with torch.enable_grad():
            return step(sources)

    reset_kernel_counts()
    first = one()
    torch.cuda.synchronize()
    out = {"params": n_params, "launches": {n: c for n, c in kernel_counts().items() if c},
           "first_loss": float(first)}
    print(f"  launches of the port's kernels in one {name}: {out['launches']} (no TPU kernel is on this path)")
    check_finite_step(name, first, step.params)
    out.update(time_train_step(name, one, TN_B * TN_SECONDS, card, helper_ab=True))
    flops = step_flops(step, (sources,))
    out.update(model_tflop=flops / 1e12, share_of_fp32_peak=flops / (out["ms"] / 1e3) / PEAK_FP32_PER_S)
    print(f"  {name}: forward and backward {out['model_tflop']:.3f} TFLOP (step_flops), "
          f"{out['share_of_fp32_peak']:.3f} of the {PEAK_FP32_PER_S / 1e12:g} TFLOP/s FP32 peak on {card}")
    del step
    torch.cuda.empty_cache()

    # the card against the CPU at B=2 x 0.5 s
    model = recipe.make_model(False, TN_SOURCES, dev, torch.Generator(device=dev).manual_seed(P17_SEED + 22))
    src2 = torch.as_tensor(next(iter(recipe.SyntheticMixtures(TN_CMP_B, TN_SOURCES, TN_CMP_S, P17_SEED + 23))),
                           device=dev)
    out["cpu"] = compare_with_cpu_f32_f64(f"Conv-TasNet step, B={TN_CMP_B} x {TN_CMP_S:g} s", model, recipe.TrainStep,
                                          (src2,), lambda s, b: s.loss(*b), "encoder.weight")
    out["grads_tf32"] = check_grads_tf32(f"Conv-TasNet (its transposed decoder included), B={TN_CMP_B}",
                                         lambda: recipe.pit_neg_si_snr(model(recipe.mixture_of(src2)), src2),
                                         dict(model.named_parameters()))
    del model
    torch.cuda.empty_cache()
    out.update(run_overfit_gate("Conv-TasNet", recipe, TN_OVERFIT, card))
    return out


def run_tf32_checks(conformer_recipe, dev, card: str) -> dict:
    """Phase 17 (d): the TF32 check of ``check_grads_tf32`` on the port's other users of ``utils.precision``:
    ``wav2vec2_base``'s feature extractor and positional convolution at phase 14's batch (8 clips of 10-12 s, f32),
    one Conformer layer of the Conformer RNN-T recipe at phase 15's batch (16 clips of 5-10 s), ``convolve`` (64
    taps) and ``resample`` (16 -> 8 kHz) on 1,024 rows of phase 10's effects chain, and ``exact_matmul`` on the
    Wav2Letter recipe's DCT product (cuBLAS's flag)."""
    import torch

    import audio_tpu_torch.functional as F
    from audio_tpu_torch.models import wav2vec2_base
    from audio_tpu_torch.transforms import MelSpectrogram
    from audio_tpu_torch.utils.precision import exact_matmul

    out = {}
    model = wav2vec2_base(device=dev, generator=torch.Generator(device=dev).manual_seed(P17_SEED + 30)).eval()
    wav, lengths = SSLCase("wav2vec2", None, dev, 0).batch(SSL_TRAIN_B, SSL_TRAIN_MIN_S, SSL_TRAIN_MAX_S,
                                                            SSL_LENGTH_SEED)
    enc = model.encoder

    def w2v_loss():
        x, _ = model.feature_extractor(wav, lengths)
        return enc.transformer.pos_conv_embed(enc.feature_projection(x)).square().mean()

    out["wav2vec2"] = check_grads_tf32(
        f"wav2vec2_base's feature extractor and positional convolution, B={SSL_TRAIN_B} x {SSL_TRAIN_MIN_S}-"
        f"{SSL_TRAIN_MAX_S} s", w2v_loss, {n: p for n, p in model.named_parameters()
                                           if n.startswith(("feature_extractor.", "encoder.transformer.pos_conv"))})
    del model, wav
    torch.cuda.empty_cache()

    layer = conformer_recipe.ConformerRNNT(CF_V, conformer_layers=1, device=dev,
                                           generator=torch.Generator(device=dev).manual_seed(P17_SEED + 31)).eval()
    melspec = conformer_recipe.MelSpectrogram(sample_rate=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS, power=2.0,
                                              device=dev)
    wav, lengths, _, _ = conformer_step_data(dev, CF_TRAIN_B, CF_MAX_S, CF_MIN_S, CF_U, CF_V, CF_SEED + 1)
    feats, feat_lens = conformer_recipe.featurize(melspec, wav, lengths, layer.time_reduction_stride, train=False)
    out["conformer"] = check_grads_tf32(
        f"one Conformer layer of the Conformer RNN-T recipe, B={CF_TRAIN_B} x {CF_MIN_S}-{CF_MAX_S} s",
        lambda: layer.transcribe(feats, feat_lens)[0].square().mean(),
        {n: p for n, p in layer.named_parameters() if n.startswith("conformer.")})
    del layer, wav, feats
    torch.cuda.empty_cache()

    rows = torch.as_tensor(np.random.default_rng(30).standard_normal((1024, T)).astype(np.float32) * 0.3,
                           device=dev).requires_grad_()
    fir = (torch.randn((1, 64), generator=torch.Generator(device=dev).manual_seed(52), device=dev) / 8).requires_grad_()
    out["convolve"] = check_grads_tf32(f"convolve, 64 taps, on phase 10's first 1024 rows of {T}",
                                       lambda: F.convolve(rows, fir).square().mean(), {"rows": rows, "taps": fir})
    out["resample"] = check_grads_tf32(f"resample 16 -> 8 kHz on phase 10's first 1024 rows of {T}",
                                       lambda: F.resample(rows, SR, SR // 2).square().mean(), {"rows": rows})
    del rows

    wav, _, _, _ = transcript_batch(dev, W2L_B, W2L_SECONDS, W2L_MIN_S, P17_SEED + 1)
    mel = MelSpectrogram(sample_rate=SR, n_fft=N_FFT, hop_length=HOP, n_mels=40, device=dev)(wav).requires_grad_()
    dct = F.create_dct(13, 40, "ortho", device=dev).requires_grad_()
    out["exact_matmul"] = check_grads_tf32(
        f"exact_matmul, the Wav2Letter recipe's DCT product {tuple(mel.shape)} x {tuple(dct.shape)}",
        lambda: exact_matmul(mel.transpose(-1, -2), dct).square().mean(), {"mel": mel, "dct": dct}, flag="cublas")
    return out


# ------------------------------------------------------------------ phase 18: Hybrid Demucs and SQUIM
HD_SOURCES = ["drums", "bass", "other", "vocals"]
HD_SR, HD_SECONDS, HD_SEGMENT, HD_OVERLAP = 44100, 30, 10.0, 0.1  # the torchaudio tutorial's segment and overlap
HD_CMP_SECONDS = 2  # the card against the CPU on one segment of this many seconds
HD_PARAMS = {"high": 83_639_368, "medium": 78_908_488, "low": 20_040_296}  # four sources (tests/test_torch_hdemucs.py)
HD_RATES = {"high": 44100, "medium": 16000, "low": 8000}  # torchaudio's sample rates for each plan
SQ_B, SQ_SECONDS, SQ_REF_SECONDS, SQ_SR, SQ_SNR_DB = 8, 4, 3, 16000, 3.0  # the SQUIM tutorial's 3 dB of noise
SQ_PARAMS = {"objective": 7_387_658, "subjective": 94_395_942}
P18_SEED = 250  # the CUDA and numpy seeds of phase 18 are 250-269
P18_F32_TOL, P18_F64_TOL = 1e-4, 1e-9  # of each output's peak


def music_mixture(dev, b: int, seconds: float, sr: int, seed: int):
    """``b`` stereo mixtures of ``seconds`` at ``sr`` made on the device: a bass line, a chord, a voice-like tone
    with vibrato and decaying noise bursts twice a second, panned apart (float32, (b, 2, n))."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    n = int(seconds * sr)
    t = torch.arange(n, device=dev, dtype=torch.float64) / sr
    shift = torch.rand((b, 1), generator=g, device=dev, dtype=torch.float64)
    bass = 0.4 * torch.sin(2 * math.pi * (55 + 55 * shift) * t)
    chord = sum(0.15 * torch.sin(2 * math.pi * f * (1 + 0.1 * shift) * t) for f in (220.0, 277.18, 329.63))
    voice = 0.3 * torch.sin(2 * math.pi * (440 * (1 + 0.2 * shift)) * t + 3 * torch.sin(2 * math.pi * 5 * t))
    drums = torch.exp(-30 * ((2 * t) % 1)) * torch.randn((b, n), generator=g, device=dev, dtype=torch.float64) * 0.5
    left, right = bass + chord + 0.8 * voice + drums, bass + 0.7 * chord + voice + drums
    return torch.stack([left, right], dim=1).float()


def check_against_cpu(name: str, run, model, inputs: tuple) -> dict:
    """``run(model, *inputs)`` (a tensor or a list of them) on the card against a copy of ``model`` on the CPU, in
    float64 on both sides (within P18_F64_TOL of each output's peak) and in float32 (P18_F32_TOL), the floating
    inputs in that type (integer inputs, token ids, as they are); the errors relative to each output's peak."""
    import torch

    out = {}
    for dtype, tol in ((torch.float64, P18_F64_TOL), (torch.float32, P18_F32_TOL)):
        card_model = copy.deepcopy(model).to(dtype)
        got = run(card_model, *(x.to(dtype) if x.is_floating_point() else x for x in inputs))
        del card_model
        got = [g.cpu() for g in (got if isinstance(got, (list, tuple)) else [got])]
        cpu_model = copy.deepcopy(model).cpu().to(dtype)
        ref = run(cpu_model, *(x.cpu().to(dtype) if x.is_floating_point() else x.cpu() for x in inputs))
        del cpu_model
        ref = ref if isinstance(ref, (list, tuple)) else [ref]
        errs = []
        for i, (a, r) in enumerate(zip(got, ref)):
            peak = float(r.abs().max())
            errs.append(check_close(f"{name}, {str(dtype)[6:]}, output {i} against the CPU", a, r, tol * peak, 0.0,
                                    quiet=True) / peak)
        print(f"  {name} against the CPU: {str(dtype)[6:]} within {max(errs):.3e} of each output's peak at worst "
              f"over {len(errs)} output(s) (limit {tol:g})")
        out[str(dtype)[6:]] = errs
    return out


def check_forward_tf32(name: str, fn) -> dict:
    """``fn()`` (a list of f32 tensors) with cuDNN's and cuBLAS's TF32 on (PyTorch's default for cuDNN) against two
    runs with both off: within the two runs' own spread of each other, elementwise (the same bits where they
    agree)."""
    import torch

    off, again = fn(), fn()
    with tf32_on("cudnn"), tf32_on("cublas"):
        on = fn()
    spread = max(float((a - o).abs().max()) for a, o in zip(again, off))
    err = max(float((t - o).abs().max()) for t, o in zip(on, off))
    moved = sum(int(((t - o).abs() > (a - o).abs()).sum()) for t, o, a in zip(on, off, again))
    print(f"  {name}: with cuDNN's and cuBLAS's TF32 on, max |difference| {err:.3e} from the run with them off (two "
          f"runs with them off: {spread:.3e}); {moved} entries outside the two runs' spread (limit 0)")
    if moved:
        raise AssertionError(f"{name}: TF32 changed the float32 outputs")
    return {"tf32_max_abs_diff": err, "repeat_max_abs_diff": spread}


def run_hdemucs(dev, card: str) -> dict:
    """Phase 18 (a): music separation at full width.  First the port's ``istft`` at n_fft 4096 on complex64 bins
    with imaginary DC and Nyquist parts against the CPU (1e-5 of the peak; the fault before PR 19's repair printed
    beside, here and on ``hdemucs_high``'s float32 output).  ``HDEMUCS_HIGH_MUSDB_PLUS.get_model``
    on a seeded ``state_dict`` (CUDA seed 250: ``hdemucs_high``, four sources, stereo, 44.1 kHz), the tutorial's
    ``separate_sources`` (``examples/tutorials/hybrid_demucs_tutorial_torch.py``: segments of 10 s, overlap 0.1 s)
    on a 30 s synthetic mixture in float32: ms a 10 s segment, the real-time factor, launches a segment and the idle
    share; one 2 s segment against the CPU in float64 and float32; ``hdemucs_low`` and ``hdemucs_medium`` likewise
    at 2 s of 8 and 16 kHz (medium alone takes the ``nfft == 2048`` empty time layer: kernel 4, stride 2); (c) the
    10 s segment with TF32 on."""
    import torch

    from audio_tpu_torch import models, pipelines

    from unittest import mock

    from audio_tpu_torch._internal.windows import hann_window
    from audio_tpu_torch.functional import _stft
    from audio_tpu_torch.functional._stft import istft

    def before_repair():
        """``istft`` as it was before PR 19: the DC and Nyquist bins handed to cuFFT with their imaginary parts."""
        return mock.patch.object(_stft, "_real_edge_bins", lambda frames, n_fft: frames)

    # the inverse STFT of HDemucs's frequency branch (n_fft 4096) on bins whose DC and Nyquist bins carry imaginary
    # parts, as a network's output does: the port's istft drops them, as numpy's irfft (cuFFT's complex64 C2R of
    # 4096 points reads the DC bin's)
    bins = torch.randn((8, 2049, 87), generator=torch.Generator(device=dev).manual_seed(P18_SEED + 6), device=dev,
                       dtype=torch.complex64)
    window = hann_window(4096, device=dev)
    got = istft(bins, 4096, 1024, 4096, window, center=True, normalized=True, length=1024 * 86)
    ref = istft(bins.cpu(), 4096, 1024, 4096, window.cpu(), center=True, normalized=True, length=1024 * 86)
    peak = float(ref.abs().max())
    out = {"istft_4096_err_of_peak": check_close("istft, n_fft 4096, complex64 bins with imaginary DC and Nyquist "
                                                 "parts, against the CPU", got.cpu(), ref, 1e-5 * peak, 0.0) / peak}
    with before_repair():
        before = istft(bins, 4096, 1024, 4096, window, center=True, normalized=True, length=1024 * 86)
    out["istft_4096_before_repair_err_of_peak"] = float((before.cpu() - ref).abs().max()) / peak
    print(f"  the same istft before the repair (cuFFT's complex64 C2R given the imaginary parts): "
          f"{out['istft_4096_before_repair_err_of_peak']:.3e} of the peak off the CPU (printed, not gated)")
    tutorial = load_example("hybrid_demucs_tutorial_torch", "tutorials", "hybrid_demucs_tutorial_torch.py")
    seeded = models.hdemucs_high(HD_SOURCES, device=dev, generator=torch.Generator(device=dev).manual_seed(P18_SEED))
    state = {k: v.detach().clone() for k, v in seeded.state_dict().items()}
    del seeded
    model = pipelines.HDEMUCS_HIGH_MUSDB_PLUS.get_model(dl_kwargs={"state_dict": state}, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  HDEMUCS_HIGH_MUSDB_PLUS on a state_dict from CUDA seed {P18_SEED}: hdemucs_high, {len(HD_SOURCES)} "
          f"sources, {n_params} parameters ({n_params / 1e6:.2f}M), nfft {model.nfft}, depth {model.depth}")
    if n_params != HD_PARAMS["high"] or pipelines.HDEMUCS_HIGH_MUSDB_PLUS.sample_rate != HD_SR:
        raise AssertionError(f"hdemucs_high has {n_params} parameters, not {HD_PARAMS['high']}")
    mix = music_mixture(dev, 1, HD_SECONDS, HD_SR, P18_SEED + 1)
    ref_std = mix.std()
    seg = mix[:, :, : int(HD_SEGMENT * HD_SR)] / ref_std

    def separate():
        return tutorial.separate_sources(model, mix / ref_std, segment=HD_SEGMENT, overlap=HD_OVERLAP,
                                         sample_rate=HD_SR) * ref_std

    sources = separate()
    torch.cuda.synchronize()
    shape = (1, len(HD_SOURCES), 2, HD_SECONDS * HD_SR)
    if tuple(sources.shape) != shape or not bool(torch.isfinite(sources).all()):
        raise AssertionError(f"separate_sources: shape {tuple(sources.shape)} (want {shape}) or not finite")
    if not bool((sources[..., 0] == 0).all()):
        raise AssertionError("separate_sources: sample 0 is not 0 (the first chunk's fade-in starts at 0)")
    rms = [float(sources[0, i].pow(2).mean().sqrt()) for i in range(len(HD_SOURCES))]
    print(f"  separate_sources on {HD_SECONDS} s of stereo at {HD_SR} Hz: {shape}, finite, sample 0 of every source "
          f"0 (the fade-in's first weight), source RMS {', '.join(f'{r:.4f}' for r in rms)}")
    out.update(params=n_params, source_rms=rms)
    seg_ms, seg_runs = median_call_ms(lambda: model(seg))
    sep_ms, sep_runs = median_call_ms(separate, reps=3)
    n_segments = math.ceil((HD_SECONDS * HD_SR - int(HD_OVERLAP * HD_SR)) / int((HD_SEGMENT - HD_OVERLAP) * HD_SR))
    out.update(segment_ms=seg_ms, segment_runs_ms=seg_runs, separate_ms=sep_ms, separate_runs_ms=sep_runs,
               segments=n_segments, rtf=sep_ms / 1e3 / HD_SECONDS)
    print(f"  hdemucs_high on one {HD_SEGMENT:g} s segment: {seg_ms:.3f} ms (runs "
          f"{', '.join(f'{r:.3f}' for r in seg_runs)}); separate_sources over {HD_SECONDS} s ({n_segments} segments): "
          f"{sep_ms:.3f} ms, real-time factor {out['rtf']:.5f}, on {card}")
    _, out["segment_peak_gb"] = peak_call(lambda: model(seg))
    out["profile"] = profile_batch(f"hdemucs_high {HD_SEGMENT:g} s segment", lambda: model(seg))
    out["tf32"] = check_forward_tf32(f"hdemucs_high on a {HD_SEGMENT:g} s segment", lambda: [model(seg)])
    n = HD_CMP_SECONDS * HD_SR
    out["cpu"] = check_against_cpu(f"hdemucs_high, {HD_CMP_SECONDS} s at {HD_SR} Hz", lambda m, x: m(x), model,
                                   (seg[:, :, :n],))
    with before_repair():
        before = model(seg[:, :, :n]).cpu()
    ref = copy.deepcopy(model).cpu()(seg[:, :, :n].cpu())
    out["before_repair_f32_err_of_peak"] = float((before - ref).abs().max() / ref.abs().max())
    print(f"  hdemucs_high, {HD_CMP_SECONDS} s, float32, with istft as before the repair: "
          f"{out['before_repair_f32_err_of_peak']:.3e} of the output's peak off the CPU (printed, not gated)")
    del model, sources
    torch.cuda.empty_cache()

    for i, plan in enumerate(("low", "medium")):
        sr = HD_RATES[plan]
        small = getattr(models, f"hdemucs_{plan}")(HD_SOURCES, device=dev,
                                                   generator=torch.Generator(device=dev).manual_seed(P18_SEED + 2 + i))
        small.eval()
        n_params = sum(p.numel() for p in small.parameters())
        merge = next(layer for layer in small.time_encoder if layer.empty)
        print(f"  hdemucs_{plan}: {n_params} parameters, nfft {small.nfft}, depth {small.depth}, its empty time layer "
              f"kernel {merge.kernel_size} stride {merge.stride}")
        if n_params != HD_PARAMS[plan] or (merge.kernel_size, merge.stride) != ((4, 2) if plan == "medium" else (8, 4)):
            raise AssertionError(f"hdemucs_{plan}: {n_params} parameters or the empty time layer's plan is off")
        clip = music_mixture(dev, 1, HD_CMP_SECONDS, sr, P18_SEED + 4 + i)
        clip = clip / clip.std()
        out[plan] = check_against_cpu(f"hdemucs_{plan}, {HD_CMP_SECONDS} s at {sr} Hz", lambda m, x: m(x), small,
                                      (clip,))
        del small
    torch.cuda.empty_cache()
    return out


def run_squim(dev, card: str) -> dict:
    """Phase 18 (b): speech-quality scoring.  ``SQUIM_OBJECTIVE`` and ``SQUIM_SUBJECTIVE`` on seeded ``state_dict``s
    (CUDA seeds 260 and 261) score 8 voiced clips of 4 s at 16 kHz, clean and with white noise at 3 dB
    (``F.add_noise``, as the SQUIM tutorial), MOS against non-matching references of 3 s (tiled by the model):
    ms a batch and the idle share; each score against the CPU in float64 and float32; (c) both with TF32 on."""
    import torch

    import audio_tpu_torch.functional as F
    from audio_tpu_torch import models, pipelines

    out = {}
    bundles = {}
    for i, (kind, bundle) in enumerate((("objective", pipelines.SQUIM_OBJECTIVE),
                                        ("subjective", pipelines.SQUIM_SUBJECTIVE))):
        g = torch.Generator(device=dev).manual_seed(P18_SEED + 10 + i)
        seeded = getattr(models, f"squim_{kind}_base")(device=dev, generator=g)
        state = {k: v.detach().clone() for k, v in seeded.state_dict().items()}
        del seeded
        bundles[kind] = bundle.get_model(dl_kwargs={"state_dict": state}, device=dev)
        n_params = sum(p.numel() for p in bundles[kind].parameters())
        print(f"  SQUIM_{kind.upper()} on a state_dict from CUDA seed {P18_SEED + 10 + i}: {n_params} parameters, "
              f"{bundle.sample_rate} Hz")
        if n_params != SQ_PARAMS[kind] or bundle.sample_rate != SQ_SR:
            raise AssertionError(f"squim_{kind}_base has {n_params} parameters, not {SQ_PARAMS[kind]}")
        out[f"{kind}_params"] = n_params
    objective, subjective = bundles["objective"], bundles["subjective"]
    clean = voiced_rows(dev, SQ_B, SQ_SECONDS * SQ_SR, P18_SEED + 12)
    noise = torch.randn(clean.shape, generator=torch.Generator(device=dev).manual_seed(P18_SEED + 13), device=dev)
    noisy = F.add_noise(clean, noise, torch.full((SQ_B,), SQ_SNR_DB, device=dev))
    reference = voiced_rows(dev, SQ_B, SQ_REF_SECONDS * SQ_SR, P18_SEED + 14)

    scores = {}
    for label, wav in (("clean", clean), ("noisy", noisy)):
        stoi, pesq, si_sdr = objective(wav)
        mos = subjective(wav, reference)
        scores[label] = {"stoi": stoi.tolist(), "pesq": pesq.tolist(), "si_sdr": si_sdr.tolist(), "mos": mos.tolist()}
        for name, s in scores[label].items():
            if len(s) != SQ_B or not all(math.isfinite(v) for v in s):
                raise AssertionError(f"SQUIM {label} {name}: {s}")
        print(f"  {label} ({SQ_B} x {SQ_SECONDS} s): STOI {np.mean(scores[label]['stoi']):.4f}, PESQ "
              f"{np.mean(scores[label]['pesq']):.4f}, SI-SDR {np.mean(scores[label]['si_sdr']):.4f} dB, MOS "
              f"{np.mean(scores[label]['mos']):.4f} (batch means; random weights)")
    out["scores"] = scores
    for kind, fn in (("objective", lambda: objective(noisy)), ("subjective", lambda: subjective(noisy, reference))):
        ms, runs = median_call_ms(fn)
        out[kind] = {"ms": ms, "runs_ms": runs, "audio_s_per_s": SQ_B * SQ_SECONDS / (ms / 1e3)}
        print(f"  SQUIM {kind} on {SQ_B} x {SQ_SECONDS} s: {ms:.3f} ms a batch (runs "
              f"{', '.join(f'{r:.3f}' for r in runs)}), {out[kind]['audio_s_per_s']:.1f} s of audio a second on {card}")
        out[kind]["profile"] = profile_batch(f"SQUIM {kind} batch", fn)
    out["tf32"] = check_forward_tf32(f"SQUIM objective and subjective on {SQ_B} x {SQ_SECONDS} s",
                                     lambda: [*objective(noisy), subjective(noisy, reference)])
    out["cpu_objective"] = check_against_cpu(f"SQUIM objective (STOI, PESQ, SI-SDR), {SQ_B} x {SQ_SECONDS} s",
                                             lambda m, x: m(x), objective, (noisy,))
    out["cpu_subjective"] = check_against_cpu(f"SQUIM subjective (MOS), {SQ_B} x {SQ_SECONDS} s",
                                              lambda m, x, r: m(x, r), subjective, (noisy, reference))
    del objective, subjective, bundles
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 19: text-to-speech
# the two character bundles at full width (audio_tpu_torch/pipelines/_tts.py: Tacotron2(38 symbols) and WaveRNN at
# hop 275), weights from CUDA seeds; the recipes at full width (examples/tts/*/train_torch.py): Tacotron2 on B=8 with
# up to the LJSpeech loader's 128 tokens and 512 frames, WaveRNN at B=8 x 24 frames at hop 200
P19_SEED = 270  # the CUDA and numpy seeds of phase 19 are 270-289
TTS_TEXTS = ["Hello world! Text to speech, on the card.", "The quick brown fox jumps over the lazy dog.",
             "Printing, in the only sense with which we are at present concerned, differs from most arts.",
             "Hi."]
TTS_PARAMS = {"tacotron2": 28_136_833, "wavernn": 4_349_613, "wavernn_recipe": 4_349_607}  # the meta device's counts
TTS_VOCODER_FRAMES = 40  # the WaveRNN vocoder's frames of each mel: 11,000 samples at hop 275
TTS_PROFILED_FRAMES = 4  # the WaveRNN vocoder's profile and TF32 check: 1,100 samples
TTS_PROFILED_STEPS = 250  # Tacotron2.infer's profile, TF32 check and second bundle: the loop's steps are alike
TACO_B, TACO_MAX_TEXT, TACO_MAX_FRAMES = 8, 128, 512
WRNN_B, WRNN_FRAMES = 8, 24
TTS_CMP_STEPS = 64  # Tacotron2.infer against the CPU in float64
TTS_GATE_BIAS = -1.0  # the seeded models' gate bias: torch's default range fires every gate at the first step
# the recipes' memorization gates with the arguments of the JAX package's slow tests of them
TACO_OVERFIT = ["--synthetic", "--tiny", "--steps", "500", "--global-batch", "8", "--overfit", "--learning-rate", "3e-3"]
WRNN_OVERFIT = ["--synthetic", "--tiny", "--steps", "400", "--global-batch", "8", "--overfit", "--learning-rate", "3e-3"]


def require_no_launch(what: str) -> None:
    """No kernel of K1-K9 launched since the counters were last set to 0."""
    counts = {n: c for n, c in kernel_counts().items() if c}
    if counts:
        raise AssertionError(f"{what} launched the port's kernels: {counts}")


def run_tts_serving(dev, card: str) -> dict:
    """Phase 19 (a): ``TACOTRON2_WAVERNN_CHAR_LJSPEECH`` and ``TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH`` at full width on
    seeded ``state_dict``s (CUDA seeds 270 and 271; the gate's bias at ``TTS_GATE_BIAS``): the character processor on
    4 sentences, ``Tacotron2.infer`` over ``decoder_max_step`` (2,000) steps in float32 with the bundles' prenet
    dropout (no host read inside: run under ``set_sync_debug_mode("error")``), the Griffin-Lim vocoder on the whole
    mel, the WaveRNN vocoder on its first 40 frames (11,000 samples a row); ms, launches and idle shares; each with TF32
    on against two runs with it off (the profile, the TF32 check and the second bundle's model on ``infer``'s first
    250 steps, the WaveRNN vocoder's on 4 frames)."""
    import torch

    from audio_tpu_torch import models, pipelines
    from audio_tpu_torch.pipelines import _tts

    wb, gb = pipelines.TACOTRON2_WAVERNN_CHAR_LJSPEECH, pipelines.TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH
    seeded = models.Tacotron2(**_tts._get_taco_params(38), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(P19_SEED))
    taco_state = {k: v.detach().clone() for k, v in seeded.state_dict().items()}
    taco_state["decoder.gate_layer.bias"].fill_(TTS_GATE_BIAS)
    seeded = models.WaveRNN(**_tts._get_wrnn_params(), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(P19_SEED + 1))
    wrnn_state = {k: v.detach().clone() for k, v in seeded.state_dict().items()}
    del seeded
    tacotron2 = wb.get_tacotron2(dl_kwargs={"state_dict": taco_state}, device=dev)
    vocoder = wb.get_vocoder(dl_kwargs={"state_dict": wrnn_state}, device=dev)
    griffin_lim = gb.get_vocoder(device=dev)
    out = {"tacotron2_params": sum(p.numel() for p in tacotron2.parameters()),
           "wavernn_params": sum(p.numel() for p in vocoder._model.parameters())}
    print(f"  TACOTRON2_WAVERNN_CHAR_LJSPEECH on state_dicts from CUDA seeds {P19_SEED} and {P19_SEED + 1}: Tacotron2 "
          f"{out['tacotron2_params']} parameters, WaveRNN {out['wavernn_params']} (hop {vocoder._model.hop_length}, "
          f"{vocoder._model.n_classes} classes), {vocoder.sample_rate} Hz")
    if (out["tacotron2_params"], out["wavernn_params"]) != (TTS_PARAMS["tacotron2"], TTS_PARAMS["wavernn"]):
        raise AssertionError(f"the bundles' models have {out['tacotron2_params']} and {out['wavernn_params']} "
                             f"parameters, not {TTS_PARAMS['tacotron2']} and {TTS_PARAMS['wavernn']}")
    tokens, lengths = wb.get_text_processor()(TTS_TEXTS)
    tokens, lengths = tokens.to(dev), lengths.to(dev)
    steps = tacotron2.decoder_max_step

    def synth():
        return tacotron2.infer(tokens, lengths)

    mel, out_len, aligns = no_host_sync(synth)()
    torch.cuda.synchronize()
    b, n_tokens = tokens.shape
    if (tuple(mel.shape) != (b, 80, steps) or tuple(aligns.shape) != (b, steps, n_tokens)
            or not bool(torch.isfinite(mel).all()) or not bool(((out_len >= 1) & (out_len <= steps)).all())):
        raise AssertionError(f"Tacotron2.infer: mel {tuple(mel.shape)}, alignments {tuple(aligns.shape)}, out_len "
                             f"{out_len.tolist()}")
    n_frames = int(out_len.max())
    if not bool((mel[..., n_frames:] == 0).all()):
        raise AssertionError("Tacotron2.infer: frames past max(out_len) are not zero")
    ms, runs, _ = timed_steps(synth, 0, 2)  # warm from the call above

    def synth_short():  # the profile, the second bundle's model and TF32 over the first TTS_PROFILED_STEPS steps
        return tacotron2.infer(tokens, lengths, max_steps=TTS_PROFILED_STEPS)

    gb_mel = gb.get_tacotron2(dl_kwargs={"state_dict": taco_state}, device=dev).infer(
        tokens, lengths, max_steps=TTS_PROFILED_STEPS)[0]
    if not torch.equal(gb_mel, synth_short()[0]):
        raise AssertionError("the two character bundles' Tacotron2 on one state_dict gave different mels")
    prof = profile_batch(f"Tacotron2.infer (B={b}, {TTS_PROFILED_STEPS} steps)", synth_short)
    per_step = prof["launches"] / TTS_PROFILED_STEPS
    out["tacotron2"] = {"ms": ms, "runs_ms": runs, "steps": steps, "out_len": out_len.tolist(), "tokens": n_tokens,
                        "launches_per_step": per_step, "profile": prof}
    print(f"  Tacotron2.infer on {b} sentences ({lengths.tolist()} characters): {ms:.3f} ms a batch (runs "
          f"{', '.join(f'{r:.3f}' for r in runs)}) over {steps} steps, {ms / steps:.4f} ms a step, out_len "
          f"{out_len.tolist()}; {per_step:.1f} launches a step and idle share {prof['idle_share']:.3f} over "
          f"{TTS_PROFILED_STEPS} steps, on {card}; no host read inside (set_sync_debug_mode('error'))")

    wav_gl, _ = griffin_lim(mel, out_len)
    if tuple(wav_gl.shape) != (b, (steps - 1) * 256) or not bool(torch.isfinite(wav_gl).all()):
        raise AssertionError(f"Griffin-Lim vocoder: {tuple(wav_gl.shape)} or not finite")
    gl_ms, gl_runs = median_call_ms(lambda: griffin_lim(mel, out_len), reps=3)
    out["griffin_lim"] = {"ms": gl_ms, "runs_ms": gl_runs,
                          "profile": profile_batch("Griffin-Lim vocoder", lambda: griffin_lim(mel, out_len))}
    print(f"  Griffin-Lim vocoder (InverseMelScale, 32 iterations at n_fft 1024, hop 256) on ({b}, 80, {steps}): "
          f"{gl_ms:.3f} ms (runs {', '.join(f'{r:.3f}' for r in gl_runs)}), waveform {tuple(wav_gl.shape)} on {card}")

    mel40, short = mel[:, :, :TTS_VOCODER_FRAMES], mel[:, :, :TTS_PROFILED_FRAMES]
    no_host_sync(lambda: vocoder(short))()
    hop = vocoder._model.hop_length
    wav, wav_len = vocoder(mel40, torch.full((b,), TTS_VOCODER_FRAMES, device=dev))
    torch.cuda.synchronize()
    n = TTS_VOCODER_FRAMES * hop
    if (tuple(wav.shape) != (b, n) or wav_len.tolist() != [n] * b or not bool(torch.isfinite(wav).all())
            or float(wav.abs().max()) > 1.0):
        raise AssertionError(f"WaveRNN vocoder: {tuple(wav.shape)}, lengths {wav_len.tolist()}")
    wr_ms = timed_steps(lambda: vocoder(mel40), 0, 1)[0]
    prof = profile_batch(f"WaveRNN vocoder ({TTS_PROFILED_FRAMES} frames, {TTS_PROFILED_FRAMES * hop} samples)",
                         lambda: vocoder(short))
    out["wavernn"] = {"ms": wr_ms, "samples": n, "samples_per_s": b * n / (wr_ms / 1e3),
                      "launches_per_sample": prof["launches"] / (TTS_PROFILED_FRAMES * hop), "profile": prof}
    print(f"  WaveRNN vocoder on ({b}, 80, {TTS_VOCODER_FRAMES}): {wr_ms:.3f} ms for {n} samples a row, "
          f"{out['wavernn']['samples_per_s']:.1f} samples a second ({out['wavernn']['samples_per_s'] / 22050:.4f} "
          f"of real time), {out['wavernn']['launches_per_sample']:.1f} launches a sample, idle share "
          f"{prof['idle_share']:.3f} on {card}")
    out["tf32"] = {
        "tacotron2": check_forward_tf32(f"Tacotron2.infer (B={b}, {TTS_PROFILED_STEPS} steps)",
                                        lambda: list(synth_short())),
        "griffin_lim": check_forward_tf32("Griffin-Lim vocoder", lambda: [griffin_lim(mel, out_len)[0]]),
        "wavernn": check_forward_tf32(f"WaveRNN vocoder ({TTS_PROFILED_FRAMES} frames)",
                                      lambda: [vocoder(short)[0]])}
    del tacotron2, vocoder, griffin_lim
    torch.cuda.empty_cache()
    return out


def run_tts_against_cpu(dev) -> dict:
    """Phase 19 (b): full-width Tacotron2 (CUDA seed 272) teacher forced at B=2 on rows of 24 and 17 tokens and 32
    and 25 frames, against the CPU in float64 (1e-9 of each output's peak) and float32 (1e-4); its ``infer`` over 64
    steps in float64 with ``out_len`` equal; full-width WaveRNN (CUDA seed 273) ``forward`` at B=2 x 6 frames
    likewise, and its ``infer`` over two frames in float64 with both sides' samplers on the argmax, the samples
    equal."""
    from unittest import mock

    import torch

    import audio_tpu_torch.models.wavernn as wavernn_module
    from audio_tpu_torch import models
    from audio_tpu_torch.pipelines import _tts

    g = torch.Generator(device=dev).manual_seed(P19_SEED + 4)
    taco = models.Tacotron2(**_tts._get_taco_params(38), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(P19_SEED + 2)).eval()
    taco.decoder.gate_layer.bias.fill_(TTS_GATE_BIAS)
    tokens = torch.randint(1, 38, (2, 24), generator=g, device=dev)
    tok_lens = torch.tensor([24, 17], device=dev)
    tokens[1, 17:] = 0
    mel = torch.randn((2, 80, 32), generator=g, device=dev)
    mel_lens = torch.tensor([32, 25], device=dev)
    out = {"tacotron2_forward": check_against_cpu(
        "Tacotron2 teacher forced, B=2 (24 and 17 tokens, 32 and 25 frames)",
        lambda m, t, tl, x, xl: list(m(t, tl, x, xl, prenet_dropout=False)), taco, (tokens, tok_lens, mel, mel_lens))}
    got = copy.deepcopy(taco).double().infer(tokens, tok_lens, prenet_dropout=False, max_steps=TTS_CMP_STEPS)
    ref = copy.deepcopy(taco).cpu().double().infer(tokens.cpu(), tok_lens.cpu(), prenet_dropout=False,
                                                   max_steps=TTS_CMP_STEPS)
    if got[1].tolist() != ref[1].tolist():
        raise AssertionError(f"Tacotron2.infer: out_len {got[1].tolist()} on the card, {ref[1].tolist()} on the CPU")
    errs = []
    for name, a, r in (("mel", got[0], ref[0]), ("alignments", got[2], ref[2])):
        peak = float(r.abs().max())
        errs.append(check_close(f"Tacotron2.infer {name}, float64, against the CPU", a.cpu(), r,
                                P18_F64_TOL * peak, 0.0, quiet=True) / peak)
    out["tacotron2_infer"] = {"out_len": got[1].tolist(), "err_of_peak": errs}
    print(f"  Tacotron2.infer over {TTS_CMP_STEPS} steps against the CPU, float64: out_len {got[1].tolist()} on both, "
          f"mel and alignments within {max(errs):.3e} of their peaks (limit {P18_F64_TOL:g})")
    del taco
    wrnn = models.WaveRNN(**_tts._get_wrnn_params(), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(P19_SEED + 3)).eval()
    spec = torch.randn((2, 1, 80, 10), generator=g, device=dev)
    wav = torch.rand((2, 1, 6 * 275), generator=g, device=dev) * 2 - 1
    out["wavernn_forward"] = check_against_cpu("WaveRNN forward, B=2 x 6 frames", lambda m, w, s: m(w, s), wrnn,
                                               (wav, spec))
    argmax = lambda logits, generator: torch.argmax(logits, dim=-1)  # noqa: E731
    spec2 = torch.randn((2, 80, 2), generator=g, device=dev, dtype=torch.float64)
    with mock.patch.object(wavernn_module, "sample_categorical", argmax):
        got, _ = copy.deepcopy(wrnn).double().infer(spec2)
        ref, _ = copy.deepcopy(wrnn).cpu().double().infer(spec2.cpu())
    if not torch.equal(got.cpu(), ref):
        raise AssertionError(f"WaveRNN.infer on the argmax: {int((got.cpu() != ref).sum())} samples differ from the "
                             "CPU's")
    out["wavernn_infer_classes"] = len(torch.unique(ref))
    print(f"  WaveRNN.infer over 2 frames ({ref.shape[-1]} samples a row), float64, both samplers on the argmax: the "
          f"samples equal the CPU's ({out['wavernn_infer_classes']} distinct classes)")
    del wrnn
    torch.cuda.empty_cache()
    return out


def tts_step_grads_against_cpu(name: str, model, loss_fn, batch: tuple) -> dict:
    """``loss_fn(model, batch)`` and every gradient of a float64 copy of ``model`` on the card against one on the CPU:
    the loss within 1e-10, each gradient within 1e-9 of its peak."""
    import torch

    def run(m, dev_batch):
        with torch.enable_grad():
            loss = loss_fn(m, dev_batch)
            grads = torch.autograd.grad(loss, list(m.parameters()))
        return loss.detach().cpu(), [gr.cpu() for gr in grads]

    cast = lambda x, d: x.to(d).double() if x.is_floating_point() else x.to(d)  # noqa: E731
    card = next(model.parameters()).device
    got = run(copy.deepcopy(model).double(), tuple(cast(x, card) for x in batch))
    ref = run(copy.deepcopy(model).cpu().double(), tuple(cast(x, "cpu") for x in batch))
    loss_err = abs(float(got[0]) - float(ref[0])) / abs(float(ref[0]))
    if loss_err > 1e-10:
        raise AssertionError(f"{name}: loss {float(got[0])!r} on the card, {float(ref[0])!r} on the CPU")
    worst = 0.0
    for (pname, _), a, r in zip(model.named_parameters(), got[1], ref[1]):
        peak = max(float(r.abs().max()), 1e-30)
        worst = max(worst, check_close(f"{name}: gradient of {pname}, float64", a, r, 1e-9 * peak, 0.0,
                                       quiet=True) / peak)
    print(f"  {name} against the CPU in float64: loss within {loss_err:.3e} (limit 1e-10), {len(got[1])} gradients "
          f"within {worst:.3e} of their peaks (limit 1e-9)")
    return {"loss_rel_err": loss_err, "grad_err_of_peak": worst}


def time_tts_step(name: str, step, card: str, tf32_loss_fn, leaves: dict) -> dict:
    """ms a step (median of 2 after a warm-up), the peak memory of those steps, one profiled step, the f32 gradients of
    ``tf32_loss_fn`` with respect to ``leaves`` with cuDNN's and cuBLAS's TF32 on in the backward."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad():
        ms, runs, losses = timed_steps(step, 1, 2)
        peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
        prof = profile_batch(name, step)
    if not all(math.isfinite(float(v)) for v in losses):
        raise AssertionError(f"{name}: losses {losses}")
    print(f"  {name}: {ms:.3f} ms a step (runs {', '.join(f'{r:.3f}' for r in runs)}), peak {peak_gb:.3f} GB above "
          f"the model, {prof['launches']:g} launches, idle share {prof['idle_share']:.3f}, loss {float(losses[-1]):.4f} "
          f"on {card}")
    return {"ms": ms, "runs_ms": runs, "peak_gb": peak_gb, "profile": prof, "losses": [float(v) for v in losses],
            "tf32": check_grads_tf32(name, tf32_loss_fn, leaves, flag="both")}


def run_tts_train(dev, card: str) -> dict:
    """Phase 19 (c): the two recipes' train steps at full width.  Tacotron2 (38 symbols, CUDA seed 276, drawn as
    flax's ``init`` draws) at B=8: 64-128 tokens, log-mel targets of 384-512 frames built from voiced waveforms by the
    recipe's ``log_mel`` (``MelSpectrogram`` at 22,050 Hz, n_fft 1024, hop 256, power 1: K2) one clip at a time and
    collated, as the LJSpeech loader does; WaveRNN (the recipe's widths, CUDA seed 278) at B=8 x 24 frames of hop 200,
    crops and their log-mels by the recipe's ``crop`` (K2).  Each step's ms, launches, idle share, peak memory, its
    gradients with TF32 on, and at B=2 against the CPU in float64; both ``--overfit`` gates.  K2 launches while the
    targets are built and nowhere else."""
    import torch

    taco_recipe = load_example("tacotron2_train_torch", "tts", "tacotron2", "train_torch.py")
    wrnn_recipe = load_example("wavernn_train_torch", "tts", "wavernn", "train_torch.py")
    rng = np.random.default_rng(P19_SEED + 5)
    out = {}
    # Tacotron2's batch: the loader's caps at the longest row
    n_frames = rng.integers(TACO_MAX_FRAMES * 3 // 4, TACO_MAX_FRAMES + 1, TACO_B)
    n_frames[0] = TACO_MAX_FRAMES
    tok_lens = rng.integers(TACO_MAX_TEXT // 2, TACO_MAX_TEXT + 1, TACO_B)
    tok_lens[0] = TACO_MAX_TEXT
    texts = [rng.integers(1, 38, int(n)).tolist() for n in tok_lens]
    wavs = voiced_rows(dev, TACO_B, (TACO_MAX_FRAMES - 1) * taco_recipe.HOP, P19_SEED + 6)
    melspec = taco_recipe.make_melspec(dev)
    require_no_launch("phase 19 before the targets")
    mels = [taco_recipe.log_mel(melspec, wavs[i, : (int(f) - 1) * taco_recipe.HOP]).cpu().numpy()
            for i, f in enumerate(n_frames)]
    batch = taco_recipe.to_device(taco_recipe.collate(texts, mels), dev)
    counts = kernel_counts()
    if counts["power_spectrogram"] != TACO_B or counts["power_spectrogram_fft"] != TACO_B:
        raise AssertionError(f"Tacotron2's targets: K2 launches {counts['power_spectrogram']} (fft "
                             f"{counts['power_spectrogram_fft']}), not {TACO_B}, each on 'fft'")
    print(f"  Tacotron2 batch: {TACO_B} clips, {tok_lens.min()}-{tok_lens.max()} tokens, {n_frames.min()}-"
          f"{n_frames.max()} frames of log-mel ({TACO_B} K2 launches on 'fft', one a clip)")
    model = taco_recipe.make_model(False, 38, dev, generator=torch.Generator(device=dev).manual_seed(P19_SEED + 6))
    step = taco_recipe.TrainStep(model)
    stats = {n: b.clone() for n, b in model.named_buffers()}
    g = torch.Generator(device=dev).manual_seed(P19_SEED + 7)
    out["tacotron2"] = time_tts_step(
        f"Tacotron2 train step (B={TACO_B}, {TACO_MAX_TEXT} tokens, {TACO_MAX_FRAMES} frames at most)",
        lambda: step(batch, g), card,
        lambda: step.loss(batch, torch.Generator(device=dev).manual_seed(P19_SEED + 8)), step.params)
    out["tacotron2"]["params"] = sum(p.numel() for p in model.parameters())
    if not all(torch.equal(b, stats[n]) for n, b in model.named_buffers()):
        raise AssertionError("Tacotron2's train steps moved the BatchNorms' running statistics")
    small = taco_recipe.collate([t[:16] for t in texts[:2]], [m[:, :24] for m in mels[:2]])
    out["tacotron2"]["cpu"] = tts_step_grads_against_cpu(
        "Tacotron2 train step's loss, B=2 (16 tokens, 24 frames), prenet dropout off", model,
        lambda m, b: taco_recipe.TrainStep(m, prenet_dropout=False).loss(b), taco_recipe.to_device(small, dev))
    del step, model
    torch.cuda.empty_cache()

    need = (WRNN_FRAMES + 4) * wrnn_recipe.HOP
    clips = voiced_rows(dev, WRNN_B, need + 2 * wrnn_recipe.N_FFT, P19_SEED + 9)
    starts = rng.integers(0, clips.shape[1] - need - 1, WRNN_B).tolist()
    before = kernel_counts()["power_spectrogram"]
    wav, mel = wrnn_recipe.crop(wrnn_recipe.make_melspec(dev), clips, starts, WRNN_FRAMES)
    counts = kernel_counts()
    if counts["power_spectrogram"] != before + 1 or counts["power_spectrogram_fft"] != counts["power_spectrogram"]:
        raise AssertionError(f"WaveRNN's crops: K2 launches {counts['power_spectrogram'] - before}, not 1 on 'fft'")
    model = wrnn_recipe.make_model(False, dev, generator=torch.Generator(device=dev).manual_seed(P19_SEED + 10))
    step = wrnn_recipe.TrainStep(model)
    print(f"  WaveRNN batch: {WRNN_B} crops of {WRNN_FRAMES} frames (waveform {tuple(wav.shape)}, log-mel "
          f"{tuple(mel.shape)}; 1 K2 launch on 'fft'); {sum(p.numel() for p in model.parameters())} parameters")
    if sum(p.numel() for p in model.parameters()) != TTS_PARAMS["wavernn_recipe"]:
        raise AssertionError("the WaveRNN recipe's model has another parameter count")
    out["wavernn"] = time_tts_step(f"WaveRNN train step (B={WRNN_B} x {WRNN_FRAMES} frames, hop {wrnn_recipe.HOP})",
                                   lambda: step(wav, mel), card, lambda: step.loss(wav, mel), step.params)
    out["wavernn"]["cpu"] = tts_step_grads_against_cpu(
        "WaveRNN train step's loss, B=2 x 3 frames", model, lambda m, b: wrnn_recipe.TrainStep(m).loss(*b),
        (wav[:2, :, : 3 * wrnn_recipe.HOP + 1], mel[:2, :, :, :7]))
    del step, model
    torch.cuda.empty_cache()
    out["launches"] = {n: c for n, c in kernel_counts().items() if c}
    if set(out["launches"]) != {"power_spectrogram", "power_spectrogram_fft"} or (
            out["launches"]["power_spectrogram"] != TACO_B + 1):
        raise AssertionError(f"phase 19's launches: {out['launches']} (K2 only, {TACO_B + 1} times, on 'fft')")
    out["tacotron2_overfit"] = run_overfit_gate("Tacotron2", taco_recipe, TACO_OVERFIT, card)
    out["wavernn_overfit"] = run_overfit_gate("WaveRNN", wrnn_recipe, WRNN_OVERFIT, card)
    for gate in ("tacotron2_overfit", "wavernn_overfit"):
        if out[gate]["overfit_launches"]:
            raise AssertionError(f"{gate}: launched the port's kernels: {out[gate]['overfit_launches']}")
    return out


# ------------------------------------------------------------------ phase 20: wav2vec2 ASR serving and alignment
# WAV2VEC2_ASR_BASE_960H at full width (12 layers, 768 wide, 29 labels; the checkpoint's aux head has 32 rows, of
# which the bundle drops 1-3) on 8 clips of 10 s (499 frames), then both decoders; MMS_FA's tokenizer and aligner on 2
P20_SEED = 290  # the CUDA and numpy seeds of phase 20 are 290-299
P20_B, P20_SECONDS, P20_BEAM = 8, 10, 10
P20_ASR_AUX_ROWS, P20_FA_AUX_ROWS = 32, 31  # the published checkpoints' aux rows, before _remove_aux_axes
P20_FA_B, P20_FA_SECONDS = 2, 10
P20_WORDS = ["THE", "AND", "OF", "TO", "A", "IN", "THAT", "IS", "WAS", "HE", "FOR", "IT", "WITH", "AS", "HIS", "ON",
             "BE", "AT", "BY", "I"]
P20_TRANSCRIPTS = [["I", "HAD", "THAT", "CURIOSITY", "BESIDE", "ME", "AT", "THIS", "MOMENT"],
                   ["THE", "QUICK", "BROWN", "FOX", "JUMPS", "OVER", "THE", "LAZY", "DOG"]]


def published_state_dict(params: dict, aux_rows: int, dev, seed: int) -> dict:
    """A torchaudio-named ``state_dict`` with a published checkpoint's shapes: the model of ``params`` with
    ``aux_rows`` rows in its aux head, drawn from CUDA seed ``seed``, its positional convolution's weight norm as
    ``weight_g``/``weight_v`` (``torch.nn.utils.weight_norm``, as torchaudio's checkpoints hold it)."""
    import torch

    from audio_tpu_torch.models import wav2vec2_model

    model = wav2vec2_model(**{**params, "aux_num_out": aux_rows}, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    pos = "encoder.transformer.pos_conv_embed.conv"
    sd = {k.replace(f"{pos}.parametrizations.weight.original0", f"{pos}.weight_g")
          .replace(f"{pos}.parametrizations.weight.original1", f"{pos}.weight_v"): v.detach().clone()
          for k, v in model.state_dict().items()}
    del model
    return sd


def peaked_log_probs(b: int, t: int, v: int, seed: int):
    """(b, t, v) log-probs of seeded token paths: each row a run of tokens in [1, v), each held 1-3 frames and
    followed by a blank frame, the path's class at 0 and the others at -4 before the log-softmax (as the JAX
    package's decoder tests build them), the rest of the row blank."""
    import torch

    rng = np.random.default_rng(seed)
    logits = np.full((b, t, v), -4.0, np.float32)
    logits[:, :, 0] = 0.0
    for i in range(b):
        f = 0
        while True:
            hold = int(rng.integers(1, 4))
            if f + hold + 1 > t:
                break
            logits[i, f:f + hold, 0] = -4.0
            logits[i, f:f + hold, int(rng.integers(1, v))] = 0.0
            f += hold + 1
    return torch.log_softmax(torch.as_tensor(logits), dim=-1)


def write_decoder_files(folder: str, labels, seed: int) -> dict:
    """The lexicon (P20_WORDS spelled in ``labels``' letters, each ending with the word boundary "|"), the tokens
    file and a 3-gram ARPA over those words (seeded log10 probabilities and backoffs), and a KenLM probing binary of
    the ARPA made by ``build_binary_lm``."""
    from audio_tpu_torch.models.decoder import build_binary_lm

    rng = np.random.default_rng(seed)
    paths = {name: os.path.join(folder, name) for name in ("lexicon.txt", "tokens.txt", "lm.arpa", "lm.bin")}
    with open(paths["lexicon.txt"], "w") as f:
        f.writelines(f"{w} {' '.join(w)} |\n" for w in P20_WORDS)
    with open(paths["tokens.txt"], "w") as f:
        f.write("\n".join(labels) + "\n")
    unigrams = ["<unk>", "<s>", "</s>"] + P20_WORDS
    bigrams = [(a, b) for a in ["<s>"] + P20_WORDS for b in P20_WORDS + ["</s>"] if rng.random() < 0.2]
    trigrams = [(a, b, c) for a, b in bigrams if b != "</s>" for c in P20_WORDS if rng.random() < 0.1]
    lines = ["", "\\data\\", f"ngram 1={len(unigrams)}", f"ngram 2={len(bigrams)}", f"ngram 3={len(trigrams)}", "",
             "\\1-grams:"]
    for w in unigrams:
        logp = -99.0 if w == "<s>" else round(-rng.uniform(0.5, 3.0), 4)
        lines.append(f"{logp} {w}" if w == "</s>" else f"{logp} {w} {round(-rng.uniform(0.1, 1.0), 4)}")
    lines += ["", "\\2-grams:"]
    lines += [f"{round(-rng.uniform(0.1, 2.0), 4)} {a} {b} {round(-rng.uniform(0.1, 1.0), 4)}" for a, b in bigrams]
    lines += ["", "\\3-grams:"] + [f"{round(-rng.uniform(0.1, 1.5), 4)} {a} {b} {c}" for a, b, c in trigrams]
    lines += ["", "\\end\\", ""]
    with open(paths["lm.arpa"], "w") as f:
        f.write("\n".join(lines))
    build_binary_lm(paths["lm.arpa"], paths["lm.bin"])
    print(f"  decoder files: {len(P20_WORDS)} words, a 3-gram ARPA of {len(unigrams)}/{len(bigrams)}/{len(trigrams)} "
          f"n-grams, its KenLM binary {os.path.getsize(paths['lm.bin'])} bytes")
    return paths


def check_cuda_decoder(name: str, decoder, log_probs, lengths, card: str, near_ties: bool) -> dict:
    """``decoder`` on the card against the same call on the CPU fed the same log-probs: the tokens equal.  With
    ``near_ties``, a row whose CPU decode in float64 differs from its float32 decode has a near tie (its tokens owe
    to rounding): it is counted and left out of the exact check, and at least one row must stay in it."""
    got = decoder(log_probs, lengths)
    ref = decoder(log_probs.cpu(), lengths.cpu())
    rows = list(range(len(ref)))
    if near_ties:
        ref64 = decoder(log_probs.cpu().double(), lengths.cpu())
        rows = [i for i in rows if ref64[i][0].tokens == ref[i][0].tokens]
        if not rows:
            raise AssertionError(f"{name}: every row has a near tie")
    bad = [i for i in rows if got[i][0].tokens != ref[i][0].tokens]
    score_err = max(abs(got[i][0].score - ref[i][0].score) for i in rows)
    print(f"  {name}: tokens equal to the CPU's on {len(rows) - len(bad)} of {len(rows)} rows held to it "
          f"({len(ref) - len(rows)} rows with a near tie left out), {sum(len(h[0].tokens) for h in got)} tokens in all, "
          f"scores within {score_err:.3e}")
    if bad:
        raise AssertionError(f"{name}: rows {bad} decode to other tokens on the card")
    return {"rows_held": len(rows), "near_tie_rows": len(ref) - len(rows), "score_err": score_err,
            "tokens": sum(len(h[0].tokens) for h in got)}


def run_asr_serving(dev, card: str) -> dict:
    """Phase 20 (a)-(c): ``WAV2VEC2_ASR_BASE_960H.get_model(dl_kwargs={"state_dict": sd})`` at full width on
    P20_B clips of P20_SECONDS (the emissions against the same bundle on the CPU, within CMP_TOL of the peak); its
    log-probs through ``cuda_ctc_decoder`` (beam 10, nbest 1) on the card against the CPU, and the peaked log-probs of
    seeded token paths likewise (no near tie there); the same log-probs on the host through the lexicon
    ``ctc_decoder`` with a 3-gram LM, native on the ARPA and on its KenLM binary, and the plain Python search: the
    same words."""
    import torch

    from audio_tpu_torch.models.decoder import ctc_decoder, cuda_ctc_decoder
    from audio_tpu_torch.pipelines import WAV2VEC2_ASR_BASE_960H as bundle

    sd = published_state_dict(bundle._params, P20_ASR_AUX_ROWS, dev, P20_SEED)
    model = bundle.get_model(dl_kwargs={"state_dict": sd}, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    labels = bundle.get_labels()
    wav, lengths = padded_clips(dev, P20_B, P20_SECONDS, P20_SECONDS, P20_SEED + 1)
    with torch.no_grad():
        emission, frames = model(wav, lengths)
    want = (P20_B, frames_of(model.model, P20_SECONDS * SR), len(labels))  # (8, 499, 29)
    if tuple(emission.shape) != want or not bool(torch.isfinite(emission).all()):
        raise AssertionError(f"WAV2VEC2_ASR_BASE_960H: emissions {tuple(emission.shape)} or not finite")
    print(f"  WAV2VEC2_ASR_BASE_960H: {n_params} parameters from a seeded state_dict ({P20_ASR_AUX_ROWS} aux rows, "
          f"weight_g/weight_v), emissions {tuple(emission.shape)} f32 from {P20_B} clips of {P20_SECONDS} s")
    out = {"params": n_params}
    cpu_model = bundle.get_model(dl_kwargs={"state_dict": sd}, device="cpu")
    with torch.no_grad():
        ref = cpu_model(wav.cpu(), lengths.cpu())[0]
    peak = float(ref.abs().max())
    out["emission_err_of_peak"] = check_close(f"WAV2VEC2_ASR_BASE_960H emissions, B={P20_B} x {P20_SECONDS} s, "
                                              "against the CPU", emission.cpu(), ref, CMP_TOL * peak, 0.0) / peak
    del cpu_model
    out["model_ms"] = median_call_ms(lambda: model(wav, lengths))[0]
    print(f"  WAV2VEC2_ASR_BASE_960H forward, f32, B={P20_B} x {P20_SECONDS} s: {out['model_ms']:.3f} ms on {card}")

    # (b) the batched prefix search on the card
    log_probs = torch.log_softmax(emission, dim=-1)
    decoder = cuda_ctc_decoder(list(labels), nbest=1, beam_size=P20_BEAM)
    out["cuda_decoder"] = check_cuda_decoder(f"cuda_ctc_decoder, beam {P20_BEAM}, on the model's log-probs",
                                             decoder, log_probs, frames, card, near_ties=True)
    peaked = peaked_log_probs(P20_B, log_probs.shape[1], len(labels), P20_SEED + 2).to(dev)
    out["cuda_decoder_peaked"] = check_cuda_decoder(f"cuda_ctc_decoder, beam {P20_BEAM}, on peaked log-probs",
                                                    decoder, peaked, frames, card, near_ties=False)
    batch = lambda: decoder(log_probs, frames)  # noqa: E731
    ms, runs = median_call_ms(batch)
    out["cuda_decoder"].update(ms=ms, runs_ms=runs, audio_s_per_s=P20_B * P20_SECONDS / (ms / 1e3))
    print(f"  cuda_ctc_decoder, beam {P20_BEAM}, ({P20_B}, {log_probs.shape[1]}, {len(labels)}): {ms:.3f} ms a batch "
          f"(runs {', '.join(f'{r:.3f}' for r in runs)}), {out['cuda_decoder']['audio_s_per_s']:.1f} s of audio a "
          f"second on {card}")
    out["cuda_decoder"]["profile"] = profile_batch(f"cuda_ctc_decoder batch ({P20_B} x {log_probs.shape[1]} frames)",
                                                   batch)

    # (c) the lexicon decoder on the host
    host_lp = log_probs.cpu()
    with tempfile.TemporaryDirectory() as folder:
        files = write_decoder_files(folder, labels, P20_SEED + 3)
        options = dict(nbest=1, beam_size=50, lm_weight=2.0, word_score=-1.0)
        words, lexicon = {}, {}
        for label, lm, plain in (("native, ARPA", files["lm.arpa"], False), ("native, KenLM binary", files["lm.bin"],
                                                                              False),
                                 ("plain Python search, ARPA", files["lm.arpa"], True)):
            dec = ctc_decoder(files["lexicon.txt"], files["tokens.txt"], lm=lm, _plain=plain, **options)
            t0 = time.perf_counter()
            hyps = dec(host_lp, frames.cpu())
            s = time.perf_counter() - t0
            words[label] = [h[0].words for h in hyps]
            lexicon[label] = {"ms_a_clip": 1e3 * s / P20_B, "words": sum(len(w) for w in words[label])}
            print(f"  lexicon ctc_decoder ({label}, beam 50, 3-gram LM weight 2): {1e3 * s / P20_B:.3f} ms a clip of "
                  f"{P20_SECONDS} s, {lexicon[label]['words']} words over {P20_B} clips, first clip "
                  f"{' '.join(words[label][0][:8])} ...")
    if len({json.dumps(w) for w in words.values()}) != 1:
        raise AssertionError(f"the lexicon decoder's words differ between its paths: {words}")
    print("  the lexicon decoder's words are equal on the native ARPA, native binary and plain Python paths")
    out["lexicon_decoder"] = lexicon
    del model
    torch.cuda.empty_cache()
    return out


def run_bundle_alignment(dev, card: str) -> dict:
    """Phase 20 (d): ``MMS_FA.get_model(with_star=True)`` (315M parameters, a seeded state_dict with the published
    shapes) on P20_FA_B clips of P20_FA_SECONDS, then ``get_tokenizer()`` and ``get_aligner()`` on a transcript a
    clip: K3 must launch (on "warp"), and the spans equal the CPU aligner's on the same emissions."""
    import torch

    from audio_tpu_torch.pipelines import MMS_FA as bundle

    sd = published_state_dict(bundle._params, P20_FA_AUX_ROWS, dev, P20_SEED + 5)
    model = bundle.get_model(with_star=True, dl_kwargs={"state_dict": sd}, device=dev)
    del sd
    tokenizer, aligner = bundle.get_tokenizer(), bundle.get_aligner()
    wav, _ = padded_clips(dev, P20_FA_B, P20_FA_SECONDS, P20_FA_SECONDS, P20_SEED + 6)
    with torch.no_grad():
        emission, _ = model(wav)
    if emission.shape[-1] != len(bundle.get_labels()) or not bool(torch.isfinite(emission).all()):
        raise AssertionError(f"MMS_FA: emissions {tuple(emission.shape)} or not finite")
    tokens = [tokenizer([w.lower() for w in words]) for words in P20_TRANSCRIPTS]

    def align():
        return [aligner(emission[i], tokens[i]) for i in range(P20_FA_B)]

    reset_kernel_counts()
    spans = align()
    torch.cuda.synchronize()
    counts = kernel_counts()
    require_launches("the MMS_FA aligner (phase 20)", counts, ["viterbi"])
    require_route("the MMS_FA aligner (phase 20)", counts, "viterbi", "warp")
    out = {"k3_launches": counts["viterbi"], "params": sum(p.numel() for p in model.parameters())}
    cpu_emission = emission.cpu()
    ref = [aligner(cpu_emission[i], tokens[i]) for i in range(P20_FA_B)]
    if spans != ref:
        raise AssertionError("MMS_FA: the card's spans differ from the CPU aligner's")
    n_spans = sum(len(word) for clip in spans for word in clip)
    print(f"  MMS_FA ({out['params']} parameters, with the star column): {P20_FA_B} clips of {P20_FA_SECONDS} s, "
          f"{sum(len(t) for t in P20_TRANSCRIPTS)} words, {n_spans} token spans equal to the CPU aligner's")
    out["align_ms"] = median_call_ms(align)[0]
    out["model_ms"] = median_call_ms(lambda: model(wav))[0]
    print(f"  MMS_FA: the model {out['model_ms']:.3f} ms and the aligner {out['align_ms']:.3f} ms for {P20_FA_B} clips "
          f"on {card}")
    del model
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the per-kernel results as JSON to this file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 1

    import audio_tpu_torch.functional as F
    from audio_tpu_torch._internal.windows import hann_window
    from audio_tpu_torch.functional._stft import _pad_center
    from audio_tpu_torch.models import emformer_rnnt_base
    from audio_tpu_torch.ops import (_build, cuda_attention, cuda_iir, cuda_lstm, cuda_rnnt_lps, cuda_spectrogram,
                                     cuda_viterbi)
    dev = torch.device("cuda", 0)
    # ---------------------------------------------------------------- phase 1
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for entry in ptxas_entries(log.read_text() if log.exists() else ""):
            print(f"  {name}: {entry}")

    rng = np.random.default_rng(1)
    torch.set_grad_enabled(False)
    wav, targets, proj, window, fb = make_inputs(dev)

    # ---------------------------------------------------------------- phase 3
    print("phase 3: kernels against their plain versions")
    # K1 ragged (rows not a multiple of a block's, T not a multiple of a chunk or a pass) on both routes
    check_lfilter_routes(rng, dev)
    # K1 main path: the lowpass biquad at (8192, 1, 16000)
    w0 = 2 * np.pi * CUTOFF / SR
    alpha = np.sin(w0) / 2 / 0.707
    a_lp = torch.tensor([[1 + alpha, -2 * np.cos(w0), 1 - alpha]], dtype=torch.float32, device=dev)
    b_lp = torch.tensor([[(1 - np.cos(w0)) / 2, 1 - np.cos(w0), (1 - np.cos(w0)) / 2]], dtype=torch.float32,
                        device=dev)
    a_lp, b_lp = (a_lp / a_lp[:, :1]).contiguous(), (b_lp / a_lp[:, :1]).contiguous()
    x1 = wav[:, None, :].contiguous()
    k1_got = cuda_iir.lfilter_fused(x1, a_lp, b_lp)
    torch.cuda.synchronize()
    k1_err = check_close(f"K1 lfilter main [{cuda_iir.lfilter_route(3, 3)}] (8192x1x16000)", k1_got,
                         cuda_iir.lfilter_plain(x1, a_lp, b_lp), 2e-4, 1e-4)
    same = torch.equal(cuda_iir.lfilter_fused(x1, a_lp, b_lp), k1_got)
    print(f"  K1 bits (8192x1x16000): equal over two runs: {same}")
    if not same:
        raise AssertionError("K1: two runs at the main shape gave different bits")
    print(f"  K1 launches by route in phase 3: {cuda_iir.lfilter_route_launches}")
    if min(cuda_iir.lfilter_route_launches.values()) < 1:
        raise AssertionError(f"K1: a route was never held against the plain version: {cuda_iir.lfilter_route_launches}")

    # K2 ragged and main: 5e-4 of the peak, as the JAX spectrogram tests
    def k2_check(name, xp, win, n_fft, hop, power, fbank):
        got = cuda_spectrogram.power_spectrogram(xp, win, n_fft, hop, power, fb=fbank)
        torch.cuda.synchronize()
        ref = cuda_spectrogram.power_spectrogram_plain(xp, win, n_fft, hop, power, fb=fbank)
        return check_close(name, got, ref, 5e-4 * float(ref.abs().max()), 0.0), got

    xs = torch.as_tensor(rng.standard_normal((7, 3001)).astype(np.float32) * 0.3, device=dev)
    # mel, power and magnitude on both routes: n_fft 400, 512, 1024 (128 mels) and 2048 on "fft",
    # 398 = 2 x 199 on "dft"
    for n_fft, hop, n_mels in ((N_FFT, HOP, N_MELS), (512, 128, N_MELS), (1024, 256, 128), (2048, 512, N_MELS),
                               (398, HOP, N_MELS)):
        win = hann_window(n_fft, device=dev)
        fbank = F.melscale_fbanks(n_fft // 2 + 1, 0.0, 8000.0, n_mels, SR, device=dev)
        route = cuda_spectrogram.kernel_route(n_fft)
        for what, power, fb_ in (("mel", 2.0, fbank), ("power", 2.0, None), ("magnitude", 1.0, None)):
            k2_check(f"K2 {what} [{route}] (7x3001, n_fft {n_fft}, hop {hop}{f', {n_mels} mels' if fb_ is not None else ''})",
                     xs, win, n_fft, hop, power, fb_)
    print(f"  K2 launches by route in phase 3 so far: {cuda_spectrogram.route_launches}")
    if cuda_spectrogram.route_launches["fft"] < 12 or cuda_spectrogram.route_launches["dft"] < 3:
        raise AssertionError(f"K2: a route was not held against the plain version: {cuda_spectrogram.route_launches}")
    # the public functions' glue around K2 (center pad, lead dims, norms, layout) on the card
    # against the same calls on the CPU, which run the plain version; 5e-4 of the peak
    xs_cpu, win_cpu, fb_cpu = xs.reshape(7, 1, -1).cpu(), window.cpu(), fb.cpu()
    for normalized in (False, True, "frame_length", "window"):
        kw = dict(n_fft=N_FFT, hop_length=HOP, normalized=normalized)
        for power in (1.0, 2.0):
            ref = F.spectrogram(xs_cpu, window=win_cpu, power=power, **kw)
            check_close(f"F.spectrogram power {power:g}, normalized {normalized!r} (7x1x3001)",
                        F.spectrogram(xs.reshape(7, 1, -1), window=window, power=power, **kw).cpu(), ref,
                        5e-4 * float(ref.abs().max()), 0.0)
        ref = F.mel_spectrogram(xs_cpu, fb_cpu, window=win_cpu, **kw)
        check_close(f"F.mel_spectrogram normalized {normalized!r} (7x1x3001)",
                    F.mel_spectrogram(xs.reshape(7, 1, -1), fb, window=window, **kw).cpu(), ref,
                    5e-4 * float(ref.abs().max()), 0.0)
    x2 = _pad_center(k1_got[:, 0], N_FFT // 2, "reflect").contiguous()
    k2_err, mel_main = k2_check("K2 mel main [fft] (8192x16400)", x2, window, N_FFT, HOP, 2.0, fb)
    ref_main = cuda_spectrogram.power_spectrogram_plain(x2, window, N_FFT, HOP, 2.0, fb=fb)
    dft_main = cuda_spectrogram._power_spectrogram_kernel(x2, window, N_FFT, HOP, 2.0, fb, route="dft")
    torch.cuda.synchronize()
    k2_dft_err = check_close("K2 mel main [dft] (8192x16400)", dft_main, ref_main, 5e-4 * float(ref_main.abs().max()), 0.0)
    print(f"  K2 main: max abs error relative to the peak, fft {k2_err / float(ref_main.abs().max()):.3e}, "
          f"dft {k2_dft_err / float(ref_main.abs().max()):.3e}")
    again = cuda_spectrogram.power_spectrogram(x2, window, N_FFT, HOP, 2.0, fb=fb)
    torch.cuda.synchronize()
    print(f"  K2 bits (8192x16400): equal over two runs: {torch.equal(again, mel_main)}")
    if not torch.equal(again, mel_main):
        raise AssertionError("K2: two runs at the main shape gave different bits")
    del ref_main, dft_main, again

    # K3 on both routes: ragged shapes in every type, ties, -inf columns, S past the warp route's cap
    # and past 1024, a non-contiguous view; then the main shape, and its bits over two runs
    check_viterbi_routes(rng, dev)
    em_main = torch.log_softmax(torch.log1p(mel_main) @ proj, -1)
    tl_main = torch.full((B,), L, dtype=torch.int32, device=dev)
    il_main = torch.full((B,), em_main.shape[1], dtype=torch.int32, device=dev)
    k3_args = k3_inputs(em_main, targets, il_main, tl_main)
    k3_ref = cuda_viterbi.viterbi_paths_plain(*k3_args)
    k3_route = cuda_viterbi.kernel_route(2 * L + 1, em_main.dtype)
    k3_err = check_viterbi_route(k3_route, "main (8192x101, V 32, L 50)", k3_args, k3_ref)
    check_viterbi_route("block", "main (8192x101, V 32, L 50)", k3_args, k3_ref)
    for route in ("warp", "block"):
        one, two = (cuda_viterbi._launch(route, *k3_args) for _ in range(2))
        torch.cuda.synchronize()
        print(f"  K3 bits [{route}] (8192x101): equal over two runs: {torch.equal(one, two)}")
        if not torch.equal(one, two):
            raise AssertionError(f"K3: two runs of route {route!r} at the main shape gave different bits")
    print(f"  K3 launches by route in phase 3: {cuda_viterbi.route_launches}")
    if min(cuda_viterbi.route_launches.values()) < 1:
        raise AssertionError(f"K3: a route was never held against the plain version: {cuda_viterbi.route_launches}")

    # K5-K8: ragged small shapes (N off the warp and row-block sizes, V = 33 and 4097,
    # k = 1, 3, 10, H = 64 and 96, bf16 rows with forced ties), then the main shape
    n_main = RNNT_S * RNNT_BEAM
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for n, d, v, hd, k in ((37, 16, 33, 64, 1), (70, 48, 33, 64, 3), (45, 100, RNNT_V, 96, 10)):
            check_slice2_kernels(rng, dev, n, d, v, hd, k, dtype, f"{tag} (N {n}, D {d}, V {v}, H {hd}, k {k})")
        errs = check_slice2_kernels(rng, dev, n_main, RNNT_D, RNNT_V, RNNT_H, RNNT_BEAM, dtype,
                                    f"{tag} main (N {n_main}, D {RNNT_D}, V {RNNT_V}, H {RNNT_H}, k {RNNT_BEAM})")
    s2_err = errs  # the main shape in bf16, the type the main path runs
    s2_err["join_stats_topk"] = check_join_wgmma(rng, dev)
    check_join_wmma(rng, dev)
    s2_err["lstm_gate_step"] = check_lstm_wgmma(rng, dev)
    print(f"  K7 launches by route in phase 3: {cuda_lstm.route_launches}")
    if min(cuda_lstm.route_launches.values()) < 1:
        raise AssertionError(f"K7: a route was never held against the plain version: {cuda_lstm.route_launches}")
    # K8 on its route "stream" at ragged shapes, then at the train step's shapes: the full loss's
    # lattice and the pruned loss's band
    check_lattice_stream(rng, dev)
    # K6 on its route "stream" at ragged shapes and rows with fewer than k candidates above -inf,
    # with routes "row" and "global" on the same rows; then K5's three routes on such rows.
    # Generators of their own, so that the later checks see the inputs they saw before
    check_row_stats_stream(np.random.default_rng(12), dev)
    print(f"  K6 launches by route in phase 3: {cuda_rnnt_lps.row_stats_route_launches}")
    k5_few = check_join_few_candidates(np.random.default_rng(13), dev)
    t_out = TRAIN_T // 4  # frames after the time reduction; phase 8 holds the model's output to it
    k8_train = {}
    for shape, label in (((TRAIN_B_FULL, t_out, TRAIN_U + 1, RNNT_V), "full lattice"),
                         ((TRAIN_B_PRUNED, t_out, TRAIN_BAND, RNNT_V), "pruned band")):
        k8_train[label] = check_lattice_stats(rng, dev, card, shape, f"bf16 {label} {shape}")
        s2_err["lattice_row_stats"] = max(s2_err["lattice_row_stats"], k8_train[label]["err"])
    print(f"  K8 launches by route in phase 3: {cuda_rnnt_lps.lattice_route_launches}")
    torch.cuda.empty_cache()

    # K9: ragged shapes (Tq, Tk off the tiles; dh = 8, 24, 128), heads deeper than the 128
    # columns on chip (dh = 136, 264, 1024: two, three and eight chunks), a fully masked row,
    # a large tile inside the gate, then the train steps' shapes (the pruned loss's batch, then
    # the full loss's); bf16 last, the type they run.  bf16 takes the wgmma route where
    # kernel_route says so and the tiled route elsewhere; f32 always the tiled route
    k9_main = (TRAIN_B_FULL, TRAIN_HEADS, TRAIN_TQ, TRAIN_TQ, TRAIN_DH)
    k9_pruned = (TRAIN_B_PRUNED, TRAIN_HEADS, TRAIN_TQ, TRAIN_TQ, TRAIN_DH)
    # bf16 at the edges of the wgmma route's limits (Tk 192 or 128, dh 128; Tq past four tiles of
    # the backward's ring): both sides
    edges = (32, 64, 65, 192, 256, 257)
    pairs = [(t, t) for t in edges] + [(32, 257), (257, 32), (65, 192), (192, 65), (256, 64), (64, 256)]
    for dh_ in (8, 64, 128):
        for tq_, tk_ in pairs:
            check_attention(rng, dev, (1, 2, tq_, tk_, dh_), torch.bfloat16, f"bf16 edge {(1, 2, tq_, tk_, dh_)}")
    check_attention(rng, dev, k9_main, torch.bfloat16, f"bf16 main {k9_main}, a fully masked row", True)
    check_attention_bits(rng, dev, k9_main, f"bf16 main {k9_main}")
    # the tiled route's bf16 case that missed its dQ tolerance once (ROADMAP.md C): the kernel and the
    # plain version each against float64 too, and the kernel's bits on memory filled with NaN
    a1 = (2, 2, 100, 70, 136)
    check_attention(np.random.default_rng(25), dev, a1, torch.bfloat16, f"bf16 {a1}, seed 25", f64=True)
    check_attention_bits(np.random.default_rng(25), dev, a1, f"bf16 {a1}, seed 25", poison=True)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for shape, masked_row in (((2, 2, 32, 32, 8), False), ((3, 4, 33, 47, 24), False),
                                  ((2, 2, 129, 161, 64), False), ((2, 2, 100, 70, 128), False),
                                  ((2, 2, 100, 70, 136), False), ((1, 3, 65, 33, 264), True),
                                  ((1, 2, 40, 72, 1024), False),
                                  ((2, 8, 160, 160, 64), True), ((2, 8, 640, 640, 64), False)):
            check_attention(rng, dev, shape, dtype, f"{tag} {shape}{', a fully masked row' if masked_row else ''}",
                            masked_row)
        check_attention(rng, dev, k9_pruned, dtype, f"{tag} main, pruned step {k9_pruned}")
        k9_err = check_attention(rng, dev, k9_main, dtype, f"{tag} main {k9_main}")
    k9_routes = dict(cuda_attention.route_launches)
    print(f"  K9 launches by route in phase 3: {k9_routes}")
    if min(k9_routes.values()) < 1:
        raise AssertionError(f"K9: a route was never held against the plain version: {k9_routes}")
    # K4: orders 1, 8, 12 and 128 at small ragged shapes, both routes at their edges, then the
    # gradient path's shape
    for b_, c_, t_, order in ((45, 3, 1007, 1), (33, 2, 300, 8), (17, 1, 5000, 12), (5, 2, 700, 128)):
        check_iir(rng, dev, b_, c_, t_, order, f"order {order} ({b_}x{c_}x{t_})")
    check_iir_routes(rng, dev)
    k4_err = check_iir(rng, dev, B, 1, T, 2, f"main, order 2 ({B}x1x{T})")
    print(f"  K4 launches by route in phase 3: {cuda_iir.iir_route_launches}")
    # the public functions outside their kernels' limits
    check_fallback_routes(dev)

    # ---------------------------------------------------------------- phase 4
    print("phase 4: the chain at full width")
    reset_kernel_counts()
    filtered, mel, emissions, paths, scores = chain(wav, targets, proj, window, fb)
    torch.cuda.synchronize()
    launches = kernel_counts()
    require_launches("one chain step", launches, ["lfilter", "power_spectrogram", "viterbi"])
    require_route("one chain step", launches, "power_spectrogram", "fft")
    require_route("one chain step", launches, "lfilter", "chunked")
    require_route("one chain step", launches, "viterbi", "warp")
    n_frames = 1 + T // HOP
    if tuple(mel.shape) != (B, n_frames, N_MELS) or tuple(paths.shape) != (B, n_frames):
        raise AssertionError(f"chain shapes: mel {tuple(mel.shape)}, paths {tuple(paths.shape)}")
    if not bool(torch.isfinite(scores).all()) or not bool(torch.isfinite(mel).all()):
        raise AssertionError("chain produced non-finite values")
    paths_h, targets_h = paths.cpu().numpy(), targets.cpu().numpy()
    bad = [i for i in range(B) if ctc_collapse(paths_h[i]) != targets_h[i].tolist()]
    print(f"  {B - len(bad)} of {B} paths collapse to their targets (limit: all)")
    if bad:
        raise AssertionError(f"{len(bad)} paths are not CTC alignments of their targets, e.g. stream {bad[0]}")

    # a slice of the chain against the plain versions on the CPU
    n_ref = 8
    cpu = [t[:n_ref].cpu() for t in (wav, targets)] + [t.cpu() for t in (proj, window, fb)]
    _, mel_ref, em_ref, paths_ref, _ = chain(*cpu)
    check_close("chain mel vs CPU plain (8 streams)", mel[:n_ref].cpu(), mel_ref,
                5e-4 * float(mel_ref.max()), 0.0)
    # emissions carry the mel tolerance through log1p and the projection
    check_close("chain emissions vs CPU plain (8 streams)", emissions[:n_ref].cpu(), em_ref, 1e-3, 0.0)
    agree = float((paths[:n_ref].cpu() == paths_ref).double().mean())
    print(f"  chain paths vs CPU plain: {agree:.4f} of frames agree (limit 0.99: the emissions differ "
          "in the last bits, which may move a near-tie)")
    if agree < 0.99:
        raise AssertionError("chain paths disagree with the CPU plain chain")

    # timings
    step_ms = []
    chain(wav, targets, proj, window, fb)
    torch.cuda.synchronize()
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chain(wav, targets, proj, window, fb)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    chain_ms = statistics.median(step_ms)
    chain_streams = 0.1 * B * (T / SR) / (chain_ms / 1e3)
    print(f"  chain: median {chain_ms:.3f} ms per step of {B} x 1 s (runs {[round(m, 3) for m in step_ms]}); "
          f"{chain_streams:.1f} streams at RTF 0.1 on {card}")

    breakdown = profile_chain(lambda: chain(wav, targets, proj, window, fb), chain_ms)
    del filtered, mel, emissions, paths, scores

    # ---------------------------------------------------------------- phase 5
    print(f"phase 5: streaming RNN-T beam search at full width (S={RNNT_S}, beam {RNNT_BEAM}, "
          f"step_max_tokens {RNNT_SMT}, bf16)")
    model = make_rnnt(dev, torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  emformer_rnnt_base({RNNT_V}): {n_params / 1e6:.1f}M parameters from seed 0, bf16")
    dec = make_decoder(model)
    feats, lengths = rnnt_segments(dev, torch.bfloat16, RNNT_S, RNNT_TICKS)
    hypos, state = dec.init_beams(RNNT_BEAM, RNNT_S), None
    reset_kernel_counts()
    for f in feats:
        hypos, state = dec.infer_batch(f, lengths, RNNT_BEAM, state, hypos)
    torch.cuda.synchronize()
    rnnt_launches = kernel_counts()
    require_launches(f"{RNNT_TICKS} ticks of infer_batch", rnnt_launches, ["join_stats_topk", "lstm_gate_step"])
    require_route(f"{RNNT_TICKS} ticks of infer_batch", rnnt_launches, "join_stats_topk", "wgmma")
    require_route(f"{RNNT_TICKS} ticks of infer_batch", rnnt_launches, "lstm_gate_step", "wgmma")
    check_beams("infer_batch", hypos.tokens, hypos.counts, hypos.scores)
    if tuple(hypos.tokens.shape) != (RNNT_S, RNNT_BEAM, RNNT_MAX_TOKENS) or len(state) != 20:
        raise AssertionError(f"infer_batch shapes: tokens {tuple(hypos.tokens.shape)}, {len(state)} layer states")

    ticks = {}
    for static in (False, True):
        dec.static_expansion = static
        reset_kernel_counts()
        tick_ms, tick_runs, tick = time_tick(dec, feats[0], lengths, state, hypos)
        require_route(f"the timed ticks, static_expansion={static}", kernel_counts(), "join_stats_topk", "wgmma")
        require_route(f"the timed ticks, static_expansion={static}", kernel_counts(), "lstm_gate_step", "wgmma")
        per_tick = {n: c / 6 for n, c in kernel_counts().items() if c}  # a warm-up and 5 timed ticks
        streams = RNNT_S * RNNT_SEG_SECONDS * 0.1 / (tick_ms / 1e3)
        print(f"  tick, static_expansion={static}: median {tick_ms:.3f} ms (runs {[round(m, 3) for m in tick_runs]}); "
              f"{streams:.1f} streams at RTF 0.1; launches a tick {per_tick} on {card}")
        ticks[static] = dict(ms=tick_ms, runs_ms=tick_runs, streams=streams, launches_per_tick=per_tick)
        ticks[static]["profile"] = profile_chain(tick, tick_ms, reps=2)
    dec.static_expansion = False

    # the same model with a tanh joiner: the join's (S, K, V) logits are written, and K6 reduces them
    model.joiner.activation = "tanh"
    what = f"{RNNT_TICKS} ticks of infer_batch, tanh joiner"
    hypos, state = dec.init_beams(RNNT_BEAM, RNNT_S), None
    reset_kernel_counts()
    for f in feats:
        hypos, state = dec.infer_batch(f, lengths, RNNT_BEAM, state, hypos)
    torch.cuda.synchronize()
    tanh_launches = kernel_counts()
    require_launches(what, tanh_launches, ["row_stats_topk", "lstm_gate_step"])
    require_route(what, tanh_launches, "row_stats_topk", "stream")
    require_route(what, tanh_launches, "lstm_gate_step", "wgmma")
    if tanh_launches["join_stats_topk"]:
        raise AssertionError(f"{what}: K5 launched {tanh_launches['join_stats_topk']} times")
    check_beams("infer_batch, tanh joiner", hypos.tokens, hypos.counts, hypos.scores)
    reset_kernel_counts()
    tanh_ms, tanh_runs, tick = time_tick(dec, feats[0], lengths, state, hypos)
    require_route("the timed tanh-joiner ticks", kernel_counts(), "row_stats_topk", "stream")
    per_tick = {n: c / 6 for n, c in kernel_counts().items() if c}  # a warm-up and 5 timed ticks
    tanh_tick = dict(ms=tanh_ms, runs_ms=tanh_runs, streams=RNNT_S * RNNT_SEG_SECONDS * 0.1 / (tanh_ms / 1e3),
                     launches_per_tick=per_tick)
    print(f"  tick, tanh joiner: median {tanh_ms:.3f} ms (runs {[round(m, 3) for m in tanh_runs]}); "
          f"{tanh_tick['streams']:.1f} streams at RTF 0.1; K6 launches a tick {per_tick['row_stats_topk']:g}, "
          f"all on 'stream'; launches a tick {per_tick} on {card}")
    tanh_tick["profile"] = profile_chain(tick, tanh_ms, reps=2)
    model.joiner.activation = "relu"
    del model, dec, hypos, state, tick

    # ---------------------------------------------------------------- phase 6
    print("phase 6: the search in f32 on the card against the CPU")
    model = make_rnnt(dev, torch.float32)
    compare_with_cpu("ReLU joiner through K5 (S=4)", model, 4, "exact", "join_stats_topk")
    route_launches = compare_with_cpu("expansion='approx' through K8 (S=32)", model, 32, "approx",
                                      "lattice_row_stats")
    require_route("expansion='approx' through K8 (S=32)", route_launches, "lattice_row_stats", "stream")
    model.joiner.activation = "tanh"
    k6_launches = compare_with_cpu("tanh joiner through K6 (S=32)", model, 32, "exact", "row_stats_topk")
    require_route("tanh joiner through K6 (S=32)", k6_launches, "row_stats_topk", "stream")
    model.joiner.activation = "relu"

    # ---------------------------------------------------------------- phase 7
    print("phase 7: the pipeline, waveform to beams")
    from audio_tpu_torch.pipelines import EMFORMER_RNNT_BASE_LIBRISPEECH as bundle

    with tempfile.TemporaryDirectory() as cache:
        stats = os.path.join(cache, "pipeline-assets", "global_stats_rnnt_librispeech.json")
        os.makedirs(os.path.dirname(stats))
        with open(stats, "w") as f:
            json.dump({"mean": [8.0] * bundle.n_mels, "invstddev": [0.25] * bundle.n_mels}, f)
        os.environ["AUDIO_TPU_HOME"] = cache  # the bundle's asset cache: it finds the file and fetches nothing
        extractor = bundle.get_streaming_feature_extractor()
    pipe_dec = bundle.get_decoder(dl_kwargs={"state_dict": model.state_dict()})
    speech = torch.as_tensor(np.random.default_rng(3).standard_normal(2 * bundle.sample_rate).astype(np.float32) * 0.1,
                             device=dev)
    reset_kernel_counts()
    feats_p, n_feats = extractor(speech)
    seg, rc = bundle.segment_length, bundle.right_context_length
    hypo, state, n_segments = None, None, 0
    for start in range(0, feats_p.shape[0] - seg - rc + 1, seg):
        piece = feats_p[start : start + seg + rc]
        hypo, state = pipe_dec.infer(piece, torch.tensor(seg + rc, device=dev), RNNT_BEAM, state, hypo)
        n_segments += 1
    torch.cuda.synchronize()
    require_launches(f"the pipeline ({n_segments} segments)", kernel_counts(), ["power_spectrogram", "join_stats_topk"])
    n_frames_p = 1 + speech.shape[0] // bundle.hop_length
    if tuple(feats_p.shape) != (n_frames_p, bundle.n_mels) or int(n_feats[0]) != n_frames_p:
        raise AssertionError(f"pipeline features: shape {tuple(feats_p.shape)}, length {int(n_feats[0])}")
    if not bool(torch.isfinite(feats_p).all()):
        raise AssertionError("pipeline features are not finite")
    check_beams("pipeline infer", hypo.tokens[None], hypo.counts[None], hypo.scores[None], pipe_dec.max_tokens)
    print(f"  top hypothesis after {n_segments} segments: {len(pipe_dec.hypo_tokens(hypo))} tokens, "
          f"score {float(hypo.scores[0]):.3f}")
    del model, pipe_dec

    # ---------------------------------------------------------------- phase 8
    print(f"phase 8: Emformer RNN-T train step at full width (T={TRAIN_T}+{TRAIN_RC} frames, U={TRAIN_U}, "
          "bf16 compute, f32 masters, dropout on)")
    recipe = load_train_recipe()
    model = emformer_rnnt_base(RNNT_V, device=dev, generator=torch.Generator().manual_seed(0))
    train = {
        "full": run_train_path(recipe, model, dev, card, "full", TRAIN_B_FULL),
        "pruned": run_train_path(recipe, model, dev, card, "pruned", TRAIN_B_PRUNED),
    }
    # the comparison takes the seeded weights, not the ones the steps above left: its inputs,
    # and so its margins, are then the same in every run
    model = emformer_rnnt_base(RNNT_V, device=dev, generator=torch.Generator().manual_seed(0))
    for loss in ("full", "pruned"):
        compare_train_with_cpu(recipe, model, dev, loss)
    del model
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 9
    print(f"phase 9: lfilter's gradient at full width (B={B} x {T} samples)")
    check_short_filter(rng, dev)
    filter_grad = {order: run_filter_grad(rng, dev, card, wav, fb, window, order, 5 if order == 2 else 2)
                   for order in (2, 8, 12)}
    fg = filter_grad[2]
    fg["profile"] = profile_chain(lambda: filter_grad_step(wav, fg["a"], fg["b"], fb, window), fg["ms"], reps=1)

    # ---------------------------------------------------------------- phase 10
    print(f"phase 10: the effects chain (B={FX_B} x {T} samples) and the Griffin-Lim vocoder (B={VOC_B} x {VOC_T})")
    t10 = time.perf_counter()
    with torch.no_grad():
        effects = run_effects(dev, card)
        vocoder = run_vocoder(dev, card)
    torch.cuda.empty_cache()
    print(f"  phase 10 took {time.perf_counter() - t10:.1f} s")

    # ---------------------------------------------------------------- phase 11
    print(f"phase 11: the CTC augmentation front end (B={B} x {T} samples) and the other ported functions")
    t11 = time.perf_counter()
    front_end = run_front_end(dev, card, fb, window)
    torch.cuda.empty_cache()
    front_end["functions"] = run_front_end_functions(dev, card)
    torch.cuda.empty_cache()
    print(f"  phase 11 took {time.perf_counter() - t11:.1f} s")

    # ---------------------------------------------------------------- phase 12
    print(f"phase 12: the transform front end (B={B} x {T} samples), the other transform classes and Kaldi's "
          "features")
    t12 = time.perf_counter()
    transforms = run_transform_front_end(dev, card)
    torch.cuda.empty_cache()
    transforms["classes"] = run_transform_classes(dev, card)
    torch.cuda.empty_cache()
    transforms["kaldi"] = run_kaldi(dev, card)
    torch.cuda.empty_cache()
    print(f"  phase 12 took {time.perf_counter() - t12:.1f} s")

    # ---------------------------------------------------------------- phase 13
    print(f"phase 13: MMS_FA-shaped forced alignment (B={FA_B} x {FA_SECONDS} s), wav2vec2_base CTC emissions "
          f"(B={ASR_B} x {ASR_SECONDS} s) and wavlm_base_plus features (B={SSL_B} x {SSL_SECONDS} s)")
    t13 = time.perf_counter()
    wav2vec2 = {"forced_alignment": run_forced_alignment(dev, card)}
    torch.cuda.empty_cache()
    wav2vec2["ctc"] = run_ctc_emissions(dev, card)
    torch.cuda.empty_cache()
    wav2vec2["wavlm"] = run_wavlm_features(dev, card)
    torch.cuda.empty_cache()
    print(f"  phase 13 took {time.perf_counter() - t13:.1f} s")

    # ---------------------------------------------------------------- phase 14
    print(f"phase 14: the SSL train steps at full width (B={SSL_TRAIN_B} x {SSL_TRAIN_MIN_S}-{SSL_TRAIN_MAX_S} s): "
          "HuBERT pretraining (f32, bf16), wav2vec2 contrastive (f32), HuBERT CTC fine-tuning (f32)")
    t14 = time.perf_counter()
    reset_kernel_counts()
    ssl = {"hubert": run_hubert_pretrain(load_example("train_hubert_torch", "self_supervised_learning",
                                                      "train_hubert_torch.py"), dev, card)}
    torch.cuda.empty_cache()
    ssl["wav2vec2"] = run_wav2vec2_pretrain(load_example("train_wav2vec2_torch", "self_supervised_learning",
                                                         "train_wav2vec2_torch.py"), dev, card)
    torch.cuda.empty_cache()
    ssl["finetune"] = run_hubert_finetune(load_example("finetune_torch", "hubert", "finetune_torch.py"), dev, card)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    ssl["kernel_launches"] = {n: c for n, c in kernel_counts().items() if c}
    print(f"  kernel launches in phase 14 (no TPU kernel is on the SSL steps' path): {ssl['kernel_launches']}")
    print(f"  phase 14 took {time.perf_counter() - t14:.1f} s")

    # ---------------------------------------------------------------- phase 15
    print(f"phase 15: the Conformer RNN-T recipes at full width: the train step (f32, B={CF_TRAIN_B} x "
          f"{CF_MIN_S}-{CF_MAX_S} s, V={CF_V}), the beam search (bf16 and f32, B={CF_SEARCH_B} x {CF_SEARCH_S} s, "
          f"beam {CF_BEAM}) and the TCPGen-biased train step (f32, B={CF_BIASED_B} x {CF_BIASED_S} s, V={CF_BIASED_V})")
    t15 = time.perf_counter()
    conformer_recipe = load_example("conformer_rnnt_train_torch", "asr", "conformer_rnnt", "train_torch.py")
    conformer = {"train": run_conformer_rnnt_train(conformer_recipe, dev, card)}
    conformer["search"] = run_conformer_search(conformer_recipe, dev, card)
    conformer["biased"] = run_biased_train(load_example("conformer_rnnt_biasing_train_torch", "asr",
                                                        "conformer_rnnt_biasing", "train_torch.py"), dev, card)
    torch.cuda.empty_cache()
    phase15_launches = {
        "power_spectrogram": conformer["train"]["launches"].get("power_spectrogram", 0)
        + conformer["biased"]["launches"].get("power_spectrogram", 0),
        "lattice_row_stats": conformer["train"]["launches"].get("lattice_row_stats", 0),
        "join_stats_topk": conformer["search"]["bf16"]["launches"].get("join_stats_topk", 0),
        "lstm_gate_step": conformer["search"]["bf16"]["launches"].get("lstm_gate_step", 0),
    }
    print(f"  kernel launches in phase 15 (a train step each of the two recipes, one bf16 search batch): "
          f"{phase15_launches}")
    print(f"  phase 15 took {time.perf_counter() - t15:.1f} s")

    # ---------------------------------------------------------------- phase 16
    print(f"phase 16: the AVSR recipe at full width: the train step (f32, B={AV_B} x {AV_MIN_FRAMES}-{AV_FRAMES} "
          f"frames of {AV_SIZE}x{AV_SIZE}, V={AV_V}), the greedy decode and the --overfit gate")
    t16 = time.perf_counter()
    avsr_eval = load_example("avsr_eval_torch", "avsr", "eval_torch.py")
    avsr = {"train": run_avsr_train(avsr_eval.train, dev, card)}
    avsr["eval"] = run_avsr_eval(avsr_eval, dev, card)
    torch.cuda.empty_cache()
    phase16_launches = {"lattice_row_stats": avsr["train"]["launches"].get("lattice_row_stats", 0)}
    s2_err["lattice_row_stats"] = max(s2_err["lattice_row_stats"], avsr["train"]["k8"]["err"])
    print(f"  kernel launches in phase 16 (one AVSR train step): {phase16_launches}")
    avsr["seconds"] = time.perf_counter() - t16
    print(f"  phase 16 took {avsr['seconds']:.1f} s")

    # ---------------------------------------------------------------- phase 17
    print(f"phase 17: Wav2Letter's CTC step (f32, B={W2L_B} x {W2L_MIN_S}-{W2L_SECONDS} s), DeepSpeech (n_hidden "
          f"{DS_HIDDEN}, B={DS_B} x {DS_SECONDS} s), Conv-TasNet's separation step (f32, B={TN_B} x {TN_SECONDS:g} s "
          f"at {TN_SR} Hz), both recipes' --overfit gates, and the TF32 check of every TF32-off convolution")
    t17 = time.perf_counter()
    w2l_recipe = load_example("wav2letter_train_torch", "asr", "wav2letter", "train_torch.py")
    zoo = {"wav2letter": run_wav2letter(w2l_recipe, dev, card)}
    torch.cuda.empty_cache()
    zoo["deepspeech"] = run_deepspeech(w2l_recipe, dev, card)
    torch.cuda.empty_cache()
    zoo["conv_tasnet"] = run_conv_tasnet(load_example("source_separation_train_torch", "source_separation",
                                                      "train_torch.py"), dev, card)
    torch.cuda.empty_cache()
    zoo["tf32"] = run_tf32_checks(conformer_recipe, dev, card)
    torch.cuda.empty_cache()
    phase17_launches = {"power_spectrogram": zoo["wav2letter"]["launches"].get("power_spectrogram", 0)
                        + zoo["deepspeech"]["launches"].get("power_spectrogram", 0)}
    print(f"  kernel launches in phase 17 (one Wav2Letter step, DeepSpeech's spectrogram): {phase17_launches}")
    zoo["seconds"] = time.perf_counter() - t17
    print(f"  phase 17 took {zoo['seconds']:.1f} s")

    # ---------------------------------------------------------------- phase 18
    print(f"phase 18: music separation (HDEMUCS_HIGH_MUSDB_PLUS, separate_sources over {HD_SECONDS} s of stereo at "
          f"{HD_SR} Hz, segments of {HD_SEGMENT:g} s), hdemucs_low and hdemucs_medium, and speech-quality scoring "
          f"(SQUIM_OBJECTIVE and SQUIM_SUBJECTIVE on {SQ_B} x {SQ_SECONDS} s at {SQ_SR} Hz)")
    t18 = time.perf_counter()
    reset_kernel_counts()
    phase18 = {"separation": run_hdemucs(dev, card)}
    phase18["squim"] = run_squim(dev, card)
    torch.cuda.synchronize()
    phase18["kernel_launches"] = {n: c for n, c in kernel_counts().items() if c}
    print(f"  launches of K1-K9 (every route) in phase 18: {phase18['kernel_launches']} (none expected: no TPU kernel "
          "is on these paths; HDemucs's STFT is a complex torch.fft, not K2's power spectrogram)")
    if phase18["kernel_launches"]:
        raise AssertionError(f"phase 18 launched the port's kernels: {phase18['kernel_launches']}")
    phase18["seconds"] = time.perf_counter() - t18
    print(f"  phase 18 took {phase18['seconds']:.1f} s")

    # ---------------------------------------------------------------- phase 19
    print(f"phase 19: text-to-speech: TACOTRON2_WAVERNN_CHAR_LJSPEECH and TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH at full "
          f"width on {len(TTS_TEXTS)} sentences, the card against the CPU, the Tacotron2 (B={TACO_B}) and WaveRNN "
          f"(B={WRNN_B} x {WRNN_FRAMES} frames) train steps at full width, and both recipes' --overfit gates")
    t19 = time.perf_counter()
    reset_kernel_counts()
    phase19 = {"serving": run_tts_serving(dev, card)}
    require_no_launch("phase 19 (a), serving")
    phase19["cpu"] = run_tts_against_cpu(dev)
    require_no_launch("phase 19 (b), the card against the CPU")
    phase19["train"] = run_tts_train(dev, card)
    phase19_launches = phase19["train"]["launches"]
    print(f"  launches of K1-K9 (every route) in phase 19: {phase19_launches} (K2 on 'fft' while the train targets "
          "were built, and no other kernel: Tacotron2's and WaveRNN's recurrences are plain products)")
    phase19["seconds"] = time.perf_counter() - t19
    print(f"  phase 19 took {phase19['seconds']:.1f} s")

    # ---------------------------------------------------------------- phase 20
    print(f"phase 20: wav2vec2 ASR serving (WAV2VEC2_ASR_BASE_960H at full width on {P20_B} clips of {P20_SECONDS} s, "
          f"cuda_ctc_decoder on the card, the lexicon ctc_decoder with a 3-gram LM on the host) and bundle alignment "
          f"(MMS_FA's tokenizer and aligner on {P20_FA_B} clips)")
    t20 = time.perf_counter()
    reset_kernel_counts()
    phase20 = {"asr": run_asr_serving(dev, card)}
    torch.cuda.synchronize()
    if any(kernel_counts().values()):
        raise AssertionError(f"phase 20 (a)-(c) launched the port's kernels: "
                             f"{ {n: c for n, c in kernel_counts().items() if c} } (none is on these paths)")
    phase20["alignment"] = run_bundle_alignment(dev, card)
    phase20_launches = {"viterbi": phase20["alignment"]["k3_launches"]}
    print(f"  launches of K1-K9 in phase 20: {phase20_launches} (K3 in the aligner; the decoders and the model "
          "launch none)")
    phase20["seconds"] = time.perf_counter() - t20
    print(f"  phase 20 took {phase20['seconds']:.1f} s")

    kernels = []
    # K1 on the chain's lowpass biquad: route chunked (the plan's launch included), route serial
    # (the kernel it replaced); then at the gradient path's orders 8 and 12 on both routes
    k1_ms = cuda_ms(lambda: cuda_iir.lfilter_fused(x1, a_lp, b_lp), 20)
    k1_serial_ms = cuda_ms(lambda: cuda_iir._lfilter_launch("serial", x1, a_lp, b_lp), 20)
    k1_plain = cuda_ms(lambda: cuda_iir.lfilter_plain(x1, a_lp, b_lp), 3)
    # x read once and y written once; the plan (a few KB) is not counted
    k1_bound = bound_ms(2 * x1.numel() * 4, 2 * x1.numel() * (a_lp.shape[1] + b_lp.shape[1] - 1))
    print(f"  K1 lfilter at the main shape (order 2): route chunked {k1_ms:.4f} ms (the plan's launch included), "
          f"route serial (the kernel it replaced) {k1_serial_ms:.4f} ms on {card}")
    k1_orders = {}
    for order in (8, 12):
        a_o = (filter_grad[order]["a"] / filter_grad[order]["a"][0]).reshape(1, -1).contiguous()
        b_o = (filter_grad[order]["b"] / filter_grad[order]["a"][0]).reshape(1, -1).contiguous()
        k1_orders[str(order)] = {route: cuda_ms(lambda r=route: cuda_iir._lfilter_launch(r, x1, a_o, b_o), 10)
                                 for route in ("chunked", "serial")}
        print(f"  K1 lfilter at order {order} (8192x1x16000, the gradient path's filter): route chunked "
              f"{k1_orders[str(order)]['chunked']:.4f} ms, route serial {k1_orders[str(order)]['serial']:.4f} ms "
              f"on {card}")
    kernels.append(dict(name="lfilter", route="cuda", source="audio_tpu_torch/csrc/lfilter.cu",
                        replaces="audio_tpu/ops/pallas_iir.py:267", launches=launches["lfilter"],
                        max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound[0],
                        bound_by=k1_bound[1], library_ms=None, kernel_route=cuda_iir.lfilter_route(3, 3),
                        serial_ms=k1_serial_ms, orders=k1_orders))
    # K2
    n_freq = N_FFT // 2 + 1
    m_rows = B * n_frames
    k2_ms = cuda_ms(lambda: cuda_spectrogram.power_spectrogram(x2, window, N_FFT, HOP, 2.0, fb=fb), 10)
    k2_dft_ms = cuda_ms(lambda: cuda_spectrogram._power_spectrogram_kernel(x2, window, N_FFT, HOP, 2.0, fb,
                                                                           route="dft"), 5)
    print(f"  K2 power_spectrogram at the main shape: route fft {k2_ms:.4f} ms, route dft (the kernel it replaced "
          f"on this path) {k2_dft_ms:.4f} ms on {card}")
    # the same frames without the mel product: the power spectra, 201 bins a frame, to device memory
    k2_power_ms = cuda_ms(lambda: cuda_spectrogram.power_spectrogram(x2, window, N_FFT, HOP, 2.0), 10)
    k2_power_bound = bound_ms(4 * (x2.numel() + window.numel() + m_rows * n_freq),
                              m_rows * (N_FFT + 2.5 * N_FFT * math.log2(N_FFT) + 3 * n_freq))
    print(f"  K2 route fft without the mel product (power, {n_freq} bins a frame): {k2_power_ms:.4f} ms, bound "
          f"{k2_power_bound[0]:.4f} ms ({k2_power_bound[1]}) on {card}")
    k2_plain = cuda_ms(lambda: cuda_spectrogram.power_spectrogram_plain(x2, window, N_FFT, HOP, 2.0, fb=fb), 3)

    def library_k2():
        spec = torch.stft(x2, N_FFT, HOP, window=window, center=False, return_complex=True)
        return (spec.real**2 + spec.imag**2).transpose(1, 2) @ fb

    lib_err = float((library_k2() - cuda_spectrogram.power_spectrogram_plain(x2, window, N_FFT, HOP, 2.0, fb=fb))
                    .abs().max())
    print(f"  K2 library path (torch.stft -> power -> @ fb) differs from the plain version by {lib_err:.3e}")
    k2_lib = cuda_ms(library_k2, 5)
    # the function's work, not K2's design (a DFT product): per frame the window, a real FFT
    # (~2.5 n log2 n operations), the power, and the mel product over fb's nonzeros
    fb_nnz = int((fb != 0).sum())
    k2_bound = bound_ms(
        4 * (x2.numel() + window.numel() + fb.numel() + m_rows * N_MELS),
        m_rows * (N_FFT + 2.5 * N_FFT * math.log2(N_FFT) + 3 * n_freq + 2 * fb_nnz),
    )
    kernels.append(dict(name="power_spectrogram", route="cuda", source="audio_tpu_torch/csrc/spectrogram.cu",
                        replaces="audio_tpu/ops/pallas_spectrogram.py:194",
                        launches=launches["power_spectrogram"], max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain,
                        bound_ms=k2_bound[0], bound_by=k2_bound[1], library_ms=k2_lib, kernel_route="fft",
                        phase15_launches=phase15_launches["power_spectrogram"],
                        phase17_launches=phase17_launches["power_spectrogram"],
                        phase19_launches=phase19_launches["power_spectrogram"]))
    # K3: the frames this run's lengths make the DP run
    k3_ms = cuda_ms(lambda: cuda_viterbi.viterbi_paths(*k3_args), 20)
    k3_block_ms = cuda_ms(lambda: cuda_viterbi._launch("block", *k3_args), 20)
    k3_plain = cuda_ms(lambda: cuda_viterbi.viterbi_paths_plain(*k3_args), 3)
    print(f"  K3 viterbi at the main shape: route {k3_route} {k3_ms:.4f} ms, route block (the kernel it replaced) "
          f"{k3_block_ms:.4f} ms on {card}")
    s = 2 * L + 1
    frames_run = int(il_main.clamp(max=n_frames).sum())
    k3_bound = bound_ms(4 * em_main.numel() + B * s * (4 + 2) + 8 * B + 4 * B * n_frames,
                        6 * s * frames_run)
    kernels.append(dict(name="viterbi", route="cuda", source="audio_tpu_torch/csrc/viterbi.cu",
                        replaces="audio_tpu/ops/pallas_viterbi.py:142", launches=launches["viterbi"],
                        max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain, bound_ms=k3_bound[0],
                        bound_by=k3_bound[1], library_ms=None, kernel_route=k3_route, block_ms=k3_block_ms,
                        phase13_launches=wav2vec2["forced_alignment"]["k3_launches"],
                        phase20_launches=phase20_launches["viterbi"]))
    # K5-K8 at the main shape in bf16, K5's and K7's weights as the search passes them (a
    # Linear's layout); launches from the runs of the paths that take them
    inp = slice2_kernel_inputs(np.random.default_rng(2), dev, n_main, RNNT_D, RNNT_V, RNNT_H, torch.bfloat16)
    ls = inp["lstm_linear"]
    k_outputs = n_main * (4 + 4 + RNNT_BEAM * 8)  # lse, blank, k values and k indices a row
    timed = {
        "join_stats_topk": (
            lambda: cuda_rnnt_lps.join_stats_topk(inp["act"], inp["w_linear"], inp["b"], RNNT_BLANK, RNNT_BEAM),
            lambda: cuda_rnnt_lps.join_stats_topk_plain(inp["act"], inp["w_linear"], inp["b"], RNNT_BLANK,
                                                        RNNT_BEAM),
            # the product on the tensor cores (bf16 inputs); the reductions are small beside it
            bound_ms(2 * (n_main * RNNT_D + RNNT_D * RNNT_V + RNNT_V) + k_outputs,
                     2 * n_main * RNNT_D * RNNT_V, PEAK_BF16_PER_S),
            "audio_tpu/ops/pallas_rnnt_lps.py:245", rnnt_launches["join_stats_topk"]),
        "row_stats_topk": (
            lambda: cuda_rnnt_lps.row_stats_topk(inp["logits"], RNNT_BLANK, RNNT_BEAM),
            lambda: cuda_rnnt_lps.row_stats_topk_plain(inp["logits"], RNNT_BLANK, RNNT_BEAM),
            # per element a maximum, an exponential and a sum, and a compare for the top-k
            bound_ms(2 * n_main * RNNT_V + k_outputs, 4 * n_main * RNNT_V),
            "audio_tpu/ops/pallas_rnnt_lps.py:150", tanh_launches["row_stats_topk"]),
        "lstm_gate_step": (
            lambda: cuda_lstm.lstm_gate_step(**ls, eps=1e-3),
            lambda: cuda_lstm.lstm_gate_step_plain(**ls, eps=1e-3),
            # gx, h, c read and h', c' written in bf16, W and the LayerNorm parameters once
            bound_ms(2 * (n_main * 4 * RNNT_H + 4 * n_main * RNNT_H + RNNT_H * 4 * RNNT_H + 10 * RNNT_H),
                     2 * n_main * RNNT_H * 4 * RNNT_H, PEAK_BF16_PER_S),
            "audio_tpu/ops/pallas_lstm.py:75", rnnt_launches["lstm_gate_step"]),
        "lattice_row_stats": (
            lambda: cuda_rnnt_lps.lattice_row_stats(inp["logits"], inp["tgt"], RNNT_BLANK),
            lambda: cuda_rnnt_lps.lattice_row_stats_plain(inp["logits"], inp["tgt"], RNNT_BLANK),
            bound_ms(2 * n_main * RNNT_V + n_main * (4 + 12), 3 * n_main * RNNT_V),
            "audio_tpu/ops/pallas_rnnt_lps.py:61", route_launches["lattice_row_stats"]),
    }
    for name, (kernel_fn, plain_fn, bound, replaces, count) in timed.items():
        source = "lstm" if name == "lstm_gate_step" else "rnnt_lps"
        kernels.append(dict(name=name, route="cuda", source=f"audio_tpu_torch/csrc/{source}.cu", replaces=replaces,
                            launches=count, max_abs_err=s2_err[name], ms=cuda_ms(kernel_fn, 10),
                            plain_ms=cuda_ms(plain_fn, 3), bound_ms=bound[0], bound_by=bound[1], library_ms=None))
        if name in phase15_launches:
            kernels[-1]["phase15_launches"] = phase15_launches[name]
        if name in phase16_launches:
            kernels[-1]["phase16_launches"] = phase16_launches[name]
            kernels[-1]["phase16_f32"] = {k: avsr["train"]["k8"][k] for k in ("err", "ms", "plain_ms", "bound_ms")}
    kernels[-4]["kernel_route"] = "wgmma"  # K5
    # K6: the routes it replaced on this path ("row") and past k = 32 ("row", "global"), timed at the
    # tick's shape beside "stream", and torch.topk of the candidates alone (it computes less: no
    # statistics, and its order among equal values is unspecified), a yardstick, not the library call
    k6_row_ms, k6_global_ms = (cuda_ms(lambda r=r: cuda_rnnt_lps._row_stats_launch(
        r, inp["logits"], RNNT_BLANK, RNNT_BEAM), 10) for r in ("row", "global"))
    k6_topk_ms = cuda_ms(lambda: torch.topk(inp["logits"][:, :RNNT_BLANK], RNNT_BEAM), 10)
    # and past route "row"'s columns: the 12 rows of V 58,114 that check_fallback_routes hands the search
    wide = torch.as_tensor(np.random.default_rng(14).standard_normal((12, 58114)).astype(np.float32) * 4,
                           device=dev).to(torch.bfloat16)
    k6_wide = {r: cuda_ms(lambda r=r: cuda_rnnt_lps._row_stats_launch(r, wide, 58113, RNNT_BEAM), 20)
               for r in ("stream", "global")}
    print(f"  K6 row_stats_topk at (12, 58114) bf16, k {RNNT_BEAM}: route stream {k6_wide['stream']:.4f} ms, route "
          f"global {k6_wide['global']:.4f} ms on {card}")
    kernels[-3].update(kernel_route=cuda_rnnt_lps.row_stats_route(torch.bfloat16, RNNT_BLANK, RNNT_BEAM),
                       row_ms=k6_row_ms, global_ms=k6_global_ms, topk_ms=k6_topk_ms, v58114_ms=k6_wide)
    k6_tick = tanh_tick["launches_per_tick"]["row_stats_topk"]
    tanh_tick["k6_saving_ms"] = k6_tick * (k6_row_ms - kernels[-3]["ms"])
    print(f"  K6 row_stats_topk at the tick's shape: route stream {kernels[-3]['ms']:.4f} ms, route row (the kernel "
          f"it replaced) {k6_row_ms:.4f} ms, route global {k6_global_ms:.4f} ms, torch.topk of the candidates alone "
          f"{k6_topk_ms:.4f} ms; {k6_tick:g} launches a tanh-joiner tick x (row - stream) = "
          f"{tanh_tick['k6_saving_ms']:.4f} ms a tick, against the tick's busy time "
          f"{tanh_tick['profile']['busy_ms']:.3f} ms on {card}")
    kernels[-2]["kernel_route"] = "wgmma"  # K7
    # K8: the route it replaced at the tick's shape (its 42 MB fit in L2), and both routes on the
    # train step's lattices, which do not
    k8_row_ms = cuda_ms(lambda: cuda_rnnt_lps._lattice_launch("row", inp["logits"], inp["tgt"], RNNT_BLANK), 10)
    kernels[-1].update(kernel_route="stream", row_ms=k8_row_ms,
                       **{label.replace(" ", "_"): {k: v for k, v in r.items() if k != "err"}
                          for label, r in k8_train.items()})
    print(f"  K8 lattice_row_stats at the tick's shape: route stream {kernels[-1]['ms']:.4f} ms, route row (the "
          f"kernel it replaced) {k8_row_ms:.4f} ms on {card}")
    # K5's yardsticks: the wmma route it replaced, and the product alone (it computes less: no
    # statistics, and it writes the (N, V) logits)
    join_args = (inp["act"], inp["w_linear"], inp["b"], RNNT_BLANK, RNNT_BEAM)
    join_outs = cuda_rnnt_lps._stats_outputs((n_main,), RNNT_BEAM, dev)
    k5_wmma_ms = cuda_ms(lambda: cuda_rnnt_lps._join_launch("wmma", *join_args, join_outs), 10)
    k5_linear_ms = cuda_ms(lambda: torch.nn.functional.linear(inp["act"], inp["w_linear"].t(), inp["b"]), 10)
    print(f"  K5 join_stats_topk at the main shape: route wgmma {kernels[-4]['ms']:.4f} ms, route wmma (the kernel "
          f"it replaced on this path) {k5_wmma_ms:.4f} ms, the product alone (F.linear, bf16) {k5_linear_ms:.4f} ms "
          f"on {card}")
    # K7's yardsticks: the wmma route it replaced, and the product alone, h W^T (N, 4H) in bf16 (it
    # computes less: no gx, no LayerNorms, and it writes the (N, 4H) gates)
    lstm_args = [ls[k] for k in ("gx", "h", "c", "w_p2g", "g_scale", "g_bias", "c_scale", "c_bias")]
    k7_wmma_ms = cuda_ms(lambda: cuda_lstm._launch("wmma", *lstm_args, 1e-3), 10)
    k7_linear_ms = cuda_ms(lambda: torch.nn.functional.linear(ls["h"], ls["w_p2g"].t()), 10)
    print(f"  K7 lstm_gate_step at the main shape: route wgmma {kernels[-2]['ms']:.4f} ms, route wmma (the kernel it "
          f"replaced on this path) {k7_wmma_ms:.4f} ms, the product alone (F.linear, bf16) {k7_linear_ms:.4f} ms "
          f"on {card}")
    # K4 as the gradient path runs it: the order-2 recurrence backwards in time
    a_tail = (fg["a"][1:] / fg["a"][0]).reshape(1, -1).contiguous()
    k4_ms = cuda_ms(lambda: cuda_iir.iir_allpole(x1, a_tail, reverse=True), 20)
    k4_serial_ms = cuda_ms(lambda: cuda_iir._iir_launch("serial", x1, a_tail, True), 20)
    k4_plain = cuda_ms(lambda: cuda_iir.iir_plain(x1, a_tail, reverse=True), 3)
    # x read once and y written once; the plan (a few KB) is not counted
    k4_bound = bound_ms(2 * x1.numel() * 4, 2 * x1.numel() * a_tail.shape[1])
    kernels.append(dict(name="iir", route="cuda", source="audio_tpu_torch/csrc/iir.cu",
                        replaces="audio_tpu/ops/pallas_iir.py:161", launches=fg["launches"]["iir"],
                        max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain, bound_ms=k4_bound[0], bound_by=k4_bound[1],
                        library_ms=None, kernel_route=cuda_iir.kernel_route(a_tail.shape[1])))
    print(f"  K4 iir at the main shape (order 2, reversed): route chunked {k4_ms:.4f} ms (the plan's launch included), "
          f"route serial (the kernel it replaced) {k4_serial_ms:.4f} ms on {card}")
    # K9 at the train step's shape in bf16; each direction alone (the backward through a kept
    # graph); the library call is scaled_dot_product_attention with the combined additive mask
    kernels += time_attention(np.random.default_rng(4), dev, k9_main, k9_err,
                              train["full"]["launches"])
    for k in kernels:
        lib = "n/a" if k["library_ms"] is None else f"{k['library_ms']:.3f}"
        print(f"  {k['name']}: {k['ms']:.3f} ms (bound {k['bound_ms']:.3f} ms by {k['bound_by']}; plain "
              f"{k['plain_ms']:.3f} ms; library {lib} ms) on {card}")

    result = {"kernels": kernels}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "card": card, "torch": torch.__version__, "chain_ms": chain_ms,
                       "chain_runs_ms": step_ms, "streams_rtf0.1": chain_streams, "launches": launches,
                       "profile": breakdown, "rnnt_launches": rnnt_launches,
                       "rnnt_tick": {("static" if k else "early_exit"): v for k, v in ticks.items()},
                       "rnnt_tick_tanh": tanh_tick, "rnnt_tanh_launches": tanh_launches, "k5_few_candidates": k5_few,
                       "train_step": train, "k2_dft_ms": k2_dft_ms, "k2_power_ms": k2_power_ms, "k5_wmma_ms": k5_wmma_ms,
                       "k5_linear_ms": k5_linear_ms, "k7_wmma_ms": k7_wmma_ms, "k7_linear_ms": k7_linear_ms,
                       "k4_serial_ms": k4_serial_ms, "k1_serial_ms": k1_serial_ms, "k1_orders": k1_orders,
                       "k8_row_ms": k8_row_ms, "k8_train": k8_train, "k3_block_ms": k3_block_ms,
                       "filter_grad": {str(o): {k: v for k, v in r.items() if k not in ("a", "b")}
                                       for o, r in filter_grad.items()},
                       "effects": effects, "vocoder": vocoder, "front_end": front_end, "transforms": transforms,
                       "wav2vec2": wav2vec2, "ssl": ssl, "conformer": conformer, "avsr": avsr, "zoo": zoo,
                       "phase18": phase18, "phase19": phase19, "phase20": phase20},
                      f, indent=1)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
