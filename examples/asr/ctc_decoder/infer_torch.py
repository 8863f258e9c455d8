#!/usr/bin/env python3
"""CTC beam-search decoding on the PyTorch port: the lexicon decoder with an LM, and the batched prefix search.

The port of ``infer.py``.  Two decoders run on the same emissions:
  1. ``ctc_decoder``, the lexicon beam search on the host (its native C++ core), the flashlight-text equivalent;
  2. ``cuda_ctc_decoder``, the batched prefix beam search on the card (on ``--device``).

Offline by default: peaked emissions that spell "the editor" in a toy vocabulary, with a lexicon the script writes.
``--wav`` decodes an audio file (read by ``audio_tpu_torch.io.load``) with a wav2vec2 ASR bundle (``--bundle``)
whose weights come from ``--state-dict`` (a ``torch.save``d torchaudio-named ``state_dict``); without one it raises,
and nothing is fetched.

    python3 examples/asr/ctc_decoder/infer_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from audio_tpu_torch.io import load as read_wav  # noqa: E402  (channels-first float32 and the rate)
from audio_tpu_torch.models.decoder import ctc_decoder, cuda_ctc_decoder  # noqa: E402

TOKENS = ["-", "|", "e", "t", "a", "o", "n", "i", "h", "s", "r", "d"]


def synthetic_emissions(transcript_tokens, vocab_size, t_per_token=3, seed=0):
    """Peaked log-prob emissions (1, T, V) that spell out ``transcript_tokens``."""
    rng = np.random.default_rng(seed)
    frames = []
    for tok in transcript_tokens:
        for _ in range(t_per_token):
            row = np.full((vocab_size,), -8.0)
            row[tok] = -0.05
            frames.append(row + 0.01 * rng.standard_normal(vocab_size))
        blank = np.full((vocab_size,), -8.0)
        blank[0] = -0.05
        frames.append(blank)
    e = np.stack(frames)[None].astype(np.float32)
    return torch.as_tensor(e - np.log(np.exp(e).sum(-1, keepdims=True)))


def bundle_emissions(args, dev):
    """The bundle's log-probs of ``--wav`` (its first channel, resampled to the bundle's rate)."""
    import audio_tpu_torch.functional as F
    from audio_tpu_torch import pipelines

    if args.state_dict is None:
        raise ValueError("--wav needs --state-dict: the bundle's weights are not fetched here")
    bundle = getattr(pipelines, args.bundle)
    model = bundle.get_model(dl_kwargs={"state_dict": torch.load(args.state_dict, weights_only=True)}, device=dev)
    wav, sr = read_wav(args.wav)
    wav = wav[:1].to(dev)
    if sr != bundle.sample_rate:
        wav = F.resample(wav, sr, int(bundle.sample_rate))
    with torch.no_grad():
        emissions, _ = model(wav)
    return torch.log_softmax(emissions, -1), list(bundle.get_labels())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--beam-size", type=int, default=50)
    p.add_argument("--lm-weight", type=float, default=2.0)
    p.add_argument("--word-score", type=float, default=0.0)
    p.add_argument("--wav", default=None, help="decode an audio file (WAV, FLAC, ...) with --bundle")
    p.add_argument("--bundle", default="WAV2VEC2_ASR_BASE_960H")
    p.add_argument("--state-dict", default=None, help="the bundle's weights, a torch.save'd state_dict")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    with tempfile.TemporaryDirectory() as folder:
        if args.wav:
            emissions, tokens = bundle_emissions(args, dev)
            lexicon = None  # lexicon-free
        else:
            # "the editor" in the toy vocabulary (| is the word boundary each lexicon spelling ends with)
            emissions = synthetic_emissions([TOKENS.index(c) for c in "the|editor|"], len(TOKENS))
            tokens = TOKENS
            lexicon = os.path.join(folder, "lexicon.txt")
            with open(lexicon, "w") as f:
                f.write("the t h e |\neditor e d i t o r |\n")

        # 1. the lexicon beam search on the host
        decoder = ctc_decoder(lexicon=lexicon, tokens=tokens, nbest=3, beam_size=args.beam_size,
                              lm_weight=args.lm_weight, word_score=args.word_score)
        best = decoder(emissions.cpu())[0][0]
    print("lexicon beam search:")
    print(f"  words:  {' '.join(best.words)}")
    print(f"  tokens: {decoder.idxs_to_tokens(best.tokens)}")
    print(f"  score:  {best.score:.3f}")

    # 2. the batched prefix beam search on the card
    lengths = torch.full((emissions.shape[0],), emissions.shape[1], dtype=torch.int32, device=dev)
    batch_decoder = cuda_ctc_decoder(tokens, nbest=3, beam_size=args.beam_size)
    top = batch_decoder(emissions.to(dev), lengths)[0][0]
    print("batched prefix beam search:")
    print(f"  tokens: {[tokens[i] for i in top.tokens]}")
    print(f"  score:  {top.score:.3f}")
    return best, top


if __name__ == "__main__":
    main()
