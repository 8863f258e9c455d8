"""Forced alignment with a wav2vec2 acoustic model, on the PyTorch port.

Counterpart of ``forced_alignment_tutorial.py``: emissions from a wav2vec2 ASR bundle, a transcript aligned to them
(``functional.forced_align``, kernel K3 on the card), and the frame path merged into word time spans.  Offline by
default: ``WAV2VEC2_ASR_BASE_960H``'s bundle class at a tiny width, its weights a seeded ``state_dict``, on synthetic
audio.  ``--state-dict`` (a ``torch.save``d torchaudio-named ``state_dict``) runs the full bundle; nothing is fetched.

    python examples/tutorials/forced_alignment_tutorial_torch.py [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

import audio_tpu_torch.functional as F
from audio_tpu_torch import pipelines
from audio_tpu_torch.models import wav2vec2_model

SAMPLE_RATE = 16000
TINY = dict(extractor_mode="group_norm", extractor_conv_layer_config=[(32, 10, 5), (32, 3, 2), (32, 2, 2)],
            extractor_conv_bias=False, encoder_embed_dim=64, encoder_projection_dropout=0.0, encoder_pos_conv_kernel=15,
            encoder_pos_conv_groups=1, encoder_num_layers=2, encoder_num_heads=4, encoder_attention_dropout=0.0,
            encoder_ff_interm_features=128, encoder_ff_interm_dropout=0.0, encoder_dropout=0.0,
            encoder_layer_norm_first=False, encoder_layer_drop=0.0, aux_num_out=29)


def tiny_bundle(bundle, aux_rows: int, seed: int = 0):
    """``bundle`` at the tiny width, and a seeded torchaudio-named ``state_dict`` with ``aux_rows`` aux rows (the
    published checkpoints' rows, before the bundle drops its unused labels)."""
    tiny = dataclasses.replace(bundle, _params={**TINY, "aux_num_out": bundle._params["aux_num_out"]})
    model = wav2vec2_model(**{**TINY, "aux_num_out": aux_rows}, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    return tiny, {k: v.detach().clone() for k, v in model.state_dict().items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--state-dict", default=None, help="the full bundle's weights, a torch.save'd state_dict")
    p.add_argument("--transcript", default="i had that curiosity beside me")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    bundle = pipelines.WAV2VEC2_ASR_BASE_960H
    if args.state_dict:
        sd = torch.load(args.state_dict, weights_only=True)
    else:
        bundle, sd = tiny_bundle(bundle, aux_rows=32)
    model = bundle.get_model(dl_kwargs={"state_dict": sd}, device=dev)
    labels = [c.lower() for c in bundle.get_labels()]
    wav = torch.as_tensor(0.1 * np.random.default_rng(0).standard_normal((1, 2 * SAMPLE_RATE)), dtype=torch.float32,
                          device=dev)
    with torch.no_grad():
        emissions, _ = model(wav)
    emission = torch.log_softmax(emissions, -1)
    print(f"emission: {tuple(emission.shape)}  (B, frames, vocab {len(labels)})")

    # tokenize the transcript (| = word separator, as in the bundles)
    dictionary = {c: i for i, c in enumerate(labels)}
    tokens = [dictionary[c] for c in args.transcript.lower().replace(" ", "|") if c in dictionary]
    targets = torch.tensor([tokens], dtype=torch.int32, device=dev)
    paths, scores = F.forced_align(emission, targets, blank=0)
    spans = F.merge_tokens(paths[0], scores[0].exp(), blank=0)

    # group the token spans into words at the | separators
    frames_per_sec = emission.shape[1] / (wav.shape[-1] / SAMPLE_RATE)
    words, current = [], []
    for s in spans:
        if labels[s.token] == "|":
            if current:
                words.append(current)
            current = []
        else:
            current.append(s)
    if current:
        words.append(current)
    for word_spans in words[:8]:
        word = "".join(labels[s.token] for s in word_spans)
        print(f"  {word:>12s}: {word_spans[0].start / frames_per_sec:6.2f}s - "
              f"{word_spans[-1].end / frames_per_sec:6.2f}s")
    return ["".join(labels[s.token] for s in w) for w in words]


if __name__ == "__main__":
    main()
