"""Multilingual forced alignment with the MMS_FA bundle, on the PyTorch port.

Counterpart of ``forced_alignment_for_multilingual_data_tutorial.py``: the MMS_FA bundle aligns romanized text in any
language; its model appends a star column for frames the transcript does not cover.  Offline by default: the bundle's
class at a tiny width with a seeded ``state_dict`` through its model, tokenizer and aligner (kernel K3 on the card), then
the star token's trellis on a toy emission.  ``--state-dict`` (a ``torch.save``d torchaudio-named ``state_dict``)
runs the full bundle; nothing is fetched.

    python examples/tutorials/forced_alignment_for_multilingual_data_tutorial_torch.py [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

import audio_tpu_torch.functional as F
from audio_tpu_torch import pipelines
from audio_tpu_torch.models import wav2vec2_model

TINY = dict(extractor_mode="layer_norm", extractor_conv_layer_config=[(32, 10, 5), (32, 3, 2), (32, 2, 2)],
            extractor_conv_bias=True, encoder_embed_dim=64, encoder_projection_dropout=0.0, encoder_pos_conv_kernel=15,
            encoder_pos_conv_groups=1, encoder_num_layers=2, encoder_num_heads=4, encoder_attention_dropout=0.0,
            encoder_ff_interm_features=128, encoder_ff_interm_dropout=0.0, encoder_dropout=0.0,
            encoder_layer_norm_first=True, encoder_layer_drop=0.0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--state-dict", default=None, help="the full MMS_FA bundle's weights, a torch.save'd state_dict")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    bundle = pipelines.MMS_FA
    if args.state_dict:
        sd = torch.load(args.state_dict, weights_only=True)
    else:  # the checkpoint's 31 aux rows, of which the bundle keeps 28
        bundle = dataclasses.replace(bundle, _params={**TINY, "aux_num_out": 28})
        sd = wav2vec2_model(**TINY, aux_num_out=31, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    model = bundle.get_model(with_star=True, dl_kwargs={"state_dict": sd}, device=dev)
    tokenizer, aligner = bundle.get_tokenizer(), bundle.get_aligner()
    wav = torch.as_tensor(0.1 * np.random.default_rng(0).standard_normal((1, 32000)), dtype=torch.float32, device=dev)
    with torch.no_grad():
        emission, _ = model(wav)
    words = "aqui estamos".split()
    spans = aligner(emission[0], tokenizer(words))
    print(f"MMS_FA: {tuple(emission.shape)} emission with the star column; {len(spans)} word spans:")
    for word, word_spans in zip(words, spans):
        print(f"  {word:>8s}: frames [{word_spans[0].start}, {word_spans[-1].end})")

    # the star token's trellis: blank, a, b, star; the star soaks up frames the transcript does not cover
    vocab = ["-", "a", "b", "*"]
    rng = np.random.default_rng(0)

    def frame(tok):
        row = np.full((len(vocab),), -8.0)
        row[tok] = -0.05
        return row + 0.01 * rng.standard_normal(len(vocab))

    # the audio says: a a <unmodeled> b b
    rows = [frame(1), frame(1)] + [np.full((len(vocab),), np.log(1.0 / len(vocab))) for _ in range(4)]
    rows += [frame(2), frame(2)]
    toy = torch.log_softmax(torch.as_tensor(np.stack(rows).astype(np.float32), device=dev), dim=-1)[None]
    paths, scores = F.forced_align(toy, torch.tensor([[1, 3, 2]], dtype=torch.int32, device=dev), blank=0)
    print("aligned path:", " ".join(vocab[t] for t in paths[0].tolist()))
    toy_spans = F.merge_tokens(paths[0], scores[0], blank=0)
    for s in toy_spans:
        print(f"  {vocab[s.token]!r}: frames [{s.start}, {s.end})")
    return spans, toy_spans


if __name__ == "__main__":
    main()
