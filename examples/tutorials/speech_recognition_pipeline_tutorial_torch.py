"""The speech recognition pipeline, on the PyTorch port.

Counterpart of ``speech_recognition_pipeline_tutorial.py``: a waveform through a wav2vec2 ASR bundle's model to CTC
emissions, then greedy decoding, and the intermediate features ``extract_features`` gives.  Offline by default:
``WAV2VEC2_ASR_BASE_960H``'s bundle class at a tiny width with a seeded ``state_dict``.  ``--state-dict`` (a
``torch.save``d torchaudio-named ``state_dict``) runs the full bundle; nothing is fetched.

    python examples/tutorials/speech_recognition_pipeline_tutorial_torch.py [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

from audio_tpu_torch import pipelines
from audio_tpu_torch.models import wav2vec2_model

TINY = dict(extractor_mode="group_norm", extractor_conv_layer_config=[(32, 10, 5), (32, 3, 2), (32, 2, 2)],
            extractor_conv_bias=False, encoder_embed_dim=64, encoder_projection_dropout=0.0, encoder_pos_conv_kernel=15,
            encoder_pos_conv_groups=1, encoder_num_layers=2, encoder_num_heads=4, encoder_attention_dropout=0.0,
            encoder_ff_interm_features=128, encoder_ff_interm_dropout=0.0, encoder_dropout=0.0,
            encoder_layer_norm_first=False, encoder_layer_drop=0.0)


class GreedyCTCDecoder:
    def __init__(self, labels, blank=0):
        self.labels = labels
        self.blank = blank

    def __call__(self, emission: torch.Tensor) -> str:
        """(T, V) emission -> transcript."""
        prev, out = self.blank, []
        for i in emission.argmax(dim=-1).tolist():
            if i != prev and i != self.blank:
                out.append(self.labels[i])
            prev = i
        return "".join(out).replace("|", " ").strip()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--state-dict", default=None, help="the full bundle's weights, a torch.save'd state_dict")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    bundle = pipelines.WAV2VEC2_ASR_BASE_960H
    print(f"sample rate: {bundle.sample_rate}, labels: {len(bundle.get_labels())}")
    if args.state_dict:
        sd = torch.load(args.state_dict, weights_only=True)
    else:  # the checkpoint's 32 aux rows, of which the bundle keeps 29
        bundle = dataclasses.replace(bundle, _params={**TINY, "aux_num_out": 29})
        sd = wav2vec2_model(**TINY, aux_num_out=32, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    model = bundle.get_model(dl_kwargs={"state_dict": sd}, device=dev)
    wav = torch.as_tensor(0.1 * np.random.default_rng(0).standard_normal((1, 16000)), dtype=torch.float32, device=dev)
    with torch.no_grad():
        features, _ = model.extract_features(wav)
        emissions, _ = model(wav)
    print(f"{len(features)} layers of intermediate features, each {tuple(features[0].shape)}")
    emission = torch.log_softmax(emissions, -1)[0]
    print(f"emission: {tuple(emission.shape)} (frames, vocab)")
    transcript = GreedyCTCDecoder(bundle.get_labels())(emission)
    print(f"transcript: {transcript!r}")
    return transcript


if __name__ == "__main__":
    main()
