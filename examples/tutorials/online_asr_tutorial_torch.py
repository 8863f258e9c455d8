"""Online (streaming) ASR with Emformer RNN-T, on the PyTorch port.

Counterpart of ``online_asr_tutorial.py``: the waveform is cut into segments of ``segment_length`` feature frames
plus ``right_context_length`` frames of look-ahead; each segment goes through the streaming feature extractor and one
step of the beam search, which carries the Emformer layers' state and the beam from one segment to the next.  Here
the streams are a batch: ``stream`` pads the clips to one length, steps all of them at once with
``RNNTBeamSearch.infer_batch``, and holds a clip's beam still once its last whole segment has passed (its length is
0 from then on), so a clip decodes the same in a batch as alone.

Offline by default: a tiny Emformer RNN-T from a seeded generator and a log-mel extractor, on noise.  ``--download``
runs ``EMFORMER_RNNT_BASE_LIBRISPEECH`` at full width on the weights of ``--state-dict`` (a ``torch.save``d
torchaudio-named ``state_dict``; without it the path raises), its streaming feature extractor reading the global
statistics from the asset cache (``$AUDIO_TPU_HOME``).  Tokens are printed as ids.

    python examples/tutorials/online_asr_tutorial_torch.py [--device cpu] [--streams 3]
"""

import argparse
from typing import Callable, List

import numpy as np
import torch

from audio_tpu_torch.models import RNNTBeamSearch, emformer_rnnt_model
from audio_tpu_torch.transforms import MelSpectrogram

SAMPLE_RATE = 16000
N_MELS = 16
HOP = 160
SEG_FRAMES, RC_FRAMES = 8, 4  # the tiny model's segment and right context, in feature frames (before the reduction)


def tiny_rnnt(num_symbols=12, device="cuda", generator=None):
    """The JAX tutorial's tiny model."""
    return emformer_rnnt_model(
        input_dim=N_MELS, encoding_dim=32, num_symbols=num_symbols,
        segment_length=SEG_FRAMES, right_context_length=RC_FRAMES,
        time_reduction_input_dim=8, time_reduction_stride=4,
        transformer_num_heads=2, transformer_ffn_dim=32, transformer_num_layers=2,
        transformer_dropout=0.0, transformer_activation="gelu",
        transformer_left_context_length=8, transformer_max_memory_size=0,
        transformer_weight_init_scale_strategy="depthwise", transformer_tanh_on_mem=True,
        symbol_embedding_dim=16, num_lstm_layers=1, lstm_layer_norm=True,
        lstm_layer_norm_epsilon=1e-3, lstm_dropout=0.0, device=device, generator=generator,
    )


def tiny_feature_extractor(device):
    """The JAX tutorial's extractor: log-mel (center off), cut or zero-padded to segment + right-context frames."""
    melspec = MelSpectrogram(sample_rate=SAMPLE_RATE, n_fft=400, hop_length=HOP, n_mels=N_MELS, power=2.0,
                             center=False, device=device)
    want = SEG_FRAMES + RC_FRAMES

    def extract(chunk):
        mel = torch.log(melspec(chunk[None]).transpose(1, 2) + 1e-6)[0][:want]
        mel = torch.nn.functional.pad(mel, (0, 0, 0, want - mel.shape[0]))
        return mel, torch.tensor([want], device=chunk.device)

    return extract


def stream(decoder: RNNTBeamSearch, feature_extractor: Callable, waves: torch.Tensor, lengths: torch.Tensor,
           seg_samples: int, rc_samples: int, beam_width: int, on_segment: Callable = None):
    """Decode clips (B, L), zero-padded past ``lengths``, segment by segment; returns (each clip's best hypothesis'
    tokens after each of its segments, the final beams).

    Clip b has ``(lengths[b] - rc_samples) // seg_samples`` whole segments, as the JAX tutorial counts them for one
    clip.  Step i feeds each clip's samples ``[i * seg, i * seg + seg + rc)`` through ``feature_extractor`` and
    then all clips through one ``infer_batch``; a clip past its last segment is given length 0, so its beam stays
    as it was.  The best hypothesis is the one of highest score (the JAX tutorial's choice)."""
    b = waves.shape[0]
    n_seg = [max(0, (int(n) - rc_samples) // seg_samples) for n in lengths.tolist()]
    hypos, state = decoder.init_beams(beam_width, b), None
    history: List[List[List[int]]] = [[] for _ in range(b)]
    for i in range(max(n_seg, default=0)):
        chunk = waves[:, i * seg_samples: i * seg_samples + seg_samples + rc_samples]
        chunk = torch.nn.functional.pad(chunk, (0, seg_samples + rc_samples - chunk.shape[1]))
        feats = torch.stack([feature_extractor(chunk[j])[0] for j in range(b)])
        live = torch.tensor([i < n for n in n_seg], device=waves.device)
        frames = torch.where(live, feats.shape[1], 0).to(torch.int32)
        hypos, state = decoder.infer_batch(feats, frames, beam_width, state, hypos)
        best = torch.argmax(hypos.scores, dim=1)
        rows = torch.arange(b, device=best.device)
        counts, tokens = hypos.counts[rows, best].tolist(), hypos.tokens[rows, best].tolist()  # two host reads
        for j in range(b):
            if i < n_seg[j]:
                history[j].append([t for t in tokens[j][:counts[j]] if t > 0])
        if on_segment is not None:
            on_segment(i, history)
    return history, hypos


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--download", action="store_true",
                   help="EMFORMER_RNNT_BASE_LIBRISPEECH on the weights of --state-dict instead of the tiny model")
    p.add_argument("--state-dict", default=None, help="the bundle's weights, a torch.save'd state_dict")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--streams", type=int, default=1, help="clips decoded together, each 0.3 s shorter than the last")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    if args.download:
        from audio_tpu_torch import pipelines

        if args.state_dict is None:
            raise ValueError("--download needs --state-dict: the bundle's weights are not fetched here")
        bundle = pipelines.EMFORMER_RNNT_BASE_LIBRISPEECH
        decoder = bundle.get_decoder(dl_kwargs={"state_dict": torch.load(args.state_dict, weights_only=True)},
                                     device=dev)
        feature_extractor = bundle.get_streaming_feature_extractor(device=dev)
        seg_samples = bundle.segment_length * bundle.hop_length
        rc_samples = bundle.right_context_length * bundle.hop_length
        beam_width = 10
    else:
        model = tiny_rnnt(device=dev, generator=torch.Generator().manual_seed(0))
        decoder = RNNTBeamSearch(model, blank=0)
        feature_extractor = tiny_feature_extractor(dev)
        seg_samples, rc_samples = SEG_FRAMES * HOP, RC_FRAMES * HOP
        beam_width = 4

    n = int(args.seconds * SAMPLE_RATE)
    lengths = torch.tensor([max(0, n - int(0.3 * SAMPLE_RATE) * j) for j in range(args.streams)])
    rng = np.random.default_rng(0)
    waves = torch.zeros((args.streams, n), dtype=torch.float32)
    for j, m in enumerate(lengths.tolist()):
        waves[j, :m] = torch.as_tensor(0.1 * rng.standard_normal(m), dtype=torch.float32)
    waves = waves.to(dev)
    print(f"streaming {args.streams} clip(s) in segments of {seg_samples} samples (+{rc_samples} right context)")

    def show(i, history):
        top = history[0][-1] if history[0] and len(history[0]) == i + 1 else None
        if top is not None:
            new = len(top) - (len(history[0][-2]) if len(history[0]) > 1 else 0)
            print(f"  segment {i}: +{new} tokens -> {' '.join(map(str, top))!r}")

    history, _ = stream(decoder, feature_extractor, waves, lengths, seg_samples, rc_samples, beam_width, show)
    finals = [h[-1] if h else [] for h in history]
    for j, tokens in enumerate(finals):
        print(f"final {j}: {' '.join(map(str, tokens))!r}")
    return finals


if __name__ == "__main__":
    main()
