"""Text-to-speech with Tacotron2, on the PyTorch port.

Counterpart of ``tacotron2_pipeline_tutorial.py``: text -> characters -> Tacotron2 -> mel spectrogram -> vocoder
(WaveRNN or Griffin-Lim) -> waveform.  Offline by default: a tiny Tacotron2 (the JAX tutorial's widths, 16 mels, at
most 40 steps, no prenet dropout) with weights from a seed, or from ``state_dict``, then Griffin-Lim at n_fft 400.
``--download`` synthesizes with ``TACOTRON2_WAVERNN_CHAR_LJSPEECH`` (or ``TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH`` with
``--vocoder griffinlim``) on their checkpoints; ``synthesize`` takes a bundle and, for each model, an injected
``state_dict``.

    python examples/tutorials/tacotron2_pipeline_tutorial_torch.py [--device cpu] [--download --vocoder wavernn]
"""

import argparse
from typing import Optional

import torch

TEXT = "Hello world! Text to speech!"
SYMBOLS = "_-!'(),.:;? abcdefghijklmnopqrstuvwxyz"
OFFLINE_CONFIG = dict(n_symbol=len(SYMBOLS), symbol_embedding_dim=32, encoder_embedding_dim=32,
                      encoder_n_convolution=1, encoder_kernel_size=3, n_mels=16, attention_rnn_dim=32,
                      attention_hidden_dim=32, attention_location_n_filter=4, attention_location_kernel_size=7,
                      decoder_rnn_dim=32, prenet_dim=16, postnet_embedding_dim=32, postnet_kernel_size=3,
                      postnet_n_convolution=2, decoder_max_step=40, gate_threshold=0.5)


def synthesize(bundle, text: str = TEXT, device="cuda", tacotron2_state_dict: Optional[dict] = None,
               vocoder_state_dict: Optional[dict] = None, generator: Optional[torch.Generator] = None):
    """``bundle``'s text processor -> Tacotron2 ``infer`` (prenet dropout on, as the bundle's model runs it) ->
    vocoder: (tokens, mel, mel lengths, waveform, waveform lengths, sample rate).  Each ``*_state_dict``
    (torchaudio's names) replaces the bundle's checkpoint."""
    processor = bundle.get_text_processor()
    tacotron2 = bundle.get_tacotron2(device=device, dl_kwargs=(
        None if tacotron2_state_dict is None else {"state_dict": tacotron2_state_dict}))
    vocoder = bundle.get_vocoder(device=device, dl_kwargs=(
        None if vocoder_state_dict is None else {"state_dict": vocoder_state_dict}))
    tokens, lengths = processor(text)
    tokens, lengths = tokens.to(device), lengths.to(device)
    with torch.no_grad():
        mel, mel_lengths, _ = tacotron2.infer(tokens, lengths, generator=generator)
        wav, wav_lengths = vocoder(mel, mel_lengths, generator=generator)
    return tokens, mel, mel_lengths, wav, wav_lengths, vocoder.sample_rate


def offline(device="cuda", state_dict: Optional[dict] = None, generator: Optional[torch.Generator] = None):
    """The offline path: ``TEXT`` -> characters -> the tiny Tacotron2 (``state_dict``, or weights drawn from seed 0)
    -> ``infer`` without prenet dropout -> ``InverseMelScale`` (201 bins) -> 4 iterations of ``GriffinLim`` at n_fft
    400: (tokens, lengths, mel, mel lengths, linear spectrogram, waveform)."""
    from audio_tpu_torch.models import Tacotron2
    from audio_tpu_torch.transforms import GriffinLim, InverseMelScale

    lookup = {c: i for i, c in enumerate(SYMBOLS)}
    tokens = torch.tensor([[lookup[c] for c in TEXT.lower() if c in lookup]], dtype=torch.int64, device=device)
    lengths = torch.tensor([tokens.shape[1]], dtype=torch.int64, device=device)
    model = Tacotron2(**OFFLINE_CONFIG, device=device,
                      generator=None if state_dict is not None else torch.Generator(device=device).manual_seed(0))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        mel, mel_lengths, _ = model.eval().infer(tokens, lengths, prenet_dropout=False)
        linear = InverseMelScale(n_stft=201, n_mels=16, sample_rate=22050, device=device)(torch.exp(mel))
        wav = GriffinLim(n_fft=400, n_iter=4, device=device)(linear, generator=generator)
    return tokens, lengths, mel, mel_lengths, linear, wav


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--download", action="store_true")
    p.add_argument("--vocoder", default="griffinlim", choices=("wavernn", "griffinlim"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    if args.download:
        from audio_tpu_torch import pipelines

        bundle = (pipelines.TACOTRON2_WAVERNN_CHAR_LJSPEECH if args.vocoder == "wavernn"
                  else pipelines.TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH)
        tokens, mel, _, wav, _, sample_rate = synthesize(bundle, TEXT, dev)
        print(f"text {TEXT!r} -> tokens {tuple(tokens.shape)} -> mel {tuple(mel.shape)} "
              f"-> waveform {tuple(wav.shape)} @ {sample_rate} Hz")
        return

    tokens, _, mel, mel_lengths, linear, wav = offline(dev)
    print(f"text processor: {TEXT!r} -> {tuple(tokens.shape)}")
    print(f"tacotron2 infer: mel {tuple(mel.shape)} (B, n_mels, T), lengths {mel_lengths.tolist()}")
    print(f"griffinlim vocoder: {tuple(linear.shape)} -> waveform {tuple(wav.shape)}")


if __name__ == "__main__":
    main()
