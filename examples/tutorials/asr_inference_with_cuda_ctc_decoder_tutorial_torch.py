"""ASR inference with the batched prefix beam search on the card, on the PyTorch port.

Counterpart of ``asr_inference_with_cuda_ctc_decoder_tutorial.py``: ``cuda_ctc_decoder`` decodes the whole batch on
the device (blank-skip pruning and a top-k over beam x vocabulary each frame, no host read until the hypotheses leave
the device).  Offline: peaked emissions of seeded transcripts.

    python examples/tutorials/asr_inference_with_cuda_ctc_decoder_tutorial_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from audio_tpu_torch.models.decoder import cuda_ctc_decoder

TOKENS = ["-", "|", "e", "t", "a", "o", "n", "i", "h", "s"]


def batch_emissions(batch, t_steps, device, seed=0):
    """(batch, t_steps, V) log-probs of seeded transcripts (each token two frames, then a blank), and the texts."""
    rng = np.random.default_rng(seed)
    texts = []
    e = np.full((batch, t_steps, len(TOKENS)), -6.0, np.float32)
    for b in range(batch):
        toks = rng.integers(2, len(TOKENS), t_steps // 3)
        texts.append("".join(TOKENS[t] for t in toks))
        for i, tok in enumerate(toks):
            e[b, 3 * i, tok] = -0.1
            e[b, 3 * i + 1, tok] = -0.1
            e[b, 3 * i + 2, 0] = -0.1
    e = e + 0.1 * rng.standard_normal(e.shape).astype(np.float32)
    return torch.log_softmax(torch.as_tensor(e, device=device), dim=-1), texts


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    batch, t_steps = 16, 60
    emissions, texts = batch_emissions(batch, t_steps, dev)
    lengths = torch.full((batch,), t_steps, dtype=torch.int32, device=dev)

    decoder = cuda_ctc_decoder(TOKENS, nbest=3, beam_size=10, blank_skip_threshold=0.95)
    t0 = time.perf_counter()
    results = decoder(emissions, lengths)
    print(f"decoded {batch} utterances in {(time.perf_counter() - t0) * 1e3:.1f} ms")

    hyps = ["".join(TOKENS[i] for i in results[b][0].tokens) for b in range(batch)]
    for b in range(min(batch, 4)):
        mark = "==" if hyps[b] == texts[b] else "!="
        print(f"[{b}] hyp {hyps[b]!r} {mark} ref {texts[b]!r}  (score {results[b][0].score:.2f})")
    print(f"{sum(h == t for h, t in zip(hyps, texts))} of {batch} transcripts decoded exactly")
    return hyps, texts


if __name__ == "__main__":
    main()
