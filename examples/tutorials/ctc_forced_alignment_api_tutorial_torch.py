"""The CTC forced-alignment API, on the PyTorch port.

Counterpart of ``ctc_forced_alignment_api_tutorial.py``: ``functional.forced_align`` (kernel K3 on the card) and
``functional.merge_tokens`` on a toy emission whose frames spell a known token sequence: the frame path, the token
spans, and a batch aligned in one call.

    python examples/tutorials/ctc_forced_alignment_api_tutorial_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import audio_tpu_torch.functional as F

TOKENS = ["-", "a", "b", "c", "d"]  # 0 = blank


def peaked_emission(token_ids, frames_per_token=3, vocab=5, seed=0):
    """(T, vocab) log-probs: each token held ``frames_per_token`` frames, then a blank frame."""
    rng = np.random.default_rng(seed)
    rows = []
    for tok in token_ids:
        for _ in range(frames_per_token):
            row = np.full((vocab,), -8.0)
            row[tok] = -0.05
            rows.append(row + 0.01 * rng.standard_normal(vocab))
        blank = np.full((vocab,), -8.0)
        blank[0] = -0.05
        rows.append(blank)
    e = np.stack(rows).astype(np.float32)
    return e - np.log(np.exp(e).sum(-1, keepdims=True))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    transcript = [1, 2, 1, 3]  # "a b a c"
    emission = torch.as_tensor(peaked_emission(transcript), device=dev)[None]
    targets = torch.tensor([transcript], dtype=torch.int32, device=dev)

    # the frame-level alignment: one (token, score) a frame
    paths, scores = F.forced_align(emission, targets, blank=0)
    print("frame path:  ", " ".join(TOKENS[t] for t in paths[0].tolist()))
    print("frame scores:", np.round(scores[0].exp().cpu().numpy(), 2))

    # repeated frames merged into TokenSpans
    spans = F.merge_tokens(paths[0], scores[0], blank=0)
    for s in spans:
        print(f"  token {TOKENS[s.token]!r}: frames [{s.start}, {s.end})  score {s.score:.3f}")

    # a batch in one call
    bpaths, _ = F.forced_align(torch.cat([emission, emission]), torch.cat([targets, targets]), blank=0)
    assert torch.equal(bpaths[0], bpaths[1])
    print(f"batched: aligned {bpaths.shape[0]} utterances in one call")
    return spans


if __name__ == "__main__":
    main()
