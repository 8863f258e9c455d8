"""ASR inference with the lexicon CTC beam-search decoder, on the PyTorch port.

Counterpart of ``asr_inference_with_ctc_decoder_tutorial.py``: beam search with a lexicon, trie smearing and the native
host core against greedy decoding, the effect of the beam size, and the incremental
``decode_begin``/``decode_step``/``decode_end`` protocol.  Offline: peaked emissions with injected confusion and a
lexicon the tutorial writes.  The decoder runs on the host; ``--device`` is where the emissions are made.

    python examples/tutorials/asr_inference_with_ctc_decoder_tutorial_torch.py [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from audio_tpu_torch.models.decoder import ctc_decoder

TOKENS = ["-", "|", "e", "t", "a", "o", "n", "i", "h", "s", "r", "d", "w", "l"]
LEXICON = {"the": "t h e |", "answer": "a n s w e r |", "is": "i s |", "hello": "h e l l o |",
           "world": "w o r l d |", "hell": "h e l l |", "words": "w o r d s |"}


def peaked_emissions(text, device, noise=0.35, seed=0):
    """(1, T, V) log-probs that mostly spell ``text``, with injected confusion."""
    rng = np.random.default_rng(seed)
    rows = []
    for ch in text:
        for _ in range(2):
            row = np.full((len(TOKENS),), -6.0)
            row[TOKENS.index(ch)] = -0.1
            rows.append(row + noise * rng.standard_normal(len(TOKENS)))
        blank = np.full((len(TOKENS),), -6.0)
        blank[0] = -0.1
        rows.append(blank + noise * rng.standard_normal(len(TOKENS)))
    e = torch.as_tensor(np.stack(rows)[None].astype(np.float32), device=device)
    return torch.log_softmax(e, dim=-1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    emissions = peaked_emissions("the|answer|is|hello|world|", torch.device(args.device))

    # greedy baseline, on the emissions' device
    idx = emissions[0].argmax(-1).tolist()
    prev, greedy = 0, []
    for i in idx:
        if i != prev and i != 0:
            greedy.append(TOKENS[i])
        prev = i
    out = {"greedy": "".join(greedy).replace("|", " ")}
    print("greedy: ", out["greedy"])

    host = emissions.cpu()  # the lexicon decoder takes CPU float32 tensors
    with tempfile.TemporaryDirectory() as folder:
        lexicon = os.path.join(folder, "lexicon.txt")
        with open(lexicon, "w") as f:
            f.writelines(f"{w} {sp}\n" for w, sp in LEXICON.items())

        # lexicon-constrained beam search
        decoder = ctc_decoder(lexicon=lexicon, tokens=TOKENS, nbest=3, beam_size=50, word_score=-0.26)
        hypos = decoder(host)
        for rank, h in enumerate(hypos[0]):
            print(f"beam[{rank}]: {' '.join(h.words):<30s} score {h.score:.2f}")
        out["beam"] = [h.words for h in hypos[0]]

        # hyperparameters: a tight beam hurts
        out["beam_size"] = {}
        for beam in (1, 5, 50):
            best = ctc_decoder(lexicon=lexicon, tokens=TOKENS, beam_size=beam)(host)[0][0]
            out["beam_size"][beam] = best.words
            print(f"beam_size {beam:3d}: {' '.join(best.words)}")

        # incremental (streaming) decoding, 10 frames at a time
        decoder.decode_begin()
        for t in range(0, host.shape[1], 10):
            decoder.decode_step(host[0, t: t + 10])
        decoder.decode_end()
        out["incremental"] = decoder.get_final_hypothesis()[0].words
    print("incremental:", " ".join(out["incremental"]))
    return out


if __name__ == "__main__":
    main()
