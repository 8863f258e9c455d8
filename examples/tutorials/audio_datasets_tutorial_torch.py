"""Audio datasets, on the PyTorch port.

Counterpart of ``audio_datasets_tutorial.py``: the dataset API (construction, indexing, metadata) on a YESNO corpus
the script writes itself, so nothing is fetched; then the same dataset under a ``torch.utils.data.DataLoader``.
Returns the items it read.

    python examples/tutorials/audio_datasets_tutorial_torch.py
"""

import argparse
import os
import tempfile

import numpy as np
import torch

import audio_tpu_torch
from audio_tpu_torch.datasets import YESNO


def fabricate_yesno(root, n=4, sr=8000):
    """Write a tiny YESNO corpus: ``<root>/waves_yesno/0_1_0_1_....wav``."""
    d = os.path.join(root, "waves_yesno")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    for _ in range(n):
        labels = rng.integers(0, 2, 8)
        wav = (0.1 * rng.standard_normal((1, sr))).astype(np.float32)
        audio_tpu_torch.save(os.path.join(d, "_".join(map(str, labels)) + ".wav"), wav, sr)


def main(argv=None):
    argparse.ArgumentParser().parse_args(argv)
    with tempfile.TemporaryDirectory() as root:
        fabricate_yesno(root)
        dataset = YESNO(root)
        print(f"YESNO: {len(dataset)} utterances")
        items = [dataset[i] for i in range(len(dataset))]
        for i, (waveform, sample_rate, labels) in enumerate(items[:3]):
            print(f"  [{i}] waveform {tuple(waveform.shape)} @ {sample_rate} Hz, labels {labels}")
        # items are CPU tensors and Python values: a DataLoader batches them (here one clip length, so stacked)
        loader = torch.utils.data.DataLoader(dataset, batch_size=2)
        batches = list(loader)
        print(f"DataLoader: {len(batches)} batches of waveforms {tuple(batches[0][0].shape)}")

    import audio_tpu_torch.datasets as D

    print("available datasets:", ", ".join(D.__all__))
    return items, batches


if __name__ == "__main__":
    main()
