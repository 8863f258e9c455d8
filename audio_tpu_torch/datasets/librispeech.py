"""LibriSpeech family datasets: ``LIBRISPEECH``, ``LibriSpeechBiasing`` and ``LibriLightLimited``.

The same classes as ``audio_tpu.datasets.librispeech`` (torchaudio's ``librispeech.py``, ``librispeech_biasing.py``
and ``librilight_limited.py``): the same directory layouts, walkers, item tuples and download tables.  The waveform
of an item is a (channels, time) float32 CPU tensor from the port's ``io.load``; the rest are Python values.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple, Union

from .._internal.download import download_url_to_file
from .utils import _extract_tar, _load_waveform

URL = "train-clean-100"
FOLDER_IN_ARCHIVE = "LibriSpeech"
SAMPLE_RATE = 16000
_DATA_SUBSETS = [
    "dev-clean",
    "dev-other",
    "test-clean",
    "test-other",
    "train-clean-100",
    "train-clean-360",
    "train-other-500",
]
_CHECKSUMS = {
    "http://www.openslr.org/resources/12/dev-clean.tar.gz": "76f87d090650617fca0cac8f88b9416e0ebf80350acb97b343a85fa903728ab3",
    "http://www.openslr.org/resources/12/dev-other.tar.gz": "12661c48e8c3fe1de2c1caa4c3e135193bfb1811584f11f569dd12645aa84365",
    "http://www.openslr.org/resources/12/test-clean.tar.gz": "39fde525e59672dc6d1551919b1478f724438a95aa55f874b576be21967e6c23",
    "http://www.openslr.org/resources/12/test-other.tar.gz": "d09c181bba5cf717b3dee7d4d592af11a3ee3a09e08ae025c5506f6ebe961c29",
    "http://www.openslr.org/resources/12/train-clean-100.tar.gz": "d4ddd1d5a6ab303066f14971d768ee43278a5f2a0aa43dc716b0e64ecbbbf6e2",
    "http://www.openslr.org/resources/12/train-clean-360.tar.gz": "146a56496217e96c14334a160df97fffedd6e0a04e66b9c5af0d40be3c792ecf",
    "http://www.openslr.org/resources/12/train-other-500.tar.gz": "ddb22f27f96ec163645d53215559df6aa36515f26e01dd70798188350adcb6d2",
}


def _download_librispeech(root, url):
    base_url = "http://www.openslr.org/resources/12/"
    filename = url + ".tar.gz"
    archive = os.path.join(root, filename)
    download_url = base_url + filename
    if not os.path.isfile(archive):
        download_url_to_file(download_url, archive, hash_prefix=_CHECKSUMS.get(download_url))
    _extract_tar(archive)


def _get_librispeech_metadata(
    fileid: str, root: str, folder: str, ext_audio: str, ext_txt: str, blist: Optional[List[str]] = None
):
    speaker_id, chapter_id, utterance_id = fileid.split("-")
    fileid_audio = f"{speaker_id}-{chapter_id}-{utterance_id}"
    filepath = os.path.join(folder, speaker_id, chapter_id, f"{fileid_audio}{ext_audio}")
    file_text = os.path.join(root, folder, speaker_id, chapter_id, f"{speaker_id}-{chapter_id}{ext_txt}")
    uttblist: List[str] = []
    with open(file_text) as ft:
        for line in ft:
            fileid_text, transcript = line.strip().split(" ", 1)
            if fileid_audio == fileid_text:
                if blist is not None:
                    for word in transcript.split():
                        if word in blist and word not in uttblist:
                            uttblist.append(word)
                break
        else:
            raise FileNotFoundError(f"Translation not found for {fileid_audio}")
    base = (filepath, SAMPLE_RATE, transcript, int(speaker_id), int(chapter_id), int(utterance_id))
    return base if blist is None else base + (uttblist,)


class LIBRISPEECH:
    """LibriSpeech ASR corpus; items are
    (waveform, sample_rate, transcript, speaker_id, chapter_id, utterance_id)."""

    _ext_txt = ".trans.txt"
    _ext_audio = ".flac"

    def __init__(
        self,
        root: Union[str, Path],
        url: str = URL,
        folder_in_archive: str = FOLDER_IN_ARCHIVE,
        download: bool = False,
    ) -> None:
        self._url = url
        if url not in _DATA_SUBSETS:
            raise ValueError(f"Invalid url '{url}' given; please provide one of {_DATA_SUBSETS}.")
        root = os.fspath(root)
        self._archive = os.path.join(root, folder_in_archive)
        self._path = os.path.join(root, folder_in_archive, url)
        if not os.path.isdir(self._path):
            if download:
                _download_librispeech(root, url)
            else:
                raise RuntimeError(
                    f"Dataset not found at {self._path}. Please set `download=True` to download the dataset."
                )
        self._walker = sorted(str(p.stem) for p in Path(self._path).glob("*/*/*" + self._ext_audio))

    def get_metadata(self, n: int):
        fileid = self._walker[n]
        return _get_librispeech_metadata(fileid, self._archive, self._url, self._ext_audio, self._ext_txt)

    def __getitem__(self, n: int):
        metadata = self.get_metadata(n)
        waveform = _load_waveform(self._archive, metadata[0], metadata[1])
        return (waveform,) + metadata[1:]

    def __len__(self) -> int:
        return len(self._walker)


class LibriSpeechBiasing(LIBRISPEECH):
    """LibriSpeech with a per-utterance biasing-word list appended to items."""

    def __init__(
        self,
        root: Union[str, Path],
        url: str = URL,
        folder_in_archive: str = FOLDER_IN_ARCHIVE,
        download: bool = False,
        blist: Optional[List[str]] = None,
    ) -> None:
        super().__init__(root, url, folder_in_archive, download)
        self.blist = blist

    def get_metadata(self, n: int):
        fileid = self._walker[n]
        return _get_librispeech_metadata(
            fileid, self._archive, self._url, self._ext_audio, self._ext_txt, self.blist or []
        )


_LL_ARCHIVE_NAME = "librispeech_finetuning"
_LL_URL = "https://dl.fbaipublicfiles.com/librilight/data/librispeech_finetuning.tgz"
_LL_CHECKSUM = "5d1efdc777b548194d7e09ba89126e2188026df9fd57aa57eb14408d2b2342af"
_LL_SUBSET_MAP = {"10min": ["1h/0"], "1h": ["1h/*"], "10h": ["1h/*", "9h"]}


class LibriLightLimited:
    """Libri-Light limited-supervision fine-tuning subsets (10min/1h/10h)."""

    _ext_txt = ".trans.txt"
    _ext_audio = ".flac"

    def __init__(self, root: Union[str, Path], subset: str = "10min", download: bool = False) -> None:
        if subset not in _LL_SUBSET_MAP:
            raise ValueError(f"`subset` must be one of {_LL_SUBSET_MAP.keys()}. Found: {subset}")
        folders = _LL_SUBSET_MAP[subset]
        root = os.fspath(root)
        self._path = os.path.join(root, _LL_ARCHIVE_NAME)
        archive = os.path.join(root, f"{_LL_ARCHIVE_NAME}.tgz")
        if not os.path.isdir(self._path):
            if not download:
                raise RuntimeError("Dataset not found. Please use `download=True` to download")
            if not os.path.isfile(archive):
                download_url_to_file(_LL_URL, archive, hash_prefix=_LL_CHECKSUM)
            _extract_tar(archive)
        path = Path(self._path)
        files_paths = []
        for folder in folders:
            paths = [p.relative_to(path) for p in path.glob(f"{folder}/*/*/*/*{self._ext_audio}")]
            files_paths += [(str(p.parent.parent.parent), str(p.stem)) for p in paths]
        files_paths.sort(key=lambda x: x[0] + x[1])
        self._fileids_paths = files_paths

    @property
    def _archive(self) -> str:
        """Root the relative paths in :meth:`get_metadata` resolve against
        (same contract as ``LIBRISPEECH._archive``)."""
        return self._path

    def get_metadata(self, n: int):
        """(relpath, sample_rate, transcript, speaker, chapter, utterance)
        without decoding audio — mirrors ``LIBRISPEECH.get_metadata``."""
        file_path, fileid = self._fileids_paths[n]
        return _get_librispeech_metadata(fileid, self._path, file_path, self._ext_audio, self._ext_txt)

    def __getitem__(self, n: int):
        metadata = self.get_metadata(n)
        waveform = _load_waveform(self._path, metadata[0], metadata[1])
        return (waveform,) + metadata[1:]

    def __len__(self) -> int:
        return len(self._fileids_paths)
