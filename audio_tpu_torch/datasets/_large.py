"""Larger corpora: LIBRITTS, TEDLIUM, MUSDB_HQ, LibriMix, QUESST14, VoxCeleb1 (identification and verification).

The same classes as ``audio_tpu.datasets._large`` (torchaudio's modules of those names): the same layouts, walkers
and item tuples, waveforms as float32 CPU tensors from the port's ``io.load``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from .. import io
from .._internal.download import download_url_to_file
from .utils import _extract_tar, _extract_zip, _load_waveform

__all__ = [
    "LIBRITTS",
    "TEDLIUM",
    "MUSDB_HQ",
    "LibriMix",
    "QUESST14",
    "VoxCeleb1Identification",
    "VoxCeleb1Verification",
]


# --------------------------------------------------------------------------
_LIBRITTS_CHECKSUMS = {
    "http://www.openslr.org/resources/60/dev-clean.tar.gz": "da0864e1bd26debed35da8a869dd5c04dfc27682921936de7cff9c8a254dbe1a",
    "http://www.openslr.org/resources/60/dev-other.tar.gz": "d413eda26f3a152ac7c9cf3658ef85504dfb1b625296e5fa83727f5186cca79c",
    "http://www.openslr.org/resources/60/test-clean.tar.gz": "234ea5b25859102a87024a4b9b86641f5b5aaaf1197335c95090cde04fe9a4f5",
    "http://www.openslr.org/resources/60/test-other.tar.gz": "33a5342094f3bba7ccc2e0500b9e72d558f72eb99328ac8debe1d9080402f10d",
    "http://www.openslr.org/resources/60/train-clean-100.tar.gz": "c5608bf1ef74bb621935382b8399c5cdd51cd3ee47cec51f00f885a64c6c7f6b",
    "http://www.openslr.org/resources/60/train-clean-360.tar.gz": "ce7cff44dcac46009d18379f37ef36551123a1dc4e5c8e4eb73ae57260de4886",
    "http://www.openslr.org/resources/60/train-other-500.tar.gz": "e35f7e34deeb2e2bdfe4403d88c8fdd5fbf64865cae41f027a185a6965f0a5df",
}


class LIBRITTS:
    _ext_original_txt = ".original.txt"
    _ext_normalized_txt = ".normalized.txt"
    _ext_audio = ".wav"

    def __init__(self, root, url: str = "train-clean-100", folder_in_archive: str = "LibriTTS",
                 download: bool = False) -> None:
        if url in ("dev-clean", "dev-other", "test-clean", "test-other",
                   "train-clean-100", "train-clean-360", "train-other-500"):
            url = "http://www.openslr.org/resources/60/" + url + ".tar.gz"
        root = os.fspath(root)
        basename = os.path.basename(url)
        archive = os.path.join(root, basename)
        basename = basename.split(".")[0]
        self._path = os.path.join(root, folder_in_archive, basename)
        if download:
            if not os.path.isdir(self._path):
                if not os.path.isfile(archive):
                    download_url_to_file(url, archive, hash_prefix=_LIBRITTS_CHECKSUMS.get(url))
                _extract_tar(archive)
        elif not os.path.exists(self._path):
            raise RuntimeError(
                f"The path {self._path} doesn't exist. "
                "Please check the ``root`` path or set `download=True` to download it"
            )
        self._walker = sorted(str(p.stem) for p in Path(self._path).glob("*/*/*" + self._ext_audio))

    def __getitem__(self, n: int):
        fileid = self._walker[n]
        speaker_id, chapter_id, _, _ = fileid.split("_")
        base = os.path.join(self._path, speaker_id, chapter_id)
        waveform, sample_rate = io.load(os.path.join(base, fileid + self._ext_audio))
        with open(os.path.join(base, fileid + self._ext_original_txt)) as ft:
            original_text = ft.readline()
        with open(os.path.join(base, fileid + self._ext_normalized_txt)) as ft:
            normalized_text = ft.readline()
        return waveform, sample_rate, original_text, normalized_text, int(speaker_id), int(chapter_id), fileid

    def __len__(self) -> int:
        return len(self._walker)


# --------------------------------------------------------------------------
_TEDLIUM_RELEASE_CONFIGS = {
    "release1": {
        "folder_in_archive": "TEDLIUM_release1",
        "url": "http://www.openslr.org/resources/7/TEDLIUM_release1.tar.gz",
        "checksum": "30301975fd8c5cac4040c261c0852f57cfa8adbbad2ce78e77e4986957445f27",
        "data_path": "",
        "supported_subsets": ["train", "test", "dev"],
        "dict": "TEDLIUM.150K.dic",
    },
    "release2": {
        "folder_in_archive": "TEDLIUM_release2",
        "url": "http://www.openslr.org/resources/19/TEDLIUM_release2.tar.gz",
        "checksum": "93281b5fcaaae5c88671c9d000b443cb3c7ea3499ad12010b3934ca41a7b9c58",
        "data_path": "",
        "supported_subsets": ["train", "test", "dev"],
        "dict": "TEDLIUM.152k.dic",
    },
    "release3": {
        "folder_in_archive": "TEDLIUM_release-3",
        "url": "http://www.openslr.org/resources/51/TEDLIUM_release-3.tgz",
        "checksum": "ad1e454d14d1ad550bc2564c462d87c7a7ec83d4dc2b9210f22ab4973b9eccdb",
        "data_path": "data/",
        "supported_subsets": ["train", "test", "dev"],
        "dict": "TEDLIUM.152k.dic",
    },
}


class TEDLIUM:
    def __init__(self, root, release: str = "release1", subset: str = "train",
                 download: bool = False, audio_ext: str = ".sph") -> None:
        self._ext_audio = audio_ext
        if release not in _TEDLIUM_RELEASE_CONFIGS:
            raise RuntimeError(
                f"The release {release} does not match any of the supported tedlium releases"
                f"{_TEDLIUM_RELEASE_CONFIGS.keys()} "
            )
        cfg = _TEDLIUM_RELEASE_CONFIGS[release]
        if subset not in cfg["supported_subsets"]:
            raise RuntimeError(
                f"The subset {subset} does not match any of the supported tedlium subsets{cfg['supported_subsets']} "
            )
        root = os.fspath(root)
        basename = os.path.basename(cfg["url"])
        archive = os.path.join(root, basename)
        if release == "release3":
            if subset == "train":
                self._path = os.path.join(root, cfg["folder_in_archive"], cfg["data_path"])
            else:
                self._path = os.path.join(root, cfg["folder_in_archive"], "legacy", subset)
        else:
            self._path = os.path.join(root, cfg["folder_in_archive"], cfg["data_path"], subset)
        if download:
            if not os.path.isdir(self._path):
                if not os.path.isfile(archive):
                    download_url_to_file(cfg["url"], archive, hash_prefix=cfg["checksum"])
                _extract_tar(archive)
        elif not os.path.exists(self._path):
            raise RuntimeError(
                f"The path {self._path} doesn't exist. "
                "Please check the ``root`` path or set `download=True` to download it"
            )
        self._filelist: List[Tuple[str, int]] = []
        stm_dir = os.path.join(self._path, "stm")
        for file in sorted(os.listdir(stm_dir)):
            if file.endswith(".stm"):
                with open(os.path.join(stm_dir, file)) as f:
                    n_lines = len(f.readlines())
                self._filelist.extend((file.replace(".stm", ""), line) for line in range(n_lines))
        self._dict_path = os.path.join(root, cfg["folder_in_archive"], cfg["dict"])
        self._phoneme_dict = None

    def _load_audio(self, path, start_time, end_time, sample_rate: int = 16000):
        start = int(float(start_time) * sample_rate)
        end = int(float(end_time) * sample_rate)
        return io.load(path, frame_offset=start, num_frames=end - start)

    def __getitem__(self, n: int):
        fileid, line = self._filelist[n]
        with open(os.path.join(self._path, "stm", fileid + ".stm")) as f:
            transcript = f.readlines()[line]
            talk_id, _, speaker_id, start_time, end_time, identifier, transcript = transcript.split(" ", 6)
        wave_path = os.path.join(self._path, "sph", fileid + self._ext_audio)
        waveform, sample_rate = self._load_audio(wave_path, start_time, end_time)
        return waveform, sample_rate, transcript, talk_id, speaker_id, identifier

    def __len__(self) -> int:
        return len(self._filelist)

    @property
    def phoneme_dict(self):
        if not self._phoneme_dict:
            self._phoneme_dict = {}
            with open(self._dict_path, "r", encoding="utf-8") as f:
                for line in f.readlines():
                    content = line.strip().split()
                    self._phoneme_dict[content[0]] = tuple(content[1:])
        return self._phoneme_dict.copy()


# --------------------------------------------------------------------------
_MUSDB_URL = "https://zenodo.org/record/3338373/files/musdb18hq.zip"
_MUSDB_CHECKSUM = "baac80d0483c61d74b2e5f3be75fa557eec52898339e6aa45c1fa48833c5d21d"
_MUSDB_SAMPLE_RATE = 44100
_MUSDB_VALIDATION_SET = [
    "Actions - One Minute Smile",
    "Clara Berry And Wooldog - Waltz For My Victims",
    "Johnny Lokke - Promises & Lies",
    "Patrick Talbot - A Reason To Leave",
    "Triviul - Angelsaint",
    "Alexander Ross - Goodbye Bolero",
    "Fergessen - Nos Palpitants",
    "Leaf - Summerghost",
    "Skelpolu - Human Mistakes",
    "Young Griffo - Pennies",
    "ANiMAL - Rockshow",
    "James May - On The Line",
    "Meaxic - Take A Step",
    "Traffic Experiment - Sirens",
]


class MUSDB_HQ:
    def __init__(self, root, subset: str, sources: Optional[List[str]] = None,
                 split: Optional[str] = None, download: bool = False) -> None:
        self.sources = ["bass", "drums", "other", "vocals"] if not sources else sources
        self.split = split
        basename = os.path.basename(_MUSDB_URL)
        archive = os.path.join(root, basename)
        basename = basename.rsplit(".", 2)[0]
        if subset not in ["test", "train"]:
            raise ValueError("`subset` must be one of ['test', 'train']")
        if self.split is not None and self.split not in ["train", "validation"]:
            raise ValueError("`split` must be one of ['train', 'validation']")
        base_path = os.path.join(root, basename)
        self._path = os.path.join(base_path, subset)
        if not os.path.isdir(self._path):
            if not os.path.isfile(archive):
                if not download:
                    raise RuntimeError("Dataset not found. Please use `download=True` to download")
                download_url_to_file(_MUSDB_URL, archive, hash_prefix=_MUSDB_CHECKSUM)
            os.makedirs(base_path, exist_ok=True)
            _extract_zip(archive, base_path)
        self.names = self._collect_songs()

    def _collect_songs(self):
        if self.split == "validation":
            return _MUSDB_VALIDATION_SET
        path = Path(self._path)
        names = []
        for root, folders, _ in os.walk(path, followlinks=True):
            root = Path(root)
            if root.name.startswith(".") or folders or root == path:
                continue
            name = str(root.relative_to(path))
            if self.split and name in _MUSDB_VALIDATION_SET:
                continue
            names.append(name)
        return sorted(names)

    def __getitem__(self, n: int):
        name = self.names[n]
        wavs = []
        num_frames = None
        for source in self.sources:
            track = Path(self._path) / name / f"{source}.wav"
            wav, sr = io.load(str(track))
            if sr != _MUSDB_SAMPLE_RATE:
                raise ValueError(f"expected sample rate {_MUSDB_SAMPLE_RATE}, but got {sr}")
            if num_frames is None:
                num_frames = wav.shape[-1]
            elif wav.shape[-1] != num_frames:
                raise ValueError("num_frames do not match across sources")
            wavs.append(wav)
        return torch.stack(wavs), _MUSDB_SAMPLE_RATE, num_frames, name

    def __len__(self) -> int:
        return len(self.names)


# --------------------------------------------------------------------------
_LIBRIMIX_TASKS = {
    "sep_clean": "mix_clean",
    "enh_single": "mix_single",
    "enh_both": "mix_both",
    "sep_noisy": "mix_both",
}


class LibriMix:
    def __init__(self, root, subset: str = "train-360", num_speakers: int = 2,
                 sample_rate: int = 8000, task: str = "sep_clean", mode: str = "min"):
        self.root = Path(root) / f"Libri{num_speakers}Mix"
        if not os.path.exists(self.root):
            raise RuntimeError(
                f"The path {self.root} doesn't exist. "
                "Please check the ``root`` path and ``num_speakers`` or download the dataset manually."
            )
        if mode not in ["max", "min"]:
            raise ValueError(f'Expect ``mode`` to be one in ["min", "max"]. Found {mode}.')
        if sample_rate == 8000:
            mix_dir = self.root / "wav8k" / mode / subset
        elif sample_rate == 16000:
            mix_dir = self.root / "wav16k" / mode / subset
        else:
            raise ValueError(f"Unsupported sample rate. Found {sample_rate}.")
        self.sample_rate = sample_rate
        self.task = task
        self.mix_dir = mix_dir / _LIBRIMIX_TASKS[task]
        if task == "enh_both":
            self.src_dirs = [mix_dir / "mix_clean"]
        else:
            self.src_dirs = [mix_dir / f"s{i + 1}" for i in range(num_speakers)]
        self.files = sorted(p.name for p in self.mix_dir.glob("*.wav"))

    def get_metadata(self, key: int):
        filename = self.files[key]
        mixed_path = os.path.relpath(self.mix_dir / filename, self.root)
        srcs_paths = [os.path.relpath(d / filename, self.root) for d in self.src_dirs]
        return self.sample_rate, mixed_path, srcs_paths

    def __getitem__(self, key: int):
        metadata = self.get_metadata(key)
        mixed = _load_waveform(self.root, metadata[1], metadata[0])
        srcs = []
        for i, path_ in enumerate(metadata[2]):
            src = _load_waveform(self.root, path_, metadata[0])
            if mixed.shape != src.shape:
                raise ValueError(f"Different waveform shapes. mixed: {mixed.shape}, src[{i}]: {src.shape}")
            srcs.append(src)
        return self.sample_rate, mixed, srcs

    def __len__(self) -> int:
        return len(self.files)


# --------------------------------------------------------------------------
_QUESST_URL = "https://speech.fit.vutbr.cz/files/quesst14Database.tgz"
_QUESST_SAMPLE_RATE = 8000
_QUESST_CHECKSUM = "4f869e06bc066bbe9c5dde31dbd3909a0870d70291110ebbb38878dcbc2fc5e4"
_QUESST_LANGUAGES = ["albanian", "basque", "czech", "nnenglish", "romanian", "slovak"]


class QUESST14:
    def __init__(self, root, subset: str, language: Optional[str] = "nnenglish", download: bool = False) -> None:
        if subset not in ["docs", "dev", "eval"]:
            raise ValueError("`subset` must be one of ['docs', 'dev', 'eval']")
        if language is not None and language not in _QUESST_LANGUAGES:
            raise ValueError(f"`language` must be None or one of {str(_QUESST_LANGUAGES)}")
        root = os.fspath(root)
        basename = os.path.basename(_QUESST_URL)
        archive = os.path.join(root, basename)
        basename = basename.rsplit(".", 2)[0]
        self._path = os.path.join(root, basename)
        if not os.path.isdir(self._path):
            if not os.path.isfile(archive):
                if not download:
                    raise RuntimeError("Dataset not found. Please use `download=True` to download")
                download_url_to_file(_QUESST_URL, archive, hash_prefix=_QUESST_CHECKSUM)
            _extract_tar(archive, root)
        lst = {"docs": "language_key_utterances.lst", "dev": "language_key_dev.lst", "eval": "language_key_eval.lst"}[subset]
        self.data = self._filter_audio_paths(self._path, language, lst)

    @staticmethod
    def _filter_audio_paths(path, language, lst_name):
        audio_paths = []
        path = Path(path)
        with open(path / "scoring" / lst_name) as f:
            for line in f:
                audio_path, lang = line.strip().split()
                if language is not None and lang != language:
                    continue
                audio_path = re.sub(r"^.*?\/", "", audio_path)
                audio_paths.append(path / audio_path)
        return audio_paths

    def get_metadata(self, n: int):
        audio_path = self.data[n]
        relpath = os.path.relpath(audio_path, self._path)
        return relpath, _QUESST_SAMPLE_RATE, audio_path.with_suffix("").name

    def __getitem__(self, n: int):
        metadata = self.get_metadata(n)
        waveform = _load_waveform(self._path, metadata[0], metadata[1])
        return (waveform,) + metadata[1:]

    def __len__(self) -> int:
        return len(self.data)


# --------------------------------------------------------------------------
_VOX_SAMPLE_RATE = 16000
_VOX_IDEN_SPLIT_URL = "https://www.robots.ox.ac.uk/~vgg/data/voxceleb/meta/iden_split.txt"
_VOX_VERI_TEST_URL = "https://www.robots.ox.ac.uk/~vgg/data/voxceleb/meta/veri_test.txt"


def _vox_file_id(file_path: str, ext: str) -> str:
    speaker_id, youtube_id, utterance_id = file_path.split("/")[-3:]
    return "-".join([speaker_id, youtube_id, utterance_id.replace(ext, "")])


class _VoxCeleb1:
    _ext_audio = ".wav"

    def __init__(self, root, download: bool = False) -> None:
        root = os.fspath(root)
        self._path = os.path.join(root, "wav")
        if not os.path.isdir(self._path):
            raise RuntimeError(
                f"Dataset not found at {self._path}. VoxCeleb1 archives must be downloaded and extracted manually."
            )


class VoxCeleb1Identification(_VoxCeleb1):
    def __init__(self, root, subset: str = "train", meta_url: str = _VOX_IDEN_SPLIT_URL, download: bool = False):
        super().__init__(root, download)
        if subset not in ["train", "dev", "test"]:
            raise ValueError("`subset` must be one of ['train', 'dev', 'test']")
        meta_list_path = os.path.join(os.fspath(root), os.path.basename(meta_url))
        if not os.path.exists(meta_list_path):
            download_url_to_file(meta_url, meta_list_path)
        index = {"train": 1, "dev": 2, "test": 3}[subset]
        f_list = []
        with open(meta_list_path, "r") as f:
            for line in f:
                id_, path = line.split()
                if int(id_) == index:
                    f_list.append(path)
        self._flist = sorted(f_list)

    def get_metadata(self, n: int):
        file_path = self._flist[n]
        file_id = _vox_file_id(file_path, self._ext_audio)
        speaker_id = int(file_id.split("-")[0][3:])
        return file_path, _VOX_SAMPLE_RATE, speaker_id, file_id

    def __getitem__(self, n: int):
        metadata = self.get_metadata(n)
        waveform = _load_waveform(self._path, metadata[0], metadata[1])
        return (waveform,) + metadata[1:]

    def __len__(self) -> int:
        return len(self._flist)


class VoxCeleb1Verification(_VoxCeleb1):
    def __init__(self, root, meta_url: str = _VOX_VERI_TEST_URL, download: bool = False):
        super().__init__(root, download)
        meta_list_path = os.path.join(os.fspath(root), os.path.basename(meta_url))
        if not os.path.exists(meta_list_path):
            download_url_to_file(meta_url, meta_list_path)
        f_list = []
        with open(meta_list_path, "r") as f:
            for line in f:
                label, path1, path2 = line.split()
                f_list.append((label, path1, path2))
        self._flist = f_list

    def get_metadata(self, n: int):
        label, file_path_spk1, file_path_spk2 = self._flist[n]
        file_id_spk1 = _vox_file_id(file_path_spk1, self._ext_audio)
        file_id_spk2 = _vox_file_id(file_path_spk2, self._ext_audio)
        return file_path_spk1, file_path_spk2, _VOX_SAMPLE_RATE, int(label), file_id_spk1, file_id_spk2

    def __getitem__(self, n: int):
        metadata = self.get_metadata(n)
        waveform_spk1 = _load_waveform(self._path, metadata[0], metadata[2])
        waveform_spk2 = _load_waveform(self._path, metadata[1], metadata[2])
        return (waveform_spk1, waveform_spk2) + metadata[2:]

    def __len__(self) -> int:
        return len(self._flist)
