"""Smaller datasets: YESNO, SPEECHCOMMANDS, LJSPEECH, CMUARCTIC, CMUDict, VCTK_092, DR_VCTK, COMMONVOICE,
FluentSpeechCommands, Snips, IEMOCAP, GTZAN.

The same classes as ``audio_tpu.datasets._small`` (torchaudio's modules of those names): the same layouts, walkers
and item tuples, waveforms as float32 CPU tensors from the port's ``io.load``.  GTZAN's filtered train/valid/test
splits are kept as (genre, start, end) ranges that expand to torchaudio's lists.
"""

from __future__ import annotations

import csv
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .. import io
from .._internal.download import download_url_to_file
from .utils import _extract_tar, _extract_zip, _load_waveform

__all__ = [
    "YESNO",
    "SPEECHCOMMANDS",
    "LJSPEECH",
    "CMUARCTIC",
    "CMUDict",
    "VCTK_092",
    "DR_VCTK",
    "COMMONVOICE",
    "FluentSpeechCommands",
    "Snips",
    "IEMOCAP",
    "GTZAN",
]


# --------------------------------------------------------------------------
class YESNO:
    _CONFIG = {
        "folder_in_archive": "waves_yesno",
        "url": "http://www.openslr.org/resources/1/waves_yesno.tar.gz",
        "checksum": "c3f49e0cca421f96b75b41640749167b52118f232498667ca7a5f9416aef8e73",
    }

    def __init__(self, root, url=None, folder_in_archive=None, download: bool = False) -> None:
        url = url or self._CONFIG["url"]
        folder_in_archive = folder_in_archive or self._CONFIG["folder_in_archive"]
        root = Path(root)
        archive = root / os.path.basename(url)
        self._path = root / folder_in_archive
        if download and not os.path.isdir(self._path):
            if not os.path.isfile(archive):
                download_url_to_file(url, str(archive), hash_prefix=self._CONFIG["checksum"])
            _extract_tar(str(archive))
        if not os.path.isdir(self._path):
            raise RuntimeError("Dataset not found. Please use `download=True` to download it.")
        self._walker = sorted(str(p.stem) for p in Path(self._path).glob("*.wav"))

    def __getitem__(self, n: int):
        fileid = self._walker[n]
        labels = [int(c) for c in fileid.split("_")]
        waveform, sample_rate = io.load(os.path.join(self._path, fileid + ".wav"))
        return waveform, sample_rate, labels

    def __len__(self) -> int:
        return len(self._walker)


# --------------------------------------------------------------------------
_SC_FOLDER = "SpeechCommands"
_SC_URL = "speech_commands_v0.02"
_SC_HASH_DIVIDER = "_nohash_"
_SC_EXCEPT_FOLDER = "_background_noise_"
_SC_SAMPLE_RATE = 16000
_SC_CHECKSUMS = {
    "http://download.tensorflow.org/data/speech_commands_v0.01.tar.gz": "743935421bb51cccdb6bdd152e04c5c70274e935c82119ad7faeec31780d811d",
    "http://download.tensorflow.org/data/speech_commands_v0.02.tar.gz": "af14739ee7dc311471de98f5f9d2c9191b18aedfe957f4a6ff791c709868ff58",
}


class SPEECHCOMMANDS:
    def __init__(self, root, url: str = _SC_URL, folder_in_archive: str = _SC_FOLDER,
                 download: bool = False, subset: Optional[str] = None) -> None:
        if subset is not None and subset not in ["training", "validation", "testing"]:
            raise ValueError("When `subset` is not None, it must be one of ['training', 'validation', 'testing'].")
        if url in ("speech_commands_v0.01", "speech_commands_v0.02"):
            url = "http://download.tensorflow.org/data/" + url + ".tar.gz"
        root = os.fspath(root)
        self._archive = os.path.join(root, folder_in_archive)
        basename = os.path.basename(url)
        archive = os.path.join(root, basename)
        basename = basename.rsplit(".", 2)[0]
        self._path = os.path.join(root, folder_in_archive, basename)
        if download:
            if not os.path.isdir(self._path):
                if not os.path.isfile(archive):
                    download_url_to_file(url, archive, hash_prefix=_SC_CHECKSUMS.get(url))
                _extract_tar(archive, self._path)
        elif not os.path.exists(self._path):
            raise RuntimeError(
                f"The path {self._path} doesn't exist. "
                "Please check the ``root`` path or set `download=True` to download it"
            )

        def load_list(*filenames):
            output = []
            for filename in filenames:
                with open(os.path.join(self._path, filename)) as fileobj:
                    output += [os.path.normpath(os.path.join(self._path, line.strip())) for line in fileobj]
            return output

        if subset == "validation":
            self._walker = load_list("validation_list.txt")
        elif subset == "testing":
            self._walker = load_list("testing_list.txt")
        elif subset == "training":
            excludes = set(load_list("validation_list.txt", "testing_list.txt"))
            walker = sorted(str(p) for p in Path(self._path).glob("*/*.wav"))
            self._walker = [
                w for w in walker
                if _SC_HASH_DIVIDER in w and _SC_EXCEPT_FOLDER not in w and os.path.normpath(w) not in excludes
            ]
        else:
            walker = sorted(str(p) for p in Path(self._path).glob("*/*.wav"))
            self._walker = [w for w in walker if _SC_HASH_DIVIDER in w and _SC_EXCEPT_FOLDER not in w]

    def get_metadata(self, n: int):
        filepath = self._walker[n]
        relpath = os.path.relpath(filepath, self._archive)
        reldir, filename = os.path.split(relpath)
        _, label = os.path.split(reldir)
        speaker, _ = os.path.splitext(filename)
        speaker, _ = os.path.splitext(speaker)
        speaker_id, utterance_number = speaker.split(_SC_HASH_DIVIDER)
        return relpath, _SC_SAMPLE_RATE, label, speaker_id, int(utterance_number)

    def __getitem__(self, n: int):
        metadata = self.get_metadata(n)
        waveform = _load_waveform(self._archive, metadata[0], metadata[1])
        return (waveform,) + metadata[1:]

    def __len__(self) -> int:
        return len(self._walker)


# --------------------------------------------------------------------------
class LJSPEECH:
    _CONFIG = {
        "folder_in_archive": "wavs",
        "url": "https://data.keithito.com/data/speech/LJSpeech-1.1.tar.bz2",
        "checksum": "be1a30453f28eb8dd26af4101ae40cbf2c50413b1bb21936cbcdc6fae3de8aa5",
    }

    def __init__(self, root, url=None, folder_in_archive=None, download: bool = False) -> None:
        url = url or self._CONFIG["url"]
        folder_in_archive = folder_in_archive or self._CONFIG["folder_in_archive"]
        root = Path(root)
        basename = os.path.basename(url)
        archive = root / basename
        basename = Path(basename.split(".tar.bz2")[0])
        self._path = root / basename / folder_in_archive
        self._metadata_path = root / basename / "metadata.csv"
        if download:
            if not os.path.isdir(self._path):
                if not os.path.isfile(archive):
                    download_url_to_file(url, str(archive), hash_prefix=self._CONFIG["checksum"])
                _extract_tar(str(archive))
        elif not os.path.exists(self._path):
            raise RuntimeError(
                f"The path {self._path} doesn't exist. "
                "Please check the ``root`` path or set `download=True` to download it"
            )
        with open(self._metadata_path, "r", newline="") as metadata:
            flist = csv.reader(metadata, delimiter="|", quoting=csv.QUOTE_NONE)
            self._flist = list(flist)

    def __getitem__(self, n: int):
        fileid, transcript, normalized_transcript = self._flist[n]
        waveform, sample_rate = io.load(self._path / (fileid + ".wav"))
        return waveform, sample_rate, transcript, normalized_transcript

    def __len__(self) -> int:
        return len(self._flist)


# --------------------------------------------------------------------------
_ARCTIC_SPEAKERS = [
    "aew", "ahw", "aup", "awb", "axb", "bdl", "clb", "eey", "fem", "gka",
    "jmk", "ksp", "ljm", "lnh", "rms", "rxr", "slp", "slt",
]


class CMUARCTIC:
    _file_text = "txt.done.data"
    _folder_text = "etc"
    _ext_audio = ".wav"
    _folder_audio = "wav"

    def __init__(self, root, url: str = "aew", folder_in_archive: str = "ARCTIC", download: bool = False) -> None:
        if url in _ARCTIC_SPEAKERS:
            url = f"http://www.festvox.org/cmu_arctic/packed/cmu_us_{url}_arctic.tar.bz2"
        root = os.fspath(root)
        basename = os.path.basename(url)
        root = os.path.join(root, folder_in_archive)
        os.makedirs(root, exist_ok=True)
        archive = os.path.join(root, basename)
        self._path = os.path.join(root, basename.split(".")[0])
        if download:
            if not os.path.isdir(self._path):
                if not os.path.isfile(archive):
                    download_url_to_file(url, archive)
                _extract_tar(archive)
        elif not os.path.exists(self._path):
            raise RuntimeError(
                f"The path {self._path} doesn't exist. "
                "Please check the ``root`` path or set `download=True` to download it"
            )
        text = os.path.join(self._path, self._folder_text, self._file_text)
        with open(text, "r", newline=None) as f:
            self._walker = [line.rstrip("\n") for line in f.readlines()]

    def __getitem__(self, n: int):
        line = self._walker[n]
        utterance_id, transcript = line.strip().split(" ", 2)[1:]
        transcript = transcript[1:-3]
        waveform, sample_rate = io.load(
            os.path.join(self._path, self._folder_audio, utterance_id + self._ext_audio)
        )
        return waveform, sample_rate, transcript, utterance_id.split("_")[1]

    def __len__(self) -> int:
        return len(self._walker)


# --------------------------------------------------------------------------
_CMUDICT_CHECKSUMS = {
    "http://svn.code.sf.net/p/cmusphinx/code/trunk/cmudict/cmudict-0.7b": "209a8b4cd265013e96f4658632a9878103b0c5abf62b50d4ef3ae1be226b29e4",
    "http://svn.code.sf.net/p/cmusphinx/code/trunk/cmudict/cmudict-0.7b.symbols": "408ccaae803641c6d7b626b6299949320c2dbca96b2220fd3fb17887b023b027",
}
# punctuation pseudo-words in cmudict 0.7b (word -> printable form first char)
_CMUDICT_PUNCT_PREFIXES = ("!", '"', "#", "%", "&", "'", "(", ")", "+", ",", "-", ".", "/", ":", ";", "?", "{", "}")


class CMUDict:
    """CMU pronouncing dictionary; items are (word, phonemes)."""

    def __init__(
        self,
        root,
        exclude_punctuations: bool = True,
        *,
        download: bool = False,
        url: str = "http://svn.code.sf.net/p/cmusphinx/code/trunk/cmudict/cmudict-0.7b",
        url_symbols: str = "http://svn.code.sf.net/p/cmusphinx/code/trunk/cmudict/cmudict-0.7b.symbols",
    ) -> None:
        self.exclude_punctuations = exclude_punctuations
        root = Path(root)
        if not os.path.isdir(root):
            raise RuntimeError(f"The root directory does not exist; {root}")
        dict_file = root / os.path.basename(url)
        symbol_file = root / os.path.basename(url_symbols)
        if not os.path.exists(dict_file):
            if not download:
                raise RuntimeError("The dictionary file is not found in the following location. "
                                   f"Set `download=True` to download it. {dict_file}")
            download_url_to_file(url, str(dict_file), _CMUDICT_CHECKSUMS.get(url))
        if not os.path.exists(symbol_file):
            if not download:
                raise RuntimeError("The symbol file is not found in the following location. "
                                   f"Set `download=True` to download it. {symbol_file}")
            download_url_to_file(url_symbols, str(symbol_file), _CMUDICT_CHECKSUMS.get(url_symbols))
        with open(symbol_file, "r") as text:
            self._symbols = [line.strip() for line in text.readlines()]
        with open(dict_file, "r", encoding="latin-1") as text:
            self._dictionary = self._parse(text.readlines())

    def _parse(self, lines):
        alt_re = re.compile(r"\([0-9]+\)")
        out = []
        for line in lines:
            if not line or line.startswith(";;;"):
                continue
            word, phones = line.strip().split("  ")
            if not word[0].isalnum() and word[0] in "".join(_CMUDICT_PUNCT_PREFIXES):
                if self.exclude_punctuations:
                    continue
                if word.startswith("..."):
                    word = "..."
                elif word.startswith("--"):
                    word = "--"
                else:
                    word = word[0]
            word = re.sub(alt_re, "", word)
            out.append((word, phones.split(" ")))
        return out

    def __getitem__(self, n: int) -> Tuple[str, List[str]]:
        return self._dictionary[n]

    def __len__(self) -> int:
        return len(self._dictionary)

    @property
    def symbols(self) -> List[str]:
        return self._symbols.copy()


# --------------------------------------------------------------------------
_VCTK_URL = "https://datashare.is.ed.ac.uk/bitstream/handle/10283/3443/VCTK-Corpus-0.92.zip"
_VCTK_CHECKSUM = "f96258be9fdc2cbff6559541aae7ea4f59df3fcaf5cf963aae5ca647357e359c"


class VCTK_092:
    def __init__(self, root: str, mic_id: str = "mic2", download: bool = False,
                 url: str = _VCTK_URL, audio_ext: str = ".flac"):
        if mic_id not in ["mic1", "mic2"]:
            raise RuntimeError(f'`mic_id` has to be either "mic1" or "mic2". Found: {mic_id}')
        archive = os.path.join(root, "VCTK-Corpus-0.92.zip")
        self._path = os.path.join(root, "VCTK-Corpus-0.92")
        self._txt_dir = os.path.join(self._path, "txt")
        self._audio_dir = os.path.join(self._path, "wav48_silence_trimmed")
        self._mic_id = mic_id
        self._audio_ext = audio_ext
        if download and not os.path.isdir(self._path):
            if not os.path.isfile(archive):
                download_url_to_file(url, archive, hash_prefix=_VCTK_CHECKSUM)
            _extract_zip(archive, self._path)
        if not os.path.isdir(self._path):
            raise RuntimeError("Dataset not found. Please use `download=True` to download it.")
        self._speaker_ids = sorted(os.listdir(self._txt_dir))
        self._sample_ids = []
        for speaker_id in self._speaker_ids:
            if speaker_id == "p280" and mic_id == "mic2":
                continue
            utterance_dir = os.path.join(self._txt_dir, speaker_id)
            for utterance_file in sorted(f for f in os.listdir(utterance_dir) if f.endswith(".txt")):
                utterance_id = os.path.splitext(utterance_file)[0]
                audio_path_mic = os.path.join(self._audio_dir, speaker_id, f"{utterance_id}_{mic_id}{audio_ext}")
                if speaker_id == "p362" and not os.path.isfile(audio_path_mic):
                    continue
                self._sample_ids.append(utterance_id.split("_"))

    def _load_sample(self, speaker_id, utterance_id, mic_id):
        with open(os.path.join(self._txt_dir, speaker_id, f"{speaker_id}_{utterance_id}.txt")) as f:
            transcript = f.readlines()[0]
        waveform, sample_rate = io.load(
            os.path.join(self._audio_dir, speaker_id, f"{speaker_id}_{utterance_id}_{mic_id}{self._audio_ext}")
        )
        return waveform, sample_rate, transcript, speaker_id, utterance_id

    def __getitem__(self, n: int):
        speaker_id, utterance_id = self._sample_ids[n]
        return self._load_sample(speaker_id, utterance_id, self._mic_id)

    def __len__(self) -> int:
        return len(self._sample_ids)


# --------------------------------------------------------------------------
_DR_VCTK_URL = "https://datashare.ed.ac.uk/bitstream/handle/10283/3038/DR-VCTK.zip"
_DR_VCTK_CHECKSUM = "781f12f4406ed36ed27ae3bce55da47ba176e2d8bae67319e389e07b2c9bd769"


class DR_VCTK:
    def __init__(self, root, subset: str = "train", *, download: bool = False, url: str = _DR_VCTK_URL) -> None:
        if subset not in ("train", "test"):
            raise RuntimeError(f"The subset '{subset}' does not match any of the supported subsets: {{'train', 'test'}}")
        root = Path(root).expanduser()
        archive = root / "DR-VCTK.zip"
        self._subset = subset
        self._path = root / "DR-VCTK" / "DR-VCTK"
        self._clean_audio_dir = self._path / f"clean_{subset}set_wav_16k"
        self._noisy_audio_dir = self._path / f"device-recorded_{subset}set_wav_16k"
        self._config_filepath = self._path / "configurations" / f"{subset}_ch_log.txt"
        if not self._path.is_dir():
            if not archive.is_file():
                if not download:
                    raise RuntimeError("Dataset not found. Please use `download=True` to download it.")
                download_url_to_file(url, str(archive), hash_prefix=_DR_VCTK_CHECKSUM)
            _extract_zip(str(archive), str(root))
        self._config = self._load_config(self._config_filepath)
        self._filename_list = sorted(self._config)

    def _load_config(self, filepath):
        skip_rows = 2 if self._subset == "train" else 1
        config = {}
        with open(filepath) as f:
            for i, line in enumerate(f):
                if i < skip_rows or not line:
                    continue
                filename, source, channel_id = line.strip().split("\t")
                config[filename] = (source, int(channel_id))
        return config

    def __getitem__(self, n: int):
        filename = self._filename_list[n]
        speaker_id, utterance_id = filename.split(".")[0].split("_")
        source, channel_id = self._config[filename]
        waveform_clean, sr_clean = io.load(self._clean_audio_dir / filename)
        waveform_noisy, sr_noisy = io.load(self._noisy_audio_dir / filename)
        return waveform_clean, sr_clean, waveform_noisy, sr_noisy, speaker_id, utterance_id, source, channel_id

    def __len__(self) -> int:
        return len(self._filename_list)


# --------------------------------------------------------------------------
class COMMONVOICE:
    _ext_audio = ".mp3"
    _folder_audio = "clips"

    def __init__(self, root, tsv: str = "train.tsv") -> None:
        self._path = os.fspath(root)
        self._tsv = os.path.join(self._path, tsv)
        with open(self._tsv, "r") as tsv_:
            walker = csv.reader(tsv_, delimiter="\t")
            self._header = next(walker)
            self._walker = list(walker)

    def __getitem__(self, n: int):
        line = self._walker[n]
        if self._header[1] != "path":
            raise ValueError(f"expect `header[1]` to be 'path', but got {self._header[1]}")
        fileid = line[1]
        filename = os.path.join(self._path, self._folder_audio, fileid)
        if not filename.endswith(self._ext_audio):
            filename += self._ext_audio
        waveform, sample_rate = io.load(filename)
        return waveform, sample_rate, dict(zip(self._header, line))

    def __len__(self) -> int:
        return len(self._walker)


# --------------------------------------------------------------------------
_FSC_SAMPLE_RATE = 16000


class FluentSpeechCommands:
    def __init__(self, root, subset: str = "train"):
        if subset not in ["train", "valid", "test"]:
            raise ValueError("`subset` must be one of ['train', 'valid', 'test']")
        root = os.fspath(root)
        self._path = os.path.join(root, "fluent_speech_commands_dataset")
        if not os.path.isdir(self._path):
            raise RuntimeError("Dataset not found.")
        subset_path = os.path.join(self._path, "data", f"{subset}_data.csv")
        with open(subset_path) as subset_csv:
            data = list(csv.reader(subset_csv))
        self.header = data[0]
        self.data = data[1:]

    def get_metadata(self, n: int):
        sample = self.data[n]
        file_name = sample[self.header.index("path")].split("/")[-1].split(".")[0]
        speaker_id, transcription, action, obj, location = sample[2:]
        file_path = os.path.join("wavs", "speakers", speaker_id, f"{file_name}.wav")
        return file_path, _FSC_SAMPLE_RATE, file_name, speaker_id, transcription, action, obj, location

    def __getitem__(self, n: int):
        metadata = self.get_metadata(n)
        waveform = _load_waveform(self._path, metadata[0], metadata[1])
        return (waveform,) + metadata[1:]

    def __len__(self) -> int:
        return len(self.data)


# --------------------------------------------------------------------------
_SNIPS_SAMPLE_RATE = 16000
_SNIPS_SPEAKERS = [
    "Aditi", "Amy", "Brian", "Emma", "Geraint", "Ivy", "Joanna", "Joey",
    "Justin", "Kendra", "Kimberly", "Matthew", "Nicole", "Raveena", "Russell", "Salli",
]


class Snips:
    _trans_file = "all.iob.snips.txt"

    def __init__(self, root, subset: str, speakers: Optional[List[str]] = None, audio_format: str = "mp3") -> None:
        if subset not in ["train", "valid", "test"]:
            raise ValueError('`subset` must be one of ["train", "valid", "test"].')
        if audio_format not in ["mp3", "wav"]:
            raise ValueError('`audio_format` must be one of ["mp3", "wav].')
        root = Path(root)
        self._path = root / "SNIPS"
        audio_path = self._path / subset
        speakers = speakers or _SNIPS_SPEAKERS
        if not os.path.isdir(self._path):
            raise RuntimeError("Dataset not found.")
        self.data = []
        for audio_file in sorted(audio_path.glob(f"*.{audio_format}")):
            speaker = audio_file.name.split("-")[0]
            if speaker in speakers:
                self.data.append(audio_file)
        self.labels = self._load_labels(self._path / self._trans_file, subset)

    @staticmethod
    def _load_labels(file, subset):
        labels = {}
        with open(file, "r") as f:
            for line in f:
                line = line.strip().split(" ")
                index = line[0]
                trans, iob_intent = " ".join(line[1:]).split("\t")
                trans = " ".join(trans.split(" ")[1:-1])
                iob = " ".join(iob_intent.split(" ")[1:-1])
                intent = iob_intent.split(" ")[-1]
                if subset in index:
                    labels[index] = (trans, iob, intent)
        return labels

    def get_metadata(self, n: int):
        audio_path = self.data[n]
        relpath = os.path.relpath(audio_path, self._path)
        file_name = audio_path.with_suffix("").name
        transcript, iob, intent = self.labels[file_name]
        return relpath, _SNIPS_SAMPLE_RATE, file_name, transcript, iob, intent

    def __getitem__(self, n: int):
        metadata = self.get_metadata(n)
        waveform = _load_waveform(self._path, metadata[0], metadata[1])
        return (waveform,) + metadata[1:]

    def __len__(self) -> int:
        return len(self.data)


# --------------------------------------------------------------------------
_IEMOCAP_SAMPLE_RATE = 16000


class IEMOCAP:
    def __init__(self, root, sessions=(1, 2, 3, 4, 5), utterance_type: Optional[str] = None):
        root = Path(root)
        self._path = root / "IEMOCAP"
        if not os.path.isdir(self._path):
            raise RuntimeError("Dataset not found.")
        if utterance_type not in ["scripted", "improvised", None]:
            raise ValueError("utterance_type must be one of ['scripted', 'improvised', or None]")
        all_data = []
        self.data = []
        self.mapping = {}
        for session in sessions:
            session_dir = self._path / f"Session{session}"
            wav_dir = session_dir / "sentences" / "wav"
            wav_paths = sorted(str(p) for p in wav_dir.glob("*/*.wav"))
            rel_paths = []
            for wav_path in wav_paths:
                start = wav_path.find("Session")
                rel_paths.append(wav_path[start:])
            for wav_path in rel_paths:
                all_data.append(str(Path(wav_path).stem))
            label_dir = session_dir / "dialog" / "EmoEvaluation"
            query = "*.txt"
            if utterance_type == "scripted":
                query = "*script*.txt"
            elif utterance_type == "improvised":
                query = "*impro*.txt"
            for label_path in label_dir.glob(query):
                with open(label_path, "r") as f:
                    for line in f:
                        if not line.startswith("["):
                            continue
                        line = re.split("[\t\n]", line)
                        wav_stem, label = line[1], line[2]
                        if wav_stem not in all_data:
                            continue
                        if label not in ["neu", "hap", "ang", "sad", "exc", "fru"]:
                            continue
                        self.mapping[wav_stem] = {"label": label}
            for wav_path in rel_paths:
                wav_stem = str(Path(wav_path).stem)
                if wav_stem in self.mapping:
                    self.data.append(wav_stem)
                    self.mapping[wav_stem]["path"] = wav_path

    def get_metadata(self, n: int):
        wav_stem = self.data[n]
        wav_path = self.mapping[wav_stem]["path"]
        label = self.mapping[wav_stem]["label"]
        speaker = wav_stem.split("_")[0]
        return wav_path, _IEMOCAP_SAMPLE_RATE, wav_stem, label, speaker

    def __getitem__(self, n: int):
        metadata = self.get_metadata(n)
        waveform = _load_waveform(self._path, metadata[0], metadata[1])
        return (waveform,) + metadata[1:]

    def __len__(self) -> int:
        return len(self.data)


# --------------------------------------------------------------------------
gtzan_genres = ["blues", "classical", "country", "disco", "hiphop", "jazz", "metal", "pop", "reggae", "rock"]

# torchaudio's filtered splits (gtzan.py) stored as inclusive
# (start, end) track-number ranges per genre — expands to identical lists.
_GTZAN_SPLIT_RANGES = {
    "training": {
        "blues": [(29, 49), (73, 97)],
        "classical": [(30, 33), (43, 48), (50, 67), (80, 99)],
        "country": [(19, 26), (28, 29), (65, 99)],
        "disco": [(5, 5), (15, 20), (22, 37), (39, 45), (47, 47), (49, 49), (53, 54), (56, 57), (59, 59),
                  (61, 61), (70, 70), (73, 74), (89, 89)],
        "hiphop": [(2, 25), (28, 29), (31, 38), (41, 42), (55, 61), (77, 80)],
        "jazz": [(0, 1), (11, 24), (41, 41), (47, 72)],
        "metal": [(2, 3), (5, 5), (21, 21), (24, 24), (35, 35), (46, 57), (59, 66), (69, 69), (71, 72),
                  (79, 80), (84, 84), (86, 86), (89, 99)],
        "pop": [(2, 9), (11, 12), (16, 20), (23, 29), (31, 36), (38, 42), (44, 44), (46, 46), (49, 50),
                (80, 80), (97, 99)],
        "reggae": [(0, 2), (4, 4), (6, 6), (9, 9), (11, 12), (14, 32), (42, 45), (49, 51), (54, 60),
                   (63, 63), (69, 69)],
        "rock": [(0, 9), (16, 26), (57, 70), (91, 99)],
    },
    "validation": {
        "blues": [(0, 11), (50, 60)],
        "classical": [(0, 10), (68, 76)],
        "country": [(0, 7), (9, 18), (27, 27), (41, 42), (45, 45), (49, 49)],
        "disco": [(0, 0), (2, 4), (6, 14), (46, 46), (48, 48), (52, 52), (67, 68), (72, 72), (75, 75),
                  (90, 90), (95, 95)],
        "hiphop": [(81, 98)],
        "jazz": [(2, 10), (25, 32)],
        "metal": [(0, 1), (6, 11), (16, 20), (36, 37), (68, 68), (76, 77), (81, 82)],
        "pop": [(10, 10), (53, 53), (55, 55), (58, 62), (81, 81), (83, 86)],
        "reggae": [(61, 62), (70, 70), (72, 72), (74, 74), (76, 78), (85, 85), (92, 99)],
        "rock": [(38, 38), (49, 56), (71, 85)],
    },
    "testing": {
        "blues": [(12, 28), (61, 72), (98, 99)],
        "classical": [(11, 29), (34, 41), (49, 49), (77, 79)],
        "country": [(30, 40), (43, 44), (46, 48), (50, 51), (53, 64)],
        "disco": [(1, 1), (21, 21), (58, 58), (62, 66), (69, 69), (76, 88), (91, 94), (96, 97), (99, 99)],
        "hiphop": [(0, 0), (26, 27), (30, 30), (40, 40), (43, 45), (51, 54), (62, 75), (99, 99)],
        "jazz": [(73, 99)],
        "metal": [(12, 15), (22, 23), (25, 33), (38, 39), (67, 67), (70, 70), (73, 75), (78, 78), (83, 83),
                  (85, 85), (87, 88)],
        "pop": [(0, 1), (13, 14), (43, 43), (63, 66), (69, 79), (82, 82), (88, 96)],
        "reggae": [(34, 40), (46, 48), (52, 53), (64, 68), (71, 71), (79, 79), (82, 84), (87, 90)],
        "rock": [(10, 15), (27, 37), (39, 48), (86, 90)],
    },
}


def _expand_gtzan_split(subset: str) -> List[str]:
    names = []
    for genre in gtzan_genres:
        for start, end in _GTZAN_SPLIT_RANGES[subset].get(genre, []):
            names.extend(f"{genre}.{i:05d}" for i in range(start, end + 1))
    return names


_GTZAN_URL = "http://opihi.cs.uvic.ca/sound/genres.tar.gz"
_GTZAN_CHECKSUMS = {
    _GTZAN_URL: "24347e0223d2ba798e0a558c4c172d9d4a19c00bb7963fe055d183dadb4ef2c6",
}


class GTZAN:
    _ext_audio = ".wav"

    def __init__(self, root, url: str = _GTZAN_URL, folder_in_archive: str = "genres",
                 download: bool = False, subset: Optional[str] = None) -> None:
        root = os.fspath(root)
        self.subset = subset
        if subset is not None and subset not in ["training", "validation", "testing"]:
            raise ValueError("When `subset` is not None, it must be one of ['training', 'validation', 'testing'].")
        archive = os.path.join(root, os.path.basename(url))
        self._path = os.path.join(root, folder_in_archive)
        if download and not os.path.isdir(self._path):
            if not os.path.isfile(archive):
                download_url_to_file(url, archive, hash_prefix=_GTZAN_CHECKSUMS.get(url))
            _extract_tar(archive)
        if not os.path.isdir(self._path):
            raise RuntimeError("Dataset not found. Please use `download=True` to download it.")
        if subset is None:
            self._walker = []
            for directory in gtzan_genres:
                fulldir = os.path.join(self._path, directory)
                if not os.path.exists(fulldir):
                    continue
                seen = set()
                for fname in sorted(os.listdir(fulldir)):
                    name, ext = os.path.splitext(fname)
                    # the official archive ships .au; converted corpora .wav
                    if ext.lower() in (".wav", ".au") and "." in name and name not in seen:
                        genre, num = name.split(".")
                        if genre in gtzan_genres and len(num) == 5 and num.isdigit():
                            self._walker.append(name)
                            seen.add(name)
        else:
            self._walker = _expand_gtzan_split(subset)

    def __getitem__(self, n: int):
        fileid = self._walker[n]
        genre, _ = fileid.split(".")
        path = os.path.join(self._path, genre, fileid + self._ext_audio)
        if not os.path.exists(path):
            path = os.path.join(self._path, genre, fileid + ".au")
        waveform, sample_rate = io.load(path)
        return waveform, sample_rate, genre

    def __len__(self) -> int:
        return len(self._walker)
