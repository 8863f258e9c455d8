"""The port's 22 datasets against ``audio_tpu.datasets``, one case each, on mock trees the test writes.

Each case writes a small corpus in the dataset's own layout (the mock trees of ``tests/datasets/``), opens it with
both packages' class and the same arguments, and compares every item: waveforms bit for bit (the port's CPU tensor
against the JAX package's numpy array, type included), every other field equal and of the same Python type (a tuple
stays a tuple, a list a list, an int an int).  Nothing is downloaded.
"""

import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import audio_tpu.datasets as jds
import audio_tpu.io as jio

import audio_tpu_torch.datasets as tds

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


def _save(path, sr=16000, t=400, ch=1, seed=0):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    wav = (np.random.default_rng(seed).standard_normal((ch, t)) * 0.1).astype(np.float32)
    jio.save(str(path), wav, sr)


def _librispeech_like(root, top, spk=84, chap=121123, n=2):
    d = Path(root) / top / str(spk) / str(chap)
    lines = []
    for u in range(n):
        fileid = f"{spk}-{chap}-{u:04d}"
        _save(d / f"{fileid}.flac", seed=u)
        lines.append(f"{fileid} HELLO BIAS WORLD {u}\n")
    (d / f"{spk}-{chap}.trans.txt").write_text("".join(lines))


def _write_sph(path, pcm, rate):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    header = (f"NIST_1A\n   1024\nsample_rate -i {rate}\nchannel_count -i 1\nsample_n_bytes -i 2\n"
              f"sample_byte_format -s2 01\nsample_coding -s3 pcm\nsample_count -i {pcm.size}\nend_head\n").encode()
    with open(path, "wb") as f:
        f.write(header + b" " * (1024 - len(header)) + pcm.astype("<i2").tobytes())


def build_librispeech(tmp):
    _librispeech_like(tmp / "LibriSpeech", "dev-clean")
    _librispeech_like(tmp / "LibriSpeech", "dev-clean", spk=1272, chap=128104, n=1)
    return (str(tmp),), {"url": "dev-clean"}


def build_librispeech_biasing(tmp):
    _librispeech_like(tmp / "LibriSpeech", "dev-clean")
    return (str(tmp),), {"url": "dev-clean", "blist": ["BIAS", "MISSING"]}


def build_librilight_limited(tmp):
    _librispeech_like(tmp / "librispeech_finetuning", os.path.join("1h", "0", "clean"))
    return (str(tmp),), {"subset": "10min"}


def build_yesno(tmp):
    for i, lab in enumerate([[0, 1, 0, 1, 0, 1, 1, 0], [1, 1, 1, 0, 0, 0, 1, 0]]):
        _save(tmp / "waves_yesno" / ("_".join(map(str, lab)) + ".wav"), sr=8000, seed=i)
    return (str(tmp),), {}


def build_speechcommands(tmp):
    base = tmp / "SpeechCommands" / "speech_commands_v0.02"
    for j, label in enumerate(("yes", "no")):
        for i in range(2):
            _save(base / label / f"speaker{i:02d}_nohash_{i}.wav", t=300, seed=2 * j + i)
    (base / "validation_list.txt").write_text("yes/speaker00_nohash_0.wav\n")
    (base / "testing_list.txt").write_text("no/speaker01_nohash_1.wav\n")
    return (str(tmp),), {"subset": "training"}


def build_ljspeech(tmp):
    base = tmp / "LJSpeech-1.1"
    rows = []
    for i in range(3):
        _save(base / "wavs" / f"LJ001-{i:04d}.wav", sr=22050, t=500, seed=i)
        rows.append(f"LJ001-{i:04d}|Transcript {i}|Normalized {i}")
    (base / "metadata.csv").write_text("\n".join(rows) + "\n")
    return (str(tmp),), {}


def build_cmuarctic(tmp):
    base = tmp / "ARCTIC" / "cmu_us_aew_arctic"
    _save(base / "wav" / "arctic_a0001.wav")
    _save(base / "wav" / "arctic_a0002.wav", seed=1)
    (base / "etc").mkdir(parents=True, exist_ok=True)
    (base / "etc" / "txt.done.data").write_text('( arctic_a0001 "Author of the danger trail." )\n'
                                                '( arctic_a0002 "Philip Steels, etc." )\n')
    return (str(tmp),), {"url": "aew"}


def build_cmudict(tmp):
    (tmp / "cmudict-0.7b").write_text(";;; comment\n!EXCLAMATION-POINT  EH2 K S K L AH0 M EY1 SH AH0 N P OY2 N T\n"
                                      "HELLO  HH AH0 L OW1\nWORLD(1)  W ER1 L D\n", encoding="latin-1")
    (tmp / "cmudict-0.7b.symbols").write_text("AH0\nEH2\nHH\n")
    return (str(tmp),), {"exclude_punctuations": False}


def build_vctk(tmp):
    base = tmp / "VCTK-Corpus-0.92"
    (base / "txt" / "p225").mkdir(parents=True)
    (base / "txt" / "p225" / "p225_001.txt").write_text("Please call Stella.\n")
    _save(base / "wav48_silence_trimmed" / "p225" / "p225_001_mic2.flac", sr=48000)
    return (str(tmp),), {}


def build_dr_vctk(tmp):
    base = tmp / "DR-VCTK" / "DR-VCTK"
    _save(base / "clean_trainset_wav_16k" / "p226_001.wav")
    _save(base / "device-recorded_trainset_wav_16k" / "p226_001.wav", seed=1)
    (base / "configurations").mkdir(parents=True, exist_ok=True)
    (base / "configurations" / "train_ch_log.txt").write_text("header row\nsecond skip row\n"
                                                              "p226_001.wav\tofficedevice\t3\n")
    return (str(tmp),), {"subset": "train"}


def build_commonvoice(tmp):
    _save(tmp / "clips" / "sample1.mp3", sr=48000)  # WAV bytes: the loaders tell containers by magic bytes
    (tmp / "train.tsv").write_text("client_id\tpath\tsentence\tup_votes\nabc\tsample1.mp3\thello world\t2\n")
    return (str(tmp),), {}


def build_fluent(tmp):
    base = tmp / "fluent_speech_commands_dataset"
    _save(base / "wavs" / "speakers" / "spk1" / "utt0.wav")
    (base / "data").mkdir(parents=True, exist_ok=True)
    (base / "data" / "train_data.csv").write_text(",path,speakerId,transcription,action,object,location\n"
                                                  "0,wavs/speakers/spk1/utt0.wav,spk1,turn on the lights,activate,"
                                                  "lights,none\n")
    return (str(tmp),), {"subset": "train"}


def build_snips(tmp):
    base = tmp / "SNIPS"
    _save(base / "train" / "Aditi-snips-train-0.wav")
    (base / "all.iob.snips.txt").write_text("Aditi-snips-train-0 BOS hello world EOS\tO O O greeting\n"
                                            "Aditi-snips-test-0 BOS bye EOS\tO O farewell\n")
    return (str(tmp),), {"subset": "train", "audio_format": "wav"}


def build_iemocap(tmp):
    base = tmp / "IEMOCAP" / "Session1"
    for i in range(2):
        _save(base / "sentences" / "wav" / "Ses01F_impro01" / f"Ses01F_impro01_F00{i}.wav", seed=i)
    lab = base / "dialog" / "EmoEvaluation"
    lab.mkdir(parents=True, exist_ok=True)
    (lab / "Ses01F_impro01.txt").write_text("% header\n[6.2901 - 8.2357]\tSes01F_impro01_F000\tneu\t[2.5, 2.5, 2.5]\n"
                                            "[9.0000 - 9.5000]\tSes01F_impro01_F001\thap\t[2.5, 2.5, 2.5]\n")
    return (str(tmp),), {"sessions": (1,)}


def build_gtzan(tmp):
    d = tmp / "genres" / "jazz"
    d.mkdir(parents=True)
    pcm = (np.sin(2 * np.pi * 440 * np.arange(2000) / 22050) * 12000).astype(np.int16)
    with open(d / "jazz.00000.au", "wb") as f:
        f.write(b".snd" + struct.pack(">IIIII", 24, pcm.nbytes, 3, 22050, 1) + pcm.astype(">i2").tobytes())
    _save(tmp / "genres" / "blues" / "blues.00001.wav", sr=22050, t=300)
    return (str(tmp),), {}


def build_libritts(tmp):
    base = tmp / "LibriTTS" / "dev-clean" / "84" / "121123"
    fileid = "84_121123_000007_000001"
    _save(base / f"{fileid}.wav", sr=24000)
    (base / f"{fileid}.original.txt").write_text("Original text!")
    (base / f"{fileid}.normalized.txt").write_text("normalized text!")
    return (str(tmp),), {"url": "dev-clean"}


def build_tedlium(tmp):
    base = tmp / "TEDLIUM_release-3" / "data"
    (base / "stm").mkdir(parents=True)
    pcm = (np.sin(2 * np.pi * 250 * np.arange(3 * 16000) / 16000) * 15000).astype(np.int16)
    _write_sph(str(base / "sph" / "TalkA.sph"), pcm, 16000)
    (base / "stm" / "TalkA.stm").write_text("TalkA 1 speaker_a 0.5 1.5 <o,f0,male> hello ted talk\n"
                                            "TalkA 1 speaker_a 1.5 2.5 <o,f0,male> second segment\n")
    (tmp / "TEDLIUM_release-3" / "TEDLIUM.152k.dic").write_text("hello HH AH L OW\nted T EH D\ntalk(2) T AO K\n")
    return (str(tmp),), {"release": "release3", "subset": "train"}


def build_musdb(tmp):
    base = tmp / "musdb18hq" / "train" / "Artist - Song"
    for i, s in enumerate(("bass", "drums", "other", "vocals")):
        _save(base / f"{s}.wav", sr=44100, t=1000, ch=2, seed=i)
    return (str(tmp),), {"subset": "train"}


def build_librimix(tmp):
    base = tmp / "Libri2Mix" / "wav8k" / "min" / "train-360"
    for i, d in enumerate(("mix_clean", "s1", "s2")):
        _save(base / d / "both.wav", sr=8000, seed=i)
    return (str(tmp),), {"subset": "train-360", "num_speakers": 2, "sample_rate": 8000}


def build_quesst14(tmp):
    base = tmp / "quesst14Database"
    _save(base / "Audio" / "quesst14_00001.wav", sr=8000)
    _save(base / "Audio" / "quesst14_00002.wav", sr=8000, seed=1)
    (base / "scoring").mkdir(parents=True, exist_ok=True)
    (base / "scoring" / "language_key_utterances.lst").write_text(
        "quesst14Database/Audio/quesst14_00001.wav nnenglish\nquesst14Database/Audio/quesst14_00002.wav czech\n")
    return (str(tmp),), {"subset": "docs", "language": None}


def build_vox_identification(tmp):
    _save(tmp / "wav" / "id10001" / "clipA" / "00001.wav")
    _save(tmp / "wav" / "id10002" / "clipB" / "00001.wav", seed=1)
    (tmp / "iden_split.txt").write_text("1 id10001/clipA/00001.wav\n3 id10002/clipB/00001.wav\n")
    return (str(tmp),), {"subset": "train"}


def build_vox_verification(tmp):
    _save(tmp / "wav" / "id10001" / "clipA" / "00001.wav")
    _save(tmp / "wav" / "id10002" / "clipB" / "00001.wav", seed=1)
    (tmp / "veri_test.txt").write_text("1 id10001/clipA/00001.wav id10002/clipB/00001.wav\n"
                                       "0 id10002/clipB/00001.wav id10001/clipA/00001.wav\n")
    return (str(tmp),), {}


BUILDERS = {"LIBRISPEECH": build_librispeech, "LibriSpeechBiasing": build_librispeech_biasing,
            "LibriLightLimited": build_librilight_limited, "YESNO": build_yesno, "SPEECHCOMMANDS": build_speechcommands,
            "LJSPEECH": build_ljspeech, "CMUARCTIC": build_cmuarctic, "CMUDict": build_cmudict,
            "VCTK_092": build_vctk, "DR_VCTK": build_dr_vctk, "COMMONVOICE": build_commonvoice,
            "FluentSpeechCommands": build_fluent, "Snips": build_snips, "IEMOCAP": build_iemocap,
            "GTZAN": build_gtzan, "LIBRITTS": build_libritts, "TEDLIUM": build_tedlium, "MUSDB_HQ": build_musdb,
            "LibriMix": build_librimix, "QUESST14": build_quesst14, "VoxCeleb1Identification": build_vox_identification,
            "VoxCeleb1Verification": build_vox_verification}


def _same(got, want, where: str) -> None:
    if isinstance(got, torch.Tensor):
        want = np.asarray(want)
        assert got.device.type == "cpu" and got.dtype == torch.from_numpy(np.zeros(0, want.dtype)).dtype, where
        assert tuple(got.shape) == want.shape, where
        np.testing.assert_array_equal(got.numpy(), want, err_msg=where)
    elif isinstance(got, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(got, dict):
        assert type(got) is type(want) and list(got) == list(want), where
        for k in got:
            _same(got[k], want[k], f"{where}[{k!r}]")
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def test_the_cases_cover_every_dataset():
    assert sorted(BUILDERS) == sorted(tds.__all__) == sorted(jds.__all__) and len(BUILDERS) == 22


@pytest.mark.parametrize("name", list(BUILDERS))
def test_every_item_equals_the_jax_package_s(name, tmp_path):
    args, kwargs = BUILDERS[name](tmp_path)
    want_ds = getattr(jds, name)(*args, **kwargs)
    got_ds = getattr(tds, name)(*args, **kwargs)
    assert len(got_ds) == len(want_ds) > 0, name
    for n in range(len(want_ds)):
        _same(got_ds[n], want_ds[n], f"{name}[{n}]")
        if hasattr(want_ds, "get_metadata"):
            _same(got_ds.get_metadata(n), want_ds.get_metadata(n), f"{name}.get_metadata({n})")
    for attr in ("symbols", "phoneme_dict", "_walker"):
        if hasattr(want_ds, attr):
            _same(getattr(got_ds, attr), getattr(want_ds, attr), f"{name}.{attr}")


def test_a_data_loader_takes_the_port_s_items(tmp_path):
    build_librispeech(tmp_path)
    ds = tds.LIBRISPEECH(str(tmp_path), url="dev-clean")
    loader = torch.utils.data.DataLoader(ds, batch_size=2, collate_fn=list)
    items = [item for batch in loader for item in batch]
    assert len(items) == 3 and all(isinstance(w, torch.Tensor) for w, *_ in items)
    _same(items[0], jds.LIBRISPEECH(str(tmp_path), url="dev-clean")[0], "loader[0]")


def test_a_missing_corpus_raises_and_nothing_is_fetched(tmp_path, monkeypatch):
    from audio_tpu_torch._internal import download

    def no_fetch(*a, **k):
        raise AssertionError("a dataset fetched")

    monkeypatch.setattr(download, "download_url_to_file", no_fetch)
    with pytest.raises(RuntimeError, match="Dataset not found"):
        tds.LIBRISPEECH(str(tmp_path), url="dev-clean")
    with pytest.raises(ValueError, match="Invalid url"):
        tds.LIBRISPEECH(str(tmp_path), url="dev-nothing")
