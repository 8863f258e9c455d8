"""The port's ``utils`` (checkpoints, profiling, the asset cache), ``_internal`` and the exports of its top level,
``io``, ``datasets`` and ``utils`` against the JAX package.

Checkpoints: a train state (a model's and AdamW's ``state_dict``, a generator, Python values) saved with
``torch.save`` and restored bit for bit, ``max_to_keep`` pruning the oldest steps, ``latest_step``, and restoring onto
the devices of ``like``.  Profiling: ``benchmark`` returns the JAX version's keys, ``trace`` writes a Chrome trace
holding the block's annotation, ``compiled_cost`` counts a product's FLOPs under the JAX version's keys and says what
it did not count.  The cache: ``_download_asset`` returns a file already there without fetching (the fetch is
replaced by one that raises), checks a hash, and fetches a missing one through ``_internal.download``, which the
test points at a ``file://`` URL.  No test reaches the network.
"""

import inspect
import json
import os
import warnings

import numpy as np
import pytest
import torch

import audio_tpu
import audio_tpu._internal as j_internal
import audio_tpu.datasets as jds
import audio_tpu.io as jio
import audio_tpu.utils as jutils
from audio_tpu._internal import module_utils as j_mu

import audio_tpu_torch
import audio_tpu_torch._internal as t_internal
import audio_tpu_torch.datasets as tds
import audio_tpu_torch.io as tio
import audio_tpu_torch.utils as tutils
from audio_tpu_torch._internal import download as t_download
from audio_tpu_torch._internal import module_utils as t_mu
from audio_tpu_torch.utils import download as t_asset

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


def _train_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.LayerNorm(5), torch.nn.Linear(5, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.randn(4, 6, generator=g)).square().sum().backward()
    opt.step()
    draw = torch.Generator().manual_seed(seed + 1)
    torch.rand(5, generator=draw)
    return {"model": model.state_dict(), "optimizer": opt.state_dict(), "generator": draw, "step": 7,
            "note": ("adamw", [1, 2.5])}


def _assert_same_tree(got, want, where="state"):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype and torch.equal(got, want), where
    elif isinstance(want, torch.Generator):
        assert isinstance(got, torch.Generator) and torch.equal(got.get_state(), want.get_state()), where
    elif isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same_tree(a, b, f"{where}[{i}]")
    else:
        assert type(got) is type(want) and got == want, where


def test_checkpoint_round_trip_prunes_and_names_the_latest_step(tmp_path):
    state = _train_state()
    mgr = tutils.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.restore(device="cpu") is None and mgr.latest_step() is None
    for step in (7, 8, 9):
        assert mgr.save(step, {**state, "step": step})
    assert mgr.latest_step() == 9 and mgr.all_steps() == [8, 9]  # step 7 pruned
    assert tutils.latest_step(str(tmp_path / "ckpt")) == 9
    restored = mgr.restore(device="cpu")
    _assert_same_tree(restored, {**state, "step": 9})
    _assert_same_tree(mgr.restore(step=8, like=state), {**state, "step": 8})
    assert torch.equal(torch.rand(3, generator=restored["generator"]), torch.rand(3, generator=state["generator"]))
    assert not mgr.save(9, state) and mgr.save(9, state, force=True)  # a saved step is replaced only with force
    mgr.close()


def test_one_shot_save_and_restore_onto_like_s_devices(tmp_path):
    state = _train_state(3)
    tutils.save_checkpoint(str(tmp_path), 5, state, max_to_keep=1)
    tutils.save_checkpoint(str(tmp_path), 6, state, max_to_keep=1)
    assert sorted(os.listdir(tmp_path)) == ["6"] and tutils.latest_step(str(tmp_path)) == 6
    like = tutils.restore_checkpoint(str(tmp_path), like=state)
    _assert_same_tree(like, state)
    assert all(t.device.type == "cpu" for t in like["model"].values())
    # the optimizer's state goes back into a fresh AdamW and steps as the saved one does
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.LayerNorm(5), torch.nn.Linear(5, 3))
    model.load_state_dict(like["model"])
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    opt.load_state_dict(like["optimizer"])
    _assert_same_tree(opt.state_dict(), state["optimizer"])


def test_restore_defaults_to_the_card():
    assert inspect.signature(tutils.restore_checkpoint).parameters["device"].default == "cuda"
    assert inspect.signature(tutils.CheckpointManager.restore).parameters["device"].default == "cuda"


def test_benchmark_returns_the_jax_version_s_keys():
    calls = []
    out = tutils.benchmark(lambda x: calls.append(1) or x * 2, torch.ones(4), warmup=2, iters=3)
    assert set(out) == {"mean_seconds", "iters_per_second"} and out["mean_seconds"] > 0 and len(calls) == 5
    assert out["iters_per_second"] == pytest.approx(1.0 / out["mean_seconds"])


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with tutils.trace(str(tmp_path / "tr")) as prof:
        with tutils.annotate("the_block"):
            torch.ones(8) @ torch.ones(8)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = json.loads((tmp_path / "tr" / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "the_block" for e in events)
    assert any(e.key == "the_block" for e in prof.key_averages())


def test_compiled_cost_counts_a_product_and_says_what_it_did_not_count():
    x = torch.ones(64, 32)
    cost = tutils.compiled_cost(lambda a: (a @ a.T).sum(), x)
    jax_cost = jutils.compiled_cost(lambda a: a @ a.T, np.ones((64, 32), np.float32))
    assert set(cost) == set(jax_cost) == {"flops", "bytes_accessed", "raw"}
    assert cost["flops"] == 2 * 64 * 64 * 32 and cost["bytes_accessed"] is None
    assert cost["raw"]["flops_by_operator"] == {"aten.mm": 2 * 64 * 64 * 32}
    assert "bytes_accessed" in cost["raw"]["not_counted"]
    assert tutils.compiled_cost(lambda a: a.exp().sum(), x)["flops"] is None  # no product: nothing counted


def test_download_asset_returns_a_cached_file_without_fetching(tmp_path, monkeypatch):
    def no_fetch(*a, **k):
        raise AssertionError("fetched")

    monkeypatch.setattr(t_asset, "download_url_to_file", no_fetch)
    monkeypatch.setenv("AUDIO_TPU_HOME", str(tmp_path))
    cached = tmp_path / "pipeline-assets" / "x.json"
    cached.parent.mkdir(parents=True)
    cached.write_bytes(b"{}")
    assert tutils._download_asset("pipeline-assets/x.json") == tutils.download_asset("pipeline-assets/x.json") \
        == str(cached)
    digest = t_asset._get_hash(cached)
    assert tutils._download_asset("pipeline-assets/x.json", hash=digest) == str(cached)
    with pytest.raises(ValueError, match="does not match"):
        tutils._download_asset("pipeline-assets/x.json", hash="0" * 64)
    other = tmp_path / "elsewhere.bin"
    other.write_bytes(b"1")
    assert tutils._download_asset("models/y.pt", path=str(other)) == str(other)


def test_download_asset_fetches_a_missing_one_from_its_route(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(t_asset, "download_url_to_file",
                        lambda url, dst, progress=True: seen.append(url) or open(dst, "wb").close())
    monkeypatch.setenv("AUDIO_TPU_HOME", str(tmp_path))
    path = tutils._download_asset("models/a.pt")
    assert seen == ["https://download.pytorch.org/torchaudio/models/a.pt"] and os.path.isfile(path)
    tutils._download_asset("https://example.invalid/b.pt")
    assert seen[-1] == "https://example.invalid/b.pt"


def test_the_pipelines_reach_the_one_asset_cache():
    from audio_tpu_torch.pipelines import rnnt_pipeline

    assert rnnt_pipeline._download_asset is tutils._download_asset


def test_download_url_to_file_checks_the_hash_prefix(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"audio" * 1000)
    digest = t_asset._get_hash(src)
    dst = tmp_path / "out" / "dst.bin"
    t_download.download_url_to_file(src.as_uri(), str(dst), hash_prefix=digest[:10])
    assert dst.read_bytes() == src.read_bytes()
    bad = tmp_path / "out" / "bad.bin"
    with pytest.raises(RuntimeError, match="invalid hash value"):
        t_download.download_url_to_file(src.as_uri(), str(bad), hash_prefix="00000000")
    assert not bad.exists() and sorted(os.listdir(tmp_path / "out")) == ["dst.bin"]


def test_module_utils_behave_as_the_jax_package_s():
    assert t_mu.is_module_available("torch") and not t_mu.is_module_available("torch", "no_such_module_xyz")

    def f(x):
        return x + 1

    assert t_mu.requires_module("torch")(f)(1) == 2
    with pytest.raises(RuntimeError) as terr:
        t_mu.requires_module("no_such_module_xyz")(f)(1)
    with pytest.raises(RuntimeError) as jerr:
        j_mu.requires_module("no_such_module_xyz")(f)(1)
    assert str(terr.value) == str(jerr.value)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        assert t_mu.deprecated("Use g.", "2.0", remove=True)(f)(1) == 2
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j_mu.deprecated("Use g.", "2.0", remove=True)(f)(1)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    with pytest.raises(RuntimeError, match="f is unavailable"):
        t_mu.fail_with_message("is unavailable")(f)(1)
    assert t_mu.no_op(f) is f


def test_internal_exports_every_name_but_eval_env():
    """``eval_env`` is the one name of the JAX package's ``_internal`` the port leaves out: its one use there reads an
    environment variable to switch the spectrogram onto its Pallas kernel, and the port reads none to pick a path
    (``test_torch_hygiene.py``)."""
    jax_names = {n for n in dir(j_internal) if not n.startswith("_")}
    port_names = {n for n in dir(t_internal) if not n.startswith("_")}
    assert jax_names - port_names == {"eval_env"}
    assert {"deprecated", "fail_with_message", "is_module_available", "no_op", "requires_module",
            "windows"} <= port_names
    assert set(t_mu.__all__) == {n for n in vars(j_mu) if not n.startswith("_") and callable(getattr(j_mu, n))
                                 and getattr(j_mu, n).__module__ == j_mu.__name__} - {"eval_env"}


@pytest.mark.parametrize("pair", ["top level", "io", "datasets", "utils"])
def test_exports_equal_the_jax_package_s(pair):
    jax_mod, port_mod, count = {"top level": (audio_tpu, audio_tpu_torch, 16), "io": (jio, tio, 6),
                                "datasets": (jds, tds, 22), "utils": (jutils, tutils, 12)}[pair]
    assert sorted(port_mod.__all__) == sorted(jax_mod.__all__) and len(set(port_mod.__all__)) == count
    for name in port_mod.__all__:
        assert hasattr(port_mod, name), name
        jax_obj, port_obj = getattr(jax_mod, name), getattr(port_mod, name)
        kind = inspect.ismodule if inspect.ismodule(jax_obj) else inspect.isclass if inspect.isclass(jax_obj) \
            else (lambda o: isinstance(o, str)) if name == "__version__" else callable
        assert kind(port_obj), name


@pytest.mark.parametrize("name", ["load", "save", "info", "load_with_torchcodec", "save_with_torchcodec",
                                  "save_checkpoint", "restore_checkpoint", "latest_step", "trace", "benchmark",
                                  "compiled_cost", "download_asset"])
def test_the_functions_keep_the_jax_signatures(name):
    """The same parameters, defaults and order; ``restore_checkpoint`` adds one, ``device`` (the card by default),
    where the JAX package restores onto the default device."""
    mod_j, mod_t = (jio, tio) if hasattr(jio, name) else (jutils, tutils)

    def params(fn):
        return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]

    want, got = params(getattr(mod_j, name)), params(getattr(mod_t, name))
    if name == "restore_checkpoint":
        want = want + [("device", "cuda")]
    assert got == want
