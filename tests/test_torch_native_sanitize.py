"""The port's native loader (``native/__init__.py``): the sanitized build
variants of ``MRI_NATIVE_SANITIZE``, each under its own library name;
the prune that removes only its own variant's stale builds; the
fallback build directory under the temp root; the knob read on every
``load()``; and a bad value exiting 2 naming the variable.  The
sanitized runs of the native tests themselves are
``test_torch_native_sanitize_asan.py`` and ``..._ubsan.py``."""

import os
import re
import subprocess

import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.native import (
    _SANITIZE_FLAGS as JAX_SANITIZE_FLAGS,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.utils import (
    envknobs as jenvknobs,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import native
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.utils import envknobs

VARIANTS = ("", "asan", "ubsan")


@pytest.fixture
def fake_gxx(monkeypatch):
    """``g++`` replaced by a writer of an empty library; records argv."""
    calls = []

    def run(argv, **kw):
        calls.append(argv)
        out = argv[argv.index("-o") + 1]
        with open(out, "wb"):
            pass
        return subprocess.CompletedProcess(argv, 0)

    monkeypatch.setattr(native.subprocess, "run", run)
    return calls


@pytest.mark.parametrize("variant", VARIANTS)
def test_each_variant_has_its_own_stem_and_flags(variant, fake_gxx, monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    so = native._compile(variant)
    stem = "libmri_torch_scan_" + (f"{variant}_" if variant else "")
    assert re.fullmatch(re.escape(stem) + r"[0-9a-f]{12}\.so", so.name), so.name
    assert so.parent == tmp_path / "_build" and so.exists()
    for v in VARIANTS:  # every variant's exact-name pattern knows only its own
        assert bool(native._SO_NAME_RE[v].match(so.name)) == (v == variant)
    # the JAX loader's flags per variant, on top of the port's own
    assert fake_gxx[0][1:1 + len(native._CXX_FLAGS)] == native._CXX_FLAGS
    assert native._SANITIZE_FLAGS[variant] == JAX_SANITIZE_FLAGS[variant]
    assert all(f in fake_gxx[0] for f in native._SANITIZE_FLAGS[variant])
    native._compile(variant)  # built once, then found
    assert len(fake_gxx) == 1


def test_prune_keeps_the_other_variants(tmp_path):
    names = {v: [f"libmri_torch_scan_{v + '_' if v else ''}{h * 12}.so" for h in "ab"]
             for v in VARIANTS}
    for group in names.values():
        for n in group:
            (tmp_path / n).write_bytes(b"")
    tmp = tmp_path / f"{names[''][0]}.4242.tmp"
    tmp.write_bytes(b"")
    native._prune_stale(names[""][0], "", tmp_path)  # production: its own only
    left = {p.name for p in tmp_path.iterdir()}
    assert names[""][1] not in left and names[""][0] in left and tmp.name in left
    assert set(names["asan"] + names["ubsan"]) <= left
    native._prune_stale(names["asan"][1], "asan", tmp_path)  # and the reverse
    left = {p.name for p in tmp_path.iterdir()}
    assert names["asan"][0] not in left and names["asan"][1] in left
    assert set(names["ubsan"]) <= left and names[""][0] in left


@pytest.mark.parametrize("cause", ["mkdir_fails", "read_only"])
def test_unwritable_build_dir_falls_back_to_the_temp_root(cause, fake_gxx, monkeypatch,
                                                          tmp_path):
    if cause == "mkdir_fails":
        blocker = tmp_path / "not_a_dir"
        blocker.write_bytes(b"")  # _build under a file: mkdir fails whoever runs
        build = blocker / "_build"
    else:  # a directory this user may not write (as root, say so by hand)
        build = tmp_path / "_build"
        real_access = native.os.access
        monkeypatch.setattr(native.os, "access",
                            lambda path, mode: path != build and real_access(path, mode))
    monkeypatch.setattr(native, "_BUILD_DIR", build)
    monkeypatch.setattr(native.tempfile, "gettempdir", lambda: str(tmp_path / "tmp"))
    so = native._compile("ubsan")
    assert so.parent == tmp_path / "tmp" / f"mri_tpu_torch_native_{os.getuid()}"
    assert so.exists() and so.name.startswith("libmri_torch_scan_ubsan_")


def test_knob_is_declared_as_in_jax(monkeypatch):
    j = jenvknobs._REGISTRY["MRI_NATIVE_SANITIZE"]
    t = envknobs._KNOBS["MRI_NATIVE_SANITIZE"]
    assert (t.cast, t.default, t.choices) == (j.cast, j.default, j.choices)
    monkeypatch.setenv("MRI_NATIVE_SANITIZE", "tsan")
    with pytest.raises(ValueError) as terr:
        envknobs.get("MRI_NATIVE_SANITIZE")
    with pytest.raises(ValueError) as jerr:
        jenvknobs.get("MRI_NATIVE_SANITIZE")
    assert str(terr.value) == str(jerr.value)


def test_load_rereads_the_knob(monkeypatch):
    """A changed variant drops the cached handle and loads its own build
    (the production library stands in for every variant here)."""
    prod = native._compile("")
    asked = []

    def compile_(variant=""):
        asked.append(variant)
        return prod

    monkeypatch.setattr(native, "_compile", compile_)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", None)
    monkeypatch.setattr(native, "_lib_variant", "")
    monkeypatch.delenv("MRI_NATIVE_SANITIZE", raising=False)
    first = native.load()
    assert native.load() is first and asked == [""]
    monkeypatch.setenv("MRI_NATIVE_SANITIZE", "ubsan")
    second = native.load()
    assert second is not first and asked == ["", "ubsan"]
    monkeypatch.setenv("MRI_NATIVE_SANITIZE", "loud")
    with pytest.raises(ValueError, match="MRI_NATIVE_SANITIZE"):
        native.load()


@pytest.mark.parametrize("argv", [[], ["--backend", "cpu"]])
def test_bad_knob_exits_2_naming_it(argv, smoke_fixture, monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("MRI_NATIVE_SANITIZE", "msan")
    monkeypatch.setattr(native, "_lib_variant", None)
    rc = tcli.main(["4", "26", str(smoke_fixture / "manifest.txt"), "--device", "cpu",
                    "--output-dir", str(tmp_path / "out"), *argv])
    assert rc == 2
    assert "MRI_NATIVE_SANITIZE" in capsys.readouterr().err
