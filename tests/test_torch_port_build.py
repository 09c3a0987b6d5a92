"""The key under which the port's CUDA sources build (``ops/_nvcc``) covers
the source, every header beside it and the compiler flags, so an edited
header never loads a library built from the old one.  No ``nvcc`` runs:
the sources live in a temporary ``csrc``.  The window transport's native
service (``native/``) is keyed the same way, and a failed ``g++`` build
raises."""

import re

import pytest

from bluefog_tpu_torch import native as _native
from bluefog_tpu_torch.ops import _nvcc

REAL_CSRC = _nvcc.CSRC_DIR


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "k.cu").write_text('#include "h.cuh"\nint f() { return g(); }\n')
    (d / "h.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(_nvcc, "CSRC_DIR", d)
    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path / "_build")
    return d


def test_key_is_stable(csrc):
    assert _nvcc.library_path("k") == _nvcc.library_path("k")
    assert _nvcc.library_path("k").parent == _nvcc.BUILD_DIR


@pytest.mark.parametrize("edit", ["source", "header", "new_header",
                                  "renamed_header", "flags"])
def test_key_changes_with_what_the_build_reads(csrc, monkeypatch, edit):
    before = _nvcc.library_path("k")
    if edit == "source":
        (csrc / "k.cu").write_text('#include "h.cuh"\nint f() { return 2; }\n')
    elif edit == "header":
        (csrc / "h.cuh").write_text("inline int g() { return 2; }\n")
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("// new\n")
    elif edit == "renamed_header":
        (csrc / "h.cuh").rename(csrc / "h2.cuh")
    else:
        monkeypatch.setattr(_nvcc, "NVCC_FLAGS", _nvcc.NVCC_FLAGS + ("-lineinfo",))
    assert _nvcc.library_path("k") != before


def test_key_covers_the_macro_definitions(csrc):
    """One source builds a library per definition (the flash kernels' one
    per head-dim instance): each its own key, the same key for the same
    definition."""
    keys = {d: _nvcc.library_path("k", d)
            for d in ((), ("FLASH_D=64",), ("FLASH_D=128",))}
    assert len(set(keys.values())) == 3
    assert _nvcc.library_path("k", ("FLASH_D=64",)) == keys[("FLASH_D=64",)]


def test_key_ignores_another_source(csrc):
    before = _nvcc.library_path("k")
    (csrc / "other.cu").write_text("int h() { return 3; }\n")
    assert _nvcc.library_path("k") == before


def test_built_library_is_reused_without_nvcc(csrc, monkeypatch):
    path = _nvcc.library_path("k")
    path.parent.mkdir(parents=True)
    path.write_bytes(b"")
    monkeypatch.setattr(_nvcc, "_nvcc", lambda: pytest.fail("nvcc was run"))
    assert _nvcc.build("k") == (path, "")


def test_header_edit_forces_a_rebuild(csrc, monkeypatch):
    """A library built before a header edit is not loaded after it."""
    stale = _nvcc.library_path("k")
    stale.parent.mkdir(parents=True)
    stale.write_bytes(b"")
    (csrc / "h.cuh").write_text("inline int g() { return 2; }\n")

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_nvcc, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _nvcc.build("k")


@pytest.mark.parametrize("src", sorted(p.name for p in REAL_CSRC.glob("*.cu")))
def test_real_sources_include_only_keyed_headers(src):
    """Every local header a source includes sits in csrc/ as a .cuh, so the
    key covers it."""
    local = re.findall(r'^\s*#include\s+"([^"]+)"', (REAL_CSRC / src).read_text(),
                       re.M)
    assert local, f"{src} includes no local header"
    for name in local:
        assert name.endswith(".cuh") and (REAL_CSRC / name).is_file(), name


# ---------------------------------------------------------------------------
# The window transport's native service (``bluefog_tpu_torch/native``):
# built with g++ into the same directory, keyed the same way.
# ---------------------------------------------------------------------------


@pytest.fixture
def nsrc(tmp_path, monkeypatch):
    d = tmp_path / "src"
    d.mkdir()
    (d / "winsvc.cc").write_text('#include "h.h"\nint f() { return g(); }\n')
    (d / "h.h").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(_native, "SRC_DIR", d)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    return d


def test_native_key_is_stable(nsrc):
    assert _native.library_path() == _native.library_path()
    assert _native.library_path().parent == _native.BUILD_DIR


@pytest.mark.parametrize("edit", ["source", "header", "new_header", "flags",
                                  "fastcall"])
def test_native_key_changes_with_what_the_build_reads(nsrc, monkeypatch,
                                                      edit):
    before = _native.library_path()
    fast_before = _native.fastcall_path()
    if edit == "fastcall":
        # The fastcall module links against the service: one key for both.
        (nsrc / "fastcall.cc").write_text("// the send module\n")
        assert _native.fastcall_path() != fast_before
    elif edit == "source":
        (nsrc / "winsvc.cc").write_text("int f() { return 2; }\n")
    elif edit == "header":
        (nsrc / "h.h").write_text("inline int g() { return 2; }\n")
    elif edit == "new_header":
        (nsrc / "extra.h").write_text("// new\n")
    else:
        monkeypatch.setattr(_native, "CXX_FLAGS",
                            _native.CXX_FLAGS + ("-g",))
    assert _native.library_path() != before


def test_native_flags_keep_float_contraction_off():
    """The drain's fold promises f32 sums bit for bit the Python fold's:
    a fused multiply-add would break that (the JAX Makefile's flag)."""
    assert "-ffp-contract=off" in _native.CXX_FLAGS


def test_native_built_library_is_reused_without_a_compiler(nsrc,
                                                           monkeypatch):
    path = _native.library_path()
    path.parent.mkdir(parents=True)
    path.write_bytes(b"")
    monkeypatch.setattr(_native, "_cxx",
                        lambda: pytest.fail("the compiler was run"))
    assert _native.build() == path


def test_native_failed_build_raises_with_the_compiler_output(nsrc):
    """No silent fallback: a source that does not compile raises with what
    g++ printed."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    (nsrc / "winsvc.cc").write_text("int f( { return 1; }\n")
    with pytest.raises(RuntimeError, match="error"):
        _native.build()
