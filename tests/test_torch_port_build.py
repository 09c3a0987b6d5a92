"""The key under which the port's CUDA sources build (``ops/_nvcc``) covers
the source, every header beside it and the compiler flags, so an edited
header never loads a library built from the old one.  No ``nvcc`` runs:
the sources live in a temporary ``csrc``."""

import re

import pytest

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
