"""``kernels/build.py``: a library is named by a hash of every file in its
source's directory and of the flags, so an edited header is rebuilt.  The
hash needs no compiler, so these run on the CPU."""

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.build import NvccLibrary
from repro_torch.kernels.flash_attention import ops as flash_ops


@pytest.fixture
def kernel_dir(tmp_path):
    csrc = tmp_path / "kernel" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "k.cuh"\nextern "C" int f() { return 0; }\n')
    (csrc / "k.cuh").write_text("#pragma once\nconstexpr int kTile = 64;\n")
    return csrc


def _lib(csrc):
    return NvccLibrary("k", csrc / "k.cu", {})


def test_editing_a_header_renames_the_library(kernel_dir):
    before = _lib(kernel_dir).library_path()
    (kernel_dir / "k.cuh").write_text("#pragma once\nconstexpr int kTile = 128;\n")
    after = _lib(kernel_dir).library_path()
    assert after != before
    assert after.parent == before.parent
    assert after.name.startswith("libk-") and after.suffix == ".so"


@pytest.mark.parametrize("edit", ["source", "new_header", "flags"])
def test_the_name_follows_sources_and_flags(kernel_dir, edit, monkeypatch):
    before = _lib(kernel_dir).library_path()
    if edit == "source":
        (kernel_dir / "k.cu").write_text("// edited\n")
    elif edit == "new_header":
        (kernel_dir / "detail").mkdir()
        (kernel_dir / "detail" / "more.cuh").write_text("#pragma once\n")
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert _lib(kernel_dir).library_path() != before


def test_the_name_is_stable_and_ignores_files_outside_csrc(kernel_dir):
    before = _lib(kernel_dir).library_path()
    (kernel_dir.parent / "ops.py").write_text("# not a CUDA source\n")
    assert _lib(kernel_dir).library_path() == before
    assert _lib(kernel_dir).digest() == _lib(kernel_dir).digest()


def test_a_built_library_is_reused_without_a_compiler(kernel_dir, tmp_path,
                                                      monkeypatch):
    lib = _lib(kernel_dir)
    lib.build_dir = tmp_path / "build" / "k"
    lib.build_dir.mkdir(parents=True)
    lib.library_path().write_bytes(b"")

    def no_nvcc():
        raise AssertionError("nvcc was called for an unchanged source")
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    assert lib.build() == lib.library_path()


def test_flash_libraries_share_a_directory_under_distinct_names():
    paths = [lib.library_path() for lib in flash_ops._LIBS.values()]
    assert paths[0].parent == paths[1].parent
    assert paths[0].name != paths[1].name
