"""How the port names its built kernel libraries: a library is rebuilt
whenever its source, any header in ``csrc/`` or the nvcc flags change.
No compiler is needed: only the names are computed."""

import shutil

from cornac_tpu_torch.ops import native


def _library_in(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(native.CSRC, csrc)
    monkeypatch.setattr(native, "CSRC", csrc)
    return csrc


def test_a_changed_header_renames_every_library(tmp_path, monkeypatch):
    csrc = _library_in(tmp_path, monkeypatch)
    libs = [native.CudaLibrary("fused_topk"), native.CudaLibrary("cosine_topk")]
    before = [lib.path() for lib in libs]
    assert before == [lib.path() for lib in libs]  # stable while nothing changes
    header = csrc / "topk_keys.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [lib.path() for lib in libs]
    assert all(a != b for a, b in zip(before, after))
    (csrc / "cosine_topk.cu").write_text((csrc / "cosine_topk.cu").read_text() + "\n")
    assert libs[0].path() == after[0] and libs[1].path() != after[1]


def test_a_new_header_renames_the_libraries(tmp_path, monkeypatch):
    csrc = _library_in(tmp_path, monkeypatch)
    lib = native.CudaLibrary("fused_topk")
    before = lib.path()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert lib.path() != before and lib.path().name.startswith("libfused_topk-")
