"""The kernel build's cache key: a library is named by a hash of the
flags, the ``.cu`` source and every header of ``csrc/``, so editing any
of them builds a new library instead of loading a stale one."""

from killerbeez_tpu_torch.ops import _build


def test_library_path_hashes_the_source_and_its_headers(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("// one\n")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (tmp_path / "a.cuh").write_text("// two\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)
    assert first.parent == _build.BUILD_DIR
