"""The kernel build's library names (``or4d_tpu_torch/ops/_build.py``), on
the CPU: a library's name carries a hash of its source, of every
``csrc`` header the source includes and of the flags, so an edited header
is rebuilt and never loads a stale library. Nothing is compiled here."""

import shutil

from or4d_tpu_torch.ops import _build


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_sources_that_share_the_tile_header_name_it():
    includes = lambda name: _build._includes((_build.CSRC / f"{name}.cu").read_bytes())
    assert includes("sa_group_mlp") == ["ball_search.cuh", "sa_mma_tile.cuh"]
    assert includes("serving_sa1_mlp") == ["sa_mma_tile.cuh"]
    assert includes("ball_query_group") == ["ball_search.cuh"]
    assert includes("ball_query_multiscale") == ["ball_search.cuh"]
    assert includes("fps") == []


def test_a_changed_header_changes_the_library_name(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    header = csrc / "sa_mma_tile.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    changed = {n for n in _build.SOURCES if before[n] != after[n]}
    assert changed == {"sa_group_mlp", "serving_sa1_mlp"}
    (csrc / "unused.cuh").write_bytes(b"// not included anywhere\n")
    assert {n: _build._lib_path(n) for n in _build.SOURCES} == after


def test_a_changed_search_header_rebuilds_both_sources_that_search(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    header = csrc / "ball_search.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    changed = {n for n in _build.SOURCES if before[n] != _build._lib_path(n)}
    # every source that searches or stages a cloud through the header
    assert changed == {"sa_group_mlp", "ball_query_group", "ball_query_multiscale", "ball_query_bounds"}


def test_a_changed_source_or_flag_changes_the_library_name(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = _build._lib_path("fps")
    src = csrc / "fps.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build._lib_path("fps") != before
    edited = _build._lib_path("fps")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DX",))
    assert _build._lib_path("fps") != edited
