"""The kernel build's hash over the shared CUDA header, and the attention
kernels' rule for splitting keys across blocks. Nothing here is
compiled or launched: the kernels themselves are held on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import shutil

import pytest

from cabinet_tpu_torch.ops import _build
from cabinet_tpu_torch.ops import attention as attn


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/ that the build reads instead of the package's."""
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, dst)
    monkeypatch.setattr(_build, "CSRC_DIR", dst)
    return dst


def _append(path, text="\n// edited\n"):
    path.write_text(path.read_text() + text)


@pytest.mark.parametrize("name", _build.SOURCES)
def test_library_path_changes_with_the_shared_header(csrc_copy, name):
    assert '#include "hopper.cuh"' in (csrc_copy / f"{name}.cu").read_text()
    before = _build.library_path(name)
    assert _build.library_path(name) == before
    _append(csrc_copy / "hopper.cuh")
    assert _build.library_path(name) != before


@pytest.mark.parametrize("name", _build.SOURCES)
def test_library_path_changes_with_a_new_header(csrc_copy, name):
    before = _build.library_path(name)
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path(name) != before


@pytest.mark.parametrize("name", _build.SOURCES)
def test_library_path_changes_with_its_own_source_only(csrc_copy, name):
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    _append(csrc_copy / f"{name}.cu")
    for n in _build.SOURCES:
        assert (_build.library_path(n) != before[n]) == (n == name)


# (B, N, SM count, splits): the main path's batch 1 and 8 on the H100's 132
# SMs, a single token, a long map, a ragged last key tile with an uneven
# split, another SM count, and a batch that fills the card several times.
@pytest.mark.parametrize("B,N,n_sm,expected", [
    (1, 1024, 132, 8), (8, 1024, 132, 1), (1, 1, 132, 1), (1, 4096, 132, 2),
    (2, 1000, 114, 3), (1, 1000, 132, 8), (1, 1500, 132, 5), (3, 257, 132, 5),
    (2, 100, 132, 2), (64, 1024, 132, 1), (1, 64, 132, 1), (5, 1024, 132, 1)])
def test_key_splits_rule(B, N, n_sm, expected):
    tiles = -(-N // attn.BLOCK)
    blocks = B * tiles
    splits = attn.key_splits(B, N, n_sm)
    assert splits == expected
    assert 1 <= splits <= tiles
    if blocks >= n_sm:
        assert splits == 1
    else:
        # one wave of one block per SM, as full as the keys allow
        assert blocks * splits <= n_sm
        assert splits == tiles or blocks * (splits + 1) > n_sm


# The f32 kernel's split counts on the H100's 132 SMs at the shapes the port
# runs it: 1024^2 serving at batch 1 (16 query tiles of 64, so 8 splits of 2
# key tiles) and batch 8 (128 blocks, no split), and the f32 MscEval's
# 256^2 crops (N=64: one key tile, nothing to split).
@pytest.mark.parametrize("B,N,expected", [(1, 1024, 8), (8, 1024, 1), (1, 64, 1)])
def test_f32_key_splits_at_the_ports_shapes(B, N, expected):
    splits = attn.key_splits(B, N, 132)
    assert splits == expected
    assert B * -(-N // attn.BLOCK) * splits <= 132


def _split_ranges(tiles, splits):
    """The key tiles [t0, t1) that each split walks, as attention_kernel
    and attention_f32_kernel compute them from their split index."""
    return [(i * tiles // splits, (i + 1) * tiles // splits) for i in range(splits)]


@pytest.mark.parametrize("tiles", [1, 2, 5, 16, 24, 64])
def test_split_ranges_cover_the_key_tiles_once(tiles):
    for splits in range(1, tiles + 1):
        ranges = _split_ranges(tiles, splits)
        assert len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == tiles
        assert all(t0 < t1 for t0, t1 in ranges)  # none empty
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # no gap, no overlap
        sizes = [t1 - t0 for t0, t1 in ranges]
        assert max(sizes) - min(sizes) <= 1
