"""K9's W-pass plan (``csrc/cols_plan.cuh``), on the CPU.

The C host code makes the plan from the shape and the card's shared memory:
the path (tiled: each tile's source rows staged in shared memory; gathered:
read from global memory), the rows a tile and the outputs a block, and the
columns a staged row holds. The header is plain C++, so here it is built
with the host's compiler into a small library and asked directly. The kernel
that runs the plan is held to the plain version on the card by
tests/test_torch_kernels_cuda.py; here the plan's choices and its promises
(the shared memory fits, a staged row holds what the reference's tables of
that many outputs reach, its pitch keeps 32 rows' words in 32 banks).
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import NamedTuple

import numpy as np
import pytest

from imageprocessingtools_tpu_torch.kernels import _build
from imageprocessingtools_tpu_torch.ops import _exact

# An H100's shared memory for pass_cols_kernel, less its 64 static bytes:
# what one block may take (227 KB), and what each of two blocks on an SM may
# take (228 KB an SM, 1 KB of it reserved a block).
H100 = (227 * 1024 - 64, 228 * 1024 // 2 - 1024 - 64)
OUTS = (64, 32, 16, 8)

_SHIM = """
#include "cols_plan.cuh"
extern "C" void plan(long long cols, int c, long long out_size, long long taps, long long most,
                     long long aim, long long* out) {
    const ipt::cols::Plan p = ipt::cols::plan(cols, c, out_size, taps, most, aim);
    const long long fields[] = {p.tiled, p.outs, p.lane_rows, p.span, p.pitch, p.out_pitch, p.smem};
    for (int k = 0; k < 7; ++k) out[k] = fields[k];
}
extern "C" long long reach(long long cols, long long out_size, long long taps, long long outs) {
    return ipt::cols::reach(cols, out_size, taps, outs);
}
extern "C" long long tiled_smem(int c, long long taps, int outs, int lane_rows, long long span) {
    const long long out_pitch = ipt::cols::odd_words(outs * c);
    return ipt::cols::staged_at(lane_rows, static_cast<int>(out_pitch), outs, taps) +
           ipt::cols::STAGES * 32LL * lane_rows * ipt::cols::odd_words(span * c + 8);
}
"""


class Plan(NamedTuple):
    path: str
    outs: int
    lane_rows: int
    span: int
    pitch: int
    out_pitch: int
    smem: int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The plan's header built with the host's C++ compiler."""
    out = tmp_path_factory.mktemp("cols_plan")
    (out / "shim.cpp").write_text(_SHIM)
    proc = subprocess.run(["g++", "-std=c++17", "-O1", "-Wall", "-Werror", "-shared", "-fPIC",
                           "-I", str(_build.CSRC), "-o", str(out / "plan.so"),
                           str(out / "shim.cpp")], capture_output=True, text=True)
    if proc.returncode != 0:
        pytest.skip(f"no host C++ build of the plan: {proc.stderr[:300]}")
    lib = ctypes.CDLL(str(out / "plan.so"))
    ll = ctypes.c_longlong
    lib.plan.argtypes = [ll, ctypes.c_int, ll, ll, ll, ll, ctypes.POINTER(ll)]
    lib.reach.argtypes = [ll, ll, ll, ll]
    lib.reach.restype = ll
    lib.tiled_smem.argtypes = [ctypes.c_int, ll, ctypes.c_int, ctypes.c_int, ll]
    lib.tiled_smem.restype = ll
    return lib


def cols_plan(lib, cols, c, out_size, taps, card=H100) -> Plan:
    out = (ctypes.c_longlong * 7)()
    lib.plan(cols, c, out_size, taps, *card, out)
    tiled, *rest = list(out)
    return Plan("tiled" if tiled else "gathered", *rest)


def _w_tables(height: int, width: int, new_width: int):
    """The W pass's indices of ``-w<new_width>`` at (height, width)."""
    (contrib,) = [c for dim, c in _exact.plan_resize(height, width, new_width).passes if dim == 1]
    return contrib.indices


def _plan(lib, shape, new_width):
    idx = _w_tables(shape[0], shape[1], new_width)
    c = shape[2] if len(shape) == 3 else 1
    return cols_plan(lib, shape[1], c, idx.shape[0], idx.shape[1]), idx


# (shape, new width) -> (path, rows a tile, outputs a block): the benchmark's
# thumbnail (57 taps: a lane sums one row) and the reference tool's -w1920
# (8 taps: two rows), an upscale, gray, and ratios whose columns do not fit.
@pytest.mark.parametrize("shape,new_width,want", [
    ((2160, 3840, 3), 256, ("tiled", 32, 16)),
    ((2160, 3840, 3), 1920, ("tiled", 64, 64)),
    ((1080, 1920, 3), 3840, ("tiled", 64, 64)),
    ((2160, 3840), 1920, ("tiled", 64, 64)),
    ((2160, 3840, 3), 100, ("tiled", 32, 8)),
    ((2160, 3840, 3), 45, ("gathered", 32, 64)),
    ((400, 20000, 3), 100, ("gathered", 32, 64)),
    ((2000, 5000), 5, ("gathered", 32, 64)),
], ids=str)
def test_plan_path_rows_and_outputs(lib, shape, new_width, want):
    plan, _ = _plan(lib, shape, new_width)
    assert (plan.path, 32 * plan.lane_rows, plan.outs) == want
    if plan.path == "gathered":
        assert plan.span == plan.pitch == 0
        assert plan.smem == 32 * plan.lane_rows * plan.out_pitch  # the output tile alone


@pytest.mark.parametrize("shape,new_width", [
    ((2160, 3840, 3), 256), ((2160, 3840, 3), 1920), ((1080, 1920, 3), 3840),
    ((2160, 3840), 1920), ((37, 53, 3), 32), ((37, 53), 77), ((5, 7, 3), 2), ((3, 3, 3), 40),
    ((1, 64, 3), 128), ((64, 1, 3), 3), ((40, 400, 3), 20), ((1079, 1913, 3), 777),
    ((2160, 3840, 3), 100), ((100, 2000, 3), 41), ((270, 480), 241),
], ids=str)
def test_a_staged_row_holds_every_group_reach(lib, shape, new_width):
    """Every group of ``outs`` neighbouring outputs of the reference's tables
    (mirrored edges included) reaches no more columns than a staged row
    holds, so that no group of theirs falls back to gathering; the block's
    shared memory fits, and the pitches are odd numbers of words."""
    plan, idx = _plan(lib, shape, new_width)
    assert plan.path == "tiled"
    for o0 in range(0, idx.shape[0], plan.outs):
        group = idx[o0:o0 + plan.outs]
        assert int(group.max()) - int(group.min()) + 1 <= plan.span, o0
    c = shape[2] if len(shape) == 3 else 1
    assert plan.pitch >= plan.span * c + 8 and plan.out_pitch >= plan.outs * c
    assert (plan.pitch // 4) % 2 == 1 and (plan.out_pitch // 4) % 2 == 1
    assert plan.smem <= H100[0]


def test_a_reach_that_does_not_fit_is_gathered(lib):
    """At 85:1 the fewest outputs a block (8) reach 7 x 85.3 + 341 columns:
    their tables and the buffers of a tile's rows do not fit shared memory,
    so the host gathers."""
    plan, idx = _plan(lib, (2160, 3840, 3), 45)
    assert idx.shape[1] == 341
    assert lib.reach(3840, 45, 341, 8) == 943
    # the output tile, offsets, weights and addends (taps padded to 4), two buffers
    smem = 32 * 28 + 8 * 344 * 20 + 2 * 32 * 2844
    assert lib.tiled_smem(3, 341, 8, 1, 943) == smem > H100[0]
    assert plan.path == "gathered"


def test_the_plan_follows_the_shape_alone(lib):
    """Channels, taps and the ratio decide; the number of rows does not (the
    batch's rows are one image's along dim 1), and a plan is a pure function."""
    a = cols_plan(lib, 3840, 3, 256, 57)
    assert a == cols_plan(lib, 3840, 3, 256, 57)
    assert cols_plan(lib, 3840, 1, 256, 57).pitch < a.pitch
    assert cols_plan(lib, 3840, 3, 256, 16).lane_rows == 2
    assert cols_plan(lib, 3840, 3, 256, 17).lane_rows == 1


def test_the_plan_follows_the_cards_shared_memory(lib):
    """With less shared memory a block takes fewer outputs, and gathers where
    not even the fewest fit: 4K -> 256 plans 16 outputs a block on an H100,
    8 on a card with 99 KB a block and 100 an SM, and gathers on one with 32 KB."""
    assert cols_plan(lib, 3840, 3, 256, 57).outs == 16
    small = cols_plan(lib, 3840, 3, 256, 57, (99 * 1024 - 64, 50 * 1024 - 1024 - 64))
    assert (small.path, small.outs) == ("tiled", 8) and small.smem <= 99 * 1024 - 64
    assert cols_plan(lib, 3840, 3, 256, 57, (32 * 1024, 16 * 1024)).path == "gathered"


@pytest.mark.parametrize("seed", range(6))
def test_random_geometries_plan_within_shared_memory(lib, seed):
    rng = np.random.default_rng(500 + seed)
    for _ in range(50):
        cols = int(rng.integers(1, 9000))
        out_size = max(1, int(cols * float(rng.choice([0.01, 0.05, 0.3, 0.5, 1.0, 2.0, 8.0]))))
        taps = int(rng.integers(1, 4 * max(1, cols // out_size) + 3))
        c = int(rng.choice([1, 3]))
        plan = cols_plan(lib, cols, c, out_size, taps)
        assert plan.path in ("tiled", "gathered")
        assert plan.smem <= H100[0]
        assert plan.lane_rows in (1, 2) and plan.outs in OUTS
        if plan.path == "tiled":
            assert plan.smem == lib.tiled_smem(c, taps, plan.outs, plan.lane_rows, plan.span)
