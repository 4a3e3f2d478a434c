"""The compiled band pipelines of ``parallel/spatial.py`` and what they need,
on the CPU.

A band graph runs only on a card (``tests/test_torch_kernels_cuda.py``);
here are its pure parts (the dispatch by mesh, the graph key), the CPU's
stand-in for capture (a second call of every band body uploads nothing from
the host), the bands as views of one copy per device and ``row_window``'s
views, and the capture's hold on the resize plan's sub-tables. The bytes of
the band forms against the unsharded ops, the golden model and the JAX
package's ``spatial.py`` are ``tests/test_torch_spatial.py``'s. Tolerance:
none (every band form is byte-equal to the port's unsharded op).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu_torch.parallel import spatial
from imageprocessingtools_tpu_torch.parallel.spatial import Band
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig
from imageprocessingtools_tpu_torch.utils import graphs
from tests.conftest import make_gradient, make_image
from tests.test_torch_batch_graphs import _refuse_uploads

CPU = torch.device("cpu")
META = torch.device("meta")
CARD0, CARD1 = torch.device("cuda", 0), torch.device("cuda", 1)
PRESET_NAMES = ("edge_detect", "enhance", "print_ready", "thumbnail")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _img(h, w, seed=0):
    return torch.from_numpy(make_image(h, w, seed=seed) if seed % 2 == 0
                            else make_gradient(h, w))


def _same_bands(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same_bands(x, y) for x, y in zip(a, b))
    return ([x.row0 for x in a] == [y.row0 for y in b]
            and all(torch.equal(x.data, y.data) for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# The CPU's stand-in for capture: a second call of a band body uploads nothing.
# ---------------------------------------------------------------------------

_TASKS = {
    "fused": ("fused", ()),
    **{name: (name, ()) for name in PRESET_NAMES},
    "-w48": (PipelineConfig(new_width=48), ()),
    "-r30": (PipelineConfig(angle=30.0), ()),
    "-r90": (PipelineConfig(angle=90.0), ()),
    "-r180": (PipelineConfig(angle=180.0), ()),
    "-w48 -r30 -mono -fv": (PipelineConfig(new_width=48, angle=30.0, mono=True, flip_v=True),
                            (True,)),
    "serve --spatial presets": (PRESET_NAMES, (False, False, True, False)),
}


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("label", list(_TASKS))
def test_a_second_call_of_a_band_body_uploads_nothing(label, n, monkeypatch):
    task, pack = _TASKS[label]
    body = spatial.band_body(task, (CPU,) * n, pack)
    img = _img(36, 60, seed=3)
    first = body(img)
    with monkeypatch.context() as patched:
        _refuse_uploads(patched)
        second = body(img)
    assert _same_bands(first, second)
    one_band = spatial.band_pipeline(task, [Band(0, img)], (CPU,), pack)
    for bands, alone in zip(*((o,) if not isinstance(task, tuple) else o
                              for o in (first, one_band))):
        assert 1 <= len(bands) <= n and torch.equal(spatial.gather(bands), spatial.gather(alone))


def test_a_band_body_checks_its_task_before_it_runs():
    for task, message in (("bogus", "unknown preset 'bogus'"),
                          (PipelineConfig(), "no data to write"),
                          (("edge_detect", "nope"), "unknown preset 'nope'")):
        with pytest.raises(ValueError, match=message):
            spatial.band_body(task, (CPU,) * 2)


# ---------------------------------------------------------------------------
# The dispatch by mesh and the graph key: pure functions.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh, compiled", [
    ((CARD0,), True), ((CARD0,) * 4, True), ((CARD0, CARD1), False),
    ((CARD0, CARD0, CARD1), False), ((CPU,), False), ((CPU,) * 4, False),
])
def test_one_card_decides_the_dispatch_from_the_mesh(mesh, compiled):
    assert spatial.one_card(mesh) is compiled


def test_the_graph_key_is_a_pure_function_of_task_shape_dtype_and_mesh():
    mesh = (CARD0,) * 4
    key = spatial.graph_key("fused", (2160, 3840, 3), torch.uint8, mesh)
    assert key == spatial.graph_key("fused", [2160, 3840, 3], torch.uint8, list(mesh))
    assert key == spatial.graph_key("fused", (2160, 3840, 3), torch.uint8, mesh, (False,))
    config = PipelineConfig(new_width=1920, angle=30.0)
    assert (spatial.graph_key(config, (8, 8, 3), torch.uint8, mesh)
            == spatial.graph_key(PipelineConfig(new_width=1920, angle=30.0), (8, 8, 3),
                                 torch.uint8, mesh))
    others = [
        spatial.graph_key("edge_detect", (2160, 3840, 3), torch.uint8, mesh),
        spatial.graph_key("fused", (2160, 3841, 3), torch.uint8, mesh),
        spatial.graph_key("fused", (2160, 3840, 3), torch.int16, mesh),
        spatial.graph_key("fused", (2160, 3840, 3), torch.uint8, (CARD0,)),
        spatial.graph_key("fused", (2160, 3840, 3), torch.uint8, (CARD1,) * 4),
        spatial.graph_key("fused", (2160, 3840, 3), torch.uint8, mesh, (True,)),
        spatial.graph_key(("fused",), (2160, 3840, 3), torch.uint8, mesh),
    ]
    assert len({key, *others}) == 1 + len(others)


def test_band_pipelines_on_the_cpu_capture_nothing():
    captures, kept = graphs.captures_made, set(spatial._band_graphs)
    img = _img(37, 53, seed=2)
    for task in ("fused", "enhance", PipelineConfig(angle=30.0), PRESET_NAMES):
        spatial.band_pipeline(task, img, (CPU,) * 3)
    assert graphs.captures_made == captures and set(spatial._band_graphs) == kept


# ---------------------------------------------------------------------------
# Bands as views of one copy per device, and row_window's views.
# ---------------------------------------------------------------------------

def _storage(t):
    return t.untyped_storage().data_ptr()


def test_shard_rows_moves_a_devices_bands_in_one_copy():
    img = _img(37, 53)
    bands = spatial.shard_rows(img, (META,) * 4)
    base = bands[0].data._base
    assert base is not None and base.is_meta and base.shape == img.shape
    assert all(b.data._base is base for b in bands)
    mixed = spatial.shard_rows(img, (META, META, CPU, CPU))
    assert mixed[0].data._base is mixed[1].data._base is not None
    assert all(b.data.device == CPU and _storage(b.data) == _storage(img) for b in mixed[2:])
    interleaved = spatial.shard_rows(img, (META, CPU, META))
    assert interleaved[0].data._base is not interleaved[2].data._base


@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_bands_on_one_device_are_views_of_one_storage(n):
    img = _img(37, 53, seed=4)
    for source in (img, img.numpy()):
        bands = spatial.shard_rows(source, (CPU,) * n)
        assert [b.row0 for b in bands] == [r0 for r0, _ in spatial.split_rows(37, n)]
        assert all(_storage(b.data) == _storage(img) for b in bands)
        assert all(b.data.storage_offset() == b.row0 * img.stride(0) for b in bands)
        assert torch.equal(spatial.gather(bands), img)


def test_row_window_is_one_view_over_adjacent_bands():
    img = _img(10, 6)
    bands = spatial.shard_rows(img, (CPU,) * 3)
    for lo, hi in ((2, 9), (0, 10), (3, 5), (4, 8)):
        window = spatial.row_window(bands, lo, hi, CPU)
        assert _storage(window) == _storage(img) and window.data_ptr() == img[lo].data_ptr()
        assert torch.equal(window, img[lo:hi])
    one = spatial.row_window(bands, 0, 10, CPU, cols=(2, 5))
    assert torch.equal(one, img[:, 2:5])


def test_row_window_joins_what_one_view_cannot_hold():
    img = _img(12, 6, seed=1)
    copies = [Band(b.row0, b.data.clone()) for b in spatial.shard_rows(img, (CPU,) * 3)]
    joined = spatial.row_window(copies, 2, 9, CPU)
    assert torch.equal(joined, img[2:9])
    assert all(_storage(joined) != _storage(b.data) for b in copies)
    # Views of one storage whose rows do not follow each other there.
    gap = [Band(0, img[0:4]), Band(4, img[5:9])]
    assert torch.equal(spatial.row_window(gap, 2, 6, CPU), torch.cat([img[2:4], img[5:7]]))
    # A column slice over several bands.
    bands = spatial.shard_rows(img, (CPU,) * 3)
    cols = spatial.row_window(bands, 1, 11, CPU, cols=(1, 4))
    assert torch.equal(cols, img[1:11, 1:4]) and _storage(cols) != _storage(img)
    # Parts on another device than the window's.
    moved = spatial.row_window(bands, 2, 9, META)
    assert moved.is_meta and moved.shape == (7, 6, 3)


# ---------------------------------------------------------------------------
# The resize plan's sub-tables are device tables that a capture holds.
# ---------------------------------------------------------------------------

def test_a_capture_holds_the_resize_plans_tables(monkeypatch):
    mesh = (CPU,) * 4
    first = spatial._resize_plan(48, 64, 21, mesh)
    assert not graphs.capturing()
    monkeypatch.setattr(graphs, "_holds", [])
    assert graphs.capturing()
    assert spatial._resize_plan(48, 64, 21, mesh) is first  # cached
    assert len(graphs._holds) == 1 and graphs._holds[0] is first
    graphs._holds.clear()
    made = spatial._resize_plan(49, 67, 23, mesh)  # made inside the capture
    assert graphs._holds[-1] is made
    passes = [t for t in graphs._holds if isinstance(t, tuple) and t and isinstance(t[0], tuple)]
    assert passes and all(p is passes[0] for p in passes)  # K9's tables, held per read
    for o0, o1, lo, hi, idx, w in made:
        assert idx.is_contiguous() and w.is_contiguous()
    assert spatial._resize_plan.cache_info().maxsize == 32


@pytest.mark.parametrize("n", [1, 4])
def test_the_band_form_of_a_fanout_equals_each_element_alone(n):
    img = _img(36, 60, seed=6)
    mesh = (CPU,) * n
    task, pack = _TASKS["serve --spatial presets"]
    outs = spatial.band_pipeline(task, img, mesh, pack)
    for name, packed, bands in zip(task, pack, outs):
        alone = spatial.preset_pipeline_spatial(img, name, mesh)
        if packed:
            alone = [Band(b.row0, spatial.pack_bits_device(b.data)) for b in alone]
        assert _same_bands(bands, alone), name
    np.testing.assert_array_equal(spatial.gather(outs[0]).numpy(),
                                  spatial.gather(spatial.preset_pipeline_spatial(
                                      img.numpy(), "edge_detect", (CPU,))).numpy())
