"""The port's compiled dispatch (``utils/graphs.py``) and the flagship's
compiled forms against the JAX package's ``jax.jit`` programs, on the CPU.

On a CPU tensor ``graphed(fn)`` is ``fn``, so the three
``kernels.fused_gray_gauss_histeq*`` aliases run the port's eager forms
(plain versions) here; they must give the bytes of the JAX package's jitted
``fused_gray_gauss_histeq``, ``..._pallas`` and ``..._pallas_mega`` (the
Pallas kernels in interpret mode, as the JAX suite runs them on the CPU).
Tolerance: none, every stage is integer-exact and the LUT's float32
operations are in the JAX order. The cache key and the LRU are pure host
logic and are held here too; the graphs themselves run only on a card
(``tests/test_torch_kernels_cuda.py``).
"""

from __future__ import annotations

import ast
import collections
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu.kernels import fused as jax_fused
from imageprocessingtools_tpu_torch import kernels
from imageprocessingtools_tpu_torch.kernels import core, fused
from imageprocessingtools_tpu_torch.utils import graphs

JAX_KERNELS_INIT = Path(__file__).resolve().parent.parent / "imageprocessingtools_tpu" / \
    "kernels" / "__init__.py"

# port alias -> the JAX package's jitted program
ALIASES = {
    "fused_gray_gauss_histeq": jax_fused.fused_gray_gauss_histeq,
    "fused_gray_gauss_histeq_pallas": jax_fused.fused_gray_gauss_histeq_pallas,
    "fused_gray_gauss_histeq_pallas_mega": jax_fused.fused_gray_gauss_histeq_pallas_mega,
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("fn", [lambda x: 255 - x, lambda x: (x[..., 0], x.sum())],
                         ids=["tensor", "tuple"])
def test_graphed_on_a_cpu_tensor_is_the_function(fn):
    x = torch.from_numpy(_image((9, 11, 3), seed=1))
    got, want = graphs.graphed(fn)(x), fn(x)
    for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        assert torch.equal(g, w)


def test_graphed_on_a_cpu_tensor_keeps_no_graph():
    seen = []
    g = graphs.graphed(lambda x: seen.append(x) or x + 1)
    x = torch.zeros(3, dtype=torch.uint8)
    assert torch.equal(g(x), x + 1)
    assert seen[0] is x  # the caller's tensor, not a copy
    assert len(g._graphs) == 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", [(37, 53, 3), (64, 96, 3)])
@pytest.mark.parametrize("alias", list(ALIASES))
def test_compiled_flagship_equals_the_jax_jitted_program(alias, shape, seed):
    img = _image(shape, seed)
    want = np.asarray(ALIASES[alias](img))
    before = [w.launches for w in kernels.counted_wrappers()]
    got = getattr(kernels, alias)(torch.from_numpy(img))
    assert [w.launches for w in kernels.counted_wrappers()] == before  # CPU: plain versions
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape[:2]
    np.testing.assert_array_equal(got.numpy(), want)


def test_compiled_aliases_wrap_the_eager_forms():
    assert fused.fused_gray_gauss_histeq_pallas_mega.fn is fused.fused_pipeline_mega
    assert fused.fused_gray_gauss_histeq_pallas.fn is fused.fused_pipeline_staged
    assert fused.fused_gray_gauss_histeq is fused.fused_gray_gauss_histeq_pallas_mega
    for alias in ALIASES:
        assert isinstance(getattr(kernels, alias), graphs.Graphed)


def test_graph_key_is_the_tensors_metadata():
    a = torch.zeros((4, 6, 3), dtype=torch.uint8)
    assert graphs.graph_key(a) == (torch.device("cpu"), (4, 6, 3), torch.uint8, (18, 3, 1))
    assert graphs.graph_key(a) == graphs.graph_key(torch.ones((4, 6, 3), dtype=torch.uint8))
    assert graphs.graph_key(a) != graphs.graph_key(a.to(torch.int32))
    assert graphs.graph_key(a) != graphs.graph_key(a.reshape(6, 4, 3))
    view = a.transpose(0, 1)
    assert graphs.graph_key(view) == (torch.device("cpu"), (6, 4, 3), torch.uint8, (3, 18, 1))
    assert graphs.graph_key(view) != graphs.graph_key(view.contiguous())


def test_graph_cache_keeps_its_stated_size(monkeypatch):
    """A ``graphed`` callable's graphs count against the one byte bound of
    every graph kept (``GRAPH_BYTES_BOUND``): past it the least recently
    used are dropped from their cache, after their last call; a hit makes
    nothing and moves the graph to the LRU's end."""
    class Entry:
        nbytes = 100

        def __init__(self, key, owner):
            self.key, self.owner, self.synced = key, weakref.ref(owner), False
            self.done = self

        def synchronize(self):
            self.synced = True

    assert graphs.GRAPH_BYTES_BOUND == 8 << 30
    monkeypatch.setattr(graphs, "GRAPH_BYTES_BOUND", 4 * Entry.nbytes)
    monkeypatch.setattr(graphs, "_held", collections.OrderedDict())
    g = graphs.graphed(lambda x: x)
    made = {}

    def lookup(key):
        return graphs._find(g._graphs, key, lambda: made.setdefault(key, Entry(key, g._graphs)))

    for key in range(6):
        assert lookup(key).key == key
    assert list(g._graphs) == [2, 3, 4, 5]
    assert made[0].synced and made[1].synced and not made[2].synced  # evicted ones waited for
    assert lookup(3) is made[3] and len(made) == 6  # a hit makes nothing, and moves 3 to the end
    assert [e.key for e in graphs._live()] == [2, 4, 5, 3]
    lookup(6)
    assert sorted(g._graphs) == [3, 4, 5, 6] and made[2].synced
    assert sum(e.nbytes for e in graphs._live()) <= graphs.GRAPH_BYTES_BOUND


def test_every_jax_kernels_export_has_a_port_counterpart():
    tree = ast.parse(JAX_KERNELS_INIT.read_text())
    jax_names = {alias.asname or alias.name for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) for alias in node.names}
    assert len(jax_names) == 12
    assert set(kernels.COUNTERPARTS) == jax_names
    for jax_name, port_name in kernels.COUNTERPARTS.items():
        assert callable(getattr(kernels, port_name)), (jax_name, port_name)
    assert kernels.COUNTERPARTS["rotate_blocked_pallas"] == "rotate_bicubic"
    assert kernels.histogram is core.histogram and kernels.lut_apply is core.lut_apply
    assert kernels.fused_gray_gauss_histeq_pallas_mega is fused.fused_gray_gauss_histeq_pallas_mega


def test_counted_wrappers_are_every_launch_counter():
    """A capture credits the wrappers that ``counted_wrappers`` lists: every
    function of the kernel modules that counts launches must be there."""
    import importlib

    counters = {fn for name in ("core", "rotate", "resize")
                for fn in vars(importlib.import_module(
                    f"imageprocessingtools_tpu_torch.kernels.{name}")).values()
                if callable(fn) and hasattr(fn, "launches")}
    assert len(counters) == 20  # 11 single-image wrappers and 9 batched ones
    assert set(kernels.counted_wrappers()) == counters
