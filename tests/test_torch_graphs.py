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


# ---------------------------------------------------------------------------
# Bindings (graphs.input_site, output_site, bindable): which replays may read
# a caller's input and write a caller's output where they lie. Pure host
# logic over a capture's notes; the bound replays run on the card
# (tests/test_torch_kernels_cuda.py).
# ---------------------------------------------------------------------------

_CARD = torch.device("cuda", 0)
_SHAPE = (2, 4, 16, 3)  # 384 bytes
_IN = graphs.Buffer(_CARD, _SHAPE, (192, 48, 3, 1), 0x10000, 384)
_OUT = graphs.Buffer(_CARD, _SHAPE[:3], (64, 16, 1), 0x20000, 128)
# K2 reads the input (chosen aligned: 16 bytes), K3 writes the output; a
# table of K3's lies elsewhere.
_NOTES = (graphs.Note(node=0xA, nargs=8, index=0, ptr=_IN.ptr, align=16),
          graphs.Note(node=0xA, nargs=8, index=1, ptr=0x30000, align=8),
          graphs.Note(node=0xB, nargs=4, index=0, ptr=0x30000, align=1),
          graphs.Note(node=0xB, nargs=4, index=1, ptr=_OUT.ptr, align=1),
          graphs.Note(node=0xB, nargs=4, index=2, ptr=0x40000, align=1))
_TOUCHED = ((0x50000, 1024),)  # the LUTs' torch ops


def _sites(notes=_NOTES, touched=_TOUCHED, out=_OUT):
    outs = [] if out is None else [(out.ptr, out.nbytes)]
    return (graphs.input_site(_IN, notes, touched, outs),
            graphs.output_site(out, notes, touched, _IN))


def _at(ptr, device=_CARD, shape=_SHAPE, strides=(192, 48, 3, 1)):
    return graphs.Buffer(device, shape, strides, ptr, 384)


@pytest.mark.parametrize("case,x,sites,bound", [
    ("bound", _at(0x90000), _sites(), True),
    ("another card", _at(0x90000, device=torch.device("cuda", 1)), _sites(), False),
    ("a host input", _at(0x90000, device=torch.device("cpu")), _sites(), False),
    ("non-contiguous", _at(0x90000, strides=(384, 48, 3, 1)), _sites(), False),
    ("off the captured alignment", _at(0x90001), _sites(), False),
    ("another shape", _at(0x90000, shape=(2, 4, 16, 1)), _sites(), False),
    ("a torch op reads the input", _at(0x90000), _sites(touched=((_IN.ptr, 384),)), False),
    ("a launch of no known node reads it", _at(0x90000),
     _sites(notes=(_NOTES[0]._replace(node=0),) + _NOTES[1:]), False),
])
def test_bindable_input(case, x, sites, bound):
    assert graphs.bindable(x, sites[0]) is bound


def test_a_bound_input_keeps_each_argument_at_its_offset():
    notes = _NOTES + (graphs.Note(node=0xC, nargs=3, index=0, ptr=_IN.ptr + 192, align=4),)
    site, _ = _sites(notes=notes)
    assert [(b.node, b.index, b.offset, b.align) for b in site.bindings] == [
        (0xA, 0, 0, 16), (0xC, 0, 192, 4)]
    assert graphs.bindable(_at(0x90004), site) is False  # 16-byte K2 on 0x90004
    no_k2 = (_NOTES[0]._replace(align=1),) + notes[1:]
    assert graphs.bindable(_at(0x90004), _sites(notes=no_k2)[0]) is True
    assert graphs.bindable(_at(0x90002), _sites(notes=no_k2)[0]) is False  # 4 bytes at +192


@pytest.mark.parametrize("case,notes,touched,out,bound", [
    ("one kernel writes it whole", _NOTES, _TOUCHED, _OUT, True),
    ("a tuple, a list or part of a storage", _NOTES, _TOUCHED, None, False),
    ("a torch op takes it", _NOTES, ((_OUT.ptr + 64, 8),), _OUT, False),
    ("two kernels hold it", _NOTES + (graphs.Note(0xC, 2, 0, _OUT.ptr + 64, 1),), _TOUCHED,
     _OUT, False),
    ("its kernel holds it from its middle", (graphs.Note(0xB, 4, 1, _OUT.ptr + 8, 1),),
     _TOUCHED, _OUT, False),
    ("no kernel writes it", _NOTES[:3], _TOUCHED, _OUT, False),
])
def test_bindable_output(case, notes, touched, out, bound):
    _, site = _sites(notes=notes, touched=touched, out=out)
    into = graphs.Buffer(_CARD, _OUT.shape, _OUT.strides, 0xA0000, 128)
    assert graphs.bindable(into, site) is bound


def test_notes_before_the_output_was_made_are_not_its():
    """An earlier stage's buffer that the graph's pool gave to the output
    later: the notes taken before the output's storage was made point into
    freed bytes, so the output still binds; a note after it does not."""
    stale = (graphs.Note(0x9, 3, 1, _OUT.ptr, 16), graphs.Note(0x9, 3, 0, _OUT.ptr + 64, 1))
    notes = stale + _NOTES
    into = graphs.Buffer(_CARD, _OUT.shape, _OUT.strides, 0xA0000, 128)
    assert graphs.output_site(_OUT, notes, _TOUCHED, _IN) is None
    site = graphs.output_site(_OUT, notes, _TOUCHED, _IN, first=len(stale))
    assert graphs.bindable(into, site) is True
    assert [(b.node, b.index) for b in site.bindings] == [(0xB, 1)]
    later = notes + (graphs.Note(0xC, 2, 0, _OUT.ptr + 64, 1),)  # a later kernel reads it
    assert graphs.output_site(_OUT, later, _TOUCHED, _IN, first=len(stale)) is None


def test_touches_counts_the_notes_before_each_storage_it_made(monkeypatch):
    """``_Touches.made``: for each live storage that an op made (not one of
    its arguments': an in-place op makes none), the notes counted then."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    count = iter(range(10, 100))
    x = torch.zeros(6, dtype=torch.uint8)
    with graphs._Touches(lambda: next(count)) as touches:
        y = torch.empty(4, dtype=torch.uint8)
        z = x + 1
        z.add_(1)
        y.copy_(z[:4])
        tmp = z * 2
        del tmp
    made = touches.made()
    assert made == {graphs._storage(y)[0]: 10, graphs._storage(z)[0]: 11}


def test_an_output_in_the_input_binds_neither():
    """An output that is a view of the input: the input cannot be read from
    the caller's buffer (the static output would not be written), and the
    output is no kernel's."""
    view = graphs.Buffer(_CARD, _SHAPE, (192, 48, 3, 1), _IN.ptr, 384)
    notes = _NOTES[:1]
    assert graphs.input_site(_IN, notes, (), [(_IN.ptr, 384)]) is None
    assert graphs.output_site(view, notes, (), _IN) is None


def test_touches_names_what_torch_ops_take_and_not_views(monkeypatch):
    """``_Touches`` records each storage that a torch op other than a view
    takes, and gives those still alive (a freed one's bytes may hold a later
    buffer). Only card storages matter; here CPU tensors stand in for them."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    x = torch.zeros((2, 3, 4), dtype=torch.uint8)
    with graphs._Touches() as touches:
        x[0].view(-1)
        assert touches.ranges() == ()
        y = x + 1
        (y * 2).sum()
    assert set(touches.ranges()) == {graphs._storage(x), graphs._storage(y)}
    del y
    assert touches.ranges() == (graphs._storage(x),)
    assert graphs._dense((2, 3, 4), (12, 4, 1)) and graphs._dense((1, 3, 4), (99, 4, 1))
    assert not graphs._dense((2, 3, 4), (24, 4, 1)) and not graphs._dense((3, 4), (1, 3))


def test_every_kernel_launch_is_noted():
    """Every port kernel is launched through ``ipt::launch``
    (``csrc/launch.cuh``), which notes its pointer arguments under capture:
    a kernel launched with ``<<<...>>>`` would read a graph's input unseen."""
    csrc = Path(graphs.__file__).resolve().parent.parent / "csrc"
    sources = sorted(csrc.glob("*.cu"))
    assert len(sources) == 7
    for src in sources:
        text = src.read_text()
        assert "<<<" not in text, src.name
        assert '#include "launch.cuh"' in text, src.name


def test_the_capture_watch_imports_nothing():
    """``_Touches`` in a fresh process imports no module (torch wraps a
    dispatch mode's handler to disable torch.compile unless told not to, and
    that imports torch._dynamo: seconds of every first capture)."""
    import subprocess
    import sys

    code = ("import sys, torch\n"
            "from imageprocessingtools_tpu_torch.utils import graphs\n"
            "before = set(sys.modules)\n"
            "with graphs._Touches():\n"
            "    torch.zeros(3) + 1\n"
            "print(sorted(set(sys.modules) - before))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=Path(graphs.__file__).resolve().parents[2])
    assert out.stdout.strip() == "[]"
