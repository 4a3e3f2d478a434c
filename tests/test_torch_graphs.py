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
import contextlib
import types
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu.kernels import fused as jax_fused
from imageprocessingtools_tpu_torch import kernels
from imageprocessingtools_tpu_torch.kernels import core, fused
from imageprocessingtools_tpu_torch.utils import graphs, profiling

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
    assert len(counters) == 21  # 11 single-image wrappers and 10 batched ones
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


# ---------------------------------------------------------------------------
# Kept dispatch plans (graphs.plan_key, _Plan, Batched) and the native
# dispatch's steps (graphs._replay): pure host logic, here also over
# stand-in graphs on a stand-in card; the plans' calls run on the card
# (tests/test_torch_kernels_cuda.py).
# ---------------------------------------------------------------------------

def test_plan_key_is_the_batchs_metadata_and_the_device():
    batch = torch.zeros((4, 6, 8, 3), dtype=torch.uint8)
    key = graphs.plan_key(batch, _CARD)
    assert key == (_CARD, torch.device("cpu"), (4, 6, 8, 3), torch.uint8, (144, 24, 3, 1))
    assert graphs.plan_key(batch.clone(), _CARD) == key  # other bytes, the same plan
    misses = {
        "another shape": graphs.plan_key(batch[:3], _CARD),
        "another dtype": graphs.plan_key(batch.to(torch.int16), _CARD),
        "other strides": graphs.plan_key(torch.zeros((4, 6, 9, 3), dtype=torch.uint8)[:, :, :8],
                                         _CARD),
        "another card": graphs.plan_key(batch, torch.device("cuda", 1)),
        "the batch elsewhere": graphs.plan_key(batch.to("meta"), _CARD),
    }
    assert all(k != key for k in misses.values()), misses


def test_a_plan_holds_while_its_graphs_do(monkeypatch):
    """``_Plan.entries``: the groups' graphs while none was dropped and the
    groups hold as many images as when the plan was made; None after the
    byte bound drops any graph, once a graph is gone, or once a group would
    hold another number of images."""
    class Entry:
        pass

    monkeypatch.setattr(graphs, "GROUP_INPUT_BYTES", 2 * 48)  # 3 images: groups of 2 and 1
    entries = [Entry(), Entry()]
    groups = tuple(graphs._PlanGroup(start, count, weakref.ref(e), 48 * start, 16 * start,
                                     True, True)
                   for (start, count), e in zip(graphs.spans(3, 2), entries))
    out = torch.empty((3, 4, 4), dtype=torch.uint8, device="meta")
    plan = graphs._Plan(_CARD, out, 48, 2, groups, graphs.evictions_made)
    assert plan.entries() == entries
    monkeypatch.setattr(graphs, "evictions_made", graphs.evictions_made + 1)
    assert plan.entries() is None
    monkeypatch.setattr(graphs, "evictions_made", plan.evictions)
    monkeypatch.setattr(graphs, "GROUP_INPUT_BYTES", 3 * 48)
    assert plan.entries() is None
    monkeypatch.setattr(graphs, "GROUP_INPUT_BYTES", 2 * 48)
    assert plan.entries() == entries
    entries.pop()
    assert plan.entries() is None


def test_a_batch_off_the_card_leaves_no_plan():
    """Plans are for batches on a card: a CPU run makes none and takes none."""
    run = graphs.batched(lambda x: 255 - x)
    before = (graphs.dispatch_plans_made, graphs.dispatch_plan_hits)
    batch = torch.from_numpy(_image((3, 4, 5, 3), 0))
    for device in (torch.device("cpu"), torch.device("cpu", 0)):
        for _ in range(2):
            assert torch.equal(run(batch, device), 255 - batch)
    assert run._plans == {} and (graphs.dispatch_plans_made, graphs.dispatch_plan_hits) == before


class _Dispatched:
    """A stand-in for ``_Dispatch``: the steps of each call, into ``calls``
    (with ``tag`` first where it is given)."""

    own = (0x1000, 0x2000)

    def __init__(self, calls=None, tag=None):
        self.calls, self.tag = [] if calls is None else calls, tag

    def __call__(self, stream, src, dst, event, steps):
        assert event == 0xE
        self.calls.append((src, dst, steps) if self.tag is None else (self.tag, src, dst, steps))


def _entry(stream):
    return types.SimpleNamespace(dispatch=_Dispatched(), event=0xE, stream=stream,
                                 static_in=torch.zeros(4, dtype=torch.uint8),
                                 captured=types.SimpleNamespace(launches={}))


@pytest.mark.parametrize("src,dst,last,recorded,calls", [
    (0x9000, 0xA000, 0, None, [(0x9000, 0xA000, "launch record")]),
    (0x9000, 0xA000, 3, None, [(0x9000, 0xA000, "wait launch record")]),
    (None, None, 3, None, [(0x1000, 0x2000, "wait"), (0x1000, 0x2000, "launch")]),
    (None, 0xA000, 0, None, [(0x1000, 0xA000, ""), (0x1000, 0xA000, "launch record")]),
    (0x9000, 0xA000, 0, {"graphs.replay": 1}, [(0x9000, 0xA000, "launch record")]),
    (0x9000, None, 3, {"graphs.replay": 1}, [(0x9000, 0x2000, "wait launch")]),
    (None, None, 3, {"graphs.upload": 1, "graphs.replay": 1},
     [(0x1000, 0x2000, "wait"), (0x1000, 0x2000, "launch")]),
    (None, 0xA000, 0, {"graphs.upload": 1, "graphs.replay": 1},
     [(0x1000, 0xA000, ""), (0x1000, 0xA000, "launch record")]),
], ids=["bound", "bound, after another stream", "copied", "copied in, bound out",
        "bound, recorded", "bound in, recorded", "copied, recorded",
        "copied in, bound out, recorded"])
def test_a_replays_native_calls_and_spans(monkeypatch, src, dst, last, recorded, calls):
    """``_replay`` on the default stream (0): a bound replay is one native
    call (the bind, the launch, the event; the wait where another stream
    recorded the graph's event last), and a copied input's wait comes before
    its copy, inside a recording of spans as outside one: the spans are the
    copy in ``graphs.upload`` (a host input) and the bind and launch in
    ``graphs.replay``. The library records the event where the output is
    bound; else the caller does, after it reads the graph's."""
    for name in ("replays_made", "upload_bytes", "copy_in_bytes", "inputs_bound",
                 "outputs_bound"):
        monkeypatch.setattr(graphs, name, 0)
    entry, x = _entry(last), torch.arange(4, dtype=torch.uint8)
    if recorded is None:
        graphs._replay(entry, x, src, dst, 0)
        spans = None
    else:
        with profiling.recording() as rec:
            graphs._replay(entry, x, src, dst, 0)
        spans = dict(collections.Counter(s.name for s in rec.spans))
    assert spans == recorded
    steps = {"wait": graphs._WAIT, "launch": graphs._LAUNCH, "record": graphs._RECORD}
    assert entry.dispatch.calls == [(s, d, sum(steps[w] for w in words.split()))
                                    for s, d, words in calls]
    assert (graphs.replays_made, graphs.inputs_bound, graphs.outputs_bound) == (
        1, src is not None, dst is not None)
    assert graphs.upload_bytes == (4 if src is None else 0)
    assert torch.equal(entry.static_in, x if src is None else torch.zeros(4, dtype=torch.uint8))
    assert entry.stream == (0 if dst is not None else last)


class _Graph:
    """A stand-in for a kept graph (``_Entry``) of ``fn`` on a copy of ``x``:
    its static input and output on the CPU, its input site, its output site
    where ``align`` (the alignment its launch was chosen by) is given and
    ``fn`` gives one tensor, a ``_Dispatched`` that logs into ``calls``
    under the graph's images, and how many times ``done`` was recorded."""

    nbytes = 0

    def __init__(self, fn, x, calls, align):
        self.static_in = x.clone()
        out = fn(self.static_in)
        self.captured = types.SimpleNamespace(out=out, launches={})
        self.inputs = graphs.Site(_CARD, tuple(x.shape), x.stride(),
                                  (graphs.Binding(0xA, 3, 0, 0, 16),))
        self.outputs = None if align is None else graphs.Site(
            _CARD, tuple(out.shape), out.stride(), (graphs.Binding(0xB, 3, 1, 0, align),))
        self.dispatch, self.event, self.stream = _Dispatched(calls, x.shape[0]), 0xE, 0
        self.records = 0
        self.done = types.SimpleNamespace(record=self._record)

    def _record(self):
        self.records += 1


# case -> (whether the batch lies on the card, one image's function, the
# alignment its output's launch was chosen by (None: no output site), and
# for the groups of 2 and 1 images of a call of three: whether the group's
# input and its rows of the output are bound)
_PLANNED = {
    "bound both ways": (True, lambda x: x[..., 0] + 1, 16, [(True, True), (True, True)]),
    "odd answers": (True, lambda x: x[:3, :5, 0] + 1, 16, [(True, True), (True, False)]),
    "input only": (True, lambda x: x[..., 0] + 1, None, [(True, False), (True, False)]),
    "a host batch": (False, lambda x: x[..., 0] + 1, 16, [(False, False), (False, False)]),
    "a tuple output": (True, lambda x: (x[..., 0], x[..., 1:]), None,
                       [(True, False), (True, False)]),
}


def _plan_counters() -> dict:
    return {**graphs.counts(), "plans": graphs.dispatch_plans_made,
            "hits": graphs.dispatch_plan_hits}


@pytest.mark.parametrize("case", list(_PLANNED))
def test_a_first_and_a_repeat_call_run_one_plan(monkeypatch, case):
    """``Batched`` on a stand-in card (stand-in graphs whose library calls
    are logged): the first call of a key makes its plan, capturing its two
    graphs and replaying none, then runs it as a repeat call does, with the
    same native calls, copies, spans and counters. A group is bound where it
    lies on the card and its address meets its graph's alignment (the odd
    answers' second group's rows, 30 bytes in, miss 16), else copied in (a
    host batch) or out (no output site, a tuple), ``done`` recorded after
    the copy out, whose bytes ``copy_out_bytes`` counts; the plan counters
    count batches on the card."""
    on_card, fn, align, bound = _PLANNED[case]
    for name in ("captures_made", "evictions_made", "replays_made", "upload_bytes",
                 "copy_in_bytes", "copy_out_bytes", "inputs_bound", "outputs_bound",
                 "dispatch_plans_made", "dispatch_plan_hits"):
        monkeypatch.setattr(graphs, name, 0)
    monkeypatch.setattr(graphs, "_held", collections.OrderedDict())
    monkeypatch.setattr(graphs, "_batch_graphs", collections.OrderedDict())
    calls = []
    monkeypatch.setattr(graphs, "_capture_entry", lambda body, x, *_: _Graph(fn, x, calls, align))
    monkeypatch.setattr(graphs, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    empty = torch.empty

    def empty_here(*shape, device=None, **kw):  # the card's allocations, on the CPU
        return empty(*shape, device=None if device == _CARD else device, **kw)

    monkeypatch.setattr(torch, "empty", empty_here)
    batch = torch.from_numpy(_image((3, 4, 8, 3), 0)).clone()  # 96 bytes an image
    monkeypatch.setattr(graphs, "GROUP_INPUT_BYTES", 2 * 96)
    if on_card:
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
        monkeypatch.setattr(torch.Tensor, "device", property(lambda t: _CARD))
    run = graphs.batched(lambda x: x)
    made = []
    for _ in range(2):
        before = _plan_counters()
        del calls[:]
        with profiling.recording() as rec:
            out = run(batch, _CARD)
        base = out.data_ptr() if isinstance(out, torch.Tensor) else None
        made.append(([(n, "own" if src == 0x1000 else src - batch.data_ptr(),
                       "own" if dst == 0x2000 else dst - base, steps)
                      for n, src, dst, steps in calls],
                     collections.Counter(s.name for s in rec.spans),
                     {k: v - before[k] for k, v in _plan_counters().items()},
                     sum(g.records for g in graphs._batch_graphs.values())))
    (calls1, spans1, delta1, records1), (calls2, spans2, delta2, records2) = made
    row_out = 0 if base is None else out[0].nbytes
    want = []
    for k, (n, (bound_in, bound_out)) in enumerate(zip((2, 1), bound)):
        dst = 2 * k * row_out if bound_out else "own"
        if not bound_in:
            want.append((n, "own", dst, 0))  # the wait before the copy in
        want.append((n, 2 * k * 96 if bound_in else "own", dst,
                     graphs._LAUNCH | (graphs._RECORD if bound_out else 0)))
    assert calls1 == calls2 == want
    copied_out = sum(not o for _, o in bound)
    copied_bytes = sum(sum(t.nbytes for t in torch.utils._pytree.tree_leaves(fn(batch[:n])))
                       for n, (_, o) in zip((2, 1), bound) if not o)
    assert spans1 == spans2 == collections.Counter({
        "graphs.group": 2, "graphs.replay": 2, "graphs.copy_out": copied_out,
        "graphs.upload": 0 if on_card else 2})
    counters = {"graphs_evicted": 0, "graph_replays": 2,
                "upload_bytes": 0 if on_card else batch.nbytes,
                "inputs_bound": sum(i for i, _ in bound),
                "outputs_bound": sum(o for _, o in bound), "copy_in_bytes": 0,
                "copy_out_bytes": copied_bytes}
    assert delta1 == {**counters, "graphs_captured": 2, "plans": int(on_card), "hits": 0}
    assert delta2 == {**counters, "graphs_captured": 0, "plans": 0, "hits": int(on_card)}
    assert (records1, records2) == (copied_out, 2 * copied_out)


def test_every_kernel_launch_is_noted():
    """Every port kernel is launched through ``ipt::launch``
    (``csrc/launch.cuh``), which notes its pointer arguments under capture:
    a kernel launched with ``<<<...>>>`` would read a graph's input unseen."""
    csrc = Path(graphs.__file__).resolve().parent.parent / "csrc"
    sources = sorted(csrc.glob("*.cu"))
    assert len(sources) == 9
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
