"""``reference_4k.resident`` at a small size on the card: correct, not correct
under the control and the three faults, its group's input and output bound
into the three-stage graph on every replay, K1's plan made once, and
in a chunk of odd answers the first group's output alone bound."""

import pytest
import torch

from port_bench import entries, frames
from port_bench.reference import reference_4k
from port_bench.tests.test_port_bench_reference_4k import run_small


@pytest.mark.cuda
def test_the_small_cell_on_the_card_is_correct(card, monkeypatch, tmp_path):
    monkeypatch.setenv("IPT_DEVICE", "cuda")
    line = run_small(tmp_path, device=card)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("substitute", ["control", "fault:alter", "fault:half", "fault:stale"])
def test_the_small_cell_on_the_card_is_not_correct_under_the_control_and_faults(
        card, monkeypatch, tmp_path, substitute):
    monkeypatch.setenv("IPT_DEVICE", "cuda")
    line = run_small(tmp_path, substitute, device=card)
    assert line["correct"] is False and line["checks"]["bytes_off"]["value"] > 0


@pytest.mark.cuda
def test_the_three_stage_graph_binds_its_group_and_plans_k1_once(card, monkeypatch):
    """Every replay of ``-w<N> -r30 -gray`` on a group on the card reads the
    group and writes its answers where they lie, and K1's plan for the one
    geometry is made once, at the capture."""
    from imageprocessingtools_tpu_torch.kernels import rotate
    from imageprocessingtools_tpu_torch.utils import graphs

    monkeypatch.setenv("IPT_DEVICE", "cuda")
    flags = ["-w250", "-r30", "-gray"]  # a geometry no other test plans
    group = frames.frames(4, 270, 500, seed=2**31 + 3, device=card)
    before, plans = graphs.counts(), rotate.plans_made
    first, _ = entries.reference_batch(group, flags)
    calls = 5
    for _ in range(calls - 1):
        out, _ = entries.reference_batch(group, flags)
    torch.cuda.synchronize(card)
    delta = {k: v - before[k] for k, v in graphs.counts().items()}
    assert delta["graphs_captured"] == 1 and delta["graph_replays"] == calls
    assert delta["inputs_bound"] == delta["outputs_bound"] == calls
    assert delta["copy_in_bytes"] == delta["upload_bytes"] == 0
    assert rotate.plans_made == plans + 1
    want = reference_4k.expected(group, {"new_width": 250, "angle": 30})
    assert torch.equal(first, want) and torch.equal(out, want)


@pytest.mark.cuda
def test_a_chunk_of_odd_answers_binds_its_first_group_s_output_alone(card, monkeypatch):
    """Answers of an odd byte count (uint8[237, 279] here, 2203 x 1895 at
    4K) put every later group's rows of a chunk off the 16 bytes that K8 was
    captured for: each group reads its input where it lies, but only the
    first writes its answers in place; the others are copied out of the
    graph (the cell's ``copy_us_per_image``), byte-equal all the same."""
    from imageprocessingtools_tpu_torch.utils import graphs

    monkeypatch.setenv("IPT_DEVICE", "cuda")
    flags = ["-w246", "-r30", "-gray"]
    chunk = frames.frames(6, 270, 500, seed=2**31 + 4, device=card)
    monkeypatch.setattr(graphs, "GROUP_INPUT_BYTES", 2 * chunk[0].nbytes)  # graph groups of 2
    entries.reference_batch(chunk, flags)  # the capture
    before = graphs.counts()
    out, _ = entries.reference_batch(chunk, flags)
    torch.cuda.synchronize(card)
    delta = {k: v - before[k] for k, v in graphs.counts().items()}
    assert (237 * 279) % 2 == 1 and tuple(out.shape) == (6, 237, 279)
    assert delta["graph_replays"] == delta["inputs_bound"] == 3
    assert delta["outputs_bound"] == 1 and delta["copy_in_bytes"] == 0
    assert torch.equal(out, reference_4k.expected(chunk, {"new_width": 246, "angle": 30}))
