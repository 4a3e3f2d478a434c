"""``print_ready_4k.resident`` at a small size on the card: correct, and not
correct under the control and the three faults."""

import pytest

from port_bench.tests.test_port_bench_print_ready_4k import run_small


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
