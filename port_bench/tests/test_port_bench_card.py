"""The small cells on the card: the program's kernels and graphs are correct
there, and the control is not."""

import pytest

from port_bench.tests.helpers import CELLS, run_small


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_cell_on_the_card_is_correct(card, monkeypatch, tmp_path, cell):
    monkeypatch.setenv("IPT_DEVICE", "cuda")
    line = run_small(cell, tmp_path, device=card)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_on_the_card_is_not_correct(card, monkeypatch, tmp_path, cell):
    monkeypatch.setenv("IPT_DEVICE", "cuda")
    line = run_small(cell, tmp_path, substitute="control", device=card)
    assert line["correct"] is False and line["checks"]["bytes_off"]["value"] > 0
