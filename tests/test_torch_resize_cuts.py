"""``resize_cuts.py``'s textual cuts still apply to ``csrc/resize.cu`` (CPU).

The cuts are timed on the card only; here each one must find its text in the
kernel's source exactly as often as it says, so that a change to the kernel
that strands a cut fails a test and not a chip run.
"""

from __future__ import annotations

import pytest

from imageprocessingtools_tpu_torch import resize_cuts


@pytest.mark.parametrize("name", sorted(resize_cuts.CUTS))
def test_cut_applies_to_the_kernel_source(name):
    text = resize_cuts.SOURCE.read_text()
    names = [name, "no_tap_loop"] if name == "no_tables" else [name]
    cut = resize_cuts.cut_source(text, names)
    assert cut != text
    for old, new, count in resize_cuts.CUTS[name]:
        assert cut.count(new) == count


def test_default_sets_apply_together_and_base_is_the_source():
    text = resize_cuts.SOURCE.read_text()
    assert resize_cuts.cut_source(text, ["base"]) == text
    for spec in resize_cuts.DEFAULT:
        resize_cuts.cut_source(text, spec.split(","))


def test_stamps_apply_to_the_kernel_source():
    text = resize_cuts.SOURCE.read_text()
    stamped = resize_cuts.cut_source(text, ["stamps"])
    # its definition and five calls (one of them stamps steps 0 and 1)
    assert stamped.count("stamp(") == len(resize_cuts.STAMP_NAMES)
    assert "ipt_resize_stamps" in stamped and "ipt_resize_stamps" not in text


def test_a_stranded_or_unknown_cut_is_refused():
    with pytest.raises(RuntimeError, match="occurs 0 times"):
        resize_cuts.cut_source("// another source\n", ["no_f64"])
    with pytest.raises(SystemExit, match="unknown cut"):
        resize_cuts.cut_source("", ["no_such_cut"])
    with pytest.raises(SystemExit, match="needs no_tap_loop"):
        resize_cuts.cut_source(resize_cuts.SOURCE.read_text(), ["no_tables"])
