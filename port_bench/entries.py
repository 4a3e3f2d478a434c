"""Entries into the port that a workload's ``call`` names where the port has
no function taking a group and the workload's ``args`` as they stand.

``reference_batch(group, flags)`` runs the reference tool's flags on a
group, through the path that ``serve`` takes for them: the port's own
argument scan (``cli._parse_args``, as ``serve.main`` parses op flags), then
``serving.process_batch`` with the ``PipelineConfig`` it gives. The flags are
parsed once per list.
"""

from __future__ import annotations

import functools

from imageprocessingtools_tpu_torch import cli, serving


@functools.lru_cache(maxsize=16)
def _config(flags: tuple):
    return cli._parse_args([*flags, "frame.ppm"])[0]


def reference_batch(group, flags):
    """``serving.process_batch(group, config)`` for the ``PipelineConfig`` of
    the reference tool's ``flags`` (a list such as ``["-w1920", "-r30",
    "-gray"]``): (the outputs on the group's device, the file type)."""
    return serving.process_batch(group, _config(tuple(flags)))
