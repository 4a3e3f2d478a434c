"""Command-line interface mirroring the reference 1:1.

Counterpart of ``imageprocessingtools_tpu/cli.py``: the same flag surface,
duplicate/conflict validation, fixed pipeline order, ``.out`` output naming,
stdout error messages and exit codes as ``ppmx-edward.c:117-205`` (errors
print to STDOUT and exit 255; success exits 0 — quirk B3). Divergences, as
in the JAX package: bug B1 is fixed (flips compose after gray/mono) and
unsafe inputs are rejected instead of invoking UB (B4).

The file is decoded on the host, uploaded once to the device that
``IPT_DEVICE`` names (``cuda`` by default), processed there, brought back
once and encoded on the host::

    python -m imageprocessingtools_tpu_torch.cli [-fv|-fh] [-wN] [-rN] [-gray|-mono] file.ppm
"""

from __future__ import annotations

import sys

import torch

from imageprocessingtools_tpu_torch.codec.ppm import PPMError, read_ppm, write_ppm
from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig, run_pipeline
from imageprocessingtools_tpu_torch.utils import log

USAGE = (
    "ppmx-edward [options] (input filename)\n"
    "Options -fv  Flip vertically\n"
    "        -fh  Flip horizontally\n"
    "        -w(new width) Scale to the new width\n"
    "        -w100 means new width is 100\n"
    "        -r(angle)  Rotate (CW)\n"
    "        -r30 means rotate 30 degree CW.\n"
    "        -mono Convert to bilevel (.pbm) format\n"
    "        -gray  Convert to grayscale (.pgm) format\n"
)


class _CliError(Exception):
    def __init__(self, message: str, show_usage: bool = False):
        super().__init__(message)
        self.message = message
        self.show_usage = show_usage


_LONG_MAX = 2**63 - 1


def _c_atoi(digits: str) -> int:
    """glibc ``atoi`` on an all-digit token (``ppmx-edward.c:151,164``).

    strtol saturates to LONG_MAX on overflow (ERANGE) and the long->int
    conversion truncates mod 2^32 on the oracle platform, so huge digit
    strings WRAP: binary-verified ``-r4294967333`` == ``-r37`` and
    ``-w8589934604`` == ``-w12`` byte-identical; ``-r4294967295`` -> -1 ->
    "invalid option for rotate."; ``-w2147483649`` -> negative ->
    "invalid option for new width". Python's ``int()`` is unbounded (and
    refuses >4300-digit strings outright), so the saturate+truncate must
    be explicit. ``atoi("") == 0``.
    """
    digits = digits.lstrip("0")  # no overflow from leading zeros
    n = _LONG_MAX if len(digits) > 19 else min(int(digits or "0"), _LONG_MAX)
    n &= 0xFFFFFFFF
    return n - 2**32 if n >= 2**31 else n


def _parse_args(argv: list[str]) -> tuple[PipelineConfig, str]:
    """Replicates the char-by-char argv scan (``ppmx-edward.c:125-183``)."""
    flip_v = flip_h = gray = mono = False
    new_width: int | None = None
    angle: float | None = None
    filename: str | None = None

    for arg in argv:
        if arg.startswith("-"):
            rest = arg[1:]
            if rest[:1] == "f":
                sub = rest[1:2]
                if sub == "h":
                    if flip_h:
                        raise _CliError("Error: Duplicate options not allowed\n")
                    if flip_v:
                        raise _CliError("Error: Conflicting options not allowed\n")
                    flip_h = True
                elif sub == "v":
                    if flip_v:
                        raise _CliError("Error: Duplicate options not allowed\n")
                    if flip_h:
                        raise _CliError("Error: Conflicting options not allowed\n")
                    flip_v = True
                else:
                    raise _CliError(
                        "Error: invalid option for flip.\n"
                        "allowed options are -fh -fv only.\n"
                    )
            elif rest[:1] == "w":
                digits = rest[1:]
                if not all(c in "0123456789" for c in digits):
                    raise _CliError("Error: invalid option for scaling.\n")
                if new_width is not None:
                    raise _CliError("Error: Duplicate options not allowed\n")
                # atoi semantics incl. "" -> 0 and mod-2^32 wrap; 0 and
                # negatives are rejected later by the pipeline with
                # "invalid option for new width".
                new_width = _c_atoi(digits)
            elif rest[:1] == "r":
                digits = rest[1:]
                if digits == "":
                    raise _CliError("Error: invalid option for rotate\n")
                if angle is not None:
                    raise _CliError("Error: Duplicate options not allowed\n")
                if not all(c in "0123456789" for c in digits):
                    raise _CliError("Error: invalid option for rotate.\n")
                value = _c_atoi(digits)
                if value < 0 or value >= 360:
                    raise _CliError("Error: invalid option for rotate.\n")
                angle = float(value)
            elif rest == "gray":
                if gray:
                    raise _CliError("Error: Duplicate options not allowed\n")
                if mono:
                    raise _CliError("Error: Conflicting options not allowed\n")
                gray = True
            elif rest == "mono":
                if mono:
                    raise _CliError("Error: Duplicate options not allowed\n")
                if gray:
                    raise _CliError("Error: Conflicting options not allowed\n")
                mono = True
            else:
                raise _CliError(
                    "Error: invalid option: %s\n" % rest, show_usage=True
                )
        else:
            if filename is not None:
                raise _CliError("Error: invalid options\n")
            filename = arg

    if filename is None:
        raise _CliError("", show_usage=True)

    config = PipelineConfig(
        new_width=new_width,
        angle=angle,
        gray=gray,
        mono=mono,
        flip_v=flip_v,
        flip_h=flip_h,
    )
    return config, filename


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        config, filename = _parse_args(argv)
    except _CliError as e:
        sys.stdout.write(e.message)
        if e.show_usage:
            sys.stdout.write(USAGE)
        log.emit("arg_error", message=e.message.strip())
        return 255

    try:
        img, max_color = read_ppm(filename)
        result, file_type = run_pipeline(img, config)
        write_ppm(
            filename + ".out",
            result.cpu().numpy(),
            file_type=file_type,
            max_color=max_color,  # pass-through, quirk B5
        )
    except (PPMError, ValueError) as e:
        message = e.message if isinstance(e, PPMError) else str(e)
        sys.stdout.write(message)
        log.emit("pipeline_error", file=filename, message=message.strip())
        return 255
    except (MemoryError, torch.OutOfMemoryError) as e:
        # Backstop for an allocation that fails anywhere in the pipeline, on
        # the host or on the card, and for a kernel's refusal of a tensor
        # too large for its launch (kernels.TooLarge, a MemoryError): the
        # reference's every malloc site prints through CHECK_ERROR and
        # exits 255 (ppmx-edward.c:31-36); plan_resize's B9 bound rejects
        # oversized resizes before allocation. A failed launch is none of
        # these and stays a traceback.
        sys.stdout.write(_exact.B9_MESSAGE)
        log.emit("pipeline_error", file=filename, message=type(e).__name__)
        return 255
    log.emit("ok", file=filename, out=filename + ".out", file_type=file_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
