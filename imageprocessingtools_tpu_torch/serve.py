"""Batch serving CLI: the reference's flag surface over MANY files.

    python -m imageprocessingtools_tpu_torch.serve [ops] [serve options] FILE...

Counterpart of ``imageprocessingtools_tpu/serve.py``, with the same argv
scan, messages and exit codes. Op flags are the reference's (``-fv -fh -wN
-rN -gray -mono``, fixed pipeline order, ``<input>.out`` naming); the
reference itself is strictly one image per process
(``ppmx-edward.c:1053-1172``). This entry point runs the same pipeline over
a whole file set through `serving.process_files` (shape bucketing, native
batch decode, decode/device/encode overlap) on the device that
``IPT_DEVICE`` names (``cuda`` by default, or ``cpu``), or over every card
(``--mesh``, ``--spatial``).

Serve options (extensions, hence the ``--`` prefix space):
    --spatial       process each file as ONE giant image in row bands over
                    the local cards (spatial parallelism) instead of batching;
                    a fan-out decodes and uploads each file once
    --mesh          split each batch over all local cards (data parallel)
    --max-batch N   images per device upload (default 256)
    --sequential    disable the reader/writer overlap threads
    --preset NAMES  serve a models/ preset pipeline instead of reference op
                    flags (edge_detect | enhance | thumbnail | print_ready);
                    mutually exclusive with op flags; composes with
                    --spatial and --mesh. A comma-separated list
                    FANS OUT: all presets run on one upload per chunk and
                    each writes <input>.<preset><suffix>
    --fanout SPEC   fan out REFERENCE op-flag pipelines: SPEC is
                    ';'-separated groups of op flags (e.g.
                    '-w1920 -gray;-mono;-r30'); every group runs on the
                    shared decode + upload, writing <input>.<tag><suffix>
                    where <tag> is the group's flags in pipeline order
                    (w1920-gray). Mutually exclusive with bare op flags;
                    composes with --preset (presets join the same fan-out)
    --suffix S      output filename suffix (default ".out"; must be
                    non-empty so inputs are never overwritten)
    --resume        skip inputs whose output file already exists, so an
                    interrupted large campaign restarts where it stopped
                    (the skip is by presence only; delete stale outputs to
                    force reprocessing)
    --skip-bad      a file that fails to open/parse/decode is skipped (one
                    "skipped <path>: <message>" line per file on stderr)
                    instead of failing the whole run; default keeps the
                    reference's fail-fast stdout/exit-255 surface
Exit codes/messages follow the single-image CLI: errors print to stdout,
exit 255 (quirk B3); success prints one summary line to stderr, which
counts the files processed in this run (resumed files separately), and
exits 0. Under ``IPT_STRUCTURED_LOG=1`` the ``serve_ok`` JSON line on stderr
also gives what the run added to ``utils.graphs``' counters:
``graphs_captured``, ``graphs_evicted``, ``graph_replays``,
``upload_bytes`` (bytes copied from the host into graphs' inputs),
``inputs_bound`` and ``outputs_bound`` (replays that read their input and
wrote their output where they lie on the card, which files read from the
host never do), ``copy_in_bytes`` (bytes copied card to card into
graphs' inputs) and ``copy_out_bytes`` (out of graphs' outputs that were
not bound), all 0 on the CPU, where nothing is captured; and what
it added to ``kernels/rotate.py``'s ``plans_made``, as ``rotate_plans_made``
(K1's host tile plans made, one per rotation geometry, which the CPU's
plain rotation also makes to check its rows), and to ``utils/graphs.py``'s
``dispatch_plans_made`` and ``dispatch_plan_hits`` (plans that batches on
the card left, and calls that took one: 0 for files, which come from the
host).
"""

from __future__ import annotations

import os
import sys
import time

import torch

from imageprocessingtools_tpu_torch import serving
from imageprocessingtools_tpu_torch.cli import _CliError, _parse_args
from imageprocessingtools_tpu_torch.codec import native
from imageprocessingtools_tpu_torch.codec.ppm import PPMError
from imageprocessingtools_tpu_torch.kernels import rotate
from imageprocessingtools_tpu_torch.models import PRESETS
from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.parallel.batch import default_mesh
from imageprocessingtools_tpu_torch.utils import graphs, log


def _counts() -> dict:
    """The always-on counters that ``serve_ok`` reports the run's share of."""
    return {**graphs.counts(), "rotate_plans_made": rotate.plans_made,
            "dispatch_plans_made": graphs.dispatch_plans_made,
            "dispatch_plan_hits": graphs.dispatch_plan_hits}


def _report_skipped(failures: dict) -> None:
    """One stderr line + one structured log event per skip-bad'ed file."""
    for p, msg in failures.items():
        sys.stderr.write(f"skipped {p}: {msg.strip()}\n")
        log.emit("serve_skipped_file", path=p, message=msg.strip())


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    serve_opts = {"spatial": False, "max_batch": 256, "overlap": True,
                  "mesh": False, "preset": None, "fanout": None,
                  "suffix": ".out", "resume": False, "skip_bad": False}
    op_args: list[str] = []
    files: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--help":
            sys.stderr.write(__doc__)
            return 0
        if a == "--spatial":
            serve_opts["spatial"] = True
        elif a == "--sequential":
            serve_opts["overlap"] = False
        elif a == "--mesh":
            serve_opts["mesh"] = True
        elif a == "--resume":
            serve_opts["resume"] = True
        elif a == "--skip-bad":
            serve_opts["skip_bad"] = True
        elif a == "--max-batch":
            i += 1
            if i >= len(argv) or not argv[i].isdigit() or int(argv[i]) < 1:
                sys.stdout.write("Error: --max-batch needs a positive integer\n")
                return 255
            serve_opts["max_batch"] = int(argv[i])
        elif a == "--preset":
            i += 1
            if i >= len(argv):
                sys.stdout.write("Error: --preset needs a name\n")
                return 255
            serve_opts["preset"] = argv[i]
        elif a == "--fanout":
            i += 1
            if i >= len(argv) or not argv[i].strip():
                sys.stdout.write("Error: --fanout needs op-flag groups\n")
                return 255
            serve_opts["fanout"] = argv[i]
        elif a == "--suffix":
            i += 1
            if i >= len(argv) or not argv[i]:
                sys.stdout.write("Error: --suffix needs a non-empty value\n")
                return 255
            serve_opts["suffix"] = argv[i]
        elif a.startswith("--"):
            sys.stdout.write(f"Error: unknown option {a}\n")
            return 255
        elif a.startswith("-"):
            op_args.append(a)
        else:
            files.append(a)
        i += 1

    if not files:
        sys.stdout.write("Error: no input files\n")
        return 255
    preset_names: list[str] = []
    if serve_opts["preset"] is not None:
        if op_args:
            sys.stdout.write("Error: --preset excludes op flags\n")
            return 255
        preset_names = serve_opts["preset"].split(",")
        for n in preset_names:
            if n not in PRESETS:
                sys.stdout.write(
                    "Error: unknown preset %r; available: %s\n"
                    % (n, " ".join(sorted(PRESETS)))
                )
                return 255
        if len(set(preset_names)) != len(preset_names):
            sys.stdout.write(
                "Error: duplicate preset in %r\n" % (serve_opts["preset"],)
            )
            return 255
    fanout_configs: list = []
    if serve_opts["fanout"] is not None:
        if op_args:
            sys.stdout.write("Error: --fanout excludes bare op flags\n")
            return 255
        for group in serve_opts["fanout"].split(";"):
            flags = group.split()
            if not flags:
                sys.stdout.write("Error: empty --fanout group\n")
                return 255
            try:
                # Validate each group with the reference parser (it needs
                # exactly one filename, so feed it the first file).
                cfg, _ = _parse_args(flags + [files[0]])
            except _CliError as e:
                sys.stdout.write(e.message)
                return 255
            fanout_configs.append(cfg)
    if fanout_configs:
        # --fanout always uses fan-out naming (<input>.<tag><suffix>),
        # even for one group; --preset names join the same dispatch.
        config = tuple(preset_names) + tuple(fanout_configs)
        try:
            serving._fanout_pipeline_fn(config)  # duplicate-tag check up front
        except ValueError as e:
            sys.stdout.write("Error: %s\n" % (str(e).strip(),))
            return 255
    elif preset_names:
        config = (preset_names[0] if len(preset_names) == 1
                  else tuple(preset_names))
    else:
        try:
            # Validate the op flags with the reference parser (it needs
            # exactly one filename, so feed it the first file).
            config, _ = _parse_args(op_args + [files[0]])
        except _CliError as e:
            sys.stdout.write(e.message)
            return 255

    n_skipped = 0
    if serve_opts["resume"]:
        sfx = serve_opts["suffix"]
        if isinstance(config, tuple):
            # Fan-out: a file counts as done only when EVERY element's
            # output exists (a partial file reruns all elements — they
            # share one dispatch anyway).
            tags = [serving.config_tag(n) for n in config]

            def _done(p):
                return all(os.path.exists(p + "." + t + sfx) for t in tags)
        else:
            def _done(p):
                return os.path.exists(p + sfx)
        todo = [p for p in files if not _done(p)]
        n_skipped = len(files) - len(todo)
        files = todo

    failures: dict = {}
    counts = _counts()
    t0 = time.perf_counter()
    try:
        mesh = default_mesh() if serve_opts["mesh"] or serve_opts["spatial"] else None
        if serve_opts["spatial"]:
            outs = []
            for p in files:
                if serve_opts["skip_bad"]:
                    # Probe the input only (open, header, payload length
                    # against the file's size); a failure past this point
                    # is a compute or write error and fails the run.
                    try:
                        native.parse_file_header(p)
                    except (PPMError, OSError) as e:
                        failures[p] = (e.message if isinstance(e, PPMError)
                                       else "error. can not open file\n")
                        continue
                outs.append(serving.process_file_spatial(
                    p, config, mesh=mesh, suffix=serve_opts["suffix"]))
        else:
            outs = serving.process_files(
                files, config, mesh=mesh,
                suffix=serve_opts["suffix"],
                max_batch=serve_opts["max_batch"],
                overlap=serve_opts["overlap"],
                on_error="skip" if serve_opts["skip_bad"] else "raise",
                failures=failures,
            )
    except (PPMError, ValueError, OSError, MemoryError, torch.OutOfMemoryError) as e:
        if isinstance(e, PPMError):
            message = e.message
        elif isinstance(e, OSError):
            # Match the single-image CLI's open-failure message (quirk B3).
            message = "error. can not open file\n"
        elif isinstance(e, (MemoryError, torch.OutOfMemoryError)):
            # Allocation-failure backstop, same surface as cli.main (B9): the
            # host's or the card's, or a kernel's refusal of a tensor too
            # large for its launch (kernels.TooLarge). A failed launch is
            # none of these and stays a traceback.
            message = _exact.B9_MESSAGE
        else:
            message = str(e)
        sys.stdout.write(message)
        # Files skip-bad already dropped must not vanish from the record
        # just because a later chunk failed the run.
        _report_skipped(failures)
        log.emit("serve_error", n_files=len(files), message=message.strip())
        return 255
    wall = time.perf_counter() - t0
    _report_skipped(failures)
    log.emit("serve_ok", n_files=len(outs), skipped=n_skipped,
             failed=len(failures), wall_s=round(wall, 3),
             **{name: n - counts[name] for name, n in _counts().items()})
    existing = (
        f".<tag>{serve_opts['suffix']}" if isinstance(config, tuple)
        else serve_opts["suffix"]
    )
    resume_note = (
        f", {n_skipped} skipped (existing {existing})"
        if serve_opts["resume"] else ""
    )
    bad_note = f", {len(failures)} bad skipped" if failures else ""
    sys.stderr.write(
        f"{len(outs)} files processed in {wall:.2f}s "
        f"({len(outs) / max(wall, 1e-9):.1f} files/s){resume_note}{bad_note}\n"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
