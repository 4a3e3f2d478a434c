"""Host ms per file inside ``serving.process_batch`` (upload, launch) and
``serving._to_host`` (wait, download), over the window's files."""

from port_bench.metrics._stage import ms_per_file


def read(run):
    return ms_per_file(run, ["serving.process_batch", "serving._to_host"])
