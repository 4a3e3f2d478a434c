"""Host ms per file inside ``serving._read_and_decode`` (read and decode, in
serving's reader thread), over the window's files."""

from port_bench.metrics._stage import ms_per_file


def read(run):
    return ms_per_file(run, ["serving._read_and_decode"])
