"""Input megapixels of every call completed in the window, over the time from
the first call's start to the last call's end (each call ended by a
synchronize)."""

from port_bench import stats


def read(run):
    return stats.rate(run.window.counts["mpix"], run.window.span_s)
