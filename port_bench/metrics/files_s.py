"""Files written in the window, over the time from the first pass's start to
the last pass's end."""

from port_bench import stats


def read(run):
    return stats.rate(run.window.counts["files"], run.window.span_s)
