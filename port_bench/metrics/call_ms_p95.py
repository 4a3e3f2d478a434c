"""The 95th percentile of every call's time in the window: on the card's
clock, from the host's start of the call to the end of its last work."""

from port_bench import stats


def read(run):
    return stats.p95(run.window.samples.get("call_ms", ()))
