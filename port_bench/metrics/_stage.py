"""Host ms per file of the window in wrapped stages of the port (``tracing.Stages``)."""


def ms_per_file(run, names):
    if run.stages is None or not run.window.counts["files"]:
        return None
    if not any(run.stages.calls[n] for n in names):
        return None
    return 1e3 * sum(run.stages.seconds[n] for n in names) / run.window.counts["files"]
