"""K1's share of its roofline in this task: the rotation stage's least time
(``work/<config>.py``'s ``per_stage(config)["rotate"]`` at the card's peaks,
``device/*.json``) over the device time of the traced stretch's kernel events
whose name holds the workload's ``kernels["rotate"]``, per unit.

Inside one graph replay, kernel names are the only split between the task's
stages. Where no kernel of that name ran (a later change that fuses K1 with
another stage, or renames it), the reader returns None and a benchmark change
repoints it."""

from port_bench import harness, spec


def read(run):
    s = run.stretch
    name = run.workload.get("kernels", {}).get("rotate")
    peaks = None if s is None or not name else harness.device_peaks(run.device)
    if peaks is None:
        return None
    kernel_us = sum(e["dur"] for e in s.events
                    if e.get("cat") == "kernel" and name in e.get("name", ""))
    if not kernel_us:
        return None
    work = spec.module("work", run.config["name"]).per_stage(run.config)["rotate"]
    ops_s = work["f64_ops"] / peaks["f64_ops_per_s"] + work["int_ops"] / peaks["int_ops_per_s"]
    least_s = max(work["bytes"] / peaks["bytes_per_s"], ops_s)
    return 100.0 * least_s * 1e6 * s.units * s.images / kernel_us
