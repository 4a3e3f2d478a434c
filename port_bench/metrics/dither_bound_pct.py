"""The dither and the P4 packing's share of their bound: the two stages'
least time as one pass (``work/<config>.py``'s ``per_stage(config)["dither"]``
and ``["pack"]`` summed, at the card's peaks, ``device/*.json``) over the
device time, per unit, of the traced stretch's kernel events whose name holds
none of the workload's ``kernels`` (the stages before the dither).

Inside one graph replay, kernel names are the only split between the task's
stages. Counting every kernel but the named ones keeps the reading whatever
the dither and the packing run as: today torch's own kernels, which also
hold the equalization LUT's 256-wide ops and the zeroing of K4's arrival
words; later a kernel of any name. Where no such kernel ran, the reader
returns None."""

from port_bench import harness, spec


def read(run):
    s = run.stretch
    names = tuple(run.workload.get("kernels", {}).values())
    peaks = None if s is None or not names else harness.device_peaks(run.device)
    if peaks is None:
        return None
    kernel_us = sum(e["dur"] for e in s.events if e.get("cat") == "kernel"
                    and not any(name in e.get("name", "") for name in names))
    if not kernel_us:
        return None
    stages = spec.module("work", run.config["name"]).per_stage(run.config)
    work = {k: stages["dither"][k] + stages["pack"][k] for k in ("bytes", "f64_ops", "int_ops")}
    ops_s = work["f64_ops"] / peaks["f64_ops_per_s"] + work["int_ops"] / peaks["int_ops_per_s"]
    least_s = max(work["bytes"] / peaks["bytes_per_s"], ops_s)
    return 100.0 * least_s * 1e6 * s.units * s.images / kernel_us
