"""The task's least time (``work/<config>.py`` at the card's peaks) over the
summed device time of every kernel event, per unit of the traced stretch. The
work is counted from the task's shapes and algorithm, never from which kernels
run, so a fused or replaced kernel reads the same work."""


def read(run):
    s = run.stretch
    if s is None:
        return None
    kernel_us = s.us(("kernel",))
    least = run.least_s(s.images)
    if not kernel_us or least is None:
        return None
    return 100.0 * least * 1e6 * s.units / kernel_us
