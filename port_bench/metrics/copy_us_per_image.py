"""Device us per image of copies and memsets in the traced stretch: the
graph's copy-in of the inputs and copy-out of the outputs."""


def read(run):
    s = run.stretch
    if s is None or not s.units:
        return None
    return s.us(("gpu_memcpy", "gpu_memset")) / (s.units * s.images)
