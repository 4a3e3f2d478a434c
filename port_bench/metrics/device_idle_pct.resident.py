"""The share of the traced stretch in which no kernel, copy or memset ran on
the card."""


def read(run):
    return None if run.stretch is None else run.stretch.idle_pct()
