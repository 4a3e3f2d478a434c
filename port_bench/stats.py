"""The statistics the benchmark reports: a tail over every sample, a rate over a
whole window, and the spread that bounds are set from."""

from __future__ import annotations

import statistics


def p95(values) -> float | None:
    """The 95th percentile of every value (linear between ranks,
    ``statistics.quantiles``' inclusive method); None for no values."""
    values = list(values)
    if not values:
        return None
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def rate(amount: float, seconds: float) -> float | None:
    """``amount`` over ``seconds``, the whole window; None where either is 0."""
    if not amount or seconds <= 0:
        return None
    return amount / seconds


def spread(values) -> float:
    """The distance between the first and third quartiles
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, median, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / median
