"""Device timing: an op's device rate in a feedback loop, and one call's cost.

Counterpart of ``imageprocessingtools_tpu/utils/timing.py``, with its
signatures and its feedback rules. On a CUDA input both time the card, as
the JAX functions' jitted programs do, through a captured CUDA graph
(``utils/graphs.py``):

- ``device_loop_rate``: run an image -> image op ``iters`` times, each
  iteration's input rebuilt from the previous output (``feedback``), so
  that no call can be skipped or reordered, and subtract a 0-iteration
  baseline. The JAX function runs the loop inside one jitted
  ``lax.fori_loop``; here the ``iters`` iterations are captured as one
  graph that reads the input where it lies, and CUDA events bracket a
  replay, so the result is the card's time per iteration, with no host
  launch between iterations. A body that cannot be captured raises
  ``graphs.CaptureError``; it is never timed from the host instead.
- ``dispatch_time``: one call plus a dependent fetch of one element, on the
  host clock. The JAX function times one dispatch of ``jax.jit(fn)``; here
  ``fn(*args)`` is captured on the given tensors and one replay is timed.

Neither moves its input: a CUDA tensor is timed on its card, a CPU tensor
(or a numpy array) eagerly on the host clock.
"""

from __future__ import annotations

import statistics
import time

import torch

from imageprocessingtools_tpu_torch.utils import graphs


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _fetch_tiny(x) -> None:
    """Wait for ``x`` by copying one of its elements to the host."""
    _first(x).reshape(-1)[:1].cpu()


def feedback(out: torch.Tensor, carry: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The next input of the loop: uint8 of ``shape``, made from ``out``, the
    body's output on ``carry``. The JAX function's five branches, in order:

    - [H, W] from [H, W, 3]: the output stacked with itself rolled by 1 row
      and by 7 columns;
    - [N, H, W] from [N, H, W, 3]: the same per image;
    - a 1-D output whose length divides W of an [H, W] input: tiled to one
      row and broadcast down the rows;
    - an [H', W', C'] output of another shape than an [H, W, C] input
      (resize): the carry XOR the uint8 sum of every output element;
    - otherwise the output ravelled and tiled to the input's size.
    """
    if out.ndim == 2 and len(shape) == 3 and tuple(out.shape) == shape[:2] and shape[2] == 3:
        return _stack_rolls(out.to(torch.uint8), 0)
    if out.ndim == 3 and len(shape) == 4 and tuple(out.shape) == shape[:3] and shape[3] == 3:
        return _stack_rolls(out.to(torch.uint8), 1)
    if out.ndim == 1 and len(shape) == 2 and shape[1] % out.shape[0] == 0:
        row = out.to(torch.uint8).repeat(shape[1] // out.shape[0])
        return row[None, :].expand(shape).contiguous()
    if out.ndim == 3 and len(shape) == 3 and tuple(out.shape) != shape:
        # The sum consumes every output element; its low byte is the JAX
        # function's int32 sum cast to uint8.
        return carry ^ out.to(torch.int32).sum().to(torch.uint8)
    flat = out.to(torch.uint8).reshape(-1)
    need = carry.numel()
    reps = -(-need // flat.numel())
    return (flat if reps == 1 else flat.repeat(reps))[:need].reshape(shape)


def _stack_rolls(out: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.stack([out, torch.roll(out, 1, dim), torch.roll(out, 7, dim + 1)],
    -1)``, written as slice copies into one buffer: less than half the
    stack's and rolls' device time at 4K (``profile_device``'s "feedback"
    cases, PERF.md), which would otherwise outweigh the flagship's."""
    nxt = out.new_empty(out.shape + (3,))
    nxt[..., 0] = out
    _roll_into(nxt[..., 1], out, 1, dim)
    _roll_into(nxt[..., 2], out, 7, dim + 1)
    return nxt


def _roll_into(dst: torch.Tensor, src: torch.Tensor, shift: int, dim: int) -> None:
    """``dst[...] = torch.roll(src, shift, dim)`` as two slice copies."""
    n = src.shape[dim]
    s = shift % n if n else 0
    dst.narrow(dim, s, n - s).copy_(src.narrow(dim, 0, n - s))
    dst.narrow(dim, 0, s).copy_(src.narrow(dim, n - s, s))


def _loop(body, x: torch.Tensor, n: int) -> torch.Tensor:
    shape = tuple(x.shape)
    for _ in range(n):
        x = feedback(body(x), x, shape)
    return x


def device_loop_rate(body, img, iters: int = 20, repeats: int = 3, stat: str = "min") -> float:
    """Seconds per iteration of ``body`` (uint8 tensor -> uint8 tensor).

    The output is fed back into the next input (``feedback``); the measured
    time includes that feedback, so rates slightly underestimate the op's.
    The 0-iteration baseline and the timed loop run as adjacent pairs; a
    pair whose delta is not positive is discarded, and ``stat`` picks the
    min or the median of the rest (1e-9 when none is left).

    On a CUDA input the loop of ``iters`` iterations is one CUDA graph, and
    CUDA events on the current stream bracket one replay of it. The
    0-iteration loop launches nothing, so it has no graph: its baseline is
    the two events recorded back to back on the stream. On a CPU input the
    host runs the loop, and the host clock times it up to a dependent
    one-element fetch.
    """
    img = torch.as_tensor(img)
    if img.device.type == "cuda":
        return _card_loop_rate(body, img, iters, repeats, stat)
    _fetch_tiny(_loop(body, img, iters))
    _fetch_tiny(_loop(body, img, 0))

    def run(n: int) -> float:
        t0 = time.perf_counter()
        _fetch_tiny(_loop(body, img, n))
        return time.perf_counter() - t0

    return _rate(run, iters, repeats, stat)


def _card_loop_rate(body, img: torch.Tensor, iters: int, repeats: int, stat: str) -> float:
    def loop(x):
        return _loop(body, x, iters)

    loop.__qualname__ = f"device_loop_rate({graphs._name(body)})"
    with torch.cuda.device(img.device):
        captured = graphs.capture(loop, img)

        def run(n: int) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if n:
                captured.replay()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        return _rate(run, iters, repeats, stat)


def _rate(run, iters: int, repeats: int, stat: str) -> float:
    deltas = []
    for _ in range(repeats):
        base = run(0)
        t = run(iters)
        if t > base:
            deltas.append((t - base) / iters)
    if not deltas:
        # Every pair underflowed: below this window's noise floor.
        return 1e-9
    return statistics.median(deltas) if stat == "median" else min(deltas)


def dispatch_time(fn, *args, repeats: int = 5) -> float:
    """Seconds for one call of ``fn(*args)`` and a dependent fetch of one
    element of its output (the first, for a tuple), on the host clock; the
    least of ``repeats`` after a warm-up call. Where an argument is a CUDA
    tensor, a call is one replay of ``fn(*args)`` captured on those tensors
    (``graphs.capture``)."""
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        captured = graphs.capture(fn, *args)

        def call():
            captured.replay()
            return captured.out
    else:
        def call():
            return fn(*args)

    _fetch_tiny(call())

    def run() -> float:
        t0 = time.perf_counter()
        _fetch_tiny(call())
        return time.perf_counter() - t0

    return min(run() for _ in range(repeats))
