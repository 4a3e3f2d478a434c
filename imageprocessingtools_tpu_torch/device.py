"""The port's one device choice, read from ``IPT_DEVICE``.

Counterpart of the ``IPT_PLATFORM`` pin in ``imageprocessingtools_tpu/cli.py``.
``IPT_DEVICE`` is ``cuda`` (the default) or ``cpu``. A missing CUDA device is
an error unless ``cpu`` was asked for: nothing falls back to the CPU behind
the caller's back.

Float32 matrix products run in full float32 (TF32 off). No path of the port
multiplies matrices; the setting serves ``ops/resize.py::resize_width_dense``,
the dense form of the JAX package's resize kept as a yardstick, as the torch
form of that package's ``Precision.HIGH``/``HIGHEST``.
"""

from __future__ import annotations

import os

import torch

_CHOICES = ("cuda", "cpu")


def get_device() -> torch.device:
    """The configured device; raises if it is ``cuda`` and CUDA is missing."""
    name = os.environ.get("IPT_DEVICE", "cuda").strip().lower() or "cuda"
    if name not in _CHOICES:
        raise RuntimeError(f"IPT_DEVICE must be one of {_CHOICES}, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "IPT_DEVICE is 'cuda' (the default) but torch sees no CUDA device; "
            "set IPT_DEVICE=cpu to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device(name)
