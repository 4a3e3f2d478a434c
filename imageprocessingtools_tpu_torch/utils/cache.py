"""Where the port's builds go: a cache directory outside the package.

Counterpart of ``imageprocessingtools_tpu/codec/native.py::_cache_dirs``, the
port's own copy. Both of the port's native builds (the CUDA kernels,
``kernels/_build.py``, and the C++ codec, ``codec/native.py``) write here,
never into the package's directory, which an installed wheel puts inside
site-packages. The candidates, most preferred first, each under
``imageprocessingtools_tpu_torch/``:

1. ``$IPT_CACHE_DIR``, if it is set (and then nothing else);
2. the checkout's ``.cache/``, where the package's parent directory holds
   ``.git`` (a source checkout; ``.gitignore`` lists ``.cache/``);
3. ``$XDG_CACHE_HOME``, or ``~/.cache`` where that is unset.
"""

from __future__ import annotations

import os
from pathlib import Path

NAME = "imageprocessingtools_tpu_torch"
# The directory that holds the package: a checkout's root, or site-packages.
ROOT = Path(__file__).resolve().parent.parent.parent


def cache_dirs() -> list[Path]:
    """The candidate build directories, most preferred first."""
    env = os.environ.get("IPT_CACHE_DIR")
    if env:
        return [Path(env) / NAME]
    dirs = []
    if (ROOT / ".git").exists():
        dirs.append(ROOT / ".cache" / NAME)
    xdg = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    dirs.append(Path(xdg) / NAME)
    return dirs


def build_dir() -> Path:
    """The first of ``cache_dirs()`` that is, or can be made, a writable
    directory. Raises ``OSError`` when none can."""
    tried = []
    for path in cache_dirs():
        try:
            path.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            tried.append(f"{path} ({e.strerror})")
            continue
        if os.access(path, os.W_OK | os.X_OK):
            return path
        tried.append(f"{path} (not writable)")
    raise OSError(f"no writable build directory: {', '.join(tried)}")
