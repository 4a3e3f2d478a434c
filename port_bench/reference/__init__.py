"""The plain references, one module per configuration (``<config>.py``), each
with ``expected(images, config)`` (uint8[N, H, W, 3] -> the task's outputs),
``control(images, config)`` (the same in the nearest precision below the one
the configuration states) and, for a task whose answers are files,
``file_bytes(output, config)``. They import plain torch and numpy only: no
JAX and nothing of the port. The arithmetic is a frozen copy of the reference
tool's (``ppmx-edward.c``) and of the flagship's published formulas.
"""
