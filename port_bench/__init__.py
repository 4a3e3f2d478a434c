"""The benchmark of ``imageprocessingtools_tpu_torch``, the port for NVIDIA Hopper.

One command runs one cell of ``BENCHMARK.json`` once, on one card::

    python3 -m port_bench.run --workload flagship_4k.resident --seed 7 --seconds 10 --trace 0

It measures the port only: nothing here imports ``jax``, ``jaxlib`` or the JAX
package, and a run that finds one of them loaded fails. Everything that belongs
to one configuration, traffic mix or metric sits in files of its own, found by
the names in ``BENCHMARK.json``:

  configs/<config>.json     the deployment: source, sizes, guarantee, limits
  workloads/<cell>.json     the cell: its configuration, traffic driver and parameters
  traffic/<driver>.py       one way of offering work (card-resident groups, a file
                            campaign)
  metrics/<metric>.py       one reader per metric
  work/<config>.py          the task's algorithmic bytes and operations per image
  device/<card>.json        the card's published peaks
  reference/<config>.py     the plain reference and its lower-precision control

``frames.py`` makes every cell's inputs from the seed, ``tracing.py`` holds the
profiler arithmetic and the wrapping of the port's stages, ``control.py`` runs
the controls on the card and ``sets.py`` runs a cell over many seeds and prints
the spreads that the bounds are set from.
"""
