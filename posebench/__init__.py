"""posebench: the benchmark of pose6d_tpu_torch's serving pipeline on an
NVIDIA GPU (BENCHMARK.json at the checkout's root names its cells).

    python3 -m posebench.run --workload CELL --seed N --seconds S --trace 0|1
    python3 -m posebench.calibrate --workload CELL --seeds N ... --control-seeds N ...
    python -m pytest -p no:cacheprovider posebench/tests   (CPU; the card test skips)

  run.py         a run: set-up, the timed window, the traced windows, the check
  cells.py       a cell's configuration, mix, limits and per-layer readers, by name
  serve.py       the program built through its public API; the ring; the closed loop
  weights.py     seeded weights made on the card
  judge.py       the check that decides `correct`, against reference/
  trace.py       the profiled windows and their reduction to a record
  flops.py       FLOPs and bytes counted on the reference networks; the card's peaks
  calibrate.py   the readings the limits are set from, many seeds in one process
  reference/     the plain float32 reference (torch only)
  configs/, traffic/, limits/, layer_metrics/   data and readers, one file each

Nothing here imports JAX or the JAX package (pose6d_tpu); reference/
imports nothing of the program.
"""
