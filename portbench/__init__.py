"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything a cell is made of is a file found by
name: its configuration under ``configs/``, its traffic or job under
``traffic/`` (which names its driver under ``drivers/``), and each
per-layer metric's reader under ``metrics/``.  The yardstick lives here
too: the peaks (``peaks.json``), the operations and bytes of the work
(``counts.py``), the kernel families (``kernel_families.json``), the
reduction of the profiler's timeline (``timeline.py``) and the plain
fp32 reference with its comparisons (``reference/``).  Nothing here
imports JAX or the JAX package.
"""
