"""The benchmark of ``clenabled_tpu_torch`` on one NVIDIA H100.

``python -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that belongs to one configuration, traffic mix,
per-layer metric or cell's limits is a file of its own, found by name:

- ``configs/<config>.json``: one deployment (its ``kind`` names the driver);
- ``traffic/<mix>.json``: one traffic mix, read by the kind's driver;
- ``drivers/<kind>.py``: builds the entry, runs the window, hands the
  answers to the comparison;
- ``metrics/<metric>.py``: reads one per-layer metric from a traced run;
  ``readers.py`` holds what the readers share;
- ``limits/<workload>.json``: the limits of a cell's comparison;
- ``reference/``: the plain reference (NumPy and plain torch, importing
  nothing of the program);
- ``roofline.py``: the card's peaks and the kernels' operations and bytes.
"""
