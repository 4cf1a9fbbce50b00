"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card
and prints one JSON line. Everything a cell needs is found by name:
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``, which names the general loop in ``drivers/``
that reads it), the plain reference and the work of its configuration
(``reference/<config>.py``, ``work/<config>.py``), the adapter to the
port for the configuration's model (``port/<model>.py``), the limits of
its correctness check (``limits/<cell>.json``) and one reader a
per-layer metric (``metrics/<metric>.py``).
"""
