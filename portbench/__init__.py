"""The benchmark of mtscomp_tpu_torch on an NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
metric is a file of its own, found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (read by :mod:`.calls`) and
``metrics/<metric>.py``.
"""
