"""The benchmark of ``gcnn_keras_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Every
configuration, traffic mix, per-layer metric, plain reference and limit
sits in a file of its own that the harness finds by the names in
``BENCHMARK.json``; see ``core/spec.py``.
"""
