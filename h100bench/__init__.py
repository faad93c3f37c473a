"""The H100 benchmark of ``m2trans_tpu_torch``: ``python h100bench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once and prints one JSON line."""
