"""The benchmark of goctr_tpu_torch on one NVIDIA H100.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` and prints one JSON line.
Everything that belongs to one model family, configuration, traffic mix,
cell or per-layer metric is a file of its own here, found by its name
(`registry.py`); README.md says how to add one.
"""
