"""The benchmark of gubernator_tpu_torch: one cell a run, driven by data.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once. Configurations
(configs/<name>.json), traffic mixes (traffic/<mix>.json), per-layer metric
readers (metrics/<metric>.py), the systems under test (systems/<system>.py) and
the plain references (references/<reference>.py) are found by the names that
BENCHMARK.json and the configuration files give.
"""
