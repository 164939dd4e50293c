"""posebench: the end-to-end benchmark of tpupose_torch on one NVIDIA H100.

    python3 posebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once and prints one JSON line. Cells,
configurations, traffic mixes and per-layer metrics are files found by
name (posebench/workloads/, configs/, traffic/, metrics/); the yardstick
(plain references, operation and byte counts, peaks, the comparison that
decides `correct`) lives here too and imports nothing of the program but
what run.py hands it.
"""
