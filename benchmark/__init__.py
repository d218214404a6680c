"""The benchmark of `nicetpu_torch`, the PyTorch and CUDA port of the
`.nice` codec: one command runs one cell of `BENCHMARK.json` once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

See README.md beside this file for the layout and how to add a
configuration, a traffic mix or a metric as files of their own.
"""
