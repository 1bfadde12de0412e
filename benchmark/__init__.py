"""The benchmark of the port (``apx_torch``) on one H100: one run of one
cell is ``python3 -m benchmark.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` (``run.py``)."""
