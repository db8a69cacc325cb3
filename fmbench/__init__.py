"""The benchmark of awry_tpu_torch: concurrent wire clients on one card.

Run one cell once with ``python3 fmbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the repository root.
"""
