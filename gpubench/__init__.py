"""Benchmark of the PyTorch/CUDA port (``repro_torch``) on an NVIDIA H100.

Run one cell once with ``python3 gpubench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.
"""
