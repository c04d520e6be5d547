"""Benchmark of montecarlopathtracing_torch, the PyTorch and CUDA port.

One run measures one cell (a configuration under a traffic mix) on the
card: ``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``.  Cells, configurations, traffic mixes, traffic loops,
scene generators and per-layer metric readers are files of their own under
this folder, found by name (``core.py``).
"""
