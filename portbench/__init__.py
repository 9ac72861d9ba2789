"""The benchmark of the PyTorch / CUDA port (``recurrent_fusion_network_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
See ``portbench/README.md``.
"""
