"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything that belongs to one configuration, traffic
mix, cell or metric sits in a file of its own here, found by its name.
"""
