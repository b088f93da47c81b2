"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of SparCML.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card(s) and
prints one JSON line (see ``run.py``). Everything that belongs to one
configuration, traffic mix, cell or per-layer metric is a file of its own,
found by the name ``BENCHMARK.json`` gives it (see ``README.md``).

Only ``program.py`` imports the port. The plain reference under
``reference/`` imports neither the port nor JAX.
"""
