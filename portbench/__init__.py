"""portbench - the benchmark of the PyTorch and CUDA port (``repro_torch``).

See ``portbench/README.md`` for the command, the layout and how to add a
cell, a configuration, a traffic mix or a per-layer metric as new files.
"""
