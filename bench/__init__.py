"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the
harness, its inputs, the plain reference, the per-layer readers and the
yardstick. ``python3 bench/run.py --help`` runs one cell."""
