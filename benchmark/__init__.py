"""The benchmark of the PyTorch and CUDA port (``dctseg_torch``) on NVIDIA
cards.  ``BENCHMARK.json`` at the root lists its cells and metrics; one run
of one cell:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It imports nothing of JAX or of the JAX package.  ``harness.py`` says how
cells, configurations, traffic kinds and per-layer readers are found by
name; ``reference/`` is the plain model the outputs are held to;
``calibrate.py`` gives the readings the limits of ``correct`` are set
from.  Tests: ``python -m pytest benchmark/tests -q`` on the CPU, and with
``-m card`` on a card.
"""
