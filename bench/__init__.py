"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix, driver kind or per-layer metric
sits in a file of its own under ``configs/``, ``traffic/``, ``drivers/``
and ``metrics/``, found by name; ``reference/`` holds the plain
references that decide ``correct`` and ``yardstick/`` the peaks, work
formulas and trace reduction. Nothing here imports JAX or the JAX
package ``repro``, and ``reference/`` imports nothing of ``repro_torch``.
"""
