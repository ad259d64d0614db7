"""The benchmark of the port (``repro_torch``): pool building and influence
queries on one H100.  ``run.py`` runs one cell of ``BENCHMARK.json``."""
