"""One reader per metric, ``<metric>.py`` with ``read(records) -> float | None``,
found by the metric's name in ``BENCHMARK.json``; ``roofline.py`` and
``readers.py`` are the arithmetic they share."""
