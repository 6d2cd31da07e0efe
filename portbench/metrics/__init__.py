"""One reader per metric, named as in ``BENCHMARK.json``: ``read(run)``
returns the metric's value from a finished run (``harness.Run``), or
None where the run holds nothing to read it from."""
