"""One reader a metric, ``<metric>.py`` with ``read(run) -> float | None``:
None where the run holds nothing that the metric reads, and the harness
then leaves the metric out of the line.  ``run`` is a
``bench.harness.Run``."""
