"""Per-layer metric readers, one a file named as the metric: ``read(data)``
takes the traced run's spans, stage times, device seconds and counts and
returns the number, or None where the run has nothing to read."""
