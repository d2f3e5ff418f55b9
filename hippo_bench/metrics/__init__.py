"""One reader per per-layer metric, found by the metric's name: the
file ``<name>.py`` here defines ``read(run)``, which returns the
metric's value from the run's counters, spans and device trace, or
``None`` where the run has nothing for it to read."""
