"""Host utilities: logging and the metrics sink, wall-clock timers, and
profiling hooks."""
