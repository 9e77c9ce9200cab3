"""Host utilities: logging and the metrics sink."""
