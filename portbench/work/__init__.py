"""The yardstick's arithmetic: peaks, per-kernel operations and bytes,
and model FLOPs."""
