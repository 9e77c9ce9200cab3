"""Faults planted in the program underneath the timed path, for the
controls and tests that show the check catches them. Each is a context
manager that patches the program's module and restores it."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def unchanged_state():
    """Every train step returns with the parameters and the optimizer's
    state as they were: the update never runs."""
    from eeg_gnn_tpu_torch.train.step import TrainStep

    return _patched(TrainStep, "update", lambda self: None)


def half_batch():
    """The cached step's batch keeps the first half of its rows, so the
    loss is the mean over them alone."""
    import eeg_gnn_tpu_torch.train.step as step_mod

    whole = step_mod.cached_batch

    def half(x, y, idx, *args, **kwargs):
        return whole(x, y, idx[:max(1, idx.shape[0] // 2)], *args, **kwargs)

    return _patched(step_mod, "cached_batch", half)


BY_NAME = {"unchanged_state": unchanged_state, "half_batch": half_batch}
