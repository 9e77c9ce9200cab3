"""device_idle_share.corr: the share of the traced steps in which no
kernel, copy or memset ran."""

from portbench import readers


def read(ctx):
    return readers.device_idle_share(ctx)
