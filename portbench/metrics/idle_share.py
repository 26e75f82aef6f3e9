"""Percent of the work's untraced seconds in which the device ran nothing:
1 - the traced window's device busy time over the untraced seconds of the
same work (``readers.idle_share``)."""

from portbench.lib import readers


def read(view):
    return readers.idle_share(view)
