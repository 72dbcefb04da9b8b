"""kernels: fill_take's share of its roofline, in %."""

from ..roofline import fill_take

from . import roofline_share


def read(run):
    return roofline_share(run, fill_take)
