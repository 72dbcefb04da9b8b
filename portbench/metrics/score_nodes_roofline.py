"""kernels: score_nodes' share of its roofline, in %."""

from ..roofline import score_nodes

from . import roofline_share


def read(run):
    return roofline_share(run, score_nodes)
