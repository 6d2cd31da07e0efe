"""``pair_dist2``'s share of its bandwidth roofline: the frozen byte model's
bytes for the traced requests, at the card's peak bandwidth, over the
kernel's device time in the trace."""
from portbench import roofline


def read(run):
    return roofline.share(run, "pair_dist2", "pair_dist2_kernel")
