"""``pair_window_ids``'s share of its bandwidth roofline: the frozen byte model's
bytes for the traced requests, at the card's peak bandwidth, over the
kernel's device time in the trace."""
from portbench import roofline


def read(run):
    return roofline.share(run, "pair_window_ids", "pair_window_ids_kernel")
