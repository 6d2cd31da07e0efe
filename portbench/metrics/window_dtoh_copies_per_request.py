"""``dtoh_copies_per_request`` in the window cells whose throughput is per layer, where it
names another end-to-end metric under ``moves`` than in the k-NN cell."""
from .dtoh_copies_per_request import read  # noqa: F401
