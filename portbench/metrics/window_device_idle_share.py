"""``device_idle_share`` in the window cells whose throughput is per layer, where it
names another end-to-end metric under ``moves`` than in the k-NN cell."""
from .device_idle_share import read  # noqa: F401
