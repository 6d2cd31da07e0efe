"""``queries_per_s`` of the traced run's window, as a per-layer metric of
the cells that do not report it end to end."""
from .queries_per_s import read  # noqa: F401
