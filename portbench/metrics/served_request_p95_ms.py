"""``request_p95_ms`` of the traced run's window, as a per-layer metric of
the cells that do not report it end to end."""
from .request_p95_ms import read  # noqa: F401
