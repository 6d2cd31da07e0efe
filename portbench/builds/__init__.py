"""Index builds, one module per name.  A configuration names its build
under ``"build"``; without the key it is ``"fmbi"``.

A module has ``deploy(cfg, points, device, microbatch) -> Built`` and
declares when the card holds the index that the window will serve:

* a build that serves a finished index reads the card itself, right after
  its export (``Built.device_bytes``), and has ``WARMUP_REQUESTS = 0``;
* a build that refines while it serves leaves ``device_bytes`` to the
  harness, which reads the card once the warm-up has ended, less
  ``bytes_before`` (read before the build touched the card).  It serves
  ``WARMUP_REQUESTS`` requests before the warm-up's timed floor, so the
  index the window starts on does not depend on the host's speed.
"""
from __future__ import annotations

import dataclasses

DEFAULT = "fmbi"


@dataclasses.dataclass(kw_only=True)
class Built:
    index: object        # what the server serves: FMBI's Index, the AMBI engine
    server: object       # the DeviceQueryServer on the device
    store: object        # the PageStore whose I/O the build and the serving charge
    setup: dict          # seconds of the build's steps
    buffer_pages: int
    device_bytes: int | None = None
    bytes_before: int | None = None
