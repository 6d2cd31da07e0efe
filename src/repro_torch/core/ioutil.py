"""Crash-safe file output: the tmp + fsync + atomic-replace idiom.

``NodeTable.save`` uses this pattern because a snapshot is often
the only durable copy of the adaptive state; the bench writers
(``BENCH_CORE.json``, ``BENCH_SERVE.json``) need the same guarantee — a
kill mid-write must never leave a torn baseline that silently corrupts
the CI regression gate.  This module is the one shared implementation.

``atomic_output`` yields a binary file handle open on ``<path>.tmp`` in
the destination directory (same filesystem, so the final ``os.replace``
is atomic); on clean exit the data is flushed, fsynced, and swapped into
place.  On an exception the temp file is removed and nothing at ``path``
changes.  A stale ``.tmp`` left by a kill between open and replace is
harmless — the next save overwrites it.
"""
from __future__ import annotations

import contextlib
import json
import os


@contextlib.contextmanager
def atomic_output(path):
    """Binary file handle whose contents land at ``path`` atomically."""
    path = os.fspath(path)
    tmp = path + ".tmp"
    f = open(tmp, "wb")
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
    except BaseException:
        f.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    f.close()
    os.replace(tmp, path)


def atomic_write_json(path, obj, *, indent: int = 2,
                      sort_keys: bool = True) -> None:
    """Serialize ``obj`` as JSON and atomically replace ``path`` with it."""
    data = (json.dumps(obj, indent=indent, sort_keys=sort_keys) + "\n").encode()
    with atomic_output(path) as f:
        f.write(data)
