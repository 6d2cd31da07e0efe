"""Append-only graft journal: crash recovery for adaptive serving.

The adaptive server's device table is a pure function of the boot-time
AMBI state and the *sequence of cold queries* it refined (grafting in
``NodeTable`` is deterministic: ``_adaptive_build`` consumes the index's
own seeded rng and the ``PageStore`` id counter, both of which are part
of the snapshot).  So the journal is **logical**: each record is one
cold host-path operation (``window`` or ``knn``) with a monotonically
increasing ``seq``.  Replaying the journal against the snapshot's AMBI
state re-executes exactly those refinements and lands on the
bit-identical table — there is no physical page image to log.

Record framing (binary, little-endian)::

    [u32 payload_len][u32 crc32(payload)][payload: JSON utf-8]

Appends are flushed and ``fsync``'d before the caller's operation is
acknowledged.  On read:

  * a **torn tail** (fewer bytes than a full header+payload at EOF —
    the crash interrupted the final append) is tolerated and dropped:
    the op was never acknowledged, so dropping it is correct;
  * a **complete record with a bad checksum** means real corruption and
    raises :class:`JournalError` instead of replaying garbage;
  * a **seq at or below the snapshot barrier** is skipped — this closes
    the crash window between "snapshot written" and "journal truncated"
    during compaction (records already folded into the snapshot must not
    be replayed twice).

Compaction writes a fresh snapshot (recording ``last_seq``) and then
truncates the journal via a create-new + ``os.replace`` so there is no
moment where neither a valid snapshot nor a valid journal exists.

JSON carries float64 coordinates via ``repr``-style shortest-roundtrip
encoding, which is exact for binary64 — replayed queries are
bit-identical to the originals.

This module is the PyTorch port's own copy of the JAX package's
``repro/serve/journal.py``, unchanged: the record format is the same, so
each package reads the other's journal.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Iterator

_HEADER = struct.Struct("<II")  # payload_len, crc32


class JournalError(RuntimeError):
    """The journal is corrupt (complete record, bad checksum / framing)."""


class GraftJournal:
    """Append-only fsync'd record log of cold-path serving ops.

    Opening an existing journal scans it (validating checksums) and
    continues the ``seq`` counter after the last intact record, so a
    recovered server keeps journaling where the dead one stopped.
    """

    def __init__(self, path, *, fault_plan=None):
        self.path = os.fspath(path)
        self.fault_plan = fault_plan
        last = 0
        if os.path.exists(self.path):
            for rec in self.read_records(self.path):
                last = rec["seq"]
        self.seq = last
        self._f = open(self.path, "ab")

    # -- writing ------------------------------------------------------------
    def append(self, op: str, **args) -> int:
        """Durably log one op; returns its seq.  The fault point fires
        *before* any bytes are written, so an injected append fault never
        leaves a torn record behind."""
        if self.fault_plan is not None:
            self.fault_plan.fire("journal_append", op=op)
        self.seq += 1
        payload = json.dumps(
            {"seq": self.seq, "op": op, **args}, sort_keys=True
        ).encode("utf-8")
        self._f.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        self._f.flush()
        os.fsync(self._f.fileno())
        return self.seq

    def truncate(self) -> None:
        """Empty the journal (compaction barrier): atomic swap-in of a
        fresh empty file, never an in-place truncation of live records."""
        self._f.close()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")

    def close(self) -> None:
        self._f.close()

    # -- reading ------------------------------------------------------------
    @staticmethod
    def read_records(path, *, after_seq: int = 0) -> Iterator[dict]:
        """Yield intact records with ``seq > after_seq``.

        Tolerates a torn final record (unacknowledged op); raises
        :class:`JournalError` on a checksum mismatch in a complete one.
        """
        path = os.fspath(path)
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            buf = f.read()
        off, end = 0, len(buf)
        while off < end:
            if end - off < _HEADER.size:
                break  # torn header at tail
            length, crc = _HEADER.unpack_from(buf, off)
            start = off + _HEADER.size
            if end - start < length:
                break  # torn payload at tail
            payload = buf[start:start + length]
            if zlib.crc32(payload) != crc:
                raise JournalError(
                    f"journal {path!r}: checksum mismatch at byte {off} "
                    f"(record is complete — this is corruption, not a torn "
                    f"tail); refusing to replay"
                )
            try:
                rec = json.loads(payload.decode("utf-8"))
            except ValueError as e:
                raise JournalError(
                    f"journal {path!r}: undecodable record at byte {off}"
                ) from e
            off = start + length
            if rec.get("seq", 0) > after_seq:
                yield rec

    @staticmethod
    def last_seq(path) -> int:
        """Seq of the last intact record (0 for empty/missing journal)."""
        last = 0
        for rec in GraftJournal.read_records(path):
            last = rec["seq"]
        return last
