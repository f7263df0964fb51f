"""Durable write-ahead journal for the crash-safe serving runtime.

An append-only, CRC-framed record log.  The serving engine journals every
admission, every step boundary, and every terminal status *before* the
effect is observable, so a process crash loses nothing that was
acknowledged: recovery (:mod:`repro_torch.serve.recovery`) loads the newest
committed snapshot and re-executes the journal tail deterministically.

Frame format (little-endian)::

    [u32 magic][u32 payload length][u32 crc32(payload)][payload bytes]

The payload is UTF-8 JSON (``allow_nan`` on, so ``Infinity`` deadlines
round-trip).  A crash mid-append leaves a **torn tail** — a frame whose
length/magic/CRC does not check out.  Replay tolerates exactly that: it
stops at the first bad frame *iff* the bad frame reaches the physical end
of the segment (the write was cut short); a bad frame followed by more
intact data means real corruption and raises :class:`JournalCorrupt`.

Segments: records append to ``seg_<n>.wal``.  :meth:`Journal.rotate`
closes the active segment and opens ``seg_<n+1>.wal`` — the snapshot
protocol rotates first, publishes the snapshot (recording the new segment
index as its replay start), then drops the fully-covered older segments;
a crash anywhere in that sequence leaves a recoverable (snapshot, tail)
pair on disk.

Durability policy: ``sync="flush"`` (default) flushes the OS buffer per
append — exactly what the in-process kill/recover tests exercise;
``sync="fsync"`` additionally fsyncs per append for real power-loss
durability (measurably slower).
"""
from __future__ import annotations

import json
import os
import struct
import zlib

MAGIC = 0x57414C31                     # "WAL1"
_HEADER = struct.Struct("<III")        # magic, length, crc32


class JournalCorrupt(Exception):
    """A frame failed its CRC/magic check *before* the physical tail —
    not a torn write but real corruption (or a foreign file)."""


class JournalError(Exception):
    """Misuse of the journal API (closed journal, bad segment state)."""


def _frame(payload: bytes) -> bytes:
    return _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload


def _encode(record: dict) -> bytes:
    return json.dumps(record, sort_keys=True).encode("utf-8")


def _segment_name(index: int) -> str:
    return f"seg_{index:06d}.wal"


def _segment_index(name: str) -> int:
    return int(name[len("seg_"):-len(".wal")])


def read_segment(path: str, strict: bool = True) -> tuple[list[dict], int]:
    """Decode one segment file.

    Returns ``(records, torn_bytes)`` — ``torn_bytes`` counts trailing
    bytes abandoned as a torn write (0 for a clean segment).  ``strict``
    raises :class:`JournalCorrupt` when a bad frame is followed by further
    data (mid-file corruption is never silently skipped).
    """
    with open(path, "rb") as f:
        buf = f.read()
    records: list[dict] = []
    off = 0
    n = len(buf)
    while off < n:
        torn = n - off
        if off + _HEADER.size > n:
            break                                  # header cut short
        magic, length, crc = _HEADER.unpack_from(buf, off)
        if magic != MAGIC:
            if strict:
                raise JournalCorrupt(
                    f"{path}: bad frame magic {magic:#x} at offset {off}")
            break
        end = off + _HEADER.size + length
        if end > n:
            break                                  # payload cut short
        payload = buf[off + _HEADER.size:end]
        if zlib.crc32(payload) != crc:
            if strict and end < n:
                raise JournalCorrupt(
                    f"{path}: CRC mismatch at offset {off} with "
                    f"{n - end} intact byte(s) beyond it")
            break                                  # torn final frame
        records.append(json.loads(payload.decode("utf-8")))
        off = end
        torn = 0
    return records, torn


def list_segments(directory: str) -> list[int]:
    """Segment indices present in ``directory`` (sorted ascending)."""
    out = []
    for name in os.listdir(directory):
        if name.startswith("seg_") and name.endswith(".wal"):
            out.append(_segment_index(name))
    return sorted(out)


def replay_directory(directory: str, from_segment: int = 0,
                     strict: bool = True) -> tuple[list[dict], int]:
    """Read-only replay of a journal directory (no write handle is opened
    — the recovery path uses this so replay never mints empty segments).

    Returns ``(records, torn_bytes)``.  A torn tail is tolerated ONLY on
    the final segment — an earlier torn segment followed by later segments
    means the log lost committed records and raises
    :class:`JournalCorrupt` under ``strict``.
    """
    segs = [i for i in list_segments(directory) if i >= from_segment]
    records: list[dict] = []
    torn = 0
    for pos, i in enumerate(segs):
        path = os.path.join(directory, _segment_name(i))
        recs, t = read_segment(path, strict=strict)
        if t and strict and pos != len(segs) - 1:
            raise JournalCorrupt(
                f"segment {i} has a torn tail but is not the final "
                "segment — later records would be lost")
        records.extend(recs)
        torn = t
    return records, torn


class Journal:
    """Append-only segmented record log rooted at ``directory``.

    Opening an existing directory resumes appending to a NEW segment after
    the highest existing one (never to a possibly-torn tail segment), so a
    recovered process can keep journaling into the same directory while
    the pre-crash segments stay replayable.
    """

    def __init__(self, directory: str, sync: str = "flush"):
        if sync not in ("flush", "fsync", "none"):
            raise ValueError(f"unknown sync policy {sync!r}")
        self.dir = directory
        self.sync = sync
        os.makedirs(directory, exist_ok=True)
        existing = self.segments()
        self._seg_index = (existing[-1] + 1) if existing else 0
        self._fh = open(self._seg_path(self._seg_index), "ab")
        self.appended = 0                   # records written by this handle
        self.bytes_written = 0

    # -- write path -----------------------------------------------------------

    def _seg_path(self, index: int) -> str:
        return os.path.join(self.dir, _segment_name(index))

    @property
    def segment(self) -> int:
        """Index of the currently-active segment."""
        return self._seg_index

    def append(self, record: dict) -> None:
        if self._fh is None:
            raise JournalError("journal is closed")
        frame = _frame(_encode(record))
        self._fh.write(frame)
        if self.sync != "none":
            self._fh.flush()
        if self.sync == "fsync":
            os.fsync(self._fh.fileno())
        self.appended += 1
        self.bytes_written += len(frame)

    def rotate(self) -> int:
        """Close the active segment and open the next; returns the NEW
        segment index (the snapshot protocol records it as the replay
        start, so everything journaled after the rotation lands in the
        tail the snapshot does not cover)."""
        if self._fh is None:
            raise JournalError("journal is closed")
        self._fh.flush()
        if self.sync == "fsync":
            os.fsync(self._fh.fileno())
        self._fh.close()
        self._seg_index += 1
        self._fh = open(self._seg_path(self._seg_index), "ab")
        return self._seg_index

    def drop_segments_before(self, index: int) -> int:
        """Delete segments fully covered by a committed snapshot; returns
        how many were removed.  Never touches the active segment."""
        dropped = 0
        for i in self.segments():
            if i < index and i != self._seg_index:
                os.unlink(self._seg_path(i))
                dropped += 1
        return dropped

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            if self.sync == "fsync":
                os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None

    # -- read path ------------------------------------------------------------

    def segments(self) -> list[int]:
        return list_segments(self.dir)

    def replay(self, from_segment: int = 0,
               strict: bool = True) -> tuple[list[dict], int]:
        """All records from ``from_segment`` onward, in append order (see
        :func:`replay_directory`)."""
        if self._fh is not None:
            self._fh.flush()
        return replay_directory(self.dir, from_segment=from_segment,
                                strict=strict)

    # -- context management ----------------------------------------------------

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
