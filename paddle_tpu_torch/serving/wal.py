"""Request write-ahead log, the durability layer under ``Router(wal_dir=...)``.

Counterpart of ``paddle_tpu/serving/wal.py``, and byte-compatible with
it: a log written by either package replays in the other. It is host
code only (no tensor is written); it journals

* each request's **admission record** (prompt ids, seed, priority,
  deadline and the wall-clock admission time, adapter_id, grammar spec
  key, prefix_cache flag),
* every **committed token batch** (the ``resume_tokens`` journal delta,
  the stream seq cursor and the grammar's ``resume_fsm_state``), and
* terminal **retirement** (finish reason).

On restart ``Router.recover()`` replays the log (a pure function:
replaying twice gives the same state), re-admits unfinished work
through the journaled re-prefill path (``engine.adopt_request``) onto
whatever engines the restarted fleet has, and resumes emission at the
journaled seq: tokens are a pure function of (prompt, seed,
temperature), so the resumed streams equal the uninterrupted ones.

Disk format: segments ``wal-<n>.log`` of ``<u32 len><u32 crc32(payload)>
<payload>`` frames, payload JSON. Appends are group-committed: the
router buffers records across one ``router.step()`` and pays one
``fsync`` a step. On open, a torn tail (a partial frame or a CRC
mismatch) is truncated away and counted in
``paddle_tpu_wal_corrupt_records_total``; everything before it is
trusted. Segments rotate at ``segment_bytes``; rotation compacts once
enough retired requests have accumulated: live requests are rewritten as
one admit and one progress record into a fresh segment (tmp file, fsync,
rename), retired history is dropped.

Fault points: ``wal.append`` / ``wal.fsync`` / ``wal.replay``.
"""
from __future__ import annotations

import json
import os
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from .. import faults, metrics

__all__ = ["RequestWAL", "WalRequest", "WalState", "RECORD_KINDS"]

_HDR = struct.Struct("<II")          # (payload length, crc32(payload))
_MAX_RECORD = 1 << 26                # sanity bound on one frame's length
_SEG_PREFIX, _SEG_SUFFIX = "wal-", ".log"

#: every record kind the log can carry — ``admit`` opens a request,
#: ``progress`` extends its committed token journal, ``retire`` closes
#: it, ``recover`` marks an old incarnation superseded by a re-admitted
#: one, ``seal`` marks a clean shutdown (graceful drain, nothing torn).
RECORD_KINDS = ("admit", "progress", "retire", "recover", "seal")

faults.declare_point(
    "wal.append", "framing one record into the WAL's group-commit "
    "buffer — a raise simulates an allocation/serialization failure "
    "before any byte is durable; the router must surface it to the "
    "submitter, never half-journal a request")
faults.declare_point(
    "wal.fsync", "the ONE durability barrier of a group commit, after "
    "the buffered frames are written and before fsync — a raise "
    "simulates a full disk / dying device; committed state stays "
    "whatever the LAST successful fsync covered")
faults.declare_point(
    "wal.replay", "top of RequestWAL.replay(), before any segment is "
    "read — a raise simulates an unreadable log directory; recovery "
    "must fail loudly (no silent empty-state restart)")


@dataclass
class WalRequest:
    """One request's durable state, folded from its log records."""

    wal_id: int
    model: Optional[str] = None
    prompt: List[int] = field(default_factory=list)
    max_new_tokens: int = 0
    temperature: float = 0.0
    eos_token_id: Optional[int] = None
    seed: int = 0
    priority: int = 0
    deadline_s: Optional[float] = None
    admit_walltime: float = 0.0          # time.time() at admission
    adapter_id: Optional[str] = None
    grammar_key: Optional[Tuple[str, int, Optional[int]]] = None
    prefix_cache: bool = True
    resume_from: Optional[int] = None    # wal_id this one re-admitted
    tokens: List[int] = field(default_factory=list)  # committed journal
    fsm_state: Optional[int] = None      # valid for exactly `tokens`
    outcome: Optional[str] = None        # finish_reason once retired
    superseded_by: Optional[int] = None  # recover record's new wal_id

    @property
    def live(self) -> bool:
        """Admitted, not retired, not superseded — recovery's work set."""
        return self.outcome is None and self.superseded_by is None


class WalState:
    """The fold of a record stream — what :meth:`RequestWAL.replay`
    returns. Building it is pure: replaying the same log twice yields
    equal states (the idempotence property tests/test_wal.py pins)."""

    def __init__(self):
        self.requests: Dict[int, WalRequest] = {}
        self.next_wal_id: int = 0
        self.sealed: bool = False        # last record was a clean seal
        self.records: int = 0

    def apply(self, rec: dict) -> None:
        self.records += 1
        kind = rec.get("k")
        self.sealed = kind == "seal"
        if kind == "admit":
            wid = int(rec["id"])
            self.next_wal_id = max(self.next_wal_id, wid + 1)
            self.requests[wid] = WalRequest(
                wal_id=wid, model=rec.get("model"),
                prompt=[int(t) for t in rec.get("prompt", ())],
                max_new_tokens=int(rec.get("max_new_tokens", 0)),
                temperature=float(rec.get("temperature", 0.0)),
                eos_token_id=rec.get("eos"),
                seed=int(rec.get("seed", 0)),
                priority=int(rec.get("priority", 0)),
                deadline_s=rec.get("deadline_s"),
                admit_walltime=float(rec.get("t", 0.0)),
                adapter_id=rec.get("adapter_id"),
                grammar_key=(tuple(rec["grammar"])
                             if rec.get("grammar") else None),
                prefix_cache=bool(rec.get("prefix_cache", True)),
                resume_from=rec.get("resume_from"),
                tokens=[int(t) for t in rec.get("tokens", ())],
                fsm_state=rec.get("fsm"))
        elif kind == "progress":
            r = self.requests.get(rec.get("id"))
            if r is None or r.outcome is not None:
                return                       # orphan delta: tolerate
            at = int(rec.get("at", len(r.tokens)))
            toks = [int(t) for t in rec.get("tokens", ())]
            if at <= len(r.tokens):
                # overlap (a replayed delta) extends only the new tail;
                # a gap (at > len — a mid-log corruption hole) is
                # dropped: deterministic decode regenerates the journal
                # identically from the shorter prefix
                r.tokens.extend(toks[len(r.tokens) - at:])
                if at + len(toks) == len(r.tokens):
                    r.fsm_state = rec.get("fsm")
        elif kind == "retire":
            r = self.requests.get(rec.get("id"))
            if r is not None and r.outcome is None:
                r.outcome = str(rec.get("reason", "error"))
        elif kind == "recover":
            r = self.requests.get(rec.get("old"))
            if r is not None and r.superseded_by is None:
                r.superseded_by = int(rec["new"])

    def pending(self) -> List[WalRequest]:
        """Admitted-but-unfinished requests in admission order — the
        exact set a restarted router must re-admit."""
        return sorted((r for r in self.requests.values() if r.live),
                      key=lambda r: r.wal_id)


def _fsync_dir(path: str) -> None:
    """Directory-entry durability for rotate/compact renames (the same
    best-effort idiom as the segment write)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class RequestWAL:
    """Append-only request log with group commit (see module docstring).

    ::

        wal = RequestWAL(wal_dir)
        wal.append("admit", id=wal.new_id(), prompt=[...], seed=7, ...)
        ...                     # buffered — nothing durable yet
        wal.commit()            # ONE write + ONE fsync for the batch
        state = wal.replay()    # pure fold of the on-disk records

    The writer side (append/commit/seal) belongs to the router's step
    loop; the reader side (replay) is what ``Router.recover()`` calls
    after a crash. Both may be used on the same live instance — replay
    reads only committed bytes.
    """

    def __init__(self, wal_dir: str, segment_bytes: int = 1 << 20,
                 compact_retired: int = 256):
        self.dir = str(wal_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        self.compact_retired = int(compact_retired)
        self._buf: List[bytes] = []     # framed records awaiting commit
        self._fh = None
        self._active_size = 0
        self._retired_since_compact = 0
        reg = metrics.get_registry()
        self._m_append = reg.histogram(
            "paddle_tpu_wal_append_seconds",
            "Framing one record (CRC + JSON) into the group-commit "
            "buffer — the per-record cost the submit/step hot path pays")
        self._m_fsync = reg.histogram(
            "paddle_tpu_wal_fsync_seconds",
            "One group commit's durability barrier: buffered frames "
            "written + ONE fsync (per router.step(), not per token)")
        self._m_replay = reg.histogram(
            "paddle_tpu_wal_replay_seconds",
            "Full log replay: every segment read, CRC-checked and "
            "folded into a WalState (the recovery critical path)")
        self._m_records = reg.counter(
            "paddle_tpu_wal_records_total",
            "WAL records appended, by kind (admit / progress / retire / "
            "recover / seal)", labels=("kind",))
        for k in RECORD_KINDS:
            self._m_records.labels(kind=k)   # pre-create: scrapes show 0
        self._m_corrupt = reg.counter(
            "paddle_tpu_wal_corrupt_records_total",
            "Torn or corrupt WAL frames discarded at open (partial "
            "header, short payload, CRC mismatch) — the tail a crash "
            "left mid-write, truncated away before replay")
        self._open()

    # ------------------------------------------------------------- segments
    def _segments(self) -> List[str]:
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith(_SEG_PREFIX)
                           and n.endswith(_SEG_SUFFIX))
        except OSError:
            names = []
        return [os.path.join(self.dir, n) for n in names]

    @staticmethod
    def _seg_index(path: str) -> int:
        name = os.path.basename(path)
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])

    def _seg_path(self, idx: int) -> str:
        return os.path.join(self.dir, f"{_SEG_PREFIX}{idx:08d}{_SEG_SUFFIX}")

    def _open(self) -> None:
        """Scan every segment, truncate any torn tail (counting the
        discarded frames), seed the id allocator from a first replay,
        and open the newest segment for append."""
        segs = self._segments()
        for path in segs:
            good, total, corrupt = self._scan(path)
            if good < total:
                self._m_corrupt.inc(max(corrupt, 1))
                with open(path, "r+b") as f:
                    f.truncate(good)
                    f.flush()
                    os.fsync(f.fileno())
                _fsync_dir(self.dir)
        if not segs:
            segs = [self._seg_path(0)]
            with open(segs[0], "ab"):
                pass
            _fsync_dir(self.dir)
        state = self.replay()
        self._next_wal_id = state.next_wal_id
        self._retired_since_compact = sum(
            1 for r in state.requests.values() if not r.live)
        active = segs[-1]
        self._fh = open(active, "ab")
        self._active_size = os.path.getsize(active)

    def _scan(self, path: str) -> Tuple[int, int, int]:
        """(good_bytes, total_bytes, corrupt_frames) for one segment —
        the torn-tail detector. Never raises on bad bytes."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return 0, 0, 0
        good, corrupt = 0, 0
        for _rec, end in self._iter_frames(data):
            if _rec is None:
                corrupt += 1
                break
            good = end
        if good < len(data) and corrupt == 0:
            corrupt = 1                  # trailing partial header
        return good, len(data), corrupt

    @staticmethod
    def _iter_frames(data: bytes) -> Iterator[Tuple[Optional[dict], int]]:
        """Yield (record, end_offset) per frame; (None, off) once on the
        first torn/corrupt frame, then stop — nothing after an
        undecodable frame can be trusted."""
        off, n = 0, len(data)
        while off + _HDR.size <= n:
            ln, crc = _HDR.unpack_from(data, off)
            end = off + _HDR.size + ln
            if ln > _MAX_RECORD or end > n:
                yield None, off
                return
            payload = data[off + _HDR.size:end]
            if zlib.crc32(payload) != crc:
                yield None, off
                return
            try:
                rec = json.loads(payload.decode())
            except (ValueError, UnicodeDecodeError):
                yield None, off
                return
            yield rec, end
            off = end

    # ------------------------------------------------------------ writer
    def new_id(self) -> int:
        """Allocate a durable request id. ``Request.req_id`` restarts
        with the process (a plain itertools counter), so the WAL owns
        the identity that survives death."""
        wid, self._next_wal_id = self._next_wal_id, self._next_wal_id + 1
        return wid

    def append(self, kind: str, **payload) -> None:
        """Frame one record into the group-commit buffer. NOTHING is
        durable until :meth:`commit` — the buffer is the group-commit
        window (one router step)."""
        t0 = time.perf_counter()
        faults.point("wal.append")
        payload["k"] = kind
        data = json.dumps(payload, separators=(",", ":")).encode()
        self._buf.append(_HDR.pack(len(data), zlib.crc32(data)) + data)
        if kind in ("retire", "recover"):
            self._retired_since_compact += 1
        self._m_records.labels(kind=kind).inc()
        self._m_append.observe(time.perf_counter() - t0)

    def commit(self) -> int:
        """Write every buffered frame and fsync ONCE; returns the number
        of records made durable. Empty buffer = no write, no fsync —
        idle steps stay free. Rotates (and maybe compacts) afterwards
        so the barrier itself never waits on a rewrite."""
        if not self._buf:
            return 0
        frames, self._buf = self._buf, []
        blob = b"".join(frames)
        t0 = time.perf_counter()
        self._fh.write(blob)
        self._fh.flush()
        faults.point("wal.fsync")
        os.fsync(self._fh.fileno())
        self._m_fsync.observe(time.perf_counter() - t0)
        self._active_size += len(blob)
        if self._active_size >= self.segment_bytes:
            self._rotate()
        return len(frames)

    def seal(self) -> None:
        """Clean-shutdown marker: append + commit a ``seal`` record.
        ``replay().sealed`` then tells the next process the previous one
        drained and exited on purpose — nothing pending, nothing torn."""
        self.append("seal")
        self.commit()

    def close(self) -> None:
        """Commit anything buffered and drop the file handle. NOT a
        seal: a closed-but-unsealed log reads as a crash, which is
        exactly right for teardown paths that didn't drain."""
        if self._fh is not None:
            self.commit()
            self._fh.close()
            self._fh = None

    def _rotate(self) -> None:
        """Start a fresh segment (append never straddles — a commit's
        frames land in one file); compact first if enough retired
        history has piled up."""
        if self._retired_since_compact >= self.compact_retired:
            self.compact()
            return
        self._fh.close()
        idx = self._seg_index(self._segments()[-1]) + 1
        path = self._seg_path(idx)
        self._fh = open(path, "ab")
        self._active_size = 0
        _fsync_dir(self.dir)

    def compact(self) -> None:
        """Drop retired history: fold the whole log, rewrite only LIVE
        requests (one admit carrying the accumulated journal each) into
        a fresh segment via tmp + fsync + rename, then delete the old
        segments. Crash-safe at every point: until the rename lands the
        old segments are the log; after it they are garbage a later
        open ignores (the new segment sorts last and replay folds
        admits idempotently)."""
        state = self.replay()
        idx = self._seg_index(self._segments()[-1]) + 1
        path = self._seg_path(idx)
        tmp = f"{path}.tmp-{os.getpid()}"
        frames = []
        for r in state.pending():
            rec = {"k": "admit", "id": r.wal_id, "model": r.model,
                   "prompt": r.prompt,
                   "max_new_tokens": r.max_new_tokens,
                   "temperature": r.temperature, "eos": r.eos_token_id,
                   "seed": r.seed, "priority": r.priority,
                   "deadline_s": r.deadline_s, "t": r.admit_walltime,
                   "adapter_id": r.adapter_id,
                   "grammar": (list(r.grammar_key)
                               if r.grammar_key else None),
                   "prefix_cache": r.prefix_cache,
                   "resume_from": r.resume_from,
                   "tokens": r.tokens, "fsm": r.fsm_state}
            data = json.dumps(rec, separators=(",", ":")).encode()
            frames.append(_HDR.pack(len(data), zlib.crc32(data)) + data)
        old = self._segments()
        if self._fh is not None:
            self._fh.close()
        try:
            with open(tmp, "wb") as f:
                f.write(b"".join(frames))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            except OSError:
                pass
            raise
        _fsync_dir(self.dir)
        for p in old:
            try:
                os.unlink(p)
            except OSError:
                pass
        _fsync_dir(self.dir)
        self._fh = open(path, "ab")
        self._active_size = os.path.getsize(path)
        self._retired_since_compact = 0

    # ------------------------------------------------------------ reader
    def replay(self) -> WalState:
        """Fold every committed record into a :class:`WalState`. Pure:
        no writer state is touched, and replaying twice yields equal
        states. Torn tails were already truncated at :meth:`_open`; a
        frame that went bad since (bit rot) stops that segment's fold
        at the last good frame — never raises on bad bytes."""
        t0 = time.perf_counter()
        faults.point("wal.replay")
        state = WalState()
        for path in self._segments():
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            for rec, _end in self._iter_frames(data):
                if rec is None:
                    break
                state.apply(rec)
        self._m_replay.observe(time.perf_counter() - t0)
        return state
