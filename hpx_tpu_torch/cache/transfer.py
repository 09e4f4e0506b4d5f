"""Block-granular KV transfer between workers: framed, checksummed,
idempotent.

Counterpart of ``hpx_tpu.cache.transfer``. The wire unit is the
:class:`KVSegment`: a contiguous run of finished prefill rows for one
request, framed with (rid, seq, start, ntok, total) and a sha256 over
header and payload. For disaggregated prefill the payload is the
prefill worker's raw compute-dtype scratch rows, ``[n_layers, 2, ntok,
n_kv, head_dim]``; the decode worker splices them through its server's
paged splice, which quantizes as a colocated prefill would. The host
tier (``cache/tier.py``) ships raw pool-dtype block rows and their f32
scale sidecars through the same framing.

Payloads are CPU tensors (numpy arrays are taken as they are): numpy has
no bfloat16 or fp8 type, so the checksum hashes a payload's raw bytes
through a ``uint8`` view. For a dtype numpy has, the header names it as
numpy does (``dtype.str``), so a float32 segment's checksum equals the
reference's for the same bytes; other dtypes are named by torch
(``torch.bfloat16``).

Delivery discipline:

* framing: ``start`` / ``ntok`` place each segment in the sequence and
  ``total`` is the full prefill length, so completeness is a local
  check, whatever the arrival order;
* checksums: a corrupt segment raises :class:`TransferCorruptError` (a
  ``NetworkError``, so the sender's bounded resend treats it as
  transient);
* idempotent redelivery: the receiver dedups on (rid, seq); duplicates
  are acked with ``dup=True`` and dropped, never ingested twice.

The receiver holds host rows only: no KV block is allocated until the
decode server admits the sequence, so an aborted transfer cannot leak
pool blocks.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.errors import NetworkError
from ..synchronization import Mutex

__all__ = [
    "KVSegment",
    "TransferCorruptError",
    "TransferReceiver",
    "make_segment",
]


class TransferCorruptError(NetworkError):
    """Segment checksum mismatch: the payload was damaged in flight. A
    ``NetworkError`` so resend loops classify it as transient."""

    def __init__(self, rid: str, seq: int, message: str = ""):
        super().__init__(
            message or f"KV segment {rid}:{seq} failed checksum",
            "TransferReceiver.ingest")
        self.rid = rid
        self.seq = seq


# an integer dtype a payload's elements are viewed as, by byte width
_RAW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _as_cpu(payload: Any) -> torch.Tensor:
    """A payload as a contiguous CPU tensor (numpy arrays shared, not
    copied)."""
    if isinstance(payload, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(payload))
    return payload.detach().to("cpu").contiguous()


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's ``dtype.str`` where numpy has the dtype (the reference's
    header), torch's name otherwise."""
    try:
        return torch.empty(0, dtype=t.dtype).numpy().dtype.str
    except TypeError:
        return str(t.dtype)


def _digest(rid: str, seq: int, start: int, ntok: int, total: int,
            payload: Any) -> str:
    t = _as_cpu(payload)
    h = hashlib.sha256()
    h.update(f"{rid}|{seq}|{start}|{ntok}|{total}|"
             f"{_dtype_name(t)}|{tuple(t.shape)}".encode())
    h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@dataclass(frozen=True)
class KVSegment:
    """One framed, checksummed run of KV rows: payload ``[n_layers, 2,
    ntok, n_kv, head_dim]`` (axis 2 in tokens), a CPU tensor."""

    rid: str          # request id (router-global)
    seq: int          # segment index within the request, 0-based
    start: int        # absolute first token row this segment covers
    ntok: int         # rows in this segment
    total: int        # full prefill length of the request
    payload: Any = field(repr=False)
    checksum: str = ""

    @property
    def key(self) -> str:
        return f"{self.rid}:{self.seq}"

    @property
    def nbytes(self) -> int:
        t = _as_cpu(self.payload)
        return t.numel() * t.element_size()

    def verify(self) -> bool:
        return self.checksum == _digest(self.rid, self.seq, self.start,
                                        self.ntok, self.total,
                                        self.payload)


def make_segment(rid: str, seq: int, start: int, total: int,
                 payload: Any) -> KVSegment:
    """Frame and checksum one run of rows (payload axis 2 is tokens)."""
    payload = _as_cpu(payload)
    ntok = int(payload.shape[2])
    return KVSegment(rid=rid, seq=seq, start=start, ntok=ntok,
                     total=total, payload=payload,
                     checksum=_digest(rid, seq, start, ntok, total,
                                      payload))


class TransferReceiver:
    """Decode-worker side: reassemble segments into contiguous prefill
    rows, exactly once. Thread-safe."""

    def __init__(self) -> None:
        self._lock = Mutex()
        # rid -> {seq: KVSegment}; dropped at assemble/abort
        self._segs: Dict[str, Dict[int, KVSegment]] = {}
        self._aborted: set = set()
        self.dups = 0          # duplicate deliveries acked and dropped
        self.corrupt = 0       # checksum failures rejected

    def ingest(self, seg: KVSegment) -> Dict[str, object]:
        """Accept one segment; returns the ack ``{"rid", "seq", "dup"}``.
        Duplicates are acked with ``dup=True`` and dropped; corrupt
        payloads raise :class:`TransferCorruptError`."""
        if not seg.verify():
            with self._lock:
                self.corrupt += 1
            raise TransferCorruptError(seg.rid, seg.seq)
        with self._lock:
            if seg.rid in self._aborted:
                # late segment of an aborted transfer: ack so that the
                # sender stops resending, keep nothing
                return {"rid": seg.rid, "seq": seg.seq, "dup": True}
            per = self._segs.setdefault(seg.rid, {})
            if seg.seq in per:
                self.dups += 1
                return {"rid": seg.rid, "seq": seg.seq, "dup": True}
            per[seg.seq] = seg
        return {"rid": seg.rid, "seq": seg.seq, "dup": False}

    def covered(self, rid: str) -> int:
        """Distinct token rows held for `rid`."""
        with self._lock:
            per = self._segs.get(rid, {})
            return sum(s.ntok for s in per.values())

    def complete(self, rid: str) -> bool:
        """True when the held segments cover the full prefill length."""
        with self._lock:
            per = self._segs.get(rid)
            if not per:
                return False
            total = next(iter(per.values())).total
            got = sorted((s.start, s.ntok) for s in per.values())
        pos = 0
        for start, ntok in got:
            if start != pos:
                return False
            pos = start + ntok
        return pos == total

    def assemble(self, rid: str, pin: bool = False) -> torch.Tensor:
        """Concatenate a complete transfer into one ``[n_layers, 2,
        total, n_kv, head_dim]`` CPU tensor (in pinned memory with
        ``pin``, for an asynchronous copy to a card) and release the
        segments."""
        if not self.complete(rid):
            with self._lock:
                per = self._segs.get(rid, {})
                held = sorted(s.seq for s in per.values())
            raise NetworkError(
                f"KV transfer {rid} incomplete: segments {held}",
                "TransferReceiver.assemble")
        with self._lock:
            per = self._segs.pop(rid)
        parts = [_as_cpu(s.payload)
                 for s in sorted(per.values(), key=lambda s: s.start)]
        shape = list(parts[0].shape)
        shape[2] = sum(p.shape[2] for p in parts)
        out = torch.empty(shape, dtype=parts[0].dtype, pin_memory=pin)
        # concatenated as raw integers of the element's width: torch's
        # cat does not take every dtype a payload may have (fp8)
        raw = _RAW[out.element_size()]
        torch.cat([p.view(raw) for p in parts], dim=2, out=out.view(raw))
        return out

    def abort(self, rid: str) -> None:
        """Drop everything held for `rid`; later segments of it are acked
        (``dup=True``) but not kept."""
        with self._lock:
            self._segs.pop(rid, None)
            self._aborted.add(rid)

    def pending(self) -> List[str]:
        with self._lock:
            return sorted(self._segs)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"pending": len(self._segs), "dups": self.dups,
                    "corrupt": self.corrupt}
