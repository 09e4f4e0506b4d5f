"""hpx_tpu_torch.cache.transfer against hpx_tpu.cache.transfer.

The KV segment protocol: framing, checksums, idempotent redelivery and
abort, as tests/test_disagg_serving.py:221-255 holds the reference's.
A float32 segment's checksum equals the reference's make_segment of the
same bytes; bfloat16 and fp8 payloads (numpy has neither) round-trip by
bytes through the framing and the receiver.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hpx_tpu.cache import transfer as ref
from hpx_tpu_torch.cache.transfer import (KVSegment, TransferCorruptError,
                                          TransferReceiver, make_segment)
from hpx_tpu_torch.core.errors import NetworkError
from hpx_tpu_torch.models.quant import FP8_DTYPE


def _rows(shape=(2, 2, 8, 2, 4)):
    return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("start,total", [(0, 12), (8, 12), (4, 4)])
def test_f32_checksum_equals_the_reference(start, total):
    rows = _rows()
    mine = make_segment("r1", 3, start, total, torch.from_numpy(rows))
    theirs = ref.make_segment("r1", 3, start, total, rows)
    assert mine.checksum == theirs.checksum
    assert (mine.rid, mine.seq, mine.start, mine.ntok, mine.total) == \
        (theirs.rid, theirs.seq, theirs.start, theirs.ntok, theirs.total)
    # a numpy payload frames the same bytes to the same checksum
    assert make_segment("r1", 3, start, total, rows).checksum == \
        theirs.checksum
    assert mine.verify() and mine.nbytes == rows.nbytes


def test_checksum_and_idempotent_redelivery():
    """tests/test_disagg_serving.py:221, on both packages' receivers."""
    rows = _rows()
    for mod, arr in ((ref, rows), (None, torch.from_numpy(rows))):
        mk = mod.make_segment if mod else make_segment
        recv = mod.TransferReceiver() if mod else TransferReceiver()
        corrupt = mod.TransferCorruptError if mod else TransferCorruptError
        a = mk("r1", 0, 0, 12, arr)
        b = mk("r1", 1, 8, 12, arr[:, :, :4])
        assert recv.ingest(a)["dup"] is False
        # duplicate delivery (lost ack): acked again, not applied again
        assert recv.ingest(a)["dup"] is True
        assert recv.stats()["dups"] == 1
        assert not recv.complete("r1")
        assert recv.covered("r1") == 8
        assert recv.ingest(b)["dup"] is False
        assert recv.complete("r1")
        got = np.asarray(recv.assemble("r1"))
        assert got.shape == (2, 2, 12, 2, 4)
        np.testing.assert_array_equal(got[:, :, :8], rows)
        np.testing.assert_array_equal(got[:, :, 8:], rows[:, :, :4])
        # a tampered payload fails verification loudly
        bad = dataclasses.replace(a, payload=arr + 1.0)
        with pytest.raises(corrupt):
            recv.ingest(bad)
        assert recv.stats() == {"pending": 0, "dups": 1, "corrupt": 1}
    assert issubclass(TransferCorruptError, NetworkError)


def test_receiver_abort_drops_segments():
    """tests/test_disagg_serving.py:247."""
    rows = torch.zeros((1, 2, 4, 2, 4))
    recv = TransferReceiver()
    recv.ingest(make_segment("r9", 0, 0, 8, rows))
    recv.abort("r9")
    assert recv.pending() == []
    # a late duplicate of an aborted rid: acked and dropped
    assert recv.ingest(make_segment("r9", 0, 0, 8, rows))["dup"] is True
    assert recv.pending() == []


def test_incomplete_assemble_raises_typed():
    recv = TransferReceiver()
    recv.ingest(make_segment("r2", 1, 4, 8, torch.ones((1, 2, 4, 1, 2))))
    with pytest.raises(NetworkError, match="incomplete"):
        recv.assemble("r2")
    assert not recv.complete("r2")


@pytest.mark.parametrize("dtype", [torch.bfloat16, FP8_DTYPE, torch.int8])
def test_payloads_numpy_lacks_round_trip_by_bytes(dtype):
    """bf16 and fp8 carry as CPU tensors and hash through a uint8 view;
    the header names the dtype, so the same bytes under another dtype
    are another segment."""
    g = torch.Generator().manual_seed(3)
    src = torch.randn((2, 2, 12, 2, 4), generator=g) * 3
    rows = src.to(dtype) if dtype != torch.int8 else \
        (src * 10).to(torch.int8)
    recv = TransferReceiver()
    segs = [make_segment("q", i, 4 * i, 12, rows[:, :, 4 * i:4 * i + 4])
            for i in range(3)]
    for s in reversed(segs):               # any arrival order
        assert recv.ingest(s)["dup"] is False
    got = recv.assemble("q")
    assert got.dtype == dtype and _bits(got) == _bits(rows)
    other = torch.zeros_like(rows[:, :, :4]).view(torch.uint8) \
        if dtype != torch.bfloat16 else None
    if other is not None:
        assert make_segment("q", 0, 0, 12, other).checksum != \
            make_segment("q", 0, 0, 12, other.view(dtype)).checksum
    # one flipped byte is refused
    raw = segs[1].payload.clone()
    raw.view(torch.uint8).reshape(-1)[5] ^= 1
    with pytest.raises(TransferCorruptError):
        TransferReceiver().ingest(dataclasses.replace(segs[1], payload=raw))


def test_pinned_assemble_on_request():
    recv = TransferReceiver()
    recv.ingest(make_segment("p", 0, 0, 4, torch.ones((1, 2, 4, 1, 2))))
    if torch.cuda.is_available():
        assert recv.assemble("p", pin=True).is_pinned()
    else:
        assert recv.assemble("p").shape == (1, 2, 4, 1, 2)
    assert isinstance(make_segment("k", 0, 0, 1, torch.ones((1, 2, 1, 1, 1))),
                      KVSegment)
