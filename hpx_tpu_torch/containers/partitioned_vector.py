"""partitioned_vector: the partitioned container, over the ranks of a mesh
axis.

Reference analog: components/containers/partitioned_vector — a vector
split into partitions placed per a distribution policy, with segmented
iterators and named registration for multi-locality access. Counterpart
of ``hpx_tpu.containers.partitioned_vector``.

A PartitionedVector is a mutable HANDLE. The container is padded (with
its fill value, or zeros from an array) up to a multiple of
max(num_partitions, P), P the ranks along the layout's axis, as the
reference pads to its sharding. Rank r of the axis holds the contiguous
block [r*B, (r+1)*B) of the padded extent, B = padded / P, on its own
device: ``data`` is that block and ``local_range()`` its valid global
[begin, end); ``size`` stays global. On an axis of one rank (every
layout outside a world) the block is the whole tensor, and everything
below is what it was on one device.

"Segments" are logical (index range, ranks) views of the blocks, not
separate objects; algorithms (algo/segmented.py) run on a rank's block
and combine over the axis.

Collective calls: on more than one rank every rank of the axis calls
``to_numpy()``, iteration, ``get(i)``, ``get_async(i)`` and ``[i]``
together, in the same order, and each gets the answer (a gather of the
blocks, or a broadcast from the owner of i). ``set(i, v)`` is called by
every rank too, but only the owner writes: no message. ``from_array``
takes the global array, the same on every rank (as ``device_put``), and
keeps the rank's block. ``view(b, e)`` is a global range; each rank's
part of it is its block's intersection with [b, e) (``array()``).

Sharing: ``from_array`` of a tensor already on the layout's device and
``copy()`` share the tensor, as the reference's handles share an
immutable jax.Array. ``set`` writes in place, so a handle whose tensor
may be shared copies it once before its first write: the other holders
never see the write, as the reference's functional update gives.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.errors import NotImplementedYet
from ..dist.distribution_policies import ContainerLayout, default_layout


def _torch_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _default_dtype(value: Any) -> torch.dtype:
    """The dtype jnp.asarray(value) gives a Python value with 64-bit
    types off: bool, int32, float32, complex64."""
    if value is None:
        return torch.float32
    kind = np.asarray(value).dtype.kind
    return {"b": torch.bool, "i": torch.int32, "u": torch.int32,
            "f": torch.float32, "c": torch.complex64}[kind]


@dataclass(frozen=True)
class Segment:
    """One logical partition: [begin, end) and where it lives.

    The analog of HPX's segment iterator position (partitioned_vector_
    segmented_iterator). With fewer partitions than ranks along the axis
    a segment spans several: `ranks` lists their global ranks and
    `devices` their devices, in axis order; `device` is the first (where
    the segment starts)."""
    index: int
    begin: int
    end: int
    devices: Tuple[Any, ...]
    ranks: Tuple[int, ...] = (0,)

    @property
    def device(self) -> Any:
        return self.devices[0]

    def __len__(self) -> int:
        return self.end - self.begin


class PartitionedVectorView:
    """A contiguous sub-range view (partitioned_vector_view analog).

    [begin, end) is global. Algorithms accept views and operate on the
    underlying slice of the tensor (a view of it, no copy): on more than
    one rank, each rank on its block's part of the range."""

    def __init__(self, pv: "PartitionedVector", begin: int, end: int) -> None:
        begin = max(0, min(begin, pv.size))
        end = max(begin, min(end, pv.size))
        self.pv = pv
        self.begin = begin
        self.end = end

    def local_range(self) -> Tuple[int, int]:
        """This rank's part of [begin, end), global."""
        lo, hi = self.pv.local_range()
        b = min(max(self.begin, lo), hi)
        return b, max(b, min(self.end, hi))

    def array(self) -> torch.Tensor:
        """This rank's part of the range (all of it on one rank)."""
        b, e = self.local_range()
        base = self.pv.local_range()[0]
        return self.pv.valid_array()[b - base:e - base]

    def __len__(self) -> int:
        return self.end - self.begin

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                raise IndexError("views are contiguous (step must be 1)")
            return PartitionedVectorView(
                self.pv, self.begin + start, self.begin + stop)
        return self.pv[self.begin + self._check(i)]

    def _check(self, i: int) -> int:
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return i

    def to_numpy(self) -> np.ndarray:
        """The range's values (collective on more than one rank)."""
        if not self.pv.multi_rank:
            return self.array().cpu().numpy().copy()
        return self.pv.to_numpy()[self.begin:self.end]

    def __repr__(self) -> str:
        return (f"<PartitionedVectorView [{self.begin}, {self.end}) of "
                f"{self.pv!r}>")


class PartitionedVector:
    """hpx::partitioned_vector<T> analog: this rank's block of the padded
    container."""

    def __init__(self, size: int, value: Any = 0, dtype: Any = None,
                 layout: Optional[ContainerLayout] = None) -> None:
        self._layout = layout or default_layout()
        self._size = int(size)
        dtype = _default_dtype(value) if dtype is None else _torch_dtype(dtype)
        padded = self._padded_size(self._size, self._layout)
        self._data = torch.full((padded // self._layout.axis_size,), value,
                                dtype=dtype, device=self._layout.device)
        self._owned = True

    # -- construction --------------------------------------------------------
    @staticmethod
    def _padded_size(n: int, layout: ContainerLayout) -> int:
        p = max(layout.num_partitions, layout.axis_size)
        return ((max(n, 1) + p - 1) // p) * p

    @classmethod
    def from_array(cls, arr: Any,
                   layout: Optional[ContainerLayout] = None
                   ) -> "PartitionedVector":
        """Build from the global 1-D array (the same on every rank): the
        rank keeps its block. A tensor on the layout's device is taken as
        it is (no copy, no synchronization) when no padding is needed;
        anything else is copied there."""
        layout = layout or default_layout()
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.array(arr))
        if arr.ndim != 1:
            raise ValueError("partitioned_vector is 1-D; got shape "
                             f"{tuple(arr.shape)}")
        size = int(arr.shape[0])
        padded = cls._padded_size(size, layout)
        block = padded // layout.axis_size
        r = layout.rank_index
        lo, hi = min(r * block, size), min((r + 1) * block, size)
        mine = (arr if hi - lo == size else arr[lo:hi]).to(layout.device)
        owned = mine.shape[0] != block
        if owned:
            mine = torch.cat([mine, mine.new_zeros(block - mine.shape[0])])
        return cls._from_block(mine, size, layout, owned)

    @classmethod
    def _from_block(cls, block: torch.Tensor, size: int,
                    layout: ContainerLayout, owned: bool = False
                    ) -> "PartitionedVector":
        """A handle on this rank's block as it is (the overlay's rewrap;
        no message)."""
        self = cls.__new__(cls)
        self._layout = layout
        self._size = int(size)
        self._data = block
        self._owned = owned
        return self

    # -- basic surface -------------------------------------------------------
    @property
    def size(self) -> int:
        return self._size

    def __len__(self) -> int:
        return self._size

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def layout(self) -> ContainerLayout:
        return self._layout

    @property
    def mesh(self):
        return self._layout.mesh

    @property
    def num_partitions(self) -> int:
        return self._layout.num_partitions

    @property
    def data(self) -> torch.Tensor:
        """This rank's block of the padded container (all of it on one
        rank)."""
        return self._data

    @property
    def multi_rank(self) -> bool:
        """True when the layout's axis has more than one rank."""
        return self._layout.axis_size > 1

    @property
    def padded_size(self) -> int:
        return self._data.shape[0] * self._layout.axis_size

    def local_range(self) -> Tuple[int, int]:
        """The global [begin, end) of this rank's block's valid elements
        ([0, size) on one rank)."""
        block = self._data.shape[0]
        r = self._layout.rank_index
        return min(r * block, self._size), min((r + 1) * block, self._size)

    def valid_array(self) -> torch.Tensor:
        """This rank's valid elements: the block, or a view of its
        unpadded prefix (the logical contents on one rank)."""
        b, e = self.local_range()
        if self._data.shape[0] == e - b:
            return self._data
        return self._data[:e - b]

    def to_numpy(self) -> np.ndarray:
        """The logical contents (collective on more than one rank: a
        gather of the blocks)."""
        if not self.multi_rank:
            return self.valid_array().cpu().numpy().copy()
        from ..collectives.device import all_gather_bits
        whole = all_gather_bits(self._data, self.mesh, self._layout.axis)
        return whole[:self._size].cpu().numpy().copy()

    # -- element access (get_value/set_value analogs) ------------------------
    def get(self, i: int) -> Any:
        """Synchronous element fetch (hpx::partitioned_vector::get_value;
        collective on more than one rank)."""
        return self._element(self._check(i)).item()

    def get_async(self, i: int):
        """get_value(launch::async) analog: Future of the element (a 0-d
        tensor, whose read may still be in flight on the stream;
        collective on more than one rank: the owner's broadcast is
        issued before it returns)."""
        from ..futures.future import make_ready_future
        return make_ready_future(self._element(self._check(i)).clone())

    def _element(self, i: int) -> torch.Tensor:
        """Element i as a 0-d tensor on this rank's device: read from the
        block, or broadcast by the rank that owns it."""
        block = self._data.shape[0]
        owner, at = divmod(i, block)
        if not self.multi_rank:
            return self._data[i]
        from ..collectives.device import broadcast
        mine = self._data[at:at + 1] if owner == self._layout.rank_index \
            else self._data.new_zeros(1)
        raw = broadcast(mine.view(torch.uint8), self.mesh, self._layout.axis,
                        root=owner)
        return raw.view(self._data.dtype)[0]

    def set(self, i: int, value: Any) -> None:
        """set_value analog: the owner writes the element in place (a fill
        on the device, no synchronization), after copying a shared
        tensor. Every rank calls it; the others do nothing."""
        owner, at = divmod(self._check(i), self._data.shape[0])
        if owner != self._layout.rank_index:
            return
        if not self._owned:
            self._data = self._data.clone()
            self._owned = True
        self._data[at] = value

    def _check(self, i: int) -> int:
        if i < 0:
            i += self._size
        if not 0 <= i < self._size:
            raise IndexError(i)
        return i

    def __getitem__(self, i: Union[int, slice]):
        if isinstance(i, slice):
            start, stop, step = i.indices(self._size)
            if step != 1:
                raise IndexError("views are contiguous (step must be 1)")
            return PartitionedVectorView(self, start, stop)
        return self.get(i)

    def __setitem__(self, i: int, value: Any) -> None:
        self.set(i, value)

    def view(self, begin: int = 0,
             end: Optional[int] = None) -> PartitionedVectorView:
        return PartitionedVectorView(
            self, begin, self._size if end is None else end)

    # -- segments (segmented iterator surface) -------------------------------
    def segments(self) -> Sequence[Segment]:
        """Logical partitions with their ranks and devices, in index
        order: the padded extent cut into num_partitions equal blocks,
        each clipped to the logical size. A segment spans every rank
        whose block its padded range overlaps (no message)."""
        npart = self.num_partitions
        padded = self.padded_size
        chunk = padded // npart
        block = self._data.shape[0]
        mesh, axis = self.mesh, self._layout.axis
        ranks = mesh.group_ranks(axis) if self.multi_rank else [mesh.rank]
        out = []
        for k in range(npart):
            pb, pe = k * chunk, (k + 1) * chunk          # padded coords
            span = tuple(ranks[d] for d in range(pb // block,
                                                 (pe - 1) // block + 1))
            devs = tuple(mesh.device_of(r) if self.multi_rank
                         else self._layout.device for r in span)
            out.append(Segment(k, min(pb, self._size), min(pe, self._size),
                               devs, span))
        return out

    def __iter__(self) -> Iterator[Any]:
        return iter(self.to_numpy())

    # -- named registration (AGAS symbol namespace) --------------------------
    def register_as(self, name: str):
        """HPX_REGISTER_PARTITIONED_VECTOR + register_as analog: not
        ported yet (AGAS)."""
        raise NotImplementedYet(_AGAS, "register_as")

    @classmethod
    def connect_to(cls, name: str, wait: bool = True) -> "PartitionedVector":
        """connect_to analog: not ported yet (AGAS)."""
        raise NotImplementedYet(_AGAS, "connect_to")

    def unregister(self, name: str):
        raise NotImplementedYet(_AGAS, "unregister")

    # -- misc ----------------------------------------------------------------
    def copy(self) -> "PartitionedVector":
        """A second handle on the same contents (the tensor is shared
        until either handle writes; no message)."""
        out = PartitionedVector.__new__(PartitionedVector)
        out._layout = self._layout
        out._size = self._size
        out._data = self._data
        self._owned = out._owned = False
        return out

    def __repr__(self) -> str:
        ranks = (f" over {self._layout.axis_size} ranks, block "
                 f"{self.local_range()}" if self.multi_rank else "")
        return (f"<partitioned_vector size={self._size} dtype={self.dtype} "
                f"partitions={self.num_partitions} axis="
                f"'{self._layout.axis}'{ranks} on {self._layout.device}>")


_AGAS = ("named registration of a partitioned_vector needs AGAS "
         "(hpx_tpu.dist.agas, over dist/actions), which is not ported "
         "yet (ROADMAP queue 1, item 6)")
