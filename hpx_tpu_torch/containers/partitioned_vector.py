"""partitioned_vector: the partitioned container, on one device.

Reference analog: components/containers/partitioned_vector — a vector
split into partitions placed per a distribution policy, with segmented
iterators and named registration for multi-locality access. Counterpart
of ``hpx_tpu.containers.partitioned_vector`` on one device.

A PartitionedVector is a mutable HANDLE over one padded tensor on its
layout's device. "Segments" are logical (index range, device) views of
that tensor, not separate objects: algorithms (algo/segmented.py) run
on the whole container at once, which on one device is the segmented
algorithm's per-segment work and its combine in one set of kernels.

Uneven sizes: the backing tensor is padded (with zeros) up to a multiple
of the partition count, as the reference pads to its sharding; `size`
stays logical and `valid_array()` returns the unpadded prefix (a view,
the tensor itself when the size divides evenly).

Sharing: `from_array` of a tensor already on the layout's device (an
algorithm's result being rewrapped, say) and `copy()` share the tensor,
as the reference's handles share an immutable jax.Array. `set` writes in
place, so a handle whose tensor may be shared copies it once before its
first write: the other holders never see the write, as the reference's
functional update gives.
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
    segmented_iterator). `devices` lists the devices the segment spans,
    in axis order (one here); `device` is the first."""
    index: int
    begin: int
    end: int
    devices: Tuple[Any, ...]

    @property
    def device(self) -> Any:
        return self.devices[0]

    def __len__(self) -> int:
        return self.end - self.begin


class PartitionedVectorView:
    """A contiguous sub-range view (partitioned_vector_view analog).

    Algorithms accept views and operate on the underlying slice of the
    tensor (a view of it, no copy)."""

    def __init__(self, pv: "PartitionedVector", begin: int, end: int) -> None:
        begin = max(0, min(begin, pv.size))
        end = max(begin, min(end, pv.size))
        self.pv = pv
        self.begin = begin
        self.end = end

    def array(self) -> torch.Tensor:
        return self.pv.valid_array()[self.begin:self.end]

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
        return self.array().cpu().numpy().copy()

    def __repr__(self) -> str:
        return (f"<PartitionedVectorView [{self.begin}, {self.end}) of "
                f"{self.pv!r}>")


class PartitionedVector:
    """hpx::partitioned_vector<T> analog over one padded tensor."""

    def __init__(self, size: int, value: Any = 0, dtype: Any = None,
                 layout: Optional[ContainerLayout] = None) -> None:
        self._layout = layout or default_layout()
        self._size = int(size)
        dtype = _default_dtype(value) if dtype is None else _torch_dtype(dtype)
        padded = self._padded_size(self._size, self._layout)
        self._data = torch.full((padded,), value, dtype=dtype,
                                device=self._layout.device)
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
        """Build from a 1-D array: a tensor on the layout's device is
        taken as it is (no copy, no synchronization) when no padding is
        needed; anything else is copied there."""
        layout = layout or default_layout()
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.array(arr))
        arr = arr.to(layout.device)
        if arr.ndim != 1:
            raise ValueError("partitioned_vector is 1-D; got shape "
                             f"{tuple(arr.shape)}")
        self = cls.__new__(cls)
        self._layout = layout
        self._size = int(arr.shape[0])
        padded = cls._padded_size(self._size, layout)
        self._owned = padded != self._size
        if self._owned:
            arr = torch.cat([arr, arr.new_zeros(padded - self._size)])
        self._data = arr
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
        """The backing (padded) tensor."""
        return self._data

    def valid_array(self) -> torch.Tensor:
        """The logical contents: the tensor, or a view of its unpadded
        prefix."""
        if self._data.shape[0] == self._size:
            return self._data
        return self._data[:self._size]

    def to_numpy(self) -> np.ndarray:
        return self.valid_array().cpu().numpy().copy()

    # -- element access (get_value/set_value analogs) ------------------------
    def get(self, i: int) -> Any:
        """Synchronous element fetch (hpx::partitioned_vector::get_value)."""
        return self._data[self._check(i)].item()

    def get_async(self, i: int):
        """get_value(launch::async) analog: Future of the element (a 0-d
        tensor, whose read may still be in flight on the stream)."""
        from ..futures.future import make_ready_future
        return make_ready_future(self._data[self._check(i)].clone())

    def set(self, i: int, value: Any) -> None:
        """set_value analog: writes the element in place (a fill on the
        device, no synchronization), after copying a shared tensor."""
        i = self._check(i)
        if not self._owned:
            self._data = self._data.clone()
            self._owned = True
        self._data[i] = value

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
        """Logical partitions with their device, in index order: the
        padded extent cut into num_partitions equal blocks, each clipped
        to the logical size."""
        npart = self.num_partitions
        chunk = self._data.shape[0] // npart
        devs = (self._layout.device,)
        return [Segment(k, min(k * chunk, self._size),
                        min((k + 1) * chunk, self._size), devs)
                for k in range(npart)]

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
        until either handle writes)."""
        out = PartitionedVector.__new__(PartitionedVector)
        out._layout = self._layout
        out._size = self._size
        out._data = self._data
        self._owned = out._owned = False
        return out

    def __repr__(self) -> str:
        return (f"<partitioned_vector size={self._size} dtype={self.dtype} "
                f"partitions={self.num_partitions} axis="
                f"'{self._layout.axis}' on {self._layout.device}>")


_AGAS = ("named registration of a partitioned_vector needs AGAS "
         "(hpx_tpu.dist.agas, over dist/actions), which is not ported "
         "yet (ROADMAP queue 1, item 6)")
