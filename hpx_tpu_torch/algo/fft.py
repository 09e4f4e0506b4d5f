"""FFT over a mesh axis of ranks: the four-step (Bailey) transform and
the pencil 2-D transforms.

Reference analog: HPX ships no FFT in-tree, but the distributed FFT
built from `hpx::collectives::all_to_all` over `partitioned_vector` data
is its published flagship collectives workload. Counterpart of
``hpx_tpu.algo.fft``: the program is the reference's, step for step,
with its `lax.all_to_all(tiled=True)` exchanges
``collectives.device.all_to_all`` over the mesh axis (the identity on a
mesh of one rank), and torch.fft's transforms where the reference calls
jnp.fft's. Every rank of the axis runs the same body on its own piece
(one process a rank, ``parallel.mesh.launch``).

Two surfaces, as the reference's:
  * whole-array helpers (`fft2_sharded`, `fft_sharded`,
    `fft2_sharded_2d`, and inverses): each rank passes its piece of an
    array laid out over the mesh (on a mesh of one rank, the whole
    array) and gets its piece of the result, laid out the same way in
    natural order; every rank of the mesh calls them together;
  * `fft2_body` / `fft1d_body`, the per-rank bodies (a rank's piece of
    the array and the mesh it runs in).

1-D algorithm (Bailey four-step), for a row-major matrix view
A[n1, n2] = v[n1*N2 + n2] with N = N1*N2 and the vector cut into
contiguous chunks (= whole rows of A):

    X[k2*N1 + k1] = FFT_axis1( FFT_axis0(A)[k1, n2] * w(k1, n2) )[k1, k2]
    with twiddle w(k1, n2) = exp(-2*pi*i * k1 * n2 / N)

so the schedule is: all_to_all (rows -> full columns), column FFTs,
twiddle, all_to_all back, row FFTs, and one final all_to_all + local
transpose to deliver natural-order output (skippable — see
`natural_order`). N is factored exactly as the reference factors it
(`_split_n`), so the port runs the same program as bench.py's
fft_1d_gflops on its 1-chip mesh.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Tuple

import torch

from ..collectives.device import all_to_all

__all__ = ["fft", "ifft", "fft2_sharded", "ifft2_sharded", "fft_sharded",
           "ifft_sharded", "fft2_sharded_2d", "ifft2_sharded_2d",
           "fft2_body", "fft1d_body"]


def _a2a(x: torch.Tensor, mesh, axis: str, split: int, concat: int
         ) -> torch.Tensor:
    """lax.all_to_all(tiled=True) over ``axis``: x cut into P blocks
    along ``split``, block j to member j, the blocks received joined
    along ``concat`` (the identity with one member)."""
    return all_to_all(x, mesh, axis, split_axis=split, concat_axis=concat)


def _on_mesh(x: torch.Tensor, mesh) -> None:
    if x.device != mesh.device:
        raise ValueError(f"a tensor on {x.device} given to a mesh on "
                         f"{mesh.device}; move it explicitly")


@functools.lru_cache(maxsize=4)
def _twiddle(n1: int, n2_loc: int, idx: int, n: int, inverse: bool,
             dtype: torch.dtype, device: torch.device,
             column_major: bool) -> torch.Tensor:
    """w(k1, n2) = exp(-+2*pi*i * k1 * n2 / N) on this rank's columns, in
    dtype. k1*n2g < N1*N2 = N: the product in floating point (exact
    below 2^24 in f32; an int32 product would wrap for N >= 2^31), then
    the angle, then cos and sin: the reference's order, in its
    precision. It depends on the shape only, so it is made once a shape
    and kept, as the reference's compiled program keeps it a constant;
    ``column_major`` lays it out as torch lays out a transform along dim
    0, so that the multiply reads both operands in one order."""
    ftype = torch.float64 if dtype == torch.complex128 else torch.float32
    k1 = torch.arange(n1, device=device, dtype=ftype)[:, None]
    n2g = (idx * n2_loc
           + torch.arange(n2_loc, device=device, dtype=ftype))[None, :]
    sign = 2.0 if inverse else -2.0
    ang = (k1 * n2g) * (sign * math.pi / n)
    w = torch.polar(torch.ones_like(ang), ang).to(dtype)
    return w.t().contiguous().t() if column_major else w


# ---------------------------------------------------------------------------
# per-rank bodies
# ---------------------------------------------------------------------------

def fft2_body(a: torch.Tensor, mesh, axis: str = "x", inverse: bool = False,
              natural_order: bool = True) -> torch.Tensor:
    """2-D FFT of a matrix row-partitioned over `axis`; this rank's piece
    [N0/P, N1]. Returns the row-partitioned result (or column-partitioned
    [N0, N1/P] when natural_order=False, saving one all_to_all)."""
    f = torch.fft.ifft if inverse else torch.fft.fft
    a = f(a, dim=1)                              # rows are local: N1 FFTs
    a = _a2a(a, mesh, axis, split=1, concat=0)   # -> [N0, N1/P]
    a = f(a, dim=0)                              # full columns now local
    if natural_order:
        a = _a2a(a, mesh, axis, split=0, concat=1)   # -> [N0/P, N1]
    return a


def fft1d_body(a: torch.Tensor, mesh, axis: str, n: int,
               inverse: bool = False, natural_order: bool = True
               ) -> torch.Tensor:
    """Four-step 1-D FFT; `a` is the [N1/P, N2] row-major matrix view
    of this rank's contiguous vector chunk. Returns the [N/P]-shaped
    natural-order chunk (or the [N1/P, N2] D-matrix when
    natural_order=False; undo with the matching inverse)."""
    f = torch.fft.ifft if inverse else torch.fft.fft
    p = mesh.axis_size(axis)
    n1 = a.shape[0] * p
    n2 = a.shape[1]
    t = _a2a(a, mesh, axis, split=1, concat=0)       # [N1, N2/P]
    b = f(t, dim=0)
    idx = mesh.axis_index(axis)
    n2_loc = n2 // p
    c = b * _twiddle(n1, n2_loc, idx, n, inverse, b.dtype, b.device,
                     b.stride(0) == 1 and n2_loc > 1)
    d = f(_a2a(c, mesh, axis, split=0, concat=1), dim=1)   # [N1/P, N2]
    # ifft normalizes each local transform by its length; the composed
    # 1-D inverse needs exactly 1/N total, which N1*N2 = N gives
    if not natural_order:
        return d
    e = _a2a(d, mesh, axis, split=1, concat=0)       # [N1, N2/P]
    return e.transpose(0, 1).reshape(-1)             # X[k2*N1+k1] chunk


# ---------------------------------------------------------------------------
# whole-array helpers
# ---------------------------------------------------------------------------

def fft2_sharded(x: torch.Tensor, mesh, axis: str = "x",
                 inverse: bool = False) -> torch.Tensor:
    """2-D FFT of a [N0, N1] array laid out over rows (dim 0 on mesh
    axis `axis`): ``x`` is this rank's [N0/P, N1] piece; both dims'
    per-rank extents must divide evenly. Local row FFTs, all_to_all
    transpose, column FFTs, all_to_all back."""
    p = mesh.shape[axis]
    n0, n1 = x.shape[0] * p, x.shape[1]
    if n0 % p or n1 % p:
        raise ValueError(f"shape {(n0, n1)} not tileable over {p} shards")
    _on_mesh(x, mesh)
    return fft2_body(x, mesh, axis, inverse=inverse)


def ifft2_sharded(x: torch.Tensor, mesh, axis: str = "x") -> torch.Tensor:
    return fft2_sharded(x, mesh, axis, inverse=True)


def fft2_sharded_2d(x: torch.Tensor, mesh, axes: Tuple[str, str] = ("x", "y"),
                    inverse: bool = False) -> torch.Tensor:
    """2-D FFT of an [N0, N1] array laid out over BOTH dims of a 2-D
    mesh (dim 0 over axes[0], dim 1 over axes[1]): ``x`` is this rank's
    [N0/Px, N1/Py] block. Pencil schedule:

        a2a over axes[1] (rows whole)  -> row FFTs   -> a2a back
        a2a over axes[0] (cols whole)  -> column FFTs -> a2a back

    Each transpose stays INSIDE one mesh axis, and the other axis's
    layout is untouched. Per-rank extents must tile: N0 % (Px*Py) == 0
    and N1 % (Px*Py) == 0."""
    ax0, ax1 = axes
    px, py = mesh.shape[ax0], mesh.shape[ax1]
    n0, n1 = x.shape[0] * px, x.shape[1] * py
    if n0 % (px * py) or n1 % (px * py):
        raise ValueError(
            f"shape {(n0, n1)} not tileable by Px*Py = {px}*{py} on both "
            f"dims (the intra-axis transposes re-split each dim)")
    _on_mesh(x, mesh)
    f = torch.fft.ifft if inverse else torch.fft.fft
    # rows whole: redistribute dim 0 over the y axis too
    t = _a2a(x, mesh, ax1, split=0, concat=1)     # [N0/(PxPy), N1]
    t = f(t, dim=1)
    a = _a2a(t, mesh, ax1, split=1, concat=0)     # [N0/Px, N1/Py]
    # columns whole: redistribute dim 1 over the x axis
    t = _a2a(a, mesh, ax0, split=1, concat=0)     # [N0, N1/(PxPy)]
    t = f(t, dim=0)
    return _a2a(t, mesh, ax0, split=0, concat=1)


def ifft2_sharded_2d(x: torch.Tensor, mesh,
                     axes: Tuple[str, str] = ("x", "y")) -> torch.Tensor:
    return fft2_sharded_2d(x, mesh, axes, inverse=True)


@functools.lru_cache(maxsize=64)
def _split_n(n: int, p: int) -> Tuple[int, int]:
    """Factor n = n1*n2 with p | n1 and p | n2, n1 as near sqrt(n) as
    possible (balanced pencils minimize all_to_all volume skew). Its
    search takes sqrt(n) steps of Python (2048 at 2^22, which outlast
    the transform's kernels on an H100), so each (n, p) is searched
    once."""
    best = None
    d = p
    while d * d <= n * p:        # n1 candidates: multiples of p
        if n % d == 0 and (n // d) % p == 0:
            if best is None or abs(d - math.isqrt(n)) < abs(
                    best - math.isqrt(n)):
                best = d
        d += p
    if best is None:
        raise ValueError(
            f"cannot factor n={n} as n1*n2 with {p} | n1 and {p} | n2")
    return best, n // best


def fft_sharded(v: torch.Tensor, mesh, axis: str = "x",
                inverse: bool = False) -> torch.Tensor:
    """1-D FFT of a length-N vector laid out in contiguous chunks over
    mesh axis `axis`: ``v`` is this rank's chunk of N/P (Bailey
    four-step; three all_to_alls; output in natural order, laid out the
    same way)."""
    p = mesh.shape[axis]
    n = v.shape[0] * p
    n1, n2 = _split_n(n, p)
    _on_mesh(v, mesh)
    return fft1d_body(v.reshape(n1 // p, n2), mesh, axis, n,
                      inverse=inverse)


def ifft_sharded(v: torch.Tensor, mesh, axis: str = "x") -> torch.Tensor:
    return fft_sharded(v, mesh, axis, inverse=True)


def fft(v: Any, mesh=None, axis: str = "x", inverse: bool = False):
    """Front door: a tensor laid out over a mesh (pass mesh) or a
    PartitionedVector (its layout carries mesh + axis) — the segmented-
    algorithm pattern (algo/__init__) applied to the FFT."""
    from ..containers.partitioned_vector import PartitionedVector
    if isinstance(v, PartitionedVector):
        if mesh is not None and mesh is not v.mesh:
            raise ValueError(
                "fft(pv, mesh=...): the layout's mesh governs; drop the "
                "mesh argument or pass the plain tensor")
        if v.padded_size != v.size:
            raise ValueError(
                f"fft over a padded partitioned_vector (size {v.size}, "
                f"padded {v.padded_size}): resize so the axis divides "
                f"the length")
        out = fft_sharded(v.data, v.mesh, v.layout.axis, inverse)
        return PartitionedVector._from_block(out, v.size, v.layout)
    if mesh is None:
        raise ValueError("pass mesh= for a plain tensor")
    return fft_sharded(v, mesh, axis, inverse)


def ifft(v: Any, mesh=None, axis: str = "x"):
    return fft(v, mesh, axis, inverse=True)
