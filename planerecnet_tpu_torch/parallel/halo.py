"""Row exchanges of the ``spatial`` mesh axis, and the layout rule of a
row-sharded forward.

In the JAX package the spatial axis is one sharding annotation
(``parallel/spmd.py::jit_forward(..., spatial=True)``,
``trainer.py::jit_train_step(..., spatial=True)``), and XLA SPMD inserts
every halo exchange. PyTorch has nothing that does that, so each exchange
is written out here, as a ``torch.autograd.Function`` whose backward is
the exact adjoint of its forward across the ranks:

* ``halo_rows``: this rank's rows with its neighbours' boundary rows
  around them. At the global top and bottom, where there is no
  neighbour, it fills the rows as the caller's op pads there (zeros,
  -inf, or the reflection of the map's own rows). Backward: each halo
  row's gradient is sent back and added to the row it came from.
* ``gather_rows``: the whole height on every rank. Backward: the sum of
  the ranks' gradients, this rank's rows of it.
* ``sum_rows``: a sum over the ranks (norm statistics). Backward: the sum
  of the ranks' gradients, since every rank's output feeds its own
  consumers.

Each counts its forward calls on its function's ``calls``, and on its
``received_bytes`` the bytes of other ranks' rows that a forward call
hands this rank (a halo's rows from the neighbours, a gather's other
shards, a sum's other partial sums): what a point-to-point exchange would
move, whatever the collective moves. ``traffic`` reads the three
together, ``reset_traffic`` sets them to 0 (``tools/profile_spatial.py``
prices a forward's exchanges from them).

Every one is built on ``all_gather`` and ``all_reduce``, which gloo (the
backend of several ranks on one card) and NCCL both take for CUDA
tensors: gloo's point-to-point ``send``/``recv`` takes CPU tensors only,
and it has no reduce-scatter. The edge handling lives inside the
Functions, so that every rank builds the same autograd graph and its
backward runs the collectives in the same order on every rank.

``Rows`` is a forward's spatial context (``models/planerecnet.py::
PlaneRecNet.forward(x, spatial=...)``). Its layout rule: a map stays
row-sharded while its height divides by the spatial ranks into shards of
at least one row (the widest halo of any layer past the stem); otherwise
it is whole on every rank. The rule depends on the map's global height
alone, so two maps of one height always share a layout; that height is
read from the map's width, which is never split (every map of the
network is the image scaled by one factor on both axes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

import torch
import torch.distributed as dist

from planerecnet_tpu_torch.parallel.mesh import Mesh, check_height

# The fewest rows a shard of a map may hold (the 3x3 windows' halo).
MIN_ROWS = 1
_FILL = {"zeros": 0.0, "-inf": float("-inf")}


def _all_gather(t: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=group)
    return t


def _reflect_sources(above, below, h):
    """(ext row, source ext row) of each reflected edge row, for the top
    and the bottom of an ext of ``above + h + below`` rows."""
    top = [(above - i, above + i) for i in range(1, above + 1)]
    last = above + h - 1
    bottom = [(last + i, last - i) for i in range(1, below + 1)]
    return top, bottom


class _HaloRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, above, below, edge, group, n, index):
        h = x.shape[-2]
        if above > h or below > h:
            raise ValueError(f"halo of {above}/{below} rows from shards of "
                             f"{h}")
        got = _all_gather(torch.cat([x[..., h - above:, :],
                                     x[..., :below, :]], -2), group, n)
        fill = _FILL.get(edge, 0.0)
        shape = list(x.shape)
        shape[-2] = above
        top = (got[index - 1][..., :above, :] if index > 0
               else x.new_full(shape, fill))
        shape[-2] = below
        bottom = (got[index + 1][..., above:, :] if index < n - 1
                  else x.new_full(shape, fill))
        ext = torch.cat([top, x, bottom], -2)
        got_rows = top.numel() * (index > 0) + bottom.numel() * (index < n - 1)
        halo_rows.received_bytes += got_rows * x.element_size()
        halo_rows.calls += 1
        if edge == "reflect":
            top_src, bottom_src = _reflect_sources(above, below, h)
            for dst, src in (top_src if index == 0 else []) + (
                    bottom_src if index == n - 1 else []):
                ext[..., dst, :] = ext[..., src, :]
        ctx.geometry = (above, below, h, edge, group, n, index)
        return ext

    @staticmethod
    def backward(ctx, dy):
        above, below, h, edge, group, n, index = ctx.geometry
        dy = dy.clone(memory_format=torch.contiguous_format)
        if edge == "reflect":
            top_src, bottom_src = _reflect_sources(above, below, h)
            for dst, src in (top_src if index == 0 else []) + (
                    bottom_src if index == n - 1 else []):
                dy[..., src, :] += dy[..., dst, :]
        dtop = dy[..., :above, :]
        dbottom = dy[..., above + h:, :]
        if index == 0:
            dtop = torch.zeros_like(dtop)
        if index == n - 1:
            dbottom = torch.zeros_like(dbottom)
        got = _all_gather(torch.cat([dtop, dbottom], -2), group, n)
        dx = dy[..., above:above + h, :].clone()
        if index < n - 1 and above:
            dx[..., h - above:, :] += got[index + 1][..., :above, :]
        if index > 0 and below:
            dx[..., :below, :] += got[index - 1][..., above:, :]
        return dx, None, None, None, None, None, None


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.geometry = (dim, x.shape[dim], group, index)
        gather_rows.received_bytes += (n - 1) * x.numel() * x.element_size()
        gather_rows.calls += 1
        return torch.cat(_all_gather(x, group, n), dim)

    @staticmethod
    def backward(ctx, dy):
        dim, h, group, index = ctx.geometry
        dx = _all_reduce(dy, group).narrow(dim, index * h, h).contiguous()
        return dx, None, None, None, None


class _SumRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        sum_rows.received_bytes += ((dist.get_world_size(group) - 1)
                                    * t.numel() * t.element_size())
        sum_rows.calls += 1
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.group), None


def halo_rows(x: torch.Tensor, above: int, below: int, edge: str,
              mesh: Mesh) -> torch.Tensor:
    """This rank's rows (dim -2) of a row-sharded map with ``above`` rows
    of the rank above and ``below`` rows of the rank below around them;
    at the global top and bottom the rows are ``edge``: "zeros", "-inf"
    or "reflect" (row -i is row i, as reflection padding reads)."""
    if edge not in ("zeros", "-inf", "reflect"):
        raise ValueError(f"halo_rows: edge {edge!r}")
    return _HaloRows.apply(x, above, below, edge, mesh.spatial_group,
                           mesh.n_spatial, mesh.spatial_index)


halo_rows.received_bytes = 0
halo_rows.calls = 0


def gather_rows(x: torch.Tensor, mesh: Mesh, dim: int = -2) -> torch.Tensor:
    """The whole of a row-sharded map (rows on ``dim``) on every rank of
    the spatial group."""
    return _GatherRows.apply(x, dim, mesh.spatial_group, mesh.n_spatial,
                             mesh.spatial_index)


gather_rows.received_bytes = 0
gather_rows.calls = 0


def sum_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the spatial group (each rank's partial sum over
    its rows becomes the whole map's)."""
    return _SumRows.apply(t, mesh.spatial_group)


sum_rows.received_bytes = 0
sum_rows.calls = 0


_EXCHANGES = (halo_rows, gather_rows, sum_rows)


def traffic() -> Tuple[int, int]:
    """(bytes received, exchanges) of this rank's forward calls of the
    three exchanges since ``reset_traffic``."""
    return (sum(f.received_bytes for f in _EXCHANGES),
            sum(f.calls for f in _EXCHANGES))


def reset_traffic() -> None:
    for f in _EXCHANGES:
        f.received_bytes = f.calls = 0


@dataclass(frozen=True)
class Rows:
    """The spatial context of one forward: the mesh, and the global
    height and width of the image whose rows the ranks split."""
    mesh: Mesh
    height: int
    width: int

    def __post_init__(self):
        check_height(self.mesh, self.height)

    @property
    def n(self) -> int:
        return self.mesh.n_spatial

    def rows_of(self, x: torch.Tensor) -> int:
        """The global height of NCHW map ``x``, from its width."""
        g, rest = divmod(self.height * x.shape[-1], self.width)
        if rest:
            raise ValueError(f"a map {x.shape[-1]} wide is not the "
                             f"{self.height}x{self.width} image scaled")
        return g

    def splits(self, g: int) -> bool:
        """Whether a map of ``g`` global rows stays row-sharded."""
        return g % self.n == 0 and g // self.n >= MIN_ROWS

    def window(self, g: int) -> Tuple[int, int]:
        """(first row, rows) of this rank's shard of a map of ``g``."""
        rows = g // self.n
        return self.mesh.spatial_index * rows, rows

    def sharded(self, x: torch.Tensor) -> bool:
        """Whether ``x`` holds this rank's rows (else the whole map)."""
        g = self.rows_of(x)
        want = g // self.n if self.splits(g) else g
        if x.shape[-2] != want:
            raise ValueError(f"a map of {g} rows holds {x.shape[-2]} rows "
                             f"here, expected {want}")
        return want != g

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map on every rank."""
        return gather_rows(x, self.mesh) if self.sharded(x) else x

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """A whole map cut to the layout the rule gives it: this rank's
        rows where its height splits, else the whole map."""
        g = x.shape[-2]
        if g == self.rows_of(x) and self.splits(g):
            first, rows = self.window(g)
            return x[..., first:first + rows, :]
        return x

    def halo(self, x: torch.Tensor, above: int, below: int,
             edge: str = "zeros") -> torch.Tensor:
        return halo_rows(x, above, below, edge, self.mesh)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return sum_rows(t, self.mesh)

    def norm_group(self, x: torch.Tensor) -> Any:
        """The group whose ranks hold disjoint parts of ``x``'s images:
        the world for a row-sharded map, the data axis for a whole one."""
        return None if self.sharded(x) else self.mesh.group
