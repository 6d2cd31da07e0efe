"""Logical-axis sharding: maps layer-semantic axes onto a device mesh (the
port of the JAX package's ``models/sharding.py``).

Logical names used by parameter and activation definitions:
  'fsdp'  -> the data-parallel mesh dims (('pod', 'data') multi-pod,
             ('data',) single-pod): ZeRO-3 style parameter sharding
  'tp'    -> the tensor-parallel 'model' dim (heads / d_ff / experts)
  'seq'   -> sequence sharding over 'model' for long-context decode caches
  'dp+tp' -> every mesh dim
  None    -> replicated

The JAX package writes a ``PartitionSpec`` (one entry per tensor dim); a
DTensor takes one placement per *mesh* dim.  ``resolve`` turns a logical
tuple into those placements: mesh dim ``m`` is ``Shard(i)`` when tensor
dim ``i`` names it, else ``Replicate()``.  A tensor dim over two mesh dims
(``'fsdp'`` under ``('pod', 'data')``) is ``Shard(i)`` on both, split pod
first, which is the rank order of JAX's ``P(('pod', 'data'))``.

Nothing here acts without a mesh: ``constrain`` (the counterpart of
``with_sharding_constraint``) returns a plain tensor as it is, so every
single-device path computes what it did before this module existed.

The DTensor APIs used across the port live here, imported in one place:
``DTensor``, ``Shard``, ``Replicate`` and ``Partial`` are public since
torch 2.4; ``local_map`` and ``implicit_replication`` are experimental
(checked on torch 2.11 and 2.13).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

__all__ = ["DTensor", "MeshAxes", "Partial", "Replicate", "Shard", "ambient_mesh",
           "axes_for_mesh", "constrain", "empty_like_placed", "full", "gathered",
           "implicit_replication", "local_region", "merge_last", "mesh_scope",
           "placements_for", "proj", "shape_safe_spec", "shard_map_compat", "split_last"]

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """The mesh's data-parallel dims ``dp`` (outermost first) and its
    tensor-parallel dim ``tp``; the mesh's dims are ``dp + (tp,)``, in that
    order."""

    dp: tuple = ("data",)
    tp: str = "model"

    @property
    def names(self) -> tuple:
        return tuple(self.dp) + (self.tp,)

    def resolve(self, logical) -> list:
        """One placement per mesh dim (``self.names`` order) for a logical
        tuple (one name per tensor dim)."""
        out = [Replicate() for _ in self.names]
        tp_dim = len(self.dp)
        for i, name in enumerate(logical):
            if name == "fsdp":
                dims = range(len(self.dp))
            elif name in ("tp", "seq"):   # 'seq': decode caches over tp
                dims = (tp_dim,)
            elif name == "dp+tp":
                dims = range(tp_dim + 1)
            elif name is None:
                continue
            else:
                raise ValueError(f"unknown logical axis {name!r}")
            for m in dims:
                out[m] = Shard(i)
        return out


def axes_for_mesh(mesh) -> MeshAxes:
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(n for n in names if n in ("pod", "data"))
    axes = MeshAxes(dp=dp or ("data",), tp="model")
    if names != axes.names:
        raise ValueError(f"mesh dims {names}: expected {axes.names}")
    return axes


def ambient_mesh():
    """The mesh the caller activated with ``launch.mesh.use_mesh``; None
    when no mesh is active."""
    return _MESH.get()


@contextlib.contextmanager
def mesh_scope(mesh):
    """Make ``mesh`` the ambient mesh for the block (``use_mesh``), plain
    tensors next to DTensors (positions, masks) taken as replicated.  A
    backward pass that recomputes a rematerialised layer must run inside
    it too."""
    token = _MESH.set(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESH.reset(token)


def shape_safe_spec(mesh, placements, shape) -> list:
    """Drop the placements that do not evenly divide their dimension: a
    tensor dim split over mesh dims whose sizes' product does not divide it
    becomes replicated on all of them (JAX's input shardings need even
    tiling; e.g. batch=1 long-context decode leaves the data axis idle,
    odd vocabs fall back to replicated).  DTensor would accept the uneven
    split; it is dropped so that shard shapes equal the reference's."""
    ways = {}
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(m)
    return [Replicate() if isinstance(p, Shard) and shape[p.dim] % ways[p.dim] else p
            for p in placements]


def placements_for(mesh, axes: MeshAxes, logical, shape) -> list:
    """``shape_safe_spec`` of ``axes.resolve(logical)``."""
    return shape_safe_spec(mesh, axes.resolve(logical), shape)


def constrain(x, axes: MeshAxes | None, logical):
    """``x`` redistributed to the logical axes on its own mesh
    (``with_sharding_constraint``; ``axes`` None: the mesh's): a no-op for
    a plain tensor, so without a mesh.  Axes that do not divide their
    dimension are dropped (``shape_safe_spec``).  The mesh is the
    tensor's, never the ambient one: a rematerialised layer is recomputed
    on the autograd engine's thread, which does not see the caller's
    context."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    if axes is None:
        axes = axes_for_mesh(mesh)
    target = tuple(placements_for(mesh, axes, logical, x.shape))
    if tuple(x.placements) != target:
        x = x.redistribute(mesh, target)
    return _PinGrad.apply(x, target) if x.requires_grad else x


class _PinGrad(torch.autograd.Function):
    """The identity, whose gradient is redistributed to the same placements:
    a sharding constraint binds the backward pass too, as JAX's does (left
    alone, DTensor may split a gradient along the sequence, and then finds
    no sharding rule for the product that flattens it)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def shard_map_compat(f, mesh, in_placements, out_placements, in_grad_placements=None):
    """``f`` run on each rank's local tensors (the counterpart of
    ``shard_map``): DTensor arguments are redistributed to
    ``in_placements``, ``f`` sees their local shards, and its outputs are
    wrapped with ``out_placements`` (``Partial()`` where the reference
    ``psum``s).  ``in_grad_placements`` gives the placements of each
    input's local gradient (``Partial()`` where ranks hold parts of a
    sum)."""
    return local_map(f, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)


def gathered(w):
    """A weight as a matmul uses it: a DTensor parameter gathered over the
    data dims (its 'fsdp' axis, ZeRO-3's gather at use; the gradient comes
    back reduce-scattered), its 'tp' split kept; a plain tensor as it is.
    The reference leaves this to XLA's partitioner; DTensor's cost model,
    left to itself, splits activations along the sequence and then has
    no sharding rule for the next product."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    target = [Replicate() if names[m] in ("pod", "data") else p
              for m, p in enumerate(w.placements)]
    return w if target == list(w.placements) else w.redistribute(w.device_mesh, target)


def proj(x, w):
    """``x @ w`` for a weight ``(in, out)``; on a mesh the weight is
    ``gathered`` and the product constrained to Megatron's layout: the
    batch over the data dims, the last dim split over 'model' where the
    weight's output dim is (a column-parallel product), else whole (a
    row-parallel product, its partial sums reduced here).  The reference
    leaves these layouts to XLA's partitioner; DTensor's own choices
    differ between torch versions and can split activations or their
    gradients along the sequence, which its flattening products then
    cannot take."""
    y = x @ gathered(w)
    if not isinstance(y, DTensor):
        return y
    model = w.device_mesh.mesh_dim_names.index("model")
    p = w.placements[model]
    column = isinstance(p, Shard) and p.dim == w.ndim - 1
    return constrain(y, None, ("fsdp",) + (None,) * (y.ndim - 2) + ("tp" if column else None,))


def split_last(x, *tail):
    """``x`` with its last dim split into ``tail`` (``(..., H * hd) -> (...,
    H, hd)``).  A DTensor split along that dim over mesh dims whose sizes do
    not divide ``tail[0]`` is first replicated there: DTensor refuses the
    view, where the reference's compiler reshards by itself."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        ways = 1
        for m, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == last:
                ways *= x.device_mesh.size(m)
        if tail[0] % ways:
            x = x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Shard) and
                                               p.dim == last else p for p in x.placements])
    return x.reshape(*x.shape[:-1], *tail)


def merge_last(x):
    """``x`` with its last two dims merged (``(..., H, hd) -> (..., H *
    hd)``).  A DTensor's gradient is held to the merged tensor's own
    placements, so that the backward view can split it again (DTensor
    refuses to split a dim whose shards do not hold whole heads)."""
    y = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if isinstance(y, DTensor) and y.requires_grad:
        y = _PinGrad.apply(y, tuple(y.placements))
    return y


def local_region(fn, args, logicals, outs):
    """``fn(*args)`` on each rank's local shards when an argument is a
    DTensor (as it is otherwise): the smallest region a DTensor sharding
    rule is missing for, run under ``local_map``.

    ``logicals`` gives each argument's logical axes (None for a plain
    tensor or a non-tensor, passed through as it is); ``outs`` gives each
    output's ``(logical axes, global shape)``, one pair for a single
    output or a list of pairs for a tuple.  Every placement is
    ``placements_for`` of its shape.  An argument replicated on a mesh
    dim that another argument is split over gets a partial gradient there
    (each rank's part of the sum over that dim)."""
    slots = [i for i, a in enumerate(args) if isinstance(a, DTensor)]
    if not slots:
        return fn(*args)
    mesh = args[slots[0]].device_mesh
    axes = axes_for_mesh(mesh)
    place = {i: placements_for(mesh, axes, logicals[i], args[i].shape) for i in slots}
    split = {m for pl in place.values() for m, p in enumerate(pl) if isinstance(p, Shard)}
    grad = [[Partial() if m in split and isinstance(p, Replicate) else p
             for m, p in enumerate(place[i])] for i in slots]
    single = not isinstance(outs, list)
    out_pl = [placements_for(mesh, axes, lg, shape) for lg, shape in ([outs] if single else outs)]

    def body(*locals_):
        full_args = list(args)
        for i, t in zip(slots, locals_):
            full_args[i] = t
        return fn(*full_args)

    run = shard_map_compat(body, mesh, tuple(place[i] for i in slots),
                           out_pl[0] if single else tuple(out_pl), tuple(grad))
    return run(*(args[i] for i in slots))


def full(x):
    """A DTensor gathered to every rank (``full_tensor``); a plain tensor as
    it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def even_local_shape(shape, mesh, placements) -> tuple:
    """The local shard shape of an evenly split ``shape`` (every rank's)."""
    local = list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            if local[p.dim] % mesh.size(m):
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split evenly "
                                 f"over {placements}")
            local[p.dim] //= mesh.size(m)
    return tuple(local)


def empty_like_placed(shape, dtype, mesh, placements, device):
    """A DTensor of global ``shape`` with ``placements`` (an even split)
    whose local shard is allocated and not filled."""
    t = torch.empty(even_local_shape(shape, mesh, placements), dtype=dtype, device=device)
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
