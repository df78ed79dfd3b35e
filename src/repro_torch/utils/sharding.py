"""Logical-axis → mesh-axis sharding rules with divisibility fallback: the
JAX package's ``repro.utils.sharding`` over ``torch.distributed``.

Params declare *logical* axes (e.g. ``("vocab", "embed")``); a rule table
maps logical axes to mesh axes. A logical axis only shards if the tensor
dim is divisible by the mesh axis size — otherwise it silently falls back
to replication (needed for e.g. qwen2's 14 heads or whisper's 51865 vocab
on a 16-way ``model`` axis).

The torch counterparts of the JAX objects:

- a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
  ``mesh_dim_names``, or a ``MeshShape`` (names and sizes only, the
  counterpart of jax's ``AbstractMesh``): ``resolve_spec`` reads nothing
  else;
- a spec is this module's ``PartitionSpec``, a tuple of mesh-axis names
  (or tuples of them, or None) per tensor dim, trailing Nones dropped;
- ``placements(spec, mesh)`` is the DTensor placement list, one
  ``Shard(d)`` or ``Replicate()`` per mesh dim: ``NamedSharding``'s
  counterpart;
- ``use_mesh(mesh)`` stands for JAX's ``with mesh:``, and
  ``maybe_constrain`` redistributes a DTensor under it (with no active
  mesh, or on a plain tensor, it returns ``x`` unchanged: the single-card
  path).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

# default logical → mesh-axis rules ("model" = tensor-parallel axis)
DEFAULT_RULES = {
    "batch": ("data",),          # expanded to ("pod","data") on multi-pod meshes
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),      # fallback when head count is non-divisible
    "kv_seq": ("model",),        # sequence-sharded KV cache (GQA fallback)
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "embed": (),
    "act_embed": ("model",),     # Megatron-SP: shard *activation* d_model
    "stack": (),                 # stacked layer dim — never sharded
    None: (),
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind it."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


class PartitionSpec(tuple):
    """Per tensor dim: a mesh-axis name, a tuple of them, or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs mesh_dim_names")
    return dict(zip(names, tuple(mesh.shape)))


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the global batch."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def resolve_spec(
    logical: Optional[Sequence[Optional[str]]],
    shape: Sequence[int],
    mesh,
    rules: Optional[dict] = None,
) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec for ``mesh``."""
    if logical is None:
        return P()
    rules = rules or DEFAULT_RULES
    sizes = axis_sizes(mesh)
    out = []
    used: set = set()
    for dim, name in zip(shape, logical):
        axes = rules.get(name, ())
        if name == "batch":
            axes = batch_axes(mesh)
        picked: Tuple[str, ...] = ()
        size = 1
        for ax in axes:
            if ax in sizes and ax not in used:
                size *= sizes[ax]
                picked += (ax,)
        if picked and size and dim % size == 0:
            used.update(picked)
            out.append(picked if len(picked) > 1 else picked[0])
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _is_def(x) -> bool:
    return hasattr(x, "spec") and hasattr(x, "shape")


def tree_specs(plan_tree, mesh):
    """Map a tree (nested dicts) of ParamDef → the same tree of
    PartitionSpec (see ``models.layers``)."""
    if _is_def(plan_tree):
        return resolve_spec(plan_tree.spec, plan_tree.shape, mesh)
    return {k: tree_specs(v, mesh) for k, v in plan_tree.items()}


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
    ``Replicate()`` (also on a mesh dim of size 1). A dim split over
    several mesh axes (``("pod", "data")``) is sharded by each, major axis
    first, as JAX splits it."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
            where[ax] = d
    # a mesh dim of one device holds the whole tensor either way:
    # Replicate keeps DTensor's propagation off its sharded paths
    sizes = axis_sizes(mesh)
    return tuple(Shard(where[ax]) if ax in where and sizes[ax] > 1
                 else Replicate() for ax in axis_names(mesh))


def layout(x, mesh, *logical: Optional[str]) -> tuple:
    """The placements that the logical names resolve to for ``x``'s shape
    on ``mesh``."""
    return placements(resolve_spec(logical, tuple(x.shape), mesh), mesh)


def tree_placements(spec_tree, mesh):
    """``placements`` over a tree (nested dicts) of PartitionSpec."""
    if isinstance(spec_tree, PartitionSpec):
        return placements(spec_tree, mesh)
    return {k: tree_placements(v, mesh) for k, v in spec_tree.items()}


def local_shape(shape: Sequence[int], spec: PartitionSpec, mesh
                ) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor placed by
    ``spec`` (every sharded dim divides evenly: ``resolve_spec`` checks)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
            out[d] //= sizes[ax]
    return tuple(out)


_MESHES: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """The port's ``with mesh:``: ``active_mesh()`` returns ``mesh`` inside."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def active_mesh():
    """The mesh of the innermost ``use_mesh`` context, if any."""
    return _MESHES[-1] if _MESHES else None


def constrain(x, mesh, *logical: Optional[str]):
    """Redistribute the DTensor ``x`` to the placements that the logical
    names resolve to on ``mesh``."""
    spec = resolve_spec(logical, x.shape, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def maybe_constrain(x, *logical: Optional[str]):
    """``constrain`` iff a mesh is active and ``x`` is a DTensor (the
    dry-run / sharded path); ``x`` itself on one device."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return constrain(x, mesh, *logical)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def whole(x):
    """The DTensor ``x`` with each partial placement reduced on every
    device (``Replicate``): a statistic over a sharded dim (a norm's sum
    over d_model) made whole before other partials meet it. ``x`` itself
    when it is no DTensor or holds no partial."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def replicated(x):
    """The DTensor ``x`` whole on every device; ``x`` itself otherwise."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def split_dims(*pls) -> set:
    """The mesh dims that any of the placement lists ``pls`` shards: the
    dims over which a computation run shard by shard is split."""
    from torch.distributed.tensor import Shard
    return {i for pl in pls for i, p in enumerate(pl) if isinstance(p, Shard)}


def grad_placements(pl, split) -> tuple:
    """The layout of the gradient of a ``local_map`` input laid out as
    ``pl``, for a computation split over the mesh dims ``split``: a
    partial sum over each split dim that the input is replicated on (each
    shard adds its own part), else the input's own layout."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if i in split and isinstance(p, Replicate)
                 else p for i, p in enumerate(pl))
