"""Sharding rules: tree → spec tree for every assigned architecture.

The placement vocabulary is four roles mapped onto mesh axes by
:class:`ShardingRules`:

* ``fsdp`` — fully-sharded data parallelism: weight matrices sharded over
  the ``data`` axis on their d_model-sized dimension;
* ``tp``  — tensor parallelism: head / hidden dimensions sharded over the
  ``model`` axis (whole heads, whole expert-hidden columns);
* ``dp``  — batch-dimension data parallelism, possibly over several axes
  (``("pod", "data")`` on the multi-pod mesh);
* ``pod`` — the cross-pod axis; only gradient all-reduce and MoE expert
  parallelism cross it, so it doubles as the expert-parallel axis on the
  multi-pod mesh and is ``None`` on a single pod.

Every proposed axis passes a divisibility gate: an axis is dropped
(replicated) whenever its mesh size does not divide the tensor dimension —
mamba2's vocab (50280 % 16 != 0) replicates while its d_model stays
FSDP-sharded, and the same rules drive a one-device mesh (every dimension
divides 1).

Spec trees mirror the input tree exactly, with a :class:`P` per leaf.
Stacked per-cycle parameters (anything under a ``"cycles"`` entry, see
:class:`repro_torch.models.transformer.LM`) carry one extra leading layer
axis, which is never sharded.  Pure tree logic over any leaves with a
``shape`` (tensors, ``torch.device("meta")`` tensors, shape structs):
nothing here allocates or touches a device, but the two functions that
put a tree at rest on a worker mesh and take it back
(:func:`split_tree`, :func:`join_tree`).

A spec never names one mesh axis twice: :class:`P` refuses it, and every
spec built here drops a repeated axis (the later dimension replicates).
The JAX package's launcher trips over such a spec, though none of its
spec trees holds one: under its mesh's explicit axis types the embedding
gather combines the token batch's ``dp`` entry (``data``) with the
embedding table's ``fsdp`` entry on d_model (``data`` too) into the
activation spec ``('data', None, 'data')``.  This package derives no
activation spec from its operands; the one rule here that could repeat an
axis — roles that share it, as in ``ShardingRules(fsdp="data",
dp=("data",))`` — keeps the first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["MESH_SIZES", "P", "ShardingRules", "param_specs",
           "batch_specs", "cache_specs", "seq_constrainer", "mesh_sizes_of",
           "generic_param_specs", "map_specs", "spec_axes", "spec_leaves",
           "placements", "distribute_tree", "Shards", "split_leaf",
           "join_leaf", "split_tree", "join_tree"]

Axis = Union[None, str, Tuple[str, ...]]

# Production mesh axis sizes: single pod (data=16, model=16) = 256
# devices, multi-pod adds (pod=2).
MESH_SIZES: Dict[str, int] = {"pod": 2, "data": 16, "model": 16}

def spec_axes(entry: Axis) -> Tuple[str, ...]:
    """The mesh axis names one spec entry names (none for ``None``)."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


class P(tuple):
    """A partition spec: one entry per tensor dimension, each ``None``
    (replicated), a mesh axis name, or a tuple of axis names.  The same
    entries as the JAX package's ``PartitionSpec``; an axis named twice is
    refused."""

    def __new__(cls, *entries: Axis):
        entries = tuple(tuple(e) if isinstance(e, list) else e
                        for e in entries)
        names = [a for e in entries for a in spec_axes(e)]
        if len(names) != len(set(names)):
            raise ValueError(f"P{entries!r} names a mesh axis twice")
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _axis_size(ax: Axis, sizes: Mapping[str, int]) -> int:
    """Number of shards an axis entry induces (1 for ``None``; products for
    multi-axis entries like ``("pod", "data")``)."""
    return math.prod(sizes[a] for a in spec_axes(ax))


def mesh_sizes_of(mesh) -> Dict[str, int]:
    """Axis-name → size mapping of a :class:`~repro_torch.dist.meshes.
    WorkerMesh` (for the divisibility gate)."""
    return dict(mesh.axes)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Role → mesh-axis assignment.  ``None`` disables a role."""

    fsdp: Optional[str] = None
    tp: Optional[str] = None
    dp: Tuple[str, ...] = ()
    seq: Optional[str] = None       # sequence parallelism (residual stream)
    pod: Optional[str] = None       # cross-pod axis == expert-parallel axis

    @classmethod
    def for_mesh(cls, multi_pod: bool) -> "ShardingRules":
        """Preset for the production meshes: FSDP over ``data``, tensor
        parallelism over ``model``; the multi-pod mesh adds the ``pod``
        axis to data parallelism and enables expert parallelism over it."""
        if multi_pod:
            return cls(fsdp="data", tp="model", dp=("pod", "data"),
                       seq=None, pod="pod")
        return cls(fsdp="data", tp="model", dp=("data",), seq=None, pod=None)

    @property
    def dp_axis(self) -> Axis:
        """The batch-dim spec entry: a bare axis name for one axis, a tuple
        for several, ``None`` when data parallelism is off."""
        if not self.dp:
            return None
        return self.dp if len(self.dp) > 1 else self.dp[0]


def seq_constrainer(rules: ShardingRules,
                    sizes: Optional[Mapping[str, int]] = None, mesh=None):
    """The residual-stream (B, S, D) sequence-parallel constraint, or
    ``None`` when ``rules.seq`` is off.  Passed to a model as its
    ``constrain``.

    Without ``mesh``: on a mesh where the sequence axis has one device it
    is the identity; a sequence split over several devices needs the
    ``torch.distributed`` mesh and raises.  With a ``DeviceMesh`` (the
    dry run's, a launcher rank's): a DTensor residual stream is
    redistributed to ``Shard(1)`` over ``rules.seq``, its other mesh
    dimensions unchanged; a plain tensor raises as above when that axis
    has more than one device."""
    if rules.seq is None:
        return None
    if mesh is None:
        sizes = MESH_SIZES if sizes is None else sizes
        if _axis_size(rules.seq, sizes) > 1:
            raise NotImplementedError(
                f"sequence parallelism over {_axis_size(rules.seq, sizes)} "
                "devices splits a DTensor residual stream: pass the "
                "torch.distributed DeviceMesh as mesh=")
        return lambda x: x
    from torch.distributed.tensor import DTensor, Shard
    names = mesh.mesh_dim_names
    seq_dims = [names.index(a) for a in spec_axes(rules.seq)]

    def constrain(x):
        if not isinstance(x, DTensor):
            if math.prod(mesh.size(d) for d in seq_dims) > 1:
                raise NotImplementedError(
                    "sequence parallelism splits a DTensor residual "
                    "stream; a plain tensor has no mesh to split over: "
                    "place the model's inputs on the DeviceMesh")
            return x
        target = list(x.placements)
        for d in seq_dims:
            target[d] = Shard(1)
        return x.redistribute(mesh, target)

    return constrain


def placements(spec: "P", mesh) -> List[Any]:
    """A spec's DTensor placements on a ``torch.distributed`` mesh:
    ``Shard(d)`` on each mesh dimension that entry ``d`` names,
    ``Replicate()`` on the others.  A tuple entry such as ``("pod",
    "data")`` shards one tensor dimension over several mesh dimensions,
    which must come in mesh order (the first outermost)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        dims = [names.index(a) for a in spec_axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"{spec!r}: entry {entry!r} is not in the "
                             f"mesh's axis order {names}")
        for m in dims:
            out[m] = Shard(d)
    return out


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh``, placed by
    its :class:`P` in ``specs`` (the same tree)."""
    from torch.distributed.tensor import distribute_tensor
    leaves = iter(spec_leaves(specs))
    return _map_with_names(lambda _names, x: distribute_tensor(
        x, mesh, placements(next(leaves), mesh)), tree)


# ---------------------------------------------------------------------------
# a tree at rest on a worker mesh: one process, a shard on each device
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Shards:
    """One tensor at rest on a worker mesh: ``pieces[i]`` is the shard
    that mesh device ``i`` (row-major over ``axes``) holds, a tensor of
    its own on that device.  A dimension whose :class:`P` entry names
    mesh axes is split into equal, contiguous chunks over them (several
    axes combine row-major, the first outermost); a device whose
    coordinates differ only on axes the spec does not name holds a copy
    of the same chunk.  ``shape`` is the whole tensor's."""

    pieces: Tuple[Any, ...]
    spec: P
    axes: Tuple[Tuple[str, int], ...]
    shape: Tuple[int, ...]


def _coords(i: int, axes: Sequence[Tuple[str, int]]) -> Dict[str, int]:
    """Mesh device ``i``'s coordinate on each axis (row-major)."""
    out: Dict[str, int] = {}
    for name, n in reversed(tuple(axes)):
        i, out[name] = divmod(i, n)
    return out


def _chunk(entry: Axis, coords: Mapping[str, int],
           sizes: Mapping[str, int]) -> int:
    """Which chunk of a dimension split by ``entry`` a device holds."""
    k = 0
    for a in spec_axes(entry):
        k = k * sizes[a] + coords[a]
    return k


def split_leaf(x, spec: P, axes: Sequence[Tuple[str, int]],
               devices: Sequence[Any]):
    """``x`` at rest on the mesh of ``devices`` (one per mesh position,
    row-major over ``axes``): a :class:`Shards` of its chunks by
    ``spec``, each a copy on its device; a leaf whose spec shards nothing
    stays whole, on ``devices[0]``."""
    axes = tuple((str(a), int(n)) for a, n in axes)
    sizes = dict(axes)
    if len(devices) != math.prod(sizes.values()):
        raise ValueError(f"{len(devices)} devices for a mesh of axes "
                         f"{sizes}")
    if all(e is None for e in spec):
        return x.to(devices[0])
    shape = tuple(x.shape)
    pieces = []
    for i, dev in enumerate(devices):
        c = _coords(i, axes)
        piece = x
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            n = _axis_size(entry, sizes)
            if shape[d] % n:
                raise ValueError(f"{spec!r} splits dimension {d} of "
                                 f"{shape} into {n}")
            step = shape[d] // n
            piece = piece.narrow(d, _chunk(entry, c, sizes) * step, step)
        pieces.append(piece.to(dev, copy=True))
    return Shards(tuple(pieces), P(*spec), axes, shape)


def join_leaf(x, device):
    """A leaf of :func:`split_leaf` whole on ``device``: the shards
    concatenated in order (pure data movement; the values are the
    leaf's bits).  A whole leaf is moved there (itself if it is there)."""
    if not isinstance(x, Shards):
        return x.to(device)
    sizes = dict(x.axes)
    dims = [d for d, e in enumerate(x.spec) if e is not None]
    first: Dict[Tuple[int, ...], int] = {}
    for i in range(len(x.pieces)):
        c = _coords(i, x.axes)
        first.setdefault(tuple(_chunk(x.spec[d], c, sizes) for d in dims), i)

    def assemble(level: int, prefix: Tuple[int, ...]):
        if level == len(dims):
            return x.pieces[first[prefix]].to(device)
        d = dims[level]
        return torch.cat([assemble(level + 1, prefix + (j,))
                          for j in range(_axis_size(x.spec[d], sizes))], d)

    return assemble(0, ())


def split_tree(tree: Any, specs: Any, axes: Sequence[Tuple[str, int]],
               devices: Sequence[Any]) -> Any:
    """Every tensor leaf of ``tree`` at rest by its :class:`P` in
    ``specs`` (:func:`split_leaf`)."""
    leaves = iter(spec_leaves(specs))
    return _map_with_names(lambda _names, x: split_leaf(
        x, next(leaves), axes, devices), tree)


def join_tree(tree: Any, device) -> Any:
    """Every leaf of a :func:`split_tree` tree whole on ``device``."""
    return _map_with_names(lambda _names, x: join_leaf(x, device), tree)


# ---------------------------------------------------------------------------
# tree walking and spec assembly
# ---------------------------------------------------------------------------


def _map_with_names(fn, tree: Any, names: Tuple[str, ...] = ()) -> Any:
    """``fn(names, leaf)`` over a dict / list / tuple tree; ``names`` are
    the dict keys on the way down (list indices skipped, as the JAX
    package's key paths are read)."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = [_map_with_names(fn, v, names) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(names, tree)


def map_specs(fn, specs: Any) -> Any:
    """``fn(spec)`` over the :class:`P` leaves of a spec tree."""
    return _map_with_names(lambda _names, p: fn(p), specs)


def spec_leaves(specs: Any) -> List[P]:
    """The :class:`P` leaves of a spec tree, in tree order."""
    out: List[P] = []
    map_specs(out.append, specs)
    return out


def _spec(leaf, roles: Sequence[Axis], n_lead: int,
          sizes: Mapping[str, int]) -> P:
    """Pad ``roles`` to the leaf's rank (leading stack dims and trailing
    dims replicated), drop any axis failing the divisibility gate, and
    drop an axis an earlier dimension already names."""
    shape = tuple(leaf.shape)
    axes = [None] * n_lead + list(roles)
    if len(axes) > len(shape):
        raise ValueError(f"role tuple {roles} too long for shape {shape}")
    axes += [None] * (len(shape) - len(axes))
    out, used = [], set()
    for dim, ax in zip(shape, axes):
        names = spec_axes(ax)
        if (ax is None or dim % _axis_size(ax, sizes) != 0
                or used.intersection(names)):
            out.append(None)
            continue
        used.update(names)
        out.append(ax)
    return P(*out)


# ---------------------------------------------------------------------------
# parameters (and optimizer-state trees, which mirror the param tree)
# ---------------------------------------------------------------------------


def _param_roles(names: Tuple[str, ...], base_rank: int,
                 rules: ShardingRules) -> Tuple[Axis, ...]:
    """Placement roles for a parameter leaf, keyed on its dict-path names.

    ``base_rank`` is the leaf rank minus the stacked-cycle dim, which
    disambiguates the MoE (E, D, F) from the dense (D, F) FFN layout."""
    name = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    fsdp, tp, ep = rules.fsdp, rules.tp, rules.pod

    # top-level tensors (same names inside optimizer-state subtrees)
    if name == "embed":
        return (tp, fsdp)                         # (vocab, d_model)
    if name == "lm_head":
        return (fsdp, tp)                         # (d_model, vocab)
    if name == "frontend_proj":
        return (None, fsdp)                       # (frontend_dim, d_model)

    if parent == "attn":
        if name in ("wq", "wk", "wv"):
            return (fsdp, tp, None)               # (D, heads, head_dim)
        if name == "wo":
            return (tp, None, fsdp)               # (heads, head_dim, D)
        if name in ("bq", "bk", "bv"):
            return (tp, None)
        return ()                                 # q_norm / k_norm

    if parent in ("ffn", "shared"):
        if name in ("wi", "wg"):
            return ((ep, fsdp, tp) if base_rank == 3   # MoE (E, D, F)
                    else (fsdp, tp))                   # dense (D, F)
        if name == "wo":
            return ((ep, tp, fsdp) if base_rank == 3   # MoE (E, F, D)
                    else (tp, fsdp))                   # dense (F, D)
        if name == "router":
            return (fsdp, None)                   # (D, E) — small, fp32
        return ()

    if parent == "rglru":
        if name in ("w_in", "w_gate"):
            return (fsdp, tp)                     # (D, W)
        if name == "w_out":
            return (tp, fsdp)                     # (W, D)
        if name == "conv_w":
            return (None, tp)                     # (K, W) depthwise conv
        return ()                                 # lam / g_r

    if parent == "ssm":
        if name in ("in_z", "in_x"):
            return (fsdp, tp)                     # (D, inner)
        if name in ("in_B", "in_C", "in_dt"):
            return (fsdp, None)                   # B/C/dt small: replicate
        if name == "conv_x":
            return (None, tp)                     # (K, inner)
        if name == "out_proj":
            return (tp, fsdp)                     # (inner, D)
        return ()                                 # convs/A_log/D/gate_norm

    return ()                                     # norms and anything unknown


def param_specs(shapes: Any, rules: ShardingRules,
                sizes: Optional[Mapping[str, int]] = None) -> Any:
    """Spec tree for an ``LM`` parameter tree (or an optimizer state that
    mirrors it).  ``shapes`` is any tree of shaped leaves."""
    sizes = MESH_SIZES if sizes is None else sizes

    def leaf_spec(names, leaf):
        n_lead = 1 if "cycles" in names else 0
        roles = _param_roles(names, len(leaf.shape) - n_lead, rules)
        return _spec(leaf, roles, n_lead, sizes)

    return _map_with_names(leaf_spec, shapes)


def generic_param_specs(shapes: Any, rules: ShardingRules,
                        sizes: Optional[Mapping[str, int]] = None,
                        n_lead: int = 0) -> Any:
    """Best-effort at-rest placement for *arbitrary* parameter trees (tasks
    the name-keyed :func:`param_specs` table does not know — ResNets, MLPs,
    anything a worker mesh hosts).

    Per leaf: the largest dimension passing the divisibility gate shards
    over ``rules.fsdp``, the largest remaining one over ``rules.tp``;
    everything else (and any leaf nothing divides on) replicates.  Roles
    whose mesh axis is absent from ``sizes`` are skipped, so the single-
    axis worker meshes reuse the production preset unchanged.  The first
    ``n_lead`` dims (member-stacked group carries) are never sharded."""
    sizes = MESH_SIZES if sizes is None else sizes
    roles = []
    for ax in (rules.fsdp, rules.tp):
        names = spec_axes(ax)
        if (names and all(a in sizes for a in names)
                and _axis_size(ax, sizes) > 1
                and not any(set(names) & set(spec_axes(r)) for r in roles)):
            roles.append(ax)

    def leaf_spec(_names, leaf) -> P:
        shape = tuple(leaf.shape)
        axes: list = [None] * len(shape)
        free = list(range(n_lead, len(shape)))
        for ax in roles:
            n = _axis_size(ax, sizes)
            cands = [i for i in free if shape[i] % n == 0 and shape[i] > 0]
            if not cands:
                continue
            pick = max(cands, key=lambda i: shape[i])
            axes[pick] = ax
            free.remove(pick)
        return P(*axes)

    return _map_with_names(leaf_spec, shapes)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, batch: Any, rules: ShardingRules,
                sizes: Optional[Mapping[str, int]] = None) -> Any:
    """Specs for a training/prefill batch struct (see
    :func:`repro_torch.launch.specs.batch_struct`): batch dim over ``dp``,
    everything else replicated (sequence parallelism enters via the
    residual-stream constraint, not the input placement)."""
    sizes = MESH_SIZES if sizes is None else sizes
    dp = rules.dp_axis

    def leaf_spec(names, leaf):
        name = names[-1] if names else ""
        if name == "positions":                   # (3, B, S) M-RoPE ids
            return _spec(leaf, (None, dp), 0, sizes)
        return _spec(leaf, (dp,), 0, sizes)       # tokens/labels/features/...

    return _map_with_names(leaf_spec, batch)


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, cache: Any, rules: ShardingRules,
                global_batch: int,
                sizes: Optional[Mapping[str, int]] = None) -> Any:
    """Specs for an ``LM.init_cache`` tree (any tree of shaped leaves with
    its keys): batch dim over ``dp`` (dropped when ``global_batch`` does
    not divide, e.g. the batch-1 ``long_500k`` shape), KV-head / SSM-head
    / recurrence-width dims over ``tp``."""
    sizes = MESH_SIZES if sizes is None else sizes
    dp: Axis = rules.dp_axis
    if dp is not None and global_batch % _axis_size(dp, sizes) != 0:
        dp = None
    tp = rules.tp

    def leaf_spec(names, leaf):
        name = names[-1] if names else ""
        n_lead = 1 if "cycles" in names else 0
        if name in ("k", "v"):                    # (B, L, n_kv, head_dim)
            roles: Tuple[Axis, ...] = (dp, None, tp, None)
        elif name == "h":                         # RG-LRU state (B, W)
            roles = (dp, tp)
        elif name == "state":                     # SSD state (B, H, P, N)
            roles = (dp, tp, None, None)
        elif name == "conv":                      # RG-LRU conv (B, K-1, W)
            roles = (dp, None, tp)
        elif names[-2:-1] == ("conv",):           # SSD conv streams
            roles = (dp, None, tp) if name == "x" else (dp, None, None)
        else:
            roles = (dp,)
        return _spec(leaf, roles, n_lead, sizes)

    return _map_with_names(leaf_spec, cache)
