"""Dry run: every (arch × shape × mesh) case at production size, abstract.

The counterpart of ``repro/launch/dryrun.py``.  A production case builds
the step of its shape (train, prefill or serve) on the production mesh —
256 ranks (16 × 16) or 512 (2 × 16 × 16), a fake process group with this
process as rank 0 (:mod:`repro_torch.launch.mesh`) — over fake tensors,
and runs it once: that is the proof that rules → specs → placement → step
are coherent for all ten architectures and four shapes (hubert's two
decode shapes skipped by design), and its counts feed the roofline
(:mod:`repro_torch.analysis.roofline`).  ``--reduced`` instead runs each
architecture's reduced variant **for real** on the local device (the card
unless ``--device cpu``), with its kernels.

Usage::

    python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out r.jsonl]
    python -m repro_torch.launch.dryrun --reduced --device cpu --all

The arguments, the record keys, statuses and skip reasons, the
``cheap_first`` order, ``--out`` / ``--skip-done``, the summary line and
the exit status are the reference's.  Eager PyTorch has no layer scan:
``--scan`` is accepted and changes nothing, every record says
``"layer_scan": false``, and every count is per layer (the reference's
scanned body is counted once by XLA).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import math
import os
import time
import traceback
import warnings
import weakref
from collections import Counter
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (SHAPES, config_for_shape, get_config,
                                 list_archs, shape_applicable)
from repro_torch.dist.meshes import WorkerMesh
from repro_torch.dist.sharding import (P, ShardingRules, batch_specs,
                                       cache_specs, distribute_tree,
                                       param_specs, seq_constrainer,
                                       spec_axes)
from repro_torch.kernels.flash_attention import (flash_attention_bwd_dkv,
                                                 flash_attention_bwd_dq,
                                                 flash_attention_fwd)
from repro_torch.kernels.optim import stacked_tree_update
from repro_torch.kernels.ssd_scan import ssd_intra_bwd, ssd_intra_fwd
from repro_torch.launch.mesh import production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models.transformer import LM
from repro_torch.train.optimizer import apply_update, init_opt_state
from repro_torch.train.step import (build_prefill_step, build_serve_step,
                                    build_train_step, place, shardings_for)
from repro_torch.train.torch_trainer import value_and_grad
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["run_case", "case_config", "main", "COLLECTIVES", "LAUNCH_COUNTERS",
           "NO_RULE", "OpRecorder"]

#: the collective kinds of the reference's ``collective_bytes_from_hlo``
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}

#: each kernel's launch counter: B1 the update, B2–B4 attention, B5–B6 SSD
LAUNCH_COUNTERS = {"B1": stacked_tree_update, "B2": flash_attention_fwd,
                   "B3": flash_attention_bwd_dq,
                   "B4": flash_attention_bwd_dkv, "B5": ssd_intra_fwd,
                   "B6": ssd_intra_bwd}

REDUCED_BATCH, REDUCED_SEQ = 4, 64

_aten = torch.ops.aten
#: ops that move no bytes: an in-place detach, a tensor's device query
_NO_TRAFFIC = (_aten.detach_.default, torch.ops.prim.device.default)
#: the ops DTensor refuses in the sweeps, which ``OpRecorder`` runs on
#: replicated operands (ROADMAP queue C item 23): recurrentgemma's
#: ``log_sigmoid`` (no rule), the GQA ``view`` that splits model-sharded
#: q heads into (kv heads, group) off whole groups, ``argmax`` of
#: vocabulary-sharded logits (its rule reads index values a fake tensor
#: lacks), the MoE decode's ``bmm`` over experts split on ``pod``; on
#: torch 2.11 also ``_unsafe_view`` of strided-shard products and
#: ``flip``.  Any other refusal fails the case.
NO_RULE = frozenset({_aten.log_sigmoid_forward, _aten.log_sigmoid_backward,
                     _aten.view, _aten._unsafe_view, _aten.argmax,
                     _aten.bmm, _aten.flip})


def _nbytes(tree) -> int:
    """Bytes of the tensors in ``tree``; a DTensor counts its local shard
    (rank 0's)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for x in torch.utils._pytree.tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x._local_tensor
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


class OpRecorder(TorchDispatchMode):
    """What rank 0 runs, counted below DTensor on its local tensors.

    * ``flops``: what ``torch.utils.flop_counter.FlopCounterMode`` counts
      (products, convolutions, attention), with its decompositions.
    * ``bytes``: each local op's input plus output bytes, views (and an
      in-place detach, a device query) excluded: what eager execution
      moves, with no fusion.
    * ``collectives``: bytes of each functional collective, as
      ``max(Σ operand bytes, result bytes)`` (the reference's rule), and
      ``counts``.
    * ``peak``: the most bytes held at once by the storages the counted
      ops made (an operand's storage, written in place, is not new).

    DTensor ops are policed first, above DTensor: a ``Partial`` operand is
    reduced to ``Replicate`` (an all-reduce) before the op reads it, as a
    row-parallel product's output is in Megatron-style tensor parallelism,
    so DTensor never picks a reduce-scatter that leaves the residual
    stream sharded where later ops cannot follow; a product over strided
    shards (:meth:`_local_batched`, :meth:`_local_mm`) and decode's cache
    write (:func:`_local_index_copy`) run on the local shards, an in-place
    detach is a no-op; an op of ``NO_RULE`` that DTensor refuses runs on
    its operands replicated, and is counted in ``replicated``; any other
    refusal raises.  DTensor's own shape propagation is not counted.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: 0.0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}
        self.replicated: Counter = Counter()
        self.live = 0                   # bytes of the storages ops made
        self.peak = 0
        self._alive: Dict[int, int] = {}
        self._depth = 0
        self._pass = None
        self._propagating = 0
        self._unpatch = None

    def __enter__(self):
        if self._depth == 0:
            self._patch_propagation()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *args):
        self._depth -= 1
        if self._depth == 0:
            self._unpatch()
        return super().__exit__(*args)

    def _patch_propagation(self):
        """DTensor derives each op's global output shape by running it on
        global-shape fake tensors, in the caller's fake mode: those runs
        are not rank 0's work, so they are flagged and not counted."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        # the uncached method where this release has one, else the one
        name = next(n for n in ("_propagate_tensor_meta_non_cached",
                                "_propagate_tensor_meta") if n in SP.__dict__)
        orig = SP.__dict__[name]

        def flagged(prop, op_schema):
            self._propagating += 1
            try:
                return orig(prop, op_schema)
            finally:
                self._propagating -= 1

        setattr(SP, name, flagged)
        self._unpatch = lambda: setattr(SP, name, orig)

    def _allocated(self, out, args, kwargs) -> None:
        """Add the storages ``out`` holds that no operand holds to the live
        bytes; each leaves them when it is freed."""
        seen = {x.untyped_storage()._cdata
                for x in torch.utils._pytree.tree_leaves((args, kwargs))
                if isinstance(x, torch.Tensor)}
        for t in torch.utils._pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._alive:
                continue
            n = st.nbytes()
            self._alive[key] = n
            self.live += n
            weakref.finalize(st, self._freed, key)
        self.peak = max(self.peak, self.live)

    def _freed(self, key) -> None:
        self.live -= self._alive.pop(key, 0)

    def record(self) -> Dict[str, Any]:
        coll = dict(self.collectives)
        coll["total"] = sum(self.collectives.values())
        coll["counts"] = dict(self.counts)
        return {"cost": {"flops": float(self.flops),
                         "bytes accessed": float(self.bytes)},
                "collectives": coll}

    # ------------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._pass is func:          # our own re-dispatch: DTensor's
                self._pass = None
                return NotImplemented
            return self._distributed(func, args, kwargs)
        if self._propagating or \
                func is torch.ops._c10d_functional.wait_tensor.default:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        kind = (_FUNCTIONAL.get(packet.__name__)
                if func.namespace == "_c10d_functional" else None)
        if kind is not None:
            out = func(*args, **kwargs)
            self.collectives[kind] += max(_nbytes((args, kwargs)),
                                          _nbytes(out))
            self.counts[kind] += 1
            self._allocated(out, args, kwargs)
            return out
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:                      # as FlopCounterMode counts
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not (func.is_view or func in _NO_TRAFFIC):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            self._allocated(out, args, kwargs)
        return out

    def _distributed(self, func, args, kwargs):
        from torch.distributed.tensor import DTensor
        with self, torch.no_grad():
            args, kwargs = tree_map_only(DTensor, _reduce_partial,
                                         (args, kwargs))
            for rule in (self._local_batched, self._local_mm,
                         _local_index_copy, _detach_in_place):
                local = rule(func, args, kwargs)
                if local is not None:
                    return local
            self._pass = func
            try:
                return func(*args, **kwargs)
            except (RuntimeError, NotImplementedError):
                if func._schema.is_mutable or \
                        func._overloadpacket not in NO_RULE:
                    raise
                self.replicated[str(func._overloadpacket)] += 1
            finally:
                self._pass = None
            return self._run_replicated(func, args, kwargs)

    def _run_replicated(self, func, args, kwargs):
        """``func`` on its DTensor operands gathered whole; the outputs are
        replicated DTensors."""
        from torch.distributed.tensor import DTensor, Replicate
        mesh = next(x.device_mesh for x in torch.utils._pytree.tree_leaves(
            (args, kwargs)) if isinstance(x, DTensor))
        whole = [Replicate()] * mesh.ndim
        args, kwargs = tree_map_only(DTensor, self._whole, (args, kwargs))
        out = func(*args, **kwargs)
        return tree_map_only(torch.Tensor, lambda t: DTensor.from_local(
            t, mesh, whole, run_check=False), out)

    def _whole(self, x):
        """``x`` gathered on every mesh dimension, as a local tensor."""
        return self._gathered(x, range(x.device_mesh.ndim))._local_tensor

    def _gathered(self, x, dims):
        """``x`` gathered (``Replicate``) on the mesh dimensions ``dims``.
        A fake shard (a production case) carries no data, and DTensor's
        own gather of a strided shard reads index values fake tensors do
        not have: so each sharded dimension's all-gather is counted by
        the same rule (its result's bytes), innermost first, and the
        gathered shard is a fresh tensor of its local shape."""
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor, Replicate
        mesh = x.device_mesh
        dims = [d for d in dims if not x.placements[d].is_replicate()]
        if not dims:
            return x
        target = [Replicate() if d in dims else p
                  for d, p in enumerate(x.placements)]
        t = x._local_tensor
        if not isinstance(t, FakeTensor):
            return x.redistribute(mesh, target)
        n = t.numel() * t.element_size()
        for d in sorted(dims, reverse=True):
            n *= mesh.size(d)
            self.collectives["all-gather"] += n
            self.counts["all-gather"] += 1
        local = list(x.shape)
        for d, p in enumerate(target):
            if _shard_dim(p) is not None:
                local[_shard_dim(p)] //= mesh.size(d)
        return DTensor.from_local(torch.empty(local, dtype=x.dtype), mesh,
                                  target, run_check=False, shape=x.shape,
                                  stride=x.stride())

    def _local_batched(self, func, args, kwargs):
        """``bmm(a, b)`` on the local shards where DTensor's rule refuses the
        strided shards that merging a data-sharded batch with model-sharded
        heads (or ``seqpar``'s model-sharded sequence) gives, though each
        rank's product is then its own.  ``b`` is first gathered on the mesh
        dimensions where ``a`` shards its rows and ``b`` its columns or the
        contraction (sequence parallelism's all-gather of K and V).  On each
        mesh dimension: both operands shard the batch alike, or one shards it
        and the other is a replica; or ``a`` shards its rows (``b`` a
        replica), or ``b`` its columns (``a`` a replica); or both split the
        contraction alike (a partial sum); or both are replicas.  Where a
        replica meets a batch shard, rank 0 takes its rows of the replica:
        on fake tensors (a production case) only how many rows that is
        matters, and the replica's leading rows stand for them; real
        tensors are left to DTensor."""
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor, Partial, Replicate
        if func is not torch.ops.aten.bmm.default or kwargs:
            return None
        a, b = args
        if not (isinstance(a, DTensor) and isinstance(b, DTensor)
                and a.device_mesh == b.device_mesh):
            return None
        gather = [d for d, (pa, pb) in enumerate(zip(a.placements,
                                                     b.placements))
                  if _shard_dim(pa) == 1 and _shard_dim(pb) in (1, 2)]
        mesh, placements, batch_shards = a.device_mesh, [], 1
        for d, (pa, pb) in enumerate(zip(a.placements, b.placements)):
            if d in gather:
                pb = Replicate()
            da, db = _shard_dim(pa), _shard_dim(pb)
            if da == db and da in (None, 0) and pa == pb:
                placements.append(pa)
            elif (da, db) in ((0, None), (1, None)):
                placements.append(pa)
            elif (da, db) == (None, 0):
                placements.append(pb)
            elif (da, db) == (None, 2):
                placements.append(pb)
            elif (da, db) == (2, 1) and type(pa) is type(pb) and getattr(
                    pa, "split_factor", 1) == getattr(pb, "split_factor", 1):
                placements.append(Partial())      # the contraction is split
            else:
                return None
            if _shard_dim(placements[-1]) == 0:
                batch_shards *= mesh.size(d)
        if a.shape[0] % batch_shards:
            return None
        b = self._gathered(b, gather)
        rows = a.shape[0] // batch_shards
        local = []
        for x in (a, b):
            t = x._local_tensor
            if t.shape[0] != rows:
                if not isinstance(t, FakeTensor):
                    return None
                t = t.narrow(0, 0, rows)
            local.append(t)
        out = func(*local)
        shape = (a.shape[0], a.shape[1], b.shape[2])
        return DTensor.from_local(out, mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=(shape[1] * shape[2], shape[2], 1))

    def _local_mm(self, func, args, kwargs):
        """``mm(a, b)`` on the local shards where an operand is a strided
        shard (``seqpar``'s sequence-sharded residual stream with batch
        and sequence merged), which DTensor's rule refuses.  On each mesh
        dimension: ``a`` shards its rows (``b`` a replica), or ``b`` its
        columns (``a`` a replica), or both split the contraction alike (a
        partial sum), or both are replicas; where ``a`` shards its rows
        and ``b`` its columns, ``a`` is gathered there first (sequence
        parallelism's all-gather before a column-parallel product)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from torch.distributed.tensor.placement_types import _StridedShard
        if func is not torch.ops.aten.mm.default or kwargs:
            return None
        a, b = args
        if not (isinstance(a, DTensor) and isinstance(b, DTensor)
                and a.device_mesh == b.device_mesh) or not any(
                    isinstance(p, _StridedShard)
                    for p in a.placements + b.placements):
            return None
        a = self._gathered(a, [
            d for d, (pa, pb) in enumerate(zip(a.placements, b.placements))
            if (_shard_dim(pa), _shard_dim(pb)) == (0, 1)])
        placements = []
        for pa, pb in zip(a.placements, b.placements):
            da, db = _shard_dim(pa), _shard_dim(pb)
            if (da, db) == (None, None):
                placements.append(Replicate())
            elif (da, db) == (0, None):
                placements.append(pa)
            elif (da, db) == (None, 1):
                placements.append(pb)
            elif (da, db) == (1, 0) and type(pa) is type(pb) and getattr(
                    pa, "split_factor", 1) == getattr(pb, "split_factor", 1):
                placements.append(Partial())
            else:
                return None
        out = func(a._local_tensor, b._local_tensor)
        shape = (a.shape[0], b.shape[1])
        return DTensor.from_local(out, a.device_mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=(shape[1], 1))


def _reduce_partial(x):
    """``x`` with every ``Partial`` mesh dimension reduced to
    ``Replicate``."""
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def _shard_dim(p) -> Optional[int]:
    """The tensor dimension a (possibly strided) shard splits; None for a
    replica; -1 for anything else (a partial sum)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    if p.is_replicate():
        return None
    return p.dim if isinstance(p, (Shard, _StridedShard)) else -1


class ShardedLM(LM):
    """``LM`` as a production case runs it, on ``mesh``: the mean NLL is
    the vocabulary-parallel cross-entropy (a max, a sum of exponentials
    and the label's logit picked by a comparison with the vocabulary
    ids, each reduced over the vocabulary's shards) — the value
    ``LM.loss``'s ``log_softmax`` + ``gather`` gives.  DTensor would
    gather the whole vocabulary for ``log_softmax``, and the gather's
    backward scatters into zeros the shape of the logits that it makes
    whole on every rank (for qwen2-0.5b's ``train_4k``, 256 × 4,095 ×
    151,936 f32 values); DTensor's ``loss_parallel`` takes a
    one-dimensional mesh only."""

    def __init__(self, cfg, mesh, **kw):
        super().__init__(cfg, **kw)
        self.mesh = mesh

    def _nll(self, logits, labels):
        from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                              distribute_tensor)
        vocab = torch.arange(logits.shape[-1])
        if isinstance(logits, DTensor):       # split as the logits' last dim
            last = logits.ndim - 1
            vocab = distribute_tensor(vocab, self.mesh, [
                Shard(0) if p.is_shard(last) else Replicate()
                for p in logits.placements])
        z = logits - logits.detach().amax(-1, keepdim=True)
        sums = self._reduced(torch.exp(z).sum(-1))
        picked = self._reduced((z * (labels[..., None] == vocab)).sum(-1))
        return torch.mean(torch.log(sums) - picked)

    def _reduced(self, x):
        """``x``'s partial sums over the vocabulary's shards reduced where
        autograd sees it, so its gradient comes back split on the batch as
        the tokens are, not whole (a replicated gradient, broadcast over
        the vocabulary, would be materialised batch-whole first)."""
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])


def _detach_in_place(func, args, kwargs):
    """``x.detach_()`` on a DTensor: nothing is left to do below autograd,
    and not every DTensor release has a rule for it."""
    from torch.distributed.tensor import DTensor
    if func is torch.ops.aten.detach_.default and isinstance(args[0],
                                                             DTensor):
        return args[0]
    return None


def _local_index_copy(func, args, kwargs):
    """``cache.index_copy_(dim, slot, new)`` (decode's write) on the local
    shards when no mesh dimension shards ``dim`` and the slot is a
    replica: each rank writes its own rows.  ``new`` is first placed as
    the cache is (a replica split where the cache is split: no
    communication).  Not every DTensor release has a rule for it."""
    from torch.distributed.tensor import DTensor
    if func is not torch.ops.aten.index_copy_.default or kwargs:
        return None
    dst, dim, index, src = args
    if not all(isinstance(x, DTensor) for x in (dst, index, src)):
        return None
    dim %= dst.ndim
    if any(_shard_dim(p) in (dim, -1) for p in dst.placements) or \
            not all(p.is_replicate() for p in index.placements):
        return None
    if src.placements != dst.placements:
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst._local_tensor.index_copy_(dim, index._local_tensor, src._local_tensor)
    return dst


def fsdp_gather(mesh, rules: ShardingRules):
    """The model's ``gather`` for a production case: each DTensor weight
    gathered (``Replicate``) on the mesh dimensions of ``rules.fsdp``
    just before the arithmetic reads it, its tensor-parallel shards kept;
    ``whole=True`` (the embedding table before the lookup) gathers every
    dimension.  Its backward is a reduce-scatter of each gradient."""
    from torch.distributed.tensor import DTensor, Replicate
    names = mesh.mesh_dim_names
    fsdp = {names.index(a) for a in spec_axes(rules.fsdp)}

    def gather(tree, whole: bool = False):
        def one(x):
            if not isinstance(x, DTensor):
                return x
            target = [Replicate() if whole or d in fsdp else p
                      for d, p in enumerate(x.placements)]
            if target == list(x.placements):
                return x
            return x.redistribute(mesh, target)
        return tree_map(one, tree)

    return gather


@contextlib.contextmanager
def _quiet():
    """DTensor's notes on its own choices (all-to-all as all-gather on a
    CPU mesh, sequential all-reduces, implicit replication of one-element
    tensors) are not the case's output."""
    log = logging.getLogger("torch.distributed.tensor")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*non-scalar tensor")
            yield
    finally:
        log.setLevel(level)


def _fakes(tree):
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype), tree)


def _production(rec, cfg, shape, rules, multi_pod) -> None:
    """Build, place and run one production case's step over fake tensors
    on the production mesh; fill ``rec``'s timings, counts, memory and
    collectives."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.time()
    with production_mesh(multi_pod=multi_pod) as mesh, _quiet():
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        model = ShardedLM(cfg, mesh,
                          constrain=seq_constrainer(rules, sizes, mesh),
                          gather=fsdp_gather(mesh, rules))
        with torch.device("meta"):
            pshape = model.init(0)
        kind, kw = input_specs(cfg, shape)
        oshape = init_opt_state("adamw", pshape) if kind == "train" else None
        with FakeTensorMode():
            params = distribute_tree(_fakes(pshape), param_specs(
                pshape, rules, sizes), mesh)
            scalar = lambda dt: distribute_tensor(
                torch.zeros((), dtype=dt), mesh, [Replicate()] * mesh.ndim)
            if kind == "train":
                opt = distribute_tree(_fakes(oshape), param_specs(
                    oshape, rules, sizes), mesh)
                batch = distribute_tree(_fakes(kw["batch"]), batch_specs(
                    cfg, kw["batch"], rules, sizes), mesh)
                fn = build_train_step(model, use_kernel=False)
                args = (params, opt, batch, scalar(torch.float32),
                        scalar(torch.int64))
            elif kind == "prefill":
                batch = distribute_tree(_fakes(kw["batch"]), batch_specs(
                    cfg, kw["batch"], rules, sizes), mesh)
                fn, args = build_prefill_step(model), (params, batch)
            else:
                cache = distribute_tree(_fakes(kw["cache"]), cache_specs(
                    cfg, kw["cache"], rules, shape.global_batch, sizes),
                    mesh)
                dp = rules.dp_axis if shape.global_batch > 1 else None
                tokens = distribute_tree(
                    torch.zeros(kw["tokens"].shape, dtype=torch.int64),
                    P(dp, None), mesh)
                fn = build_serve_step(model)
                args = (params, cache, tokens, scalar(torch.int64))
            rec["lower_s"] = round(time.time() - t0, 2)

            t1 = time.time()
            recorder = OpRecorder()
            with implicit_replication(), recorder:
                out = fn(*args)
            rec["compile_s"] = round(time.time() - t1, 2)
            rec.update(recorder.record())
            rec["memory"] = {"argument_size_in_bytes": _nbytes(args),
                             "output_size_in_bytes": _nbytes(out),
                             "temp_size_in_bytes": recorder.peak}
            if recorder.replicated:
                rec["replicated"] = dict(recorder.replicated)


# ---------------------------------------------------------------- reduced
def _reduced_inputs(cfg, shape, device) -> Tuple[str, Dict]:
    """A reduced case's real inputs, drawn from seed 0 on the host: the
    batch of ``input_specs`` (token ids, frames or patches in the model's
    dtype, M-RoPE ids), or a zeroed cache, tokens and a position."""
    kind, kw = input_specs(cfg, shape)
    gen = torch.Generator().manual_seed(0)

    def draw(name, m):
        if name == "positions":             # (3, B, S): text-like ids
            pos = torch.arange(m.shape[-1])
            return pos.expand(*m.shape).contiguous()
        if m.dtype == torch.int64:
            return torch.randint(0, cfg.vocab_size, tuple(m.shape),
                                 generator=gen)
        return torch.randn(tuple(m.shape), generator=gen).to(m.dtype)

    if kind == "decode":
        model = LM(cfg)
        out = {"cache": model.init_cache(shape.global_batch, shape.seq_len,
                                         device=device),
               "tokens": draw("tokens", kw["tokens"]).to(device),
               "index": torch.tensor(shape.seq_len // 2, device=device)}
        return kind, out
    return kind, {"batch": {k: draw(k, m).to(device)
                            for k, m in kw["batch"].items()}}


def _launches() -> Dict[str, int]:
    return {k: fn.launches for k, fn in LAUNCH_COUNTERS.items()}


def _max_diff(a, b) -> float:
    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    return max((float((x.float() - y.float()).abs().max())
                for x, y in pairs), default=0.0)


_HP = {"lr": 3e-4, "wd": 0.1, "b1": 0.9, "b2": 0.95}     # build_train_step's


def _reduced(rec, cfg, shape, rules, device) -> None:
    """One step of the shape's kind for real on ``device``'s (1, 1) mesh:
    the counts from the plain step; memory and launches from the step
    that runs (on the card the kernels'); then, on the card, the kernels'
    outputs against the plain path's on the same parameters and inputs
    (outside the counts): the loss and gradients, or the logits, and the
    kernel step's new parameters and AdamW moments against
    ``apply_update`` on the gradients of the kernels' model (recomputed:
    the kernels are deterministic)."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.time()
    mesh = WorkerMesh.build([0], axes=(("data", 1), ("model", 1)))
    params = LM(cfg).init(0)
    params = place(params, shardings_for([device], param_specs(
        params, rules, mesh.sizes)))
    kind, inputs = _reduced_inputs(cfg, shape, device)
    opt = init_opt_state("adamw", params) if kind == "train" else None
    rec["lower_s"] = round(time.time() - t0, 2)

    def run_step(model):
        if kind == "train":
            return build_train_step(model)(params, opt, inputs["batch"],
                                           _HP["lr"], 0)
        if kind == "prefill":
            return build_prefill_step(model)(params, inputs["batch"])
        return build_serve_step(model)(params, tree_map(
            torch.clone, inputs["cache"]), inputs["tokens"], inputs["index"])

    def compared(model):
        if kind == "train":
            (loss, _), grads = value_and_grad(model.loss, params,
                                              inputs["batch"])
            return loss, grads
        if kind == "prefill":
            return build_prefill_step(model)(params, inputs["batch"])
        with torch.no_grad():
            return model.decode_step(params, tree_map(
                torch.clone, inputs["cache"]), inputs["tokens"],
                inputs["index"])[0]

    t1 = time.time()
    arg_bytes = _nbytes((params, opt, inputs))
    recorder = OpRecorder()
    if not cuda:
        with recorder:
            out = run_step(LM(cfg))
        rec.update(recorder.record())
        rec["launches"] = {k: 0 for k in LAUNCH_COUNTERS}
    else:
        with recorder:
            run_step(LM(cfg))
        sync()
        rec.update(recorder.record())
        torch.cuda.reset_peak_memory_stats(device)
        before = _launches()
        out = run_step(LM(cfg, use_kernel=True))
        sync()
        rec["launches"] = {k: v - before[k] for k, v in _launches().items()}
    rec["collectives"] = {**{k: 0.0 for k in COLLECTIVES}, "total": 0.0,
                          "counts": {k: 0 for k in COLLECTIVES}}
    temp = (torch.cuda.max_memory_allocated(device) - arg_bytes if cuda
            else recorder.peak)
    rec["compile_s"] = round(time.time() - t1, 2)
    rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                     "output_size_in_bytes": _nbytes(out),
                     "temp_size_in_bytes": max(0, temp)}
    if cuda:
        got, plain = compared(LM(cfg, use_kernel=True)), compared(LM(cfg))
        if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(
                (got, out))):
            raise FloatingPointError("the kernel step gave non-finite values")
        if kind == "train":
            want = apply_update("adamw", params, got[1], opt, _HP, 0)
            rec["kernel_vs_plain"] = {
                "loss": abs(float(got[0]) - float(plain[0])),
                "grads": _max_diff(got[1], plain[1]),
                "update": _max_diff(out[:2], want)}
        else:
            rec["kernel_vs_plain"] = {"logits": _max_diff(got, plain)}
    rec["device"] = str(device)


# ------------------------------------------------------------------ cases
def case_config(arch: str, shape_name: str, *, multi_pod: bool = False,
                rules: Optional[ShardingRules] = None,
                cfg_overrides: Optional[Dict[str, Any]] = None,
                tag: str = "", reduced: bool = False):
    """``(record, cfg, shape, rules)`` of a case before it runs: the
    reference's skip (``status`` "skipped" and its ``reason``) or the
    config it runs — ``remat`` for a train shape, the reduced variant and
    a 4 × 64 shape for ``reduced``, the overrides — with the record's
    ``tag``, ``sliding_window``, ``rules``, ``layer_scan``, ``params`` and
    ``active_params``."""
    shape = SHAPES[shape_name]
    base = get_config(arch)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "multi_pod": multi_pod, "reduced": reduced}
    if not shape_applicable(base, shape):
        rec["status"] = "skipped"
        rec["reason"] = ("encoder-only: no decode step"
                         if base.is_encoder_only else "inapplicable")
        return rec, None, shape, None

    cfg = config_for_shape(base, shape)
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
    if reduced:
        if multi_pod:
            raise ValueError("--reduced runs on the local single mesh")
        cfg = cfg.reduced()
        shape = dataclasses.replace(shape, global_batch=REDUCED_BATCH,
                                    seq_len=REDUCED_SEQ)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
        rec["cfg_overrides"] = dict(cfg_overrides)
    rec["tag"] = tag
    rec["sliding_window"] = cfg.sliding_window
    rules = rules or ShardingRules.for_mesh(multi_pod)
    rec["rules"] = dataclasses.asdict(rules)
    rec["layer_scan"] = False
    rec["params"] = cfg.param_count()
    rec["active_params"] = cfg.active_param_count()
    return rec, cfg, shape, rules


def run_case(arch: str, shape_name: str, *, multi_pod: bool = False,
             rules: Optional[ShardingRules] = None,
             collect_hlo: bool = True, verbose: bool = True,
             use_scan: bool = False,
             cfg_overrides: Optional[Dict[str, Any]] = None,
             tag: str = "", reduced: bool = False,
             device: Any = None) -> Dict[str, Any]:
    """One (arch, shape, mesh) case; returns the record.

    **Production** (``reduced=False``): parameter shapes from ``LM.init``
    under ``torch.device("meta")`` (nothing drawn; grok-1's 314 B included),
    fake tensors of those shapes (``FakeTensorMode``), the AdamW state
    mirroring them, the batch / cache, all placed as DTensors by the spec
    trees of :mod:`repro_torch.dist.sharding` on the production mesh; then
    the shape's step (``use_kernel=False``) runs once.  Train cases run
    with ``remat`` (each cycle under ``torch.utils.checkpoint``), as the
    reference's do.

    The formulation the counts describe: weights rest sharded by their
    specs and are gathered on the FSDP axis just before the arithmetic
    reads them (:func:`fsdp_gather`, the model's ``gather`` hook; its
    backward reduce-scatters each gradient), keeping their tensor-parallel
    shards; the embedding table is gathered whole before the lookup;
    activations are sharded on the batch over the ``dp`` axes; a partial
    sum is all-reduced before an op reads it; ops DTensor cannot shard run
    replicated (``OpRecorder``; the record's ``replicated`` counts them).
    So the collectives recorded are those of this formulation, not XLA's
    partitioner's.  On the CPU mesh DTensor runs an all-to-all as an
    all-gather, and counts it so.

    The record: ``cost`` ``{"flops", "bytes accessed"}`` per device,
    counted on rank 0's local ops (``flops`` as ``FlopCounterMode``
    counts; ``bytes accessed`` each local op's input plus output bytes,
    what eager execution moves with no fusion); ``memory`` of rank 0
    (``argument_size_in_bytes`` and ``output_size_in_bytes``: its local
    shards; ``temp_size_in_bytes``: the peak of the step's live fake
    storage above its arguments, by ``OpRecorder``; no generated-code
    size); ``collectives``, the dict ``collective_bytes_from_hlo`` gives,
    from the functional collectives that ran.  No HLO is written
    (``hlo_path`` is absent; ``collect_hlo`` is accepted for the
    reference's signature).  ``lower_s`` is the seconds to build the
    abstract state, ``compile_s`` those of the traced step.

    **Reduced** (``reduced=True``): the architecture's reduced config and
    a 4 × 64 batch on a (1, 1) mesh of ``device`` (default: the card; a
    ``torch.device``, a string), parameters from ``LM.init(0)``, one
    real step of the shape's kind: ``cost`` from the plain step; on the
    card the kernels' step gives ``launches`` (B1–B6) and
    ``kernel_vs_plain`` (the loss and gradients, or the logits, against
    the plain step's; a train step's new parameters and AdamW moments
    against ``apply_update``'s); ``memory`` from the card's
    ``max_memory_allocated`` less the arguments (on the CPU the
    ``OpRecorder`` peak); ``collectives`` all zero.
    """
    rec, cfg, shape, rules = case_config(
        arch, shape_name, multi_pod=multi_pod, rules=rules,
        cfg_overrides=cfg_overrides, tag=tag, reduced=reduced)
    if cfg is None:
        return rec
    if reduced:
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass "
                               "--device cpu to run on the CPU")
        _reduced(rec, cfg, shape, rules, device)
    else:
        _production(rec, cfg, shape, rules, multi_pod)
    rec["status"] = "ok"
    if verbose:
        mem = rec.get("memory", {})
        mesh_tag = ("1x1" if reduced else
                    "2x16x16" if multi_pod else "16x16")
        print(f"[{arch} × {shape_name} × {mesh_tag}] "
              f"lower {rec['lower_s']}s compile {rec['compile_s']}s "
              f"flops={rec.get('cost', {}).get('flops', float('nan')):.3e} "
              f"temp={mem.get('temp_size_in_bytes', 0)/2**30:.2f}GiB",
              flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--scan", action="store_true",
                    help="accepted for the reference's CLI; the port has "
                         "no layer scan and counts every layer")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cases already ok/skipped in --out")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced arch variants, one real step each on "
                         "the local (1, 1) mesh")
    ap.add_argument("--device", default="cuda",
                    help="the device of --reduced: cuda (default; raises "
                         "without a visible card) or cpu")
    args = ap.parse_args(argv)
    if args.reduced and (args.multi_pod or args.both_meshes):
        ap.error("--reduced runs on the local single mesh")

    archs = list_archs() if args.arch is None or args.all else [args.arch]
    cheap_first = ["decode_32k", "long_500k", "prefill_32k", "train_4k"]
    shapes = cheap_first if args.shape is None or args.all else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    done = set()
    if args.skip_done and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") in ("ok", "skipped"):
                    # reduced records must not satisfy full-size cases (or
                    # vice versa): the flag is part of the key
                    done.add((r["arch"], r["shape"], r["multi_pod"],
                              r.get("reduced", False)))

    records = []
    for shape in shapes:
        for arch in archs:
            for mp in meshes:
                if (arch, shape, mp, args.reduced) in done:
                    continue
                try:
                    rec = run_case(arch, shape, multi_pod=mp,
                                   use_scan=args.scan or mp,
                                   reduced=args.reduced, device=args.device)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    print(f"[{arch} × {shape}] ERROR {e!r}")
                records.append(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")

    ok = sum(r["status"] == "ok" for r in records)
    sk = sum(r["status"] == "skipped" for r in records)
    er = sum(r["status"] == "error" for r in records)
    print(f"\ndry-run: {ok} ok, {sk} skipped (by design), {er} errors "
          f"of {len(records)} cases")
    if er:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
