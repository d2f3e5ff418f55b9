"""Real-training backend: Hippo stages driving a PyTorch model (the §5.2
``Trainer`` counterpart).

``TorchTrainer`` executes a stage as a handful of *chunks*: each chunk
covers up to ``chunk_steps`` training steps (stage lengths split into
descending power-of-two chunks, :func:`chunk_lengths`), consuming a data
slab drawn in one piece (``DataPipeline.next_batches``) and uploaded once,
and per-step hyper-parameter values uploaded once per chunk as float32
device rows sliced on the device (the ``setup(hp)`` hot-update of Figure 9
becomes "hp values are device values of the step").  No step of a chunk
reads a value back to the host, so the host queues a whole chunk without
waiting for the device.  The package runs eagerly: there is nothing to
compile per chunk, and ``exec_calls`` counts chunks issued.

**One walk.**  Every entry — :meth:`run_stage` and :meth:`run_chain` (a
solo chain: one member), :meth:`run_stages_batched` and
:meth:`run_chains_batched` (a sibling group of ``M``) — runs one walk over
the members' chains, a stage level at a time.  It holds the ``(params,
opt)`` carries and the data pipelines across every stage boundary (no
checkpoint round-trip, no slab re-prefetch) and returns ``[member][stage]``
boundary snapshots for the dispatcher's write-behind checkpointing.  The
carry's layout is chosen once per call: per member (a solo chain, or a
group's looped tier: each member's chunk as a solo run executes it) or
member-stacked (a group's vectorised tier); see Sibling groups.

Uploads and spans (:mod:`repro_torch.utils.tracing`, recorded only while
a profiler or a ``recording()`` block is on): ``train.chain`` around a
chain or a stage, ``train.group`` around a group, ``train.evaluate``
around an evaluation.  Inside them, per stage, a ``data.upload`` of the
static scalar hps; per chunk, ``data.slab`` (each pipeline's slab drawn,
:meth:`_draw`), ``data.upload`` (the slab through :meth:`_upload`, one a
pipeline or one stacked on axis 1; the step indices and hp rows through
:meth:`_upload_rows`, an ``(n,)`` row a name and member or one step-major
``(n, M)`` a name) and ``train.chunk`` (the steps, device-timed by CUDA
events, with the member-steps and group width).  :meth:`run_stage_stepwise`,
the plain per-step loop kept as the bit-exactness reference, takes its
slab, hp rows and step index through the same helpers, a step at a time.

Everything a resumed trial needs is in the state tree:

    {"params", "opt", "opt_name", "data" (pipeline position), "step"}

so stage-based execution is *lossless*: training a prefix once and forking
the checkpoint yields bit-identical parameters to training each trial
straight through, and the chunk walk, chains included, is bit-identical to
the per-step loop on one device.  Optimizer updates write fresh tensors,
so a solo snapshot is just a reference to the carry at that boundary.

Kernel plane: ``use_kernel`` routes the optimizer update of every step
through the update kernel
(:func:`repro_torch.kernels.optim.fused_apply_update`) and, as in the JAX
package, sets ``task.use_kernel`` on a task that has the attribute (the
LM's attention then goes through the flash-attention kernels).  It
defaults to on for a CUDA device.  ``use_kernel=True`` on the CPU runs the
plain versions, counted as fallbacks and warned once; on CUDA there is no
fallback.
``kernel_calls`` / ``kernel_fallbacks`` expose the kernel plane's counters
(cumulative since this trainer's construction) for ``EngineStats``.

Device and numerics: ``device=None`` means ``"cuda"`` and raises where
there is no CUDA device — nothing carries on on the CPU because it found
no GPU; pass ``device="cpu"`` to ask for it.  A state restored from the
checkpoint store's serialized tiers comes back with its tensors on the
host: every entry that takes a state (:meth:`run_stage`, :meth:`run_chain`,
the batched entries, :meth:`run_stage_stepwise`, :meth:`evaluate`) first
moves its tensor leaves to the trainer's device (:meth:`on_device`), and a
state already there passes through unchanged.  Constructing a trainer on a
CUDA device sets, process-wide,
``torch.backends.cudnn.allow_tf32 = False`` and
``torch.backends.cuda.matmul.allow_tf32 = False`` (the card computes what
an f32 reference computes) and ``torch.backends.cudnn.deterministic =
True``, ``benchmark = False`` (the losslessness claim is bitwise).

Sibling groups: the members share ``[start, stop)``, static hps, hp names
and the batch-size schedule, and differ in hp *values*.  A mismatch raises
``ValueError``, which the dispatcher answers with member-sequential chains;
a solo chain whose stages are not contiguous raises ``ChainNotFusable``,
answered with the per-stage loop.  Members whose data states are equal
(siblings forked from one checkpoint) share one pipeline and one slab.
The tier, as in the JAX package, is chosen by ``vectorize_groups`` (on for
a CUDA device, off on the CPU; an explicit value overrides):

* **vectorised** (member-stacked) — each step is the task's loss under
  ``torch.func.vmap`` over the stacked carry (the shared slab broadcast
  with ``in_dims=None``, never stacked) and one ordinary
  ``torch.autograd.grad`` of the members' summed losses
  (:func:`group_value_and_grad`), so the task's kernels fold the group
  into one launch each, backward included (:mod:`repro_torch.kernels.ops`);
  then one member-stacked optimizer update
  (:func:`repro_torch.kernels.optim.stacked_apply_update`: one B1 launch
  per tree) with per-member hp values as ``(M,)`` device rows of
  step-major ``(n, M)`` tensors.  Member-stacked matrix products and
  convolutions (``bmm``, a grouped convolution) need not give solo's bits;
* **looped** (per member) — each member's chunk exactly as a solo run
  executes it, bit-equal to solo by construction.

A boundary snapshot of the stacked carry is a per-member **copy**, not a
view: a view ``x[g]`` would pin the whole stack for as long as any
member's checkpoint lives, so a group whose siblings a tuner kills would
hold every member's memory; the copy frees a killed member's share and
costs one device copy of the state per boundary.

Mesh plane: a one-device :class:`~repro_torch.dist.meshes.WorkerMesh`
takes the default path (the trainer's device), as the JAX trainer's does,
so a one-device-mesh fleet computes a thread fleet's bits.  A wider mesh
runs a stage sharded over its devices, as the JAX trainer's
``set_mesh`` / ``_carry_shardings`` / ``_meshed_build`` do: between
chunks the carry ``(params, opt)`` rests split per leaf by
``generic_param_specs`` (``n_lead`` 1 for a member-stacked group: the
member axis never splits), a shard on each mesh device in mesh order
(:func:`~repro_torch.dist.sharding.split_tree`; a leaf nothing divides
stays whole on the first device).  Before each chunk the carry is
gathered whole on the mesh's first device — a concatenation of the
shards, pure data movement — and the chunk runs there unchanged; after
it the carry is split again, outside the arithmetic; an optimizer switch
puts its fresh slots at rest too; boundary snapshots leave the trainer
whole on the first device, so the store, evaluation and the handoff see
one-device trees.  The JAX trainer runs the chunk's arithmetic
replicated on every device of the mesh; this one runs it once, with the
same results, so a mesh fleet is bit-equal to a thread fleet.  The
devices are the mesh's cards on a CUDA trainer
(:meth:`WorkerMesh.torch_devices`: a mesh naming a card this process
cannot see is refused by :meth:`check_mesh` when the engine, gateway or
``serve_studies`` is built, before any work) and, on a CPU trainer, the
CPU once per mesh position, each shard a tensor of its own.  The
workers are threads of one process, so this is a single-controller
layout, not DTensor's one rank per device.  :meth:`mesh_compatible` is
the divisibility gate over the task's parameter shapes (nothing is
placed on the card for it), cached per mesh.  :meth:`device_transfer`,
the dispatcher's device-to-device handoff, hands out a clone on the
mesh's first device (the trainer's own device for a CPU trainer): the
dispatcher's cached copy and each consumer's copy are tensors no one
else holds.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.trainer import (ChainNotFusable, StageContext,
                                      TrainerBackend)
from repro_torch.core.values import desc_static, desc_values
from repro_torch.data.pipeline import DataPipeline
from repro_torch.dist.sharding import (generic_param_specs, join_tree,
                                       spec_leaves, split_tree)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.optim import fused_apply_update, stacked_apply_update
from repro_torch.train.optimizer import (apply_update, apply_update_stacked,
                                         init_opt_state)
from repro_torch.utils import tracing
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["TorchTrainer", "chunk_lengths", "value_and_grad",
           "group_value_and_grad"]


def chunk_lengths(n: int, max_chunk: int) -> List[int]:
    """Split ``n`` steps into descending power-of-two chunk lengths capped at
    ``max_chunk``, so every stage length reuses O(log max_chunk) distinct
    slab shapes."""
    if max_chunk < 1:
        raise ValueError(f"max_chunk must be >= 1, got {max_chunk}")
    out: List[int] = []
    while n > 0:
        c = min(max_chunk, 1 << (n.bit_length() - 1))
        out.append(c)
        n -= c
    return out


def _stack(trees: Sequence[Any]) -> Any:
    """Member-stack structurally identical trees leaf by leaf."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def group_value_and_grad(loss_fn, params: Any, batch: Any,
                         batch_dim: Optional[int] = 0):
    """``(losses, aux), grads`` of a sibling group: ``params`` a
    member-stacked tree, ``batch`` stacked (``batch_dim=0``) or shared by
    every member (``None``); ``losses`` ``(M,)``.  The loss runs under
    ``torch.func.vmap`` and the gradient is one ``torch.autograd.grad`` of
    the summed losses (each member's loss depends on its own slice only,
    so its slice of the gradient is its own).  Not
    ``vmap(grad_and_value(loss))``: ``torch.func.grad`` differentiates with
    ``create_graph=True`` and keeps the backward's graph, ~1.7× a solo
    step's memory a member (qwen2-0.5b, ``tools/group_probe.py memory``).
    A leaf the loss never reads gets zeros, as under ``jax.grad``."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = torch.func.vmap(loss_fn, in_dims=(0, batch_dim))(leaves,
                                                                 batch)
    grads = iter(torch.autograd.grad(loss.sum(), tree_leaves(leaves),
                                     allow_unused=True,
                                     materialize_grads=True))
    return (loss.detach(), aux), tree_map(lambda _: next(grads), params)


def value_and_grad(loss_fn, params: Any, batch: Any):
    """``(loss, aux), grads`` of ``loss_fn(params, batch) -> (loss, aux)``
    with ``grads`` a tree shaped like ``params``.  The parameters are not
    touched: gradients are taken with respect to detached views.  A leaf
    the loss never reads (an audio model's ``embed``) gets zeros, as under
    ``jax.grad``, so the update decays it as the reference's does."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = loss_fn(leaves, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                     allow_unused=True,
                                     materialize_grads=True))
    return (loss.detach(), aux), tree_map(lambda _: next(grads), params)


class _PerMember:
    """The walk's carry, one per member (``n_lead`` 0 at rest): a solo
    chain, or a group's looped tier.  Each member's chunk runs as a solo
    run executes it (:meth:`TorchTrainer._run_chunk`, the solo update),
    with its own ``(n,)`` hp rows and its pipeline's slab."""

    def __init__(self, tr: "TorchTrainer", carries: List[Any], shared: bool):
        self.tr, self.shared = tr, shared
        self.carries = [tr._at_rest(c, 0) for c in carries]

    def switch(self, opt_name: str) -> None:
        """Fresh optimizer slots, back in the at-rest layout."""
        tr = self.tr
        self.carries = [tr._at_rest((p, init_opt_state(opt_name, p)), 0)
                        for p in (tr._whole(c[0]) for c in self.carries)]

    def scalars(self, static_hp: Dict[str, float]):
        return self.tr._scalars(static_hp)

    def rows(self, rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return rows

    def slab(self, slabs: List[Dict[str, np.ndarray]]):
        return [self.tr._upload(sl) for sl in slabs]

    def run(self, opt_name: str, static, hps, slabs, steps) -> None:
        tr, carries = self.tr, self.carries
        for m, hp in enumerate(hps):
            work = tr._whole(carries[m])
            carries[m] = None        # the shards are not pinned
            carries[m] = tr._at_rest(tr._run_chunk(
                opt_name, work, static, hp, slabs[0 if self.shared else m],
                steps), 0)
            del work

    def snapshots(self) -> List[Any]:
        return [self.tr._whole(c) for c in self.carries]


class _Stacked:
    """The walk's carry on a group's vectorised tier: member-stacked
    ``(M, ...)`` (``n_lead`` 1 at rest: the member axis never splits), a
    list in a chunk, updated in place step by step
    (:meth:`TorchTrainer._run_group_chunk`); static hps as ``(M,)`` rows,
    hp rows step-major ``(n, M)``, the slab shared or stacked on axis 1."""

    def __init__(self, tr: "TorchTrainer", carries: List[Any], shared: bool):
        self.tr, self.shared, self.group = tr, shared, len(carries)
        self.carry = tr._at_rest(tuple(
            _stack([c[i] for c in carries]) for i in (0, 1)), 1)

    def switch(self, opt_name: str) -> None:
        """Fresh optimizer slots, back in the at-rest layout."""
        params = self.tr._whole(self.carry[0])
        self.carry = self.tr._at_rest(
            (params, init_opt_state(opt_name, params)), 1)

    def scalars(self, static_hp: Dict[str, float]):
        return {k: torch.full((self.group,), v, dtype=torch.float32,
                              device=self.tr._home)
                for k, v in static_hp.items()}

    def rows(self, rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        # step-major (n, M): row i is one contiguous (M,) vector, the
        # kernel's per-member operand
        return [{k: np.asarray([r[k] for r in rows], np.float32).T
                 for k in rows[0]}]

    def slab(self, slabs: List[Dict[str, np.ndarray]]):
        return self.tr._upload(slabs[0] if self.shared else {
            k: np.stack([sl[k] for sl in slabs], axis=1) for k in slabs[0]})

    def run(self, opt_name: str, static, hps, slab, steps) -> None:
        work = list(self.tr._whole(self.carry))
        self.carry = None            # pins neither input nor shards
        self.tr._run_group_chunk(opt_name, work, static, hps[0], slab, steps,
                                 self.shared)
        self.carry = self.tr._at_rest(tuple(work), 1)

    def snapshots(self) -> List[Any]:
        whole = self.tr._whole(self.carry)
        return [tuple(tree_map(lambda x, m=m: x[m].clone(), c) for c in whole)
                for m in range(self.group)]


class TorchTrainer(TrainerBackend):
    """Stage executor over any task exposing ``init(rng)`` and
    ``loss(params, batch) -> (scalar, metrics)``."""

    def __init__(self, task, pipeline_factory: Callable[[], DataPipeline],
                 eval_batch: Dict[str, np.ndarray],
                 default_optimizer: str = "momentum", seed: int = 0,
                 objective_from: str = "acc", chunk_steps: int = 8,
                 use_kernel: Optional[bool] = None,
                 device: Union[str, torch.device, None] = None,
                 vectorize_groups: Optional[bool] = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchTrainer runs on a CUDA device and none is "
                    "available; pass device='cpu' to ask for the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self._home = self.device     # where chunks run: a mesh's first
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.task = task
        self.pipeline_factory = pipeline_factory
        self.eval_batch = self._upload(eval_batch)
        self.default_optimizer = default_optimizer
        self.seed = seed
        self.objective_from = objective_from
        self.chunk_steps = int(chunk_steps)
        if self.chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
        self.use_kernel = (self.device.type == "cuda") if use_kernel is None \
            else bool(use_kernel)
        if self.use_kernel and hasattr(task, "use_kernel"):
            task.use_kernel = True      # e.g. the LM's attention kernels
        self._update = fused_apply_update if self.use_kernel else apply_update
        self._group_update = (stacked_apply_update if self.use_kernel
                              else apply_update_stacked)
        self.vectorize_groups = (self.device.type == "cuda") \
            if vectorize_groups is None else bool(vectorize_groups)
        self._kernel_stats0 = kernel_ops.KERNEL_STATS.snapshot()
        self.exec_calls = 0          # chunks (or single steps) issued
        self.evaluations = 0         # evaluate() calls
        self._params0 = None         # initial parameters, drawn at first use
        self._mesh_ok: Dict[Tuple, bool] = {}   # mesh_compatible verdicts
        self._wmesh = None           # the bound WorkerMesh (> 1 device)
        self._mesh_devices: Optional[List[torch.device]] = None

    # ------------------------------------------------- kernel-plane counters
    @property
    def kernel_calls(self) -> int:
        """Kernel-plane calls since construction: one per training step
        for the optimizer update, one per attention layer per forward for
        an LM run with its kernels."""
        return kernel_ops.KERNEL_STATS.calls - self._kernel_stats0[0]

    @property
    def kernel_fallbacks(self) -> int:
        """Kernel→plain-version fallbacks since construction."""
        return kernel_ops.KERNEL_STATS.fallbacks - self._kernel_stats0[1]

    supports_batched_stages = True
    supports_chain_fusion = True

    @property
    def batched_bitwise_solo(self) -> bool:  # type: ignore[override]
        # the looped tier runs each member's solo chunks; the vectorised
        # tier's member-stacked products sum in another order
        return not self.vectorize_groups

    def clone_state(self, state):
        # leaves are never mutated in place — a fresh container tree is a
        # full-depth safe copy
        return tree_map(lambda x: x, state)

    # ------------------------------------------------------------ mesh plane
    def _devices(self, mesh) -> List[torch.device]:
        """A mesh's devices: its cards on a CUDA trainer (``ValueError``
        for an id that is not visible), the CPU once per mesh position on
        a CPU trainer."""
        if self.device.type == "cuda":
            return mesh.torch_devices()
        return [self.device] * mesh.n_devices

    def check_mesh(self, mesh) -> None:
        """Refuse, before any work, a mesh wider than one device whose
        cards this process cannot see (a CUDA trainer)."""
        if mesh.n_devices > 1:
            self._devices(mesh)

    def set_mesh(self, mesh) -> None:
        """Bind to the dispatching worker's mesh: a one-device mesh (or a
        thread worker) takes the default path, on the trainer's device; a
        wider one binds its devices, and chunks run on its first."""
        if mesh is None or mesh.n_devices == 1:
            self._wmesh, self._mesh_devices = None, None
            self._home = self.device
            return
        if self._wmesh is None or self._wmesh.key != mesh.key:
            self._mesh_devices = self._devices(mesh)
        self._wmesh, self._home = mesh, self._mesh_devices[0]

    def _at_rest(self, carry, n_lead: int):
        """The carry as it rests between chunks on the bound mesh: each
        leaf split by ``generic_param_specs`` (the first ``n_lead`` dims,
        a group's member axis, never), a shard on each mesh device; a
        leaf nothing divides whole on the first.  Without a mesh, the
        carry itself."""
        if self._wmesh is None:
            return carry
        specs = generic_param_specs(carry, self._wmesh.rules,
                                    sizes=self._wmesh.sizes, n_lead=n_lead)
        return split_tree(carry, specs, self._wmesh.axes,
                          self._mesh_devices)

    def _whole(self, carry):
        """The carry gathered whole on the mesh's first device: the shards
        concatenated in order, pure data movement, so the chunk that runs
        on it computes what it computes on a thread worker.  (The JAX
        trainer runs the arithmetic replicated on every device of the
        mesh; here it runs once, on the first, with the same results.)"""
        if self._wmesh is None:
            return carry
        return join_tree(carry, self._home)

    def mesh_compatible(self, mesh, ctxs) -> bool:
        """The divisibility gate as a placement gate: a mesh wider than
        one device is only worth occupying when at least one parameter
        dimension shards over it under ``generic_param_specs``.  The
        shapes are those of the trainer's initial parameters, or of the
        task's draw on the host when :meth:`init_state` has not drawn
        them: nothing is placed on the card for the gate."""
        if mesh is None or mesh.n_devices == 1:
            return True
        ok = self._mesh_ok.get(mesh.key)
        if ok is None:
            params = self._params0
            if params is None:
                params = self.task.init(
                    torch.Generator().manual_seed(self.seed))
            specs = generic_param_specs(params, mesh.rules, sizes=mesh.sizes)
            ok = any(ax is not None for spec in spec_leaves(specs)
                     for ax in spec)
            self._mesh_ok[mesh.key] = ok
        return ok

    def device_transfer(self, state, mesh):
        """Device-to-device handoff: a clone of every tensor leaf on the
        mesh's first device (the trainer's device for a CPU trainer or a
        thread worker), in a fresh container tree.  Declines (``None`` →
        the store) when that device is not visible to this process."""
        dev = self.device
        if mesh is not None and dev.type == "cuda":
            try:
                dev = mesh.torch_devices()[0]
            except ValueError:
                return None

        def clone(x):
            if isinstance(x, torch.Tensor):
                return x.detach().to(dev, copy=True)
            return x

        return tree_map(clone, state)

    # ------------------------------------------------------------------ state
    def init_state(self) -> Dict[str, Any]:
        """The state every root stage starts from.  The parameters are
        drawn from the seed once per trainer and shared by every root
        stage: they are never updated in place (a 0.5B-parameter LM takes
        tens of seconds to draw on the host)."""
        if self._params0 is None:
            gen = torch.Generator().manual_seed(self.seed)
            self._params0 = tree_map(lambda x: x.to(self.device),
                                     self.task.init(gen))
        params = tree_map(lambda x: x, self._params0)
        pipe = self.pipeline_factory()
        return {
            "params": params,
            "opt": None,               # lazy: optimizer choice is a static hp
            "opt_name": None,
            "data": pipe.state(),
            "step": 0,
        }

    # -------------------------------------------------------------- stage prep
    def _stage_plan(self, ctx: StageContext):
        """Per-step value arrays, static scalar hps, optimizer, hp names."""
        vals = desc_values(ctx.desc, ctx.node_start, ctx.start, ctx.stop)
        static = desc_static(ctx.desc)
        opt_name = static.get("optimizer", self.default_optimizer)
        static_hp = {k: float(v) for k, v in static.items()
                     if isinstance(v, (int, float)) and not k.startswith("_")}
        names = [k for k in vals if k != "bs"]
        return vals, static_hp, opt_name, names

    @staticmethod
    def _bs_runs(vals: Dict[str, List[float]], n: int
                 ) -> List[Tuple[int, int, Optional[int]]]:
        """Maximal runs ``[(i0, i1, bs)]`` of constant batch size; ``bs`` is
        None when the stage has no batch-size sequence (pipeline keeps its
        restored size)."""
        if "bs" not in vals:
            return [(0, n, None)]
        sizes = [int(round(v)) for v in vals["bs"]]
        runs, i0 = [], 0
        for i in range(1, n + 1):
            if i == n or sizes[i] != sizes[i0]:
                runs.append((i0, i, sizes[i0]))
                i0 = i
        return runs

    # ----------------------------------------------------------------- upload
    def _upload(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host arrays → device tensors, one transfer per field.  Integer
        fields (labels are int32 in the datasets) become int64 here, once,
        so no step converts them."""
        out = {}
        for k, v in arrays.items():
            v = np.asarray(v)
            if np.issubdtype(v.dtype, np.integer):
                v = v.astype(np.int64)
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(self._home)
        return out

    def _scalars(self, values: Dict[str, float]) -> Dict[str, torch.Tensor]:
        return {k: torch.tensor(v, dtype=torch.float32, device=self._home)
                for k, v in values.items()}

    def _foreign(self, x: Any) -> bool:
        """Is ``x`` a tensor off this trainer's device?"""
        if not isinstance(x, torch.Tensor):
            return False
        dev = self._home
        return x.device.type != dev.type or (
            dev.index is not None and x.device.index != dev.index)

    def on_device(self, *states: Dict[str, Any]) -> List[Dict[str, Any]]:
        """``states`` with every tensor leaf on this trainer's device,
        uploaded once each (a leaf shared by several states, as a resume
        load's fan-out shares them, once in all; from pinned memory with
        ``non_blocking``).  A state with no leaf elsewhere is returned
        itself: no copy."""
        memo: Dict[int, torch.Tensor] = {}

        def move(x):
            if not self._foreign(x):
                return x
            y = memo.get(id(x))
            if y is None:
                y = memo[id(x)] = x.to(self._home,
                                       non_blocking=x.is_pinned())
            return y

        return [tree_map(move, s) if any(map(self._foreign, tree_leaves(s)))
                else s for s in states]

    def _init_opt(self, state: Dict[str, Any], opt_name: str):
        opt = state["opt"]
        if opt is None or state["opt_name"] != opt_name:
            opt = init_opt_state(opt_name, state["params"])
        return opt

    # ------------------------------------------------------------ chunk parts
    def _windows(self, pipes: List[DataPipeline], vals: Dict[str, List[float]],
                 n: int):
        """A stage's chunk windows ``(w0, w1)``: its runs of one batch size
        (every pipeline set to the run's size before its first chunk), each
        cut by :func:`chunk_lengths`."""
        for i0, i1, bs in self._bs_runs(vals, n):
            if bs is not None:
                for pipe in pipes:
                    pipe.set_batch_size(bs)
            for k_len in chunk_lengths(i1 - i0, self.chunk_steps):
                yield i0, i0 + k_len
                i0 += k_len

    @staticmethod
    def _draw(pipes: List[DataPipeline], n: int
              ) -> List[Dict[str, np.ndarray]]:
        """Each pipeline's next ``n`` batches as one host slab."""
        with tracing.span("data.slab"):
            return [pipe.next_batches(n) for pipe in pipes]

    def _upload_rows(self, t0: int, t1: int, rows: List[Dict[str, Any]]
                     ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """The step indices ``[t0, t1)`` and the hp rows on the device: one
        float32 tensor for each value array of ``rows`` (a dict a member,
        or one for a member-stacked group), each one transfer."""
        steps = torch.arange(t0, t1, dtype=torch.int32, device=self._home)
        return steps, [{k: torch.from_numpy(np.ascontiguousarray(
            v, np.float32)).to(self._home) for k, v in r.items()}
            for r in rows]

    # ------------------------------------------------------------- chunk body
    def _run_chunk(self, opt_name: str, carry, static_hp, hp_xs, slab, steps):
        """``len(steps)`` training steps over device-resident slab / hp /
        step arrays; indexing a device tensor is a view, never a read-back."""
        params, opt = carry
        for i in range(steps.shape[0]):
            hp = dict(static_hp)
            hp.update({k: v[i] for k, v in hp_xs.items()})
            batch = {k: v[i] for k, v in slab.items()}
            _, grads = value_and_grad(self.task.loss, params, batch)
            params, opt = self._update(opt_name, params, grads, opt, hp,
                                       steps[i])
        self.exec_calls += 1
        return params, opt

    def _run_group_chunk(self, opt_name: str, carry: List[Any], static_hp,
                         hp_xs, slab, steps, shared: bool) -> None:
        """The vectorised tier's chunk: ``len(steps)`` steps of the
        member-stacked ``carry = [params, opt]``, each one
        :func:`group_value_and_grad` and one stacked update.  The carry is
        updated in place, so no reference pins a step's input state once
        its update has run (a group's state is M times a member's: 12 GB
        for four qwen2-0.5b members)."""
        for i in range(steps.shape[0]):
            hp = dict(static_hp)
            hp.update({k: v[i] for k, v in hp_xs.items()})
            _, grads = group_value_and_grad(
                self.task.loss, carry[0], {k: v[i] for k, v in slab.items()},
                None if shared else 0)
            carry[0], carry[1] = self._group_update(
                opt_name, carry[0], grads, carry[1], hp, steps[i])
            del grads
        self.exec_calls += 1

    # -------------------------------------------------------------- execute
    @tracing.traced("train.chain")
    def run_stage(self, state: Dict[str, Any], ctx: StageContext
                  ) -> Dict[str, Any]:
        return self._walk([state], [[ctx]], batched=False)[0][-1]

    @tracing.traced("train.chain")
    def run_chain(self, state: Dict[str, Any],
                  ctxs: Sequence[StageContext]) -> List[Dict[str, Any]]:
        """Chain-fused execution: the carry stays on device across every
        stage boundary (one persistent pipeline, no host round-trip) and a
        boundary snapshot is returned per stage — bit-identical to running
        :meth:`run_stage` per stage."""
        return self._walk([state], [list(ctxs)], batched=False)[0]

    @tracing.traced("train.group")
    def run_stages_batched(self, states: Sequence[Dict[str, Any]],
                           ctxs: Sequence[StageContext]
                           ) -> List[Dict[str, Any]]:
        """A sibling group of stages as one call (see the module
        docstring); one boundary state per member."""
        return [b[-1] for b in self._walk(list(states), [[c] for c in ctxs],
                                          batched=True)]

    @tracing.traced("train.group")
    def run_chains_batched(self, states: Sequence[Dict[str, Any]],
                           chains: Sequence[Sequence[StageContext]]
                           ) -> List[List[Dict[str, Any]]]:
        """A group of parallel sibling chains of equal depth, one stage
        level at a time over the group's carry, which persists across
        boundaries; ``[member][stage]`` boundary states."""
        return self._walk(list(states), [list(c) for c in chains],
                          batched=True)

    def _admit(self, states, chains, plans, refuse) -> None:
        """The conditions under which members' chains run as one walk: each
        chain contiguous (else ``refuse``), and siblings agreeing (else
        ``ValueError``); the first one broken raises, naming it."""
        for s, ch in zip(states, chains):
            step = ch[0].start
            for c in ch:
                if c.start != step:
                    raise refuse(
                        f"chain stages must be contiguous: stage starts at "
                        f"{c.start}, previous stopped at {step}")
                step = c.stop
            assert s["step"] == ch[0].start, (s["step"], ch[0].start)
        if len(chains) == 1:
            return
        depth = len(chains[0])
        if any(len(ch) != depth for ch in chains):
            raise ValueError("batched chains must share their depth")
        for j in range(depth):
            ctx0 = chains[0][j]
            vals0, static0, opt0, names0 = plans[0][j]
            runs = self._bs_runs(vals0, ctx0.stop - ctx0.start)
            for ch, pl in zip(chains[1:], plans[1:]):
                c = ch[j]
                vals, static, opt_n, names = pl[j]
                if (c.start, c.stop) != (ctx0.start, ctx0.stop):
                    raise ValueError("batched stages must share [start, stop)")
                if opt_n != opt0 or static != static0:
                    raise ValueError("batched stages must share static hps")
                if names != names0:
                    raise ValueError("batched stages must share hp names")
                if self._bs_runs(vals, c.stop - c.start) != runs:
                    raise ValueError(
                        "batched stages must share the bs schedule")

    def _walk(self, states: List[Dict[str, Any]],
              chains: List[List[StageContext]], batched: bool
              ) -> List[List[Dict[str, Any]]]:
        """Run ``M >= 1`` members' chains of equal depth, one stage level at
        a time, returning ``[member][stage]`` boundary states; the carries
        and pipelines persist across stage boundaries.  A solo chain
        (``batched`` False) is refused with ``ChainNotFusable``, a group
        with ``ValueError``; a group on the vectorised tier carries its
        members stacked."""
        plans = [[self._stage_plan(c) for c in ch] for ch in chains]
        self._admit(states, chains, plans,
                    ValueError if batched else ChainNotFusable)
        states = self.on_device(*states)
        # siblings forked from one checkpoint share the data stream: one
        # pipeline and one slab serve them all
        shared = all(tuple(s["data"]) == tuple(states[0]["data"])
                     for s in states[1:])
        pipes = []
        for s in (states[:1] if shared else states):
            pipe = self.pipeline_factory()
            pipe.restore(s["data"])
            pipes.append(pipe)
        if (plans[0][0][0].get("bs") is None
                and len({p.batch_size for p in pipes}) > 1):
            raise ValueError("batched stages must share the batch size")

        opt_name = plans[0][0][2]
        layout = (_Stacked if batched and self.vectorize_groups
                  else _PerMember)(self, [(s["params"],
                                           self._init_opt(s, opt_name))
                                          for s in states], shared)
        members = len(states)
        boundaries: List[List[Dict[str, Any]]] = [[] for _ in states]
        for j, ctx in enumerate(chains[0]):
            vals, static_hp, stage_opt, names = plans[0][j]
            if stage_opt != opt_name:
                # optimizer switch at the boundary: fresh slots, exactly as
                # run_stage would re-init on the restored state
                opt_name = stage_opt
                layout.switch(opt_name)
            with tracing.span("data.upload"):
                static_dev = layout.scalars(static_hp)
            for w0, w1 in self._windows(pipes, vals, ctx.stop - ctx.start):
                slabs = self._draw(pipes, w1 - w0)
                with tracing.span("data.upload"):
                    slab = layout.slab(slabs)
                    steps, hp_xs = self._upload_rows(
                        ctx.start + w0, ctx.start + w1, layout.rows(
                            [{k: pl[j][0][k][w0:w1] for k in names}
                             for pl in plans]))
                with tracing.span("train.chunk", device=self._home,
                                  steps=(w1 - w0) * members, members=members):
                    layout.run(opt_name, static_dev, hp_xs, slab, steps)
            datas = [pipes[0].state()] * members if shared \
                else [p.state() for p in pipes]
            for m, (params, opt) in enumerate(layout.snapshots()):
                boundaries[m].append(
                    {"params": params, "opt": opt, "opt_name": opt_name,
                     "data": datas[m], "step": ctx.stop})
        return boundaries

    # ---------------------------------------------------- per-step reference
    @tracing.traced("train.chain")
    def run_stage_stepwise(self, state: Dict[str, Any], ctx: StageContext
                           ) -> Dict[str, Any]:
        """The plain data plane: one batch drawn and uploaded per training
        step, hp values uploaded per step (the walk's helpers with a
        one-step window).  Kept as the bit-exactness reference for the
        walk."""
        assert state["step"] == ctx.start, (state["step"], ctx.start)
        state, = self.on_device(state)
        vals, static_hp, opt_name, names = self._stage_plan(ctx)
        carry = (state["params"], self._init_opt(state, opt_name))
        pipe = self.pipeline_factory()
        pipe.restore(state["data"])
        with tracing.span("data.upload"):
            static_dev = self._scalars(static_hp)

        for i, step in enumerate(range(ctx.start, ctx.stop)):
            if "bs" in vals:
                pipe.set_batch_size(int(round(vals["bs"][i])))
            batch, = self._draw([pipe], 1)
            with tracing.span("data.upload"):
                slab = self._upload(batch)
                steps, (hp_xs,) = self._upload_rows(
                    step, step + 1, [{k: vals[k][i:i + 1] for k in names}])
            with tracing.span("train.chunk", device=self._home, steps=1,
                              members=1):
                carry = self._run_chunk(opt_name, carry, static_dev, hp_xs,
                                        slab, steps)

        return {"params": carry[0], "opt": carry[1], "opt_name": opt_name,
                "data": pipe.state(), "step": ctx.stop}

    # ------------------------------------------------------------- evaluate
    @tracing.traced("train.evaluate")
    def evaluate(self, state: Dict[str, Any], ctx: StageContext
                 ) -> Dict[str, float]:
        state, = self.on_device(state)
        batch = self.eval_batch
        if self._home != self.device:            # a mesh's first card
            batch = {k: v.to(self._home) for k, v in batch.items()}
        with torch.no_grad():
            loss, metrics = self.task.loss(state["params"], batch)
        self.evaluations += 1
        out = {"loss": float(loss)}
        out["val_acc"] = float(metrics.get(self.objective_from, -loss))
        for k, v in metrics.items():
            out[k] = float(v)
        return out

    def stage_seconds(self, ctx: StageContext) -> Optional[float]:
        return None  # wall-clock measured by the engine
