"""Real-training backend: Hippo stages driving a PyTorch model (the §5.2
``Trainer`` counterpart), with a fused data plane.

``TorchTrainer`` executes a stage as a handful of *chunks*: each chunk
covers up to ``chunk_steps`` training steps, consuming a data slab
prefetched in one piece (``DataPipeline.next_batches``) and uploaded once,
and per-step hyper-parameter values uploaded once per chunk as one
``(n_steps,)`` f32 device tensor per name and sliced on the device (the
``setup(hp)`` hot-update of Figure 9 becomes "hp values are device values
of the step").  No step of a chunk reads a value back to the host, so the
host queues a whole chunk without waiting for the device.  Stage lengths
split into descending power-of-two chunks (:func:`chunk_lengths`).

The package runs eagerly: there is nothing to compile per chunk, and
``exec_calls`` counts chunks issued.

Spans (:mod:`repro_torch.utils.tracing`, recorded only while a profiler
or a ``recording()`` block is on): ``train.chain`` around a chain or a
stage, ``train.group`` around a sibling group, ``train.evaluate`` around
an evaluation; inside them, per chunk, ``data.slab`` (the slab drawn),
``data.upload`` (slab, hp rows, step indices and static scalars sent to
the device) and ``train.chunk`` (the chunk's steps, device-timed by CUDA
events, with its member-steps and group width).

Chain fusion: :meth:`run_chain` executes an entire scheduler-extracted
chain with the ``(params, opt)`` carry and the data pipeline held live
across every stage boundary — no checkpoint round-trip, no slab
re-prefetch between consecutive stages — while still returning a boundary
snapshot per stage for the dispatcher's write-behind checkpointing.
Optimizer updates write fresh tensors, so a snapshot is just a reference
to the carry at that boundary.

Everything a resumed trial needs is in the state tree:

    {"params", "opt", "opt_name", "data" (pipeline position), "step"}

so stage-based execution is *lossless*: training a prefix once and forking
the checkpoint yields bit-identical parameters to training each trial
straight through, and the fused / chain-fused paths are bit-identical to
the per-step loop (kept as :meth:`run_stage_stepwise`) on one device.

Kernel plane: ``use_kernel`` routes the optimizer update of every step
through the fused kernel
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

Sibling groups: :meth:`run_stages_batched` executes a group of sibling
stages — same ``[start, stop)``, static hps, hp names and batch-size
schedule, divergent hp *values* — as one call, and
:meth:`run_chains_batched` a group of parallel sibling chains, one stage
level at a time, with the group's carry and pipelines held across
boundaries; both return ``[member][stage]`` boundary snapshots.  A
mismatch raises ``ValueError``, which the dispatcher answers with
member-sequential chains.  Members whose data states are equal (siblings
forked from one checkpoint) share one pipeline and one slab.  Two tiers,
as in the JAX package, chosen by ``vectorize_groups`` (on for a CUDA
device, off on the CPU; an explicit value overrides):

* **vectorised** — the carry is member-stacked ``(M, ...)``; each step
  is the task's loss under ``torch.func.vmap`` over it (the shared slab
  broadcast with ``in_dims=None``, never stacked) and one ordinary
  ``torch.autograd.grad`` of the members' summed losses
  (:func:`group_value_and_grad`), so the task's kernels fold the group
  into one launch each, backward included (:mod:`repro_torch.kernels.ops`);
  then one member-stacked optimizer update
  (:func:`repro_torch.kernels.optim.stacked_apply_update`: one B1 launch
  per tree) with per-member hp values as ``(M,)`` device rows of
  step-major ``(n, M)`` tensors.  Member-stacked matrix products and
  convolutions (``bmm``, a grouped convolution) need not give solo's bits;
* **looped** — each member's chunk exactly as a solo run executes it,
  bit-equal to solo by construction.

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


class TorchTrainer(TrainerBackend):
    """Stage executor over any task exposing ``init(rng)`` and
    ``loss(params, batch) -> (scalar, metrics)``."""

    def __init__(self, task, pipeline_factory: Callable[[], DataPipeline],
                 eval_batch: Dict[str, np.ndarray],
                 default_optimizer: str = "momentum", seed: int = 0,
                 objective_from: str = "acc", fused: bool = True,
                 chunk_steps: int = 8,
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
        self.fused = fused
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

    @property
    def supports_batched_stages(self) -> bool:  # type: ignore[override]
        return self.fused

    @property
    def supports_chain_fusion(self) -> bool:  # type: ignore[override]
        return self.fused

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

    # -------------------------------------------------------------- execute
    def run_stage(self, state: Dict[str, Any], ctx: StageContext
                  ) -> Dict[str, Any]:
        if not self.fused:
            return self.run_stage_stepwise(state, ctx)
        return self._run_fused_chain(state, [ctx])[-1]

    def run_chain(self, state: Dict[str, Any],
                  ctxs: Sequence[StageContext]) -> List[Dict[str, Any]]:
        """Chain-fused execution: the carry stays on device across every
        stage boundary (one persistent pipeline, no host round-trip) and a
        boundary snapshot is returned per stage — bit-identical to running
        :meth:`run_stage` per stage."""
        if not self.fused:
            return super().run_chain(state, ctxs)
        return self._run_fused_chain(state, list(ctxs))

    def run_stages_batched(self, states: Sequence[Dict[str, Any]],
                           ctxs: Sequence[StageContext]
                           ) -> List[Dict[str, Any]]:
        """A sibling group of stages as one call (see the module
        docstring); one boundary state per member."""
        if not self.fused:
            return [self.run_stage_stepwise(s, c)
                    for s, c in zip(states, ctxs)]
        return [b[-1] for b in self._run_group(list(states),
                                               [[c] for c in ctxs])]

    def run_chains_batched(self, states: Sequence[Dict[str, Any]],
                           chains: Sequence[Sequence[StageContext]]
                           ) -> List[List[Dict[str, Any]]]:
        """A group of parallel sibling chains of equal depth, one stage
        level at a time over the group's carry, which persists across
        boundaries; ``[member][stage]`` boundary states."""
        if not self.fused:
            return [self.run_chain(s, c) for s, c in zip(states, chains)]
        return self._run_group(list(states), [list(c) for c in chains])

    @tracing.traced("train.chain")
    def _run_fused_chain(self, state: Dict[str, Any],
                         chain: List[StageContext]) -> List[Dict[str, Any]]:
        """Run one chain, returning the boundary state of every stage.  The
        carry ``(params, opt)`` and the data pipeline persist across stage
        boundaries; each boundary only snapshots the carry so the
        dispatcher can checkpoint it, then execution continues."""
        plans = [self._stage_plan(c) for c in chain]
        step = chain[0].start
        for c in chain:   # stages of one chain must be contiguous
            if c.start != step:
                raise ChainNotFusable(
                    f"chain stages must be contiguous: stage starts at "
                    f"{c.start}, previous stopped at {step}")
            step = c.stop
        assert state["step"] == chain[0].start, (state["step"], chain[0].start)
        state, = self.on_device(state)

        opt_name = plans[0][2]
        carry = self._at_rest(
            (state["params"], self._init_opt(state, opt_name)), 0)
        pipe = self.pipeline_factory()
        pipe.restore(state["data"])
        boundaries: List[Dict[str, Any]] = []

        for ctx, (vals, static_hp, stage_opt, names) in zip(chain, plans):
            if stage_opt != opt_name:
                # optimizer switch at the boundary: fresh slots, exactly as
                # run_stage would re-init on the restored state (and back
                # to the mesh's at-rest layout)
                params = self._whole(carry[0])
                carry = self._at_rest(
                    (params, init_opt_state(stage_opt, params)), 0)
                opt_name = stage_opt
            with tracing.span("data.upload"):
                static_dev = self._scalars(static_hp)
            for i0, i1, bs in self._bs_runs(vals, ctx.stop - ctx.start):
                if bs is not None:
                    pipe.set_batch_size(bs)
                w0 = i0
                for k_len in chunk_lengths(i1 - i0, self.chunk_steps):
                    w1 = w0 + k_len
                    with tracing.span("data.slab"):
                        batches = pipe.next_batches(k_len)
                    with tracing.span("data.upload"):
                        slab = self._upload(batches)
                        steps = torch.arange(ctx.start + w0, ctx.start + w1,
                                             dtype=torch.int32,
                                             device=self._home)
                        hp_xs = {k: torch.tensor(
                            np.asarray(vals[k][w0:w1], np.float32),
                            device=self._home) for k in names}
                    work = self._whole(carry)
                    carry = None         # the shards are not pinned
                    with tracing.span("train.chunk", device=self._home,
                                      steps=k_len, members=1):
                        work = self._run_chunk(opt_name, work, static_dev,
                                               hp_xs, slab, steps)
                    carry = self._at_rest(work, 0)
                    del work
                    w0 = w1
            # a snapshot leaves the trainer whole, on the mesh's first
            # device: the store, evaluation and the handoff see one device
            params, opt = self._whole(carry)
            boundaries.append(
                {"params": params, "opt": opt, "opt_name": opt_name,
                 "data": pipe.state(), "step": ctx.stop})
        return boundaries

    # --------------------------------------------------------- sibling groups
    def _check_group(self, states, chains, plans) -> None:
        """The conditions under which members run as one group; a
        ``ValueError`` names the first one broken."""
        depth = len(chains[0])
        if any(len(ch) != depth for ch in chains):
            raise ValueError("batched chains must share their depth")
        for s, ch in zip(states, chains):
            step = ch[0].start
            assert s["step"] == step, (s["step"], step)
            for c in ch:
                if c.start != step:
                    raise ValueError(
                        f"chain stages must be contiguous: stage starts at "
                        f"{c.start}, previous stopped at {step}")
                step = c.stop
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

    @tracing.traced("train.group")
    def _run_group(self, states: List[Dict[str, Any]],
                   chains: List[List[StageContext]]
                   ) -> List[List[Dict[str, Any]]]:
        """Run ``M`` parallel chains (one per member) of equal depth,
        returning ``[member][stage]`` boundary states: the group's carry —
        member-stacked on the vectorised tier, one per member on the looped
        tier — and its pipelines persist across stage boundaries."""
        group = len(states)
        plans = [[self._stage_plan(c) for c in ch] for ch in chains]
        self._check_group(states, chains, plans)
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
        carries = [(s["params"], self._init_opt(s, opt_name))
                   for s in states]
        vec = self.vectorize_groups
        if vec:
            # at rest on a mesh with the member axis whole (n_lead 1); a
            # list in a chunk, updated in place step by step (see
            # _run_group_chunk)
            carry = self._at_rest(tuple(
                _stack([c[i] for c in carries]) for i in (0, 1)), 1)
        else:
            carries = [self._at_rest(c, 0) for c in carries]
        boundaries: List[List[Dict[str, Any]]] = [[] for _ in range(group)]

        for j, ctx0 in enumerate(chains[0]):
            vals0, static_hp, stage_opt, names = plans[0][j]
            if stage_opt != opt_name:
                # optimizer switch at the boundary: fresh slots, exactly as
                # run_stage would re-init on the restored state (and back
                # to the mesh's at-rest layout)
                opt_name = stage_opt
                if vec:
                    params = self._whole(carry[0])
                    carry = self._at_rest(
                        (params, init_opt_state(opt_name, params)), 1)
                else:
                    carries = [self._at_rest(
                        (p, init_opt_state(opt_name, p)), 0) for p in
                        (self._whole(c[0]) for c in carries)]
            with tracing.span("data.upload"):
                if vec:
                    static_dev = {k: torch.full(
                        (group,), v, dtype=torch.float32, device=self._home)
                        for k, v in static_hp.items()}
                else:
                    static_dev = self._scalars(static_hp)
            for i0, i1, bs in self._bs_runs(vals0, ctx0.stop - ctx0.start):
                if bs is not None:
                    for pipe in pipes:
                        pipe.set_batch_size(bs)
                w0 = i0
                for k_len in chunk_lengths(i1 - i0, self.chunk_steps):
                    w1 = w0 + k_len
                    with tracing.span("data.slab"):
                        slabs = [pipe.next_batches(k_len) for pipe in pipes]
                    with tracing.span("data.upload"):
                        steps = torch.arange(ctx0.start + w0, ctx0.start + w1,
                                             dtype=torch.int32,
                                             device=self._home)
                        if vec:
                            # step-major (n, M): row i is one contiguous
                            # (M,) vector, the kernel's per-member operand
                            hp_xs = {k: torch.from_numpy(
                                np.ascontiguousarray(np.asarray(
                                    [pl[j][0][k][w0:w1] for pl in plans],
                                    np.float32).T)).to(self._home)
                                for k in names}
                            slab = self._upload(slabs[0] if shared else {
                                k: np.stack([sl[k] for sl in slabs], axis=1)
                                for k in slabs[0]})
                        else:
                            up = [self._upload(sl) for sl in slabs]
                            hps = [{k: torch.tensor(
                                np.asarray(pl[j][0][k][w0:w1], np.float32),
                                device=self._home) for k in names}
                                for pl in plans]
                    chunk = tracing.span("train.chunk", device=self._home,
                                         steps=k_len * group, members=group)
                    if vec:
                        work = list(self._whole(carry))
                        carry = None     # pins neither input nor shards
                        with chunk:
                            self._run_group_chunk(opt_name, work, static_dev,
                                                  hp_xs, slab, steps, shared)
                        carry = self._at_rest(tuple(work), 1)
                    else:
                        with chunk:
                            for m, hp_m in enumerate(hps):
                                work = self._whole(carries[m])
                                carries[m] = None    # nor are member m's
                                carries[m] = self._at_rest(self._run_chunk(
                                    opt_name, work, static_dev, hp_m,
                                    up[0 if shared else m], steps), 0)
                                del work
                    w0 = w1
            # snapshots leave the trainer whole, on the mesh's first device
            if vec:
                whole = self._whole(carry)
                snaps = [tuple(tree_map(lambda x, m=m: x[m].clone(), c)
                               for c in whole) for m in range(group)]
                del whole
            else:
                snaps = [self._whole(c) for c in carries]
            datas = [pipes[0].state()] * group if shared \
                else [p.state() for p in pipes]
            for m in range(group):
                boundaries[m].append(
                    {"params": snaps[m][0], "opt": snaps[m][1],
                     "opt_name": opt_name, "data": datas[m],
                     "step": ctx0.stop})
        return boundaries

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

    # ---------------------------------------------------- per-step reference
    @tracing.traced("train.chain")
    def run_stage_stepwise(self, state: Dict[str, Any], ctx: StageContext
                           ) -> Dict[str, Any]:
        """The plain data plane: one batch materialised on the host and
        uploaded per training step, hp values uploaded per step.  Kept as
        the bit-exactness reference for the fused paths."""
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
            with tracing.span("data.slab"):
                batch = pipe.next_batch()
            with tracing.span("data.upload"):
                slab = self._upload({k: v[None] for k, v in batch.items()})
                hp_xs = {k: torch.tensor([vals[k][i]], dtype=torch.float32,
                                         device=self._home) for k in names}
                steps = torch.tensor([step], dtype=torch.int32,
                                     device=self._home)
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
