"""Trainer backends — the worker-side training logic (Hippo §5.2, Figure 9).

The paper's users override a ``Trainer`` with ``setup(hp)`` (hot-update of
hyper-parameter values), ``train`` (one logical iteration), ``evaluate``,
``save`` and ``load``.  Here a backend executes whole *stages*: it receives
the stage's node descriptor (the canonical hyper-parameter piece), the step
range, and the state loaded from the resume checkpoint, and returns the new
state plus (optionally) evaluation metrics.

Backends:

* :class:`SimulatedTrainer` — a deterministic analytic response surface.
  Used by the discrete-event cluster simulator that reproduces the paper's
  GPU-hour / end-to-end numbers.  Crucially, its state is a pure function
  of the *hyper-parameter value trajectory* (never the trial id), so two
  trials sharing a prefix produce bit-identical states on the shared range
  — the same property real deterministic training has, and the premise of
  stage sharing.

* ``TorchTrainer`` (:mod:`repro_torch.train.torch_trainer`) — real PyTorch
  training with per-step hyper-parameter values held as device tensors
  over prefetched data slabs; used by the runnable examples and the
  losslessness tests.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.values import desc_static, desc_values

__all__ = ["TrainerBackend", "SimulatedTrainer", "StageContext",
           "ChainNotFusable"]


class ChainNotFusable(ValueError):
    """A backend refuses to run these stages as one fused chain (they are
    not contiguous, say).  The only error the dispatcher answers with the
    per-stage loop; any other exception from a backend propagates."""


@dataclass(frozen=True)
class StageContext:
    """What a backend needs to execute one stage."""

    node_id: str
    desc: Dict[str, Any]      # canonical hp-piece descriptor of the node
    node_start: int           # global step where the node's config takes over
    start: int                # stage [start, stop)
    stop: int
    path_key: str             # content hash of the node's path (ckpt address)


class TrainerBackend:
    """Interface between the execution engine and the training substrate."""

    #: True when :meth:`run_stages_batched` executes a whole sibling group in
    #: one device call (the dispatcher then runs its grouping pass); the
    #: default sequential fallback keeps simulated/unfused backends correct
    #: without pretending they batch.
    supports_batched_stages: bool = False

    #: True when :meth:`run_chain` keeps the state carry on device across
    #: stage boundaries (no host round-trip between consecutive stages of a
    #: chain).  The dispatcher then executes whole scheduler-extracted
    #: chains through it and write-behinds the boundary checkpoints.
    supports_chain_fusion: bool = False

    def init_state(self) -> Any:
        """Fresh model state (step 0)."""
        raise NotImplementedError

    def run_stage(self, state: Any, ctx: StageContext) -> Any:
        """Train from ctx.start to ctx.stop under ctx.desc; return new state."""
        raise NotImplementedError

    def run_stages_batched(self, states: Sequence[Any],
                           ctxs: Sequence[StageContext]) -> List[Any]:
        """Execute a group of sibling stages — same ``[start, stop)``, same
        static hyper-parameters and batch shapes, divergent hp *values* —
        returning one new state per member.  Backends that can fuse the
        group into a single compiled call override this (and set
        ``supports_batched_stages``); the default runs members sequentially,
        which is always semantically equivalent."""
        return [self.run_stage(s, c) for s, c in zip(states, ctxs)]

    def run_chain(self, state: Any, ctxs: Sequence[StageContext]) -> List[Any]:
        """Execute a whole chain — consecutive stages, each starting where
        the previous stopped — returning the state at EVERY stage boundary
        (``len(ctxs)`` states; the dispatcher checkpoints each one and posts
        per-stage events, so the virtual clock keeps stage granularity).
        Backends that keep the carry on device across boundaries override
        this (and set ``supports_chain_fusion``); the default per-stage loop
        is always semantically equivalent."""
        out: List[Any] = []
        for ctx in ctxs:
            if ctx.stop > ctx.start:
                state = self.run_stage(state, ctx)
            out.append(state)
        return out

    def run_chains_batched(self, states: Sequence[Any],
                           chains: Sequence[Sequence[StageContext]]
                           ) -> List[List[Any]]:
        """Execute a group of parallel sibling *chains* — equal depth, and
        stage-wise identical ``[start, stop)`` / static hps / hp names /
        batch-size schedules, divergent hp values — returning the per-stage
        boundary states of every member (``[member][stage]``).  Fusing
        backends run each stage level as one batched call over member-
        stacked carries; the default runs member chains sequentially."""
        return [self.run_chain(s, c) for s, c in zip(states, chains)]

    def evaluate(self, state: Any, ctx: StageContext) -> Dict[str, float]:
        """Metrics of the model at ``ctx.stop``."""
        raise NotImplementedError

    def stage_seconds(self, ctx: StageContext) -> Optional[float]:
        """Virtual duration of the stage (simulated backends); None = measure
        wall-clock (real backends)."""
        return None

    def overheads(self) -> Tuple[float, float]:
        """(checkpoint-load seconds, checkpoint-save seconds)."""
        return (0.0, 0.0)

    #: True when every member of a batched group call gets the bits its
    #: solo run would (a looped group tier, the simulator): a retry may then
    #: re-put a boundary that the other tier committed.  A vectorised tier
    #: (member-stacked products) clears it, and the dispatcher then takes
    #: back the unannounced boundary puts of a unit that fails.
    batched_bitwise_solo: bool = True

    def clone_state(self, state: Any) -> Any:
        """An independent copy of a state pytree, for a caller that hands
        one restored state to several consumers.  Backends that never
        mutate a leaf in place override with a cheap container copy."""
        return copy.deepcopy(state)

    # ------------------------------------------------------- mesh protocol
    def check_mesh(self, mesh: Any) -> None:
        """Raise if this backend can never execute on ``mesh`` (a
        :class:`repro_torch.dist.meshes.WorkerMesh`).  Called when a worker
        with that mesh joins an engine, and by the gateway for its slots,
        so a fleet the backend cannot run is refused before any work
        starts.  Default: every mesh (the simulator schedules against
        inert descriptors)."""

    def set_mesh(self, mesh: Optional[Any]) -> None:
        """Bind subsequent ``run_*`` calls to the dispatching worker's
        device mesh, or reset with ``None``.  Host-only backends ignore
        it — the dispatcher calls this before every execution, so it must
        be cheap."""

    def mesh_compatible(self, mesh: Any,
                        ctxs: Sequence[StageContext]) -> bool:
        """Can the work described by ``ctxs`` run on ``mesh``?  The
        dispatcher skips incompatible workers during placement (counting
        ``placement_rejections``).  Default: any mesh hosts any work."""
        return True

    def device_transfer(self, state: Any, mesh: Optional[Any]) -> Any:
        """Device-to-device handoff of a boundary state to a worker bound
        to ``mesh``, bypassing the checkpoint store.  Must return a state
        no one else holds (a fresh copy on the mesh's device); return
        ``None`` to decline — the dispatcher then falls back to the
        store."""
        return self.clone_state(state)


# ---------------------------------------------------------------------------
# Simulated trainer
# ---------------------------------------------------------------------------


class SimulatedTrainer(TrainerBackend):
    """Deterministic analytic model of training dynamics.

    The state carries accumulated *progress*; each step contributes
    ``gain(lr, bs, momentum, step)`` where the gain peaks when the learning
    rate tracks an ideal annealing trajectory ``lr*(step) = lr0 / (1 + step/T)``
    — so schedules that decay (StepLR, cosine, exponential) dominate
    constants, as in the paper's Figure 2.  Validation accuracy saturates
    with progress: ``acc = a_max · (1 − exp(−progress / T))``.

    ``seconds_per_step`` scales linearly with batch size over the reference
    batch (data-parallel cost model) — this drives the simulator clock and
    the critical-path profile.
    """

    def __init__(self, lr0: float = 0.1, horizon: int = 200,
                 a_max: float = 0.95, base_seconds_per_step: float = 1.0,
                 ref_batch: float = 128.0, load_seconds: float = 2.0,
                 save_seconds: float = 2.0, eval_seconds: float = 5.0):
        self.lr0 = lr0
        self.horizon = horizon
        self.a_max = a_max
        self.base_seconds_per_step = base_seconds_per_step
        self.ref_batch = ref_batch
        self.load_seconds = load_seconds
        self.save_seconds = save_seconds
        self.eval_seconds = eval_seconds

    # ------------------------------------------------------------- dynamics
    def init_state(self) -> Dict[str, float]:
        return {"progress": 0.0, "step": 0}

    def _gain(self, step: int, hp: Dict[str, float]) -> float:
        lr = hp.get("lr", self.lr0)
        if lr <= 0:
            return 0.0
        ideal = self.lr0 / (1.0 + step / max(1.0, self.horizon / 4))
        # log-distance to the ideal annealed lr; too-high lr hurts more.
        d = math.log(lr / ideal)
        gain = math.exp(-(d * d) / (2.0 * 1.2 ** 2))
        mom = hp.get("momentum", 0.9)
        gain *= 1.0 - 0.5 * abs(mom - 0.9)
        bs = hp.get("bs", self.ref_batch)
        # larger batches take fewer, bigger steps: mild sub-linear utility
        gain *= (bs / self.ref_batch) ** 0.5
        return gain

    def run_stage(self, state: Dict[str, float], ctx: StageContext) -> Dict[str, float]:
        assert state["step"] == ctx.start, (
            f"state at step {state['step']} cannot run stage starting {ctx.start}")
        vals = desc_values(ctx.desc, ctx.node_start, ctx.start, ctx.stop)
        static = desc_static(ctx.desc)
        # float() detaches from the (read-only, cache-shared) restored leaf:
        # += on a 0-d numpy view would mutate the checkpoint store's cached
        # tree in place
        progress = float(state["progress"])
        names = list(vals)
        for i, step in enumerate(range(ctx.start, ctx.stop)):
            hp = {k: vals[k][i] for k in names}
            hp.update({k: v for k, v in static.items() if isinstance(v, (int, float))})
            progress += self._gain(step, hp)
        return {"progress": progress, "step": ctx.stop}

    def evaluate(self, state: Dict[str, float], ctx: StageContext) -> Dict[str, float]:
        # deterministic "noise" keyed by the computation path, NOT the trial:
        # two merged trials must observe the same metric.
        jitter = (int(ctx.path_key[:8], 16) % 1000) / 1000.0 - 0.5
        acc = self.a_max * (1.0 - math.exp(-state["progress"] / (self.horizon / 3)))
        acc *= 1.0 + 0.01 * jitter
        return {"val_acc": acc, "loss": max(0.02, 2.3 * math.exp(
            -state["progress"] / (self.horizon / 3)))}

    # --------------------------------------------------------------- timing
    def stage_seconds(self, ctx: StageContext) -> float:
        vals = desc_values(ctx.desc, ctx.node_start, ctx.start, ctx.stop)
        bs = vals.get("bs")
        sec = 0.0
        for i in range(ctx.stop - ctx.start):
            scale = (bs[i] / self.ref_batch) if bs else 1.0
            sec += self.base_seconds_per_step * scale
        return sec

    def overheads(self) -> Tuple[float, float]:
        return (self.load_seconds, self.save_seconds)
