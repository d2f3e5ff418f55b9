"""Hippo's core: hp sequences, search plans, stage trees, scheduler, engine."""

from repro_torch.core.hpseq import (
    Constant, Cosine, CosineWarmRestarts, Cyclic, Exponential, HpConfig,
    Linear, MultiStep, Piecewise, Seq, StepLR, Warmup,
)
from repro_torch.core.trial import Trial
from repro_torch.core.searchplan import SearchPlan
from repro_torch.core.stagetree import (StageTreeBuilder, build_stage_tree,
                                  sibling_chain_groups, sibling_groups,
                                  stage_trees_equal)
from repro_torch.core.scheduler import (POLICIES, CriticalPathScheduler,
                                  FIFOScheduler, FairShareScheduler,
                                  SchedulingPolicy, WeightedFanoutScheduler,
                                  make_policy)
from repro_torch.core.engine import EngineStats, ExecutionEngine, StudyStats, Tuner
from repro_torch.core.faults import (FatalStageError, FaultError,
                                     FaultInjector, FaultyBackend,
                                     FaultyStore, StoreOutageError,
                                     TransientStageError, WorkerCrashed)
from repro_torch.core.trainer import (ChainNotFusable, SimulatedTrainer,
                                      StageContext, TrainerBackend)
from repro_torch.core.db import SearchPlanDB, study_key
from repro_torch.core.merge import k_wise_merge_rate, merge_rate, total_steps, unique_steps
from repro_torch.core.study import (PlanKeyMismatch, Study, StudyFuture,
                              StudyService, StudySpec, run_studies)
