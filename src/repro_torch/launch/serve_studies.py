"""Launcher: drive the front-door study gateway under mixed traffic.

The operational entry point for the deployment — a supervisor would run
exactly this loop: keep one :class:`~repro_torch.frontdoor.StudyGateway` open,
admit studies from many tenants over many plan keys as they arrive, lease
the worker fleet across the per-key sessions, snapshot periodically, and
(after a crash or a rolling restart) resume from the newest snapshot
instead of recomputing.

Examples::

    # one key, default tenant — the classic single-session service
    PYTHONPATH=src python -m repro_torch.launch.serve_studies \\
        --studies 4 --arrival-gap 3600 --workers 40

    # multi-tenant: weighted quotas, bounded queues, a concurrency cap
    PYTHONPATH=src python -m repro_torch.launch.serve_studies \\
        --studies 8 --keys 2 --workers 12 --max-concurrent 4 \\
        --tenant-quota alice:2.0 --tenant-quota bob:1.0:8:2

    # kill/restore proof: snapshot mid-run, discard the live gateway,
    # finish from disk — served totals match the uninterrupted run
    PYTHONPATH=src python -m repro_torch.launch.serve_studies \\
        --studies 4 --snapshot-at 9000 --session /tmp/hippo-gw.snap

``--snapshot-at T`` drives the deployment to global virtual time ``T``,
snapshots the whole gateway envelope (every session + admission state +
lease table), then **kills the live gateway** and finishes from the
snapshot via ``StudyGateway.restore``.  Uses the simulator backend, so it
touches no device; a caller serves real training by passing
``main(argv, backend=...)`` a factory of ``TorchTrainer`` s.
``--devices-per-worker N`` gives every slot an ``N``-device
:class:`~repro_torch.dist.meshes.WorkerMesh` (``plan_worker_meshes``),
over which a ``TorchTrainer`` runs each stage sharded; a backend that
cannot run such a mesh (a CUDA ``TorchTrainer`` whose process sees fewer
cards) refuses it before any work starts.

The port of the JAX package's ``repro.launch.serve_studies``: the same
flags and output lines.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

from repro_torch.core import FaultInjector, SearchPlanDB, StudySpec
from repro_torch.core.engine import session_rotation
from repro_torch.core.trainer import SimulatedTrainer
from repro_torch.core.tuners import GridSearchSpace, GridTuner
from repro_torch.dist.meshes import plan_worker_meshes
from repro_torch.core.hpseq import (Constant, Exponential, MultiStep, StepLR,
                                    Warmup)
from repro_torch.frontdoor import StudyGateway, TenantQuota
from repro_torch.train.checkpoint import CheckpointStore, DirectoryObjectStore

EXAMPLES = """\
examples:
  # one key, one tenant (the classic single-session service)
  serve_studies --studies 4 --arrival-gap 3600 --workers 40

  # two teams with weighted fair shares (alice gets 2x bob's share) and a
  # bounded queue + running cap for bob; studies spread over 2 plan keys
  serve_studies --studies 8 --keys 2 --workers 12 --max-concurrent 4 \\
      --tenant-quota alice:2.0 --tenant-quota bob:1.0:8:2

  # continuous durability: rotated gateway snapshots every 600 virtual
  # seconds; on restart the deployment resumes from the newest slot
  serve_studies --studies 6 --snapshot-every 600 --session /tmp/gw.snap

  # prove the kill/restore path end-to-end
  serve_studies --studies 4 --snapshot-at 9000 --session /tmp/gw.snap
"""


def _space(seed: int, steps: int) -> GridSearchSpace:
    lrs = [StepLR(0.1, 0.1, [90, 135]),
           StepLR(0.1, 0.1, [100, 150]),
           Warmup(5, 0.1, StepLR(0.1, 0.1, [90, 135])),
           Warmup(5, 0.1, Exponential(0.1, 0.95))]
    # rotate the lr menu per arriving team: heavy overlap, not identity
    lrs = lrs[seed % len(lrs):] + lrs[:seed % len(lrs)]
    return GridSearchSpace(
        fns={"lr": lrs[:3],
             "bs": [Constant(128), MultiStep(128, [70], values=[128, 256])]})


def _parse_quota(text: str):
    """NAME:WEIGHT[:MAX_QUEUED[:MAX_RUNNING]] -> (name, TenantQuota)."""
    parts = text.split(":")
    if len(parts) < 2 or len(parts) > 4:
        raise argparse.ArgumentTypeError(
            f"bad --tenant-quota {text!r}: expected "
            "NAME:WEIGHT[:MAX_QUEUED[:MAX_RUNNING]]")
    name = parts[0]
    try:
        weight = float(parts[1])
        max_queued = int(parts[2]) if len(parts) > 2 else 16
        max_running = int(parts[3]) if len(parts) > 3 else None
        return name, TenantQuota(weight=weight, max_queued=max_queued,
                                 max_running=max_running)
    except (ValueError, argparse.ArgumentTypeError) as exc:
        raise argparse.ArgumentTypeError(
            f"bad --tenant-quota {text!r}: {exc}")


def _submit_all(gw: StudyGateway, args, tenants) -> None:
    for i in range(args.studies):
        model = (args.model if args.keys == 1
                 else f"{args.model}-v{i % args.keys}")
        spec = StudySpec(model, args.dataset, ("lr", "bs"))
        gw.submit(spec, GridTuner(_space(i, args.steps).trials(args.steps)),
                  tenant=tenants[i % len(tenants)],
                  at=i * args.arrival_gap)


def _report_session(stats, label: str = "") -> None:
    if label:
        print(f"session {label}:")
    print(f"served: {stats.gpu_hours:.1f} GPU-h, "
          f"e2e {stats.end_to_end / 3600:.2f} h, "
          f"{stats.steps_run} steps, {stats.rounds} scheduling rounds")
    if stats.ckpt_bytes_written:
        print(f"ckpt plane: {stats.ckpt_bytes_written / 1e6:.1f} MB written "
              f"({stats.ckpt_delta_commits} delta commits, "
              f"dedup {stats.dedup_ratio:.2f}x), tiers "
              f"mem/disk/remote {stats.ckpt_mem_hits}/{stats.ckpt_disk_hits}"
              f"/{stats.ckpt_remote_hits} hits, "
              f"{stats.ckpt_tier_demotions} demotions, "
              f"{stats.ckpt_tier_promotions} promotions, "
              f"{stats.ckpt_tmp_reclaimed} stale tmp reclaimed")
    if stats.mesh_placements:
        print(f"mesh plane: {stats.mesh_placements} mesh placements, "
              f"{stats.placement_rejections} rejections, "
              f"{stats.d2d_handoffs} d2d handoffs")
    if stats.stage_failures or stats.faults_injected:
        print(f"fault plane: {stats.faults_injected} faults injected, "
              f"{stats.stage_failures} stage failures, "
              f"{stats.stage_retries} retries, "
              f"{stats.groups_degraded} groups degraded, "
              f"{stats.workers_quarantined} quarantines, "
              f"{stats.wasted_gpu_seconds / 3600:.2f} GPU-h wasted")
    for sid, ss in sorted(stats.by_study.items()):
        print(f"  {sid}: {ss.gpu_seconds / 3600:7.1f} GPU-h  "
              f"{ss.steps_run:6d} steps served  "
              f"{ss.instant_results:3d} instant")


def _report(gw: StudyGateway, archive) -> None:
    multi = len(archive) > 1
    for key, stats in archive:
        _report_session(stats, label=key[:12] if multi else "")
    ledger = gw.tenant_ledger()
    if len(ledger) > 1 or set(ledger) != {"default"}:
        for tenant in sorted(ledger):
            e = ledger[tenant]
            print(f"tenant {tenant}: {e['gpu_seconds'] / 3600:.1f} GPU-h "
                  f"over {e['studies']:.0f} studies "
                  f"({e['queued']:.0f} still queued at the door)")


def _store_factory(args):
    """Per-plan-key tiered checkpoint plane from the CLI knobs (None =
    every session gets its own in-memory store)."""
    if not args.ckpt_dir:
        return None

    def factory(key: str) -> CheckpointStore:
        d = os.path.join(args.ckpt_dir, key[:16])
        remote = (DirectoryObjectStore(os.path.join(args.remote_dir,
                                                    key[:16]))
                  if args.remote_dir else None)
        cap = (int(args.disk_capacity_mb * 1e6)
               if args.disk_capacity_mb else None)
        return CheckpointStore(d, remote=remote, disk_capacity_bytes=cap)

    return factory


def main(argv=None, backend=None):
    """Run the deployment the flags describe (``argv``, default
    ``sys.argv[1:]``) and return the gateway's archive, ``[(plan key,
    EngineStats)]``.  ``backend`` is a zero-argument factory of the
    trainer each gateway (and each restore) runs over; default: the
    simulator the flags configure."""
    ap = argparse.ArgumentParser(
        description="front-door study gateway under mixed multi-tenant "
                    "traffic (simulated backend)",
        epilog=EXAMPLES,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--studies", type=int, default=4)
    ap.add_argument("--steps", type=int, default=160)
    ap.add_argument("--workers", type=int, default=40,
                    help="worker slots in the gateway-owned fleet (leased "
                         "across the per-key sessions)")
    ap.add_argument("--keys", type=int, default=1,
                    help="distinct plan keys to spread the studies over "
                         "(model name is varied); each key gets its own "
                         "session, fleet share follows demand")
    ap.add_argument("--arrival-gap", type=float, default=3600.0,
                    help="virtual seconds between study arrivals")
    ap.add_argument("--model", default="resnet20")
    ap.add_argument("--dataset", default="cifar10")
    ap.add_argument("--policy", default="fair_share")
    ap.add_argument("--sec-per-step", type=float, default=60.0)
    ap.add_argument("--tenant-quota", action="append", default=[],
                    metavar="NAME:WEIGHT[:MAX_QUEUED[:MAX_RUNNING]]",
                    help="per-tenant admission quota (repeatable).  WEIGHT "
                         "scales the tenant's fair share at the door and "
                         "inside shared sessions; MAX_QUEUED bounds its "
                         "admission queue (default 16); MAX_RUNNING caps "
                         "its concurrently-running studies.  Studies are "
                         "submitted round-robin across the named tenants.")
    ap.add_argument("--max-concurrent", type=int, default=None,
                    help="gateway-wide cap on concurrently-running studies; "
                         "over-cap submissions wait at the door "
                         "(queued_admission) and are admitted least-"
                         "weighted-usage-first")
    ap.add_argument("--session", default=None,
                    help="gateway snapshot path (required by --snapshot-at)")
    ap.add_argument("--snapshot-at", type=float, default=None,
                    help="global virtual time to snapshot at; the live "
                         "gateway is then discarded and the run finishes "
                         "via restore")
    ap.add_argument("--snapshot-every", type=float, default=None,
                    help="continuous durability: rotate a gateway snapshot "
                         "to --session every T virtual seconds; on startup "
                         "the deployment resumes from the newest readable "
                         "rotation slot (a SIGKILL loses at most one "
                         "interval)")
    ap.add_argument("--snapshot-keep", type=int, default=3,
                    help="rotation slots kept by --snapshot-every")
    ap.add_argument("--inject-faults", type=int, default=None, metavar="SEED",
                    help="deterministic fault injection: worker crashes, "
                         "transient stage failures, store outages and "
                         "admission deferrals drawn from this seed (same "
                         "seed => same fault schedule)")
    ap.add_argument("--fault-rates", default="0.05,0.02,0.01",
                    metavar="STAGE,CRASH,OUTAGE[,ADMISSION]",
                    help="per-draw probabilities used by --inject-faults")
    ap.add_argument("--throttle", type=float, default=0.0,
                    help="wall seconds to sleep between engine steps "
                         "(paces the virtual-time simulator for demos and "
                         "for exercising the signal handlers)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory for the checkpoint plane (enables "
                         "delta-encoded durable checkpoints, one "
                         "subdirectory per plan key; default: in-memory "
                         "stores)")
    ap.add_argument("--remote-dir", default=None,
                    help="directory standing in for the remote object-store "
                         "tier (requires --ckpt-dir)")
    ap.add_argument("--disk-capacity-mb", type=float, default=None,
                    help="local disk tier capacity; LRU blobs past it "
                         "demote to --remote-dir")
    ap.add_argument("--devices-per-worker", type=int, default=0,
                    help="give every worker slot a mesh of this many "
                         "devices (0 = plain thread workers).  The "
                         "simulator accounts the mesh width; the PyTorch "
                         "trainer runs a one-device mesh and refuses a "
                         "wider one")
    ap.add_argument("--mesh-host", default="host0",
                    help="host label for the worker meshes (device-to-"
                         "device checkpoint handoff is host-local)")
    args = ap.parse_args(argv)
    if args.remote_dir and not args.ckpt_dir:
        ap.error("--remote-dir requires --ckpt-dir")
    if args.disk_capacity_mb and not args.remote_dir:
        # the capacity only drives demotion to the remote tier; without one
        # it would be silently ignored
        ap.error("--disk-capacity-mb requires --remote-dir")
    if args.snapshot_every is not None and not args.session:
        ap.error("--snapshot-every requires --session PATH")
    if args.keys < 1:
        ap.error("--keys must be >= 1")

    try:
        quotas = dict(_parse_quota(q) for q in args.tenant_quota)
    except argparse.ArgumentTypeError as exc:
        ap.error(str(exc))
    tenants = sorted(quotas) or ["default"]

    if backend is None:
        def backend():
            return SimulatedTrainer(base_seconds_per_step=args.sec_per_step,
                                    horizon=args.steps)

    def injector():
        if args.inject_faults is None:
            return None
        rates = [float(x) for x in args.fault_rates.split(",")]
        stage, crash, outage = rates[:3]
        admission = rates[3] if len(rates) > 3 else 0.0
        return FaultInjector(args.inject_faults, stage_fault_rate=stage,
                             crash_rate=crash, outage_rate=outage,
                             admission_fault_rate=admission)

    meshes = (plan_worker_meshes(args.workers, args.devices_per_worker,
                                 host=args.mesh_host)
              if args.devices_per_worker > 0 else None)
    restored = False
    if args.session and session_rotation(args.session):
        # a prior --snapshot-every run left rotated snapshots: resume the
        # whole deployment from the newest readable slot (the restored
        # envelope carries every session, the admission queue, the lease
        # table AND the snapshot cadence)
        gw = StudyGateway.restore_latest(SearchPlanDB(), args.session,
                                         backend(),
                                         store_factory=_store_factory(args),
                                         fault_injector=injector())
        restored = True
        print(f"restored gateway at t={gw.time:.0f}s from newest rotation "
              f"slot ({len(gw.sessions)} sessions, "
              f"{len(gw.futures)} studies attached)")
    else:
        gw = StudyGateway(SearchPlanDB(), backend(),
                          n_slots=None if meshes else args.workers,
                          slot_meshes=meshes, quotas=quotas,
                          max_concurrent=args.max_concurrent,
                          fault_injector=injector(),
                          store_factory=_store_factory(args),
                          policy=args.policy)
        _submit_all(gw, args, tenants)
    if args.snapshot_every is not None:
        gw.enable_auto_snapshot(args.session, args.snapshot_every,
                                keep=args.snapshot_keep)

    # graceful shutdown: SIGTERM/SIGINT finish the current engine step,
    # snapshot the gateway to --session, and exit cleanly — a supervisor's
    # rolling restart then resumes via the startup restore above
    shutdown = {"sig": None}

    def _on_signal(signum, frame):
        shutdown["sig"] = signum

    prev_handlers = {s: signal.signal(s, _on_signal)
                     for s in (signal.SIGTERM, signal.SIGINT)}

    if args.snapshot_at is not None and not restored:
        if not args.session:
            ap.error("--snapshot-at requires --session PATH")
        gw.run_until(args.snapshot_at)
        path = gw.snapshot(args.session)
        done = sum(f.done() for f in gw.futures)
        print(f"snapshot at t={gw.time:.0f}s -> {path} "
              f"({done}/{len(gw.futures)} studies done); "
              "discarding live gateway, resuming from disk")
        del gw                        # the "crash"
        # fresh stores over the same tiers: committed blobs (local or
        # demoted to remote) are re-indexed at init and picked up by the
        # restore's eager recompute-on-miss check
        gw = StudyGateway.restore(SearchPlanDB(), args.session, backend(),
                                  store_factory=_store_factory(args),
                                  fault_injector=injector())

    try:
        while gw.step():
            if args.throttle:
                time.sleep(args.throttle)
            if shutdown["sig"] is not None:
                name = signal.Signals(shutdown["sig"]).name
                if args.session:
                    # with rotation on, the final snapshot must become the
                    # newest slot — restore_latest only scans slots, so a
                    # plain base-path write would be ignored on restart
                    if args.snapshot_every is not None:
                        path = gw.snapshot_rotated()
                    else:
                        path = gw.snapshot(args.session)
                    print(f"{name}: final snapshot at t={gw.time:.0f}s "
                          f"-> {path}; exiting")
                else:
                    print(f"{name}: no --session configured, exiting "
                          "without a snapshot")
                sys.exit(0)
    finally:
        # main() runs in-process under the launcher tests: put the
        # process's previous handlers back
        for s, h in prev_handlers.items():
            signal.signal(s, h)
    archive = gw.close()
    _report(gw, archive)
    return archive


if __name__ == "__main__":
    main()
