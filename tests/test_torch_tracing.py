"""The port's tracer (``repro_torch.utils.tracing``): off, a study records
nothing, reads no clock and makes no CUDA event; under a profiler or a
``recording()`` block, the same study leaves a span tree whose shape
holds the engine's own counts."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import Constant, HpConfig, MultiStep, SearchPlanDB, Study
from repro_torch.core.trainer import StageContext
from repro_torch.core.trial import Trial
from repro_torch.core.tuners import GridTuner
from repro_torch.data import DataPipeline
from repro_torch.train.checkpoint import CheckpointStore
from repro_torch.train.torch_trainer import TorchTrainer
from repro_torch.utils import tracing
from test_torch_trainer import StepwiseTrainer

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)


class TinyTask:
    """Linear softmax classifier."""

    def init(self, gen):
        return {"w": 0.1 * torch.randn((16, 4), generator=gen),
                "b": torch.zeros((4,))}

    def loss(self, params, batch):
        logits = batch["x"] @ params["w"] + params["b"]
        nll = -torch.gather(F.log_softmax(logits, dim=-1), 1,
                            batch["y"][:, None]).mean()
        acc = (torch.argmax(logits, -1) == batch["y"]).float().mean()
        return nll, {"acc": acc}


def tiny_dataset(n=128, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(0, 1, (n, 16)).astype(np.float32),
            "y": rng.integers(0, 4, n).astype(np.int32)}


TIERS = {"solo": dict(batch_siblings=False),
         "looped": dict(batch_siblings=True),
         "vectorised": dict(batch_siblings=True, vectorize_groups=True),
         "stepwise": dict(batch_siblings=False, trainer=StepwiseTrainer)}


def study(tier):
    """A small study on the CPU: three trials that share 12 of 24 steps,
    on one worker (the prefix chain carries one tail with it; the other
    two meet as a group where the tier groups); ``(backend, stats)``."""
    kw = dict(TIERS[tier])
    batch = kw.pop("batch_siblings")
    trainer = kw.pop("trainer", TorchTrainer)
    data = tiny_dataset()
    backend = trainer(TinyTask(),
                      lambda: DataPipeline(data, batch_size=8, seed=3),
                      tiny_dataset(seed=1), default_optimizer="momentum",
                      device="cpu", chunk_steps=4, **kw)
    trials = [Trial(HpConfig({"lr": MultiStep(0.05, [12], values=[0.05, v]),
                              "bs": Constant(8)}), 24)
              for v in (0.02, 0.01, 0.005)]
    st = Study.create(SearchPlanDB(), "tiny", "synth", ("lr", "bs"))
    stats = st.engine(backend, n_workers=1, batch_siblings=batch,
                      store=CheckpointStore()).run([GridTuner(trials)])
    return backend, stats


class CountingEvent:
    made = 0

    def __init__(self, enable_timing=False):
        CountingEvent.made += 1
        self.recorded, self.synced = 0, False

    def record(self, stream=None):
        self.recorded += 1

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        return 2.5


@pytest.fixture
def watched(monkeypatch):
    """Clock reads, streams asked for and CUDA events made, counted."""
    calls = {"clock": 0, "stream": 0}
    clock = tracing._clock

    def counting():
        calls["clock"] += 1
        return clock()

    def stream(device):
        calls["stream"] += 1
        return device
    monkeypatch.setattr(tracing, "_clock", counting)
    monkeypatch.setattr(torch.cuda, "Event", CountingEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    CountingEvent.made = 0
    tracing.clear()
    yield calls
    tracing.clear()


def test_recording_off_records_nothing(watched):
    assert not tracing.active()
    backend, stats = study("looped")
    assert stats.steps_run > 0 and stats.batched_groups >= 1
    with tracing.span("train.chunk", device=torch.device("cuda"),
                      steps=1) as rec:
        assert rec is None
    with tracing.unit("n0:4"):
        pass
    assert tracing.records() == [] and tracing.dropped() == 0
    assert watched == {"clock": 0, "stream": 0} and CountingEvent.made == 0


def recorder(how):
    if how == "profiler":
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU])
    return tracing.recording()


def children(recs):
    out = {}
    for r in recs:
        out.setdefault(r.parent, []).append(r)
    return out


def descendants(rec, kids):
    for c in kids.get(rec.id, []):
        yield c
        yield from descendants(c, kids)


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_span_tree_holds_the_engine_counts(watched, how, tier):
    with recorder(how):
        assert tracing.active()
        backend, stats = study(tier)
    assert not tracing.active()
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    kids = children(recs)
    names = {r.name for r in recs}
    assert {"engine.step", "ckpt.put", "train.chain", "train.chunk",
            "train.evaluate", "data.slab", "data.upload"} <= names
    if tier in ("looped", "vectorised"):
        assert stats.batched_groups >= 1 and "train.group" in names
    for r in recs:
        assert r.end is not None and r.start <= r.end
        if r.parent is None:
            assert r.name == "engine.step"
            continue
        up = by_id[r.parent]
        assert up.start <= r.start and r.end <= up.end
        assert up.thread == r.thread
    # the spans of one work unit share its key; every put belongs to one
    units = set()
    for r in recs:
        if r.name in ("train.chain", "train.group"):
            up = by_id[r.parent]
            if up.name in ("train.chain", "train.group"):
                continue          # a stepwise stage inside a chain call
            assert r.unit is not None and ":" in r.unit
            units.add(r.unit)
            assert {d.unit for d in descendants(r, kids)} <= {r.unit}
    assert {r.unit for r in recs if r.name.startswith("ckpt.")} <= units
    chunks = [r for r in recs if r.name == "train.chunk"]
    assert sum(r.attrs["steps"] for r in chunks) == stats.steps_run
    widths = {r.attrs["members"] for r in chunks}
    assert widths == ({1, 2} if tier in ("looped", "vectorised") else {1})
    assert sum(r.name == "train.evaluate" for r in recs) == stats.evals_run
    assert sum(r.name == "ckpt.put" for r in recs) == stats.ckpt_saves
    assert all(r.device_s() is None for r in chunks)     # a CPU trainer
    # nothing after the block
    backend.evaluate(backend.init_state(), None)
    assert len(tracing.records()) == len(recs)
    assert tracing.dropped() == 0 and CountingEvent.made == 0


def lr_ctx(lr, start, stop):
    return StageContext("n", {"hps": {"lr": {"kind": "const", "value": lr}},
                              "static": {"optimizer": "momentum"}},
                        0, start, stop, "n")


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_chunk_uploads_go_through_one_seam(watched, tier):
    """Every chunk draws its slabs, uploads them, its step indices and its
    hp rows, then runs: one ``_upload`` a pipeline (two members on
    distinct data streams; one stacked on axis 1 on the vectorised tier)
    and one ``_upload_rows`` a chunk — an ``(n,)`` row a member, or one
    step-major ``(n, M)`` — both inside ``data.upload``, and the spans
    open in the order ``data.slab``, ``data.upload``, ``train.chunk``."""
    kw = dict(TIERS[tier])
    kw.pop("batch_siblings")
    data = tiny_dataset()
    backend = kw.pop("trainer", TorchTrainer)(
        TinyTask(), lambda: DataPipeline(data, batch_size=8, seed=3),
        tiny_dataset(seed=1), default_optimizer="momentum", device="cpu",
        chunk_steps=4, **kw)
    s0 = backend.init_state()
    s1 = dict(s0, data=(3, 0, 16, 8))     # another position in the stream
    chain = lambda lr: [lr_ctx(lr, 0, 6), lr_ctx(lr, 6, 12)]
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            out = fn(*args)
            top = tracing._local.top
            chunks = sum(r.name == "train.chunk" for r in tracing.records())
            calls.append((name, top.name, chunks, args, out))
            return out
        setattr(backend, name, wrapped)

    spy("_upload", backend._upload)
    spy("_upload_rows", backend._upload_rows)
    with tracing.recording():
        if tier == "stepwise":
            backend.run_stage_stepwise(s0, lr_ctx(0.05, 0, 6))
        elif tier == "solo":
            backend.run_chain(s0, chain(0.05))
        else:
            backend.run_chains_batched([s0, s1], [chain(0.05), chain(0.02)])
    members, slabs = {"solo": (1, 1), "stepwise": (1, 1), "looped": (2, 2),
                      "vectorised": (2, 1)}[tier]
    recs = tracing.records()
    chunks = [r for r in recs if r.name == "train.chunk"]
    lengths = [1] * 6 if tier == "stepwise" else [4, 2, 4, 2]
    assert [c.attrs["steps"] for c in chunks] == [n * members
                                                  for n in lengths]
    assert all(c.attrs["members"] == members for c in chunks)
    assert {top for _, top, *_ in calls} == {"data.upload"}
    for i, n in enumerate(lengths):
        mine = [c for c in calls if c[2] == i]
        ups = [out for name, *_, out in mine if name == "_upload"]
        rows = [out for name, *_, out in mine if name == "_upload_rows"]
        assert len(ups) == slabs and len(rows) == 1
        lead = (n, 2) if tier == "vectorised" else (n,)
        assert all(u["x"].shape[:len(lead) + 1] == lead + (8,) for u in ups)
        steps, hps = rows[0]
        assert steps.shape == (n,) and steps.dtype == torch.int32
        shapes = [tuple(h["lr"].shape) for h in hps]
        assert shapes == ([(n, 2)] if tier == "vectorised"
                          else [(n,)] * members)
    # per chunk, in the order the spans open under the entry's span
    kids = children(recs)
    for c in chunks:
        sibs = kids[c.parent]
        k = sibs.index(c)
        assert [r.name for r in sibs[k - 2:k]] == ["data.slab", "data.upload"]


def test_ssd_scan_spans_nest_in_the_chunks(watched):
    """A recorded Mamba-2 study: one ``train.ssd_scan`` per SSD layer and
    forward, each nested in the ``train.chunk`` (or ``train.evaluate``)
    that ran it."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_dataset
    from repro_torch.models.transformer import LM
    cfg = get_config("mamba2-2.7b").reduced(d_model=64, vocab_size=64)
    data = synthetic_lm_dataset(8, 32, cfg.vocab_size, seed=0)
    backend = TorchTrainer(
        LM(cfg), lambda: DataPipeline(data, batch_size=2, seed=3),
        synthetic_lm_dataset(2, 32, cfg.vocab_size, seed=5),
        default_optimizer="adamw", device="cpu", chunk_steps=2)
    trial = Trial(HpConfig({"lr": Constant(3e-4), "bs": Constant(2)}), 4)
    st = Study.create(SearchPlanDB(), "ssd", "synth", ("lr", "bs"))
    with tracing.recording():
        stats = st.engine(backend, n_workers=1, store=CheckpointStore()).run(
            [GridTuner([trial])])
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    per = {}
    for r in recs:
        if r.name == "train.ssd_scan":
            per[r.parent] = per.get(r.parent, 0) + 1
    assert {by_id[p].name for p in per} == {"train.chunk", "train.evaluate"}
    chunks = [r for r in recs if r.name == "train.chunk"]
    assert sum(c.attrs["steps"] for c in chunks) == stats.steps_run == 4
    for c in chunks:
        assert per[c.id] == cfg.num_layers * c.attrs["steps"]
    for r in recs:
        if r.name == "train.evaluate":
            assert per[r.id] == cfg.num_layers


def test_device_span_times_by_events_after_the_fact(watched):
    with tracing.recording():
        with tracing.span("train.chunk", device=torch.device("cuda"),
                          steps=4, members=1) as rec:
            start, end = rec._events
            assert start.recorded == 1 and end.recorded == 0
        assert end.recorded == 1 and not end.synced
    assert CountingEvent.made == 2
    assert rec.device_s() == pytest.approx(2.5e-3) and end.synced
    assert rec.device_s() == pytest.approx(2.5e-3)
    with tracing.recording():
        with tracing.span("train.chunk", device=torch.device("cpu")) as rec:
            pass
    assert rec.device_s() is None and CountingEvent.made == 2


def test_units_nest(watched):
    with tracing.recording():
        with tracing.unit("a:4"):
            with tracing.span("train.chain") as outer:
                with tracing.unit("b:8"), tracing.span("ckpt.put") as inner:
                    pass
                with tracing.span("data.slab") as back:
                    pass
            with tracing.span("train.evaluate") as after:
                pass
        with tracing.span("engine.step") as none:
            pass
    assert (outer.unit, inner.unit, back.unit, after.unit, none.unit) == (
        "a:4", "b:8", "a:4", "a:4", None)
    assert inner.parent == back.parent == outer.id and after.parent is None


def test_traced_closes_its_span_on_an_exception(watched):
    @tracing.traced("train.evaluate")
    def fails():
        raise KeyError("gone")

    with tracing.recording():
        with pytest.raises(KeyError):
            fails()
        with tracing.span("engine.step") as rec:
            pass
    first, second = tracing.records()
    assert first.name == "train.evaluate" and first.end is not None
    assert second is rec and rec.parent is None


def test_full_buffer_counts_what_it_drops(watched, monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    with tracing.recording():
        with tracing.span("engine.step"):
            for _ in range(4):
                with tracing.span("train.chunk"):
                    with tracing.span("data.upload"):
                        pass
    recs = tracing.records()
    assert [r.name for r in recs] == ["engine.step", "train.chunk",
                                      "data.upload"]
    assert tracing.dropped() == 6
    ids = {r.id for r in recs}
    assert all(r.parent is None or r.parent in ids for r in recs)
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_recording_nests():
    with tracing.recording():
        with tracing.recording():
            assert tracing.active()
        assert tracing.active()
    assert not tracing.active()
    assert tracing.span("engine.step") is tracing.span("ckpt.get")
