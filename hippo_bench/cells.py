"""A cell — one configuration under one traffic mix — on the port.

``<config>.<traffic>`` resolves by name to ``configs/<config>.json`` and
``traffic/<traffic>.json``; the port's model is its registry entry for
the file's ``port.arch`` with every field ``port.fields`` maps set from
the file.  The system under test is ``repro_torch``'s
``StudyService(share=True)`` on one worker over a ``TorchTrainer`` with
its defaults (kernels on, sibling groups on for a CUDA device), AdamW,
the memory tier.  Its model's ``init`` hands over the weights the
benchmark drew (:mod:`hippo_bench.weights`), and the trainer's stage
entries are wrapped, on the instance, to read the state the first rung
hands back (:class:`RungRecorder`); nothing of the port is edited.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hippo_bench import studies, weights

HERE = os.path.dirname(os.path.abspath(__file__))


def load_config(name: str) -> Dict[str, Any]:
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def split(workload: str):
    """``qwen2-0.5b.high_merge`` → ``("qwen2-0.5b", "high_merge")``."""
    config, _, traffic = workload.rpartition(".")
    if not config or not traffic:
        raise ValueError(f"a workload is <config>.<traffic>, not {workload!r}")
    return config, traffic


def load_limits(workload: str) -> Dict[str, Any]:
    path = os.path.join(HERE, "limits", workload + ".json")
    with open(path) as f:
        return json.load(f)


def port_config(cfg: Dict[str, Any]):
    from repro_torch.configs import get_config
    over = {field: cfg[key] for field, key in cfg["port"]["fields"].items()}
    mc = dataclasses.replace(get_config(cfg["port"]["arch"]), **over)
    if cfg["block"] == "ssd":
        mc = dataclasses.replace(mc, ssm_heads=mc.ssm_inner // mc.ssm_head_dim)
    return mc


class SeededTask:
    """The port's ``LM`` whose ``init`` returns the benchmark's weights."""

    def __init__(self, lm, params):
        self.lm = lm
        self.params = params

    def init(self, rng):
        return self.params

    def loss(self, params, batch):
        return self.lm.loss(params, batch)

    @property
    def use_kernel(self):
        return self.lm.use_kernel

    @use_kernel.setter
    def use_kernel(self, value):
        self.lm.use_kernel = value


def leaf_norms(state, p0: Dict) -> Dict[str, torch.Tensor]:
    """Per leaf, on the device and without a copy in float32: the norm
    of the parameters' change from ``p0``, and the root of the summed
    second moment (the gradients' size as AdamW has taken them in)."""
    from hippo_bench.reference.lm import flat
    params = flat(state["params"])
    v = flat(state["opt"]["v"])
    norm = torch.linalg.vector_norm
    return {"update": torch.stack([norm(params[k] - p0[k],
                                        dtype=torch.float32) for k in p0]),
            "grad_rms": torch.stack([v[k].sum(dtype=torch.float32).sqrt()
                                     for k in p0])}


def key_of(pairs) -> tuple:
    """A schedule prefix as a hashable key: ``(lr, wd)`` per step."""
    return tuple((float(f"{lr:.12g}"), float(f"{wd:.12g}"))
                 for lr, wd in pairs)


class RungRecorder:
    """Reads the port's state where the first rung's stages hand it back
    (the trainer's boundary states at that step of chains that start
    from the initial weights): :func:`leaf_norms`, kept on the device,
    by the schedule prefix that produced it.  Set on the trainer
    instance's methods; nothing of the port is edited."""

    def __init__(self, backend, p0: Dict, rung: int):
        from repro_torch.core.values import desc_static, desc_values
        self.records: Dict[tuple, Dict[str, torch.Tensor]] = {}

        def note(chain, bounds):
            if chain[0].start != 0:
                return
            pairs = []
            for ctx, bound in zip(chain, bounds):
                lrs = desc_values(ctx.desc, ctx.node_start, ctx.start,
                                  ctx.stop)["lr"]
                wd = float(desc_static(ctx.desc).get("wd", 0.0))
                pairs += [(lr, wd) for lr in lrs]
                if ctx.stop == rung:
                    self.records[key_of(pairs)] = leaf_norms(bound, p0)

        def wrap(name, split):
            fn = getattr(backend, name)

            def wrapped(*args, **kw):
                out = fn(*args, **kw)
                for chain, bounds in split(args, out):
                    note(chain, bounds)
                return out
            setattr(backend, name, wrapped)

        wrap("run_chain", lambda a, out: [(a[1], out)])
        wrap("run_stage", lambda a, out: [([a[1]], [out])])
        wrap("run_stages_batched",
             lambda a, out: [([c], [b]) for c, b in zip(a[1], out)])
        wrap("run_chains_batched", lambda a, out: list(zip(a[1], out)))


@dataclasses.dataclass
class Round:
    seconds: float
    stats: Any
    tuners: List[Any]
    trials: List[List[Any]]
    rung_states: Dict[tuple, Dict[str, torch.Tensor]]

    @property
    def trial_steps(self) -> int:
        return sum(t.trial_steps for t in self.tuners)


class Cell:
    """A cell's inputs made from ``seed`` and the port's system built
    over them, ready to run rounds."""

    def __init__(self, workload: str, seed: int, device="cuda",
                 cfg: Optional[Dict] = None, mix: Optional[Dict] = None):
        from repro_torch.models.transformer import LM
        from repro_torch.data import DataPipeline
        from repro_torch.train.torch_trainer import TorchTrainer
        config, traffic = split(workload)
        self.workload, self.seed = workload, seed
        self.cfg = cfg if cfg is not None else load_config(config)
        self.mix = mix if mix is not None else studies.load_mix(traffic)
        self.device = torch.device(device)
        self.model_config = port_config(self.cfg)
        lm = LM(self.model_config)
        with torch.device("meta"):
            skeleton = lm.init(torch.Generator())
        self.params = weights.make_params(
            skeleton, self.model_config.d_model, seed, self.device)
        c = self.cfg
        n, B = c["n_train"], c["batch"]
        self.tokens = weights.make_tokens(n + c["n_eval"], c["seq_len"],
                                          c["vocab_size"], seed, self.device)
        self.pipe_seed = weights.derive(seed, "pipeline") % 2 ** 32
        host = self.tokens.cpu().numpy()
        train, evals = {"tokens": host[:n]}, {"tokens": host[n:]}
        self.backend = TorchTrainer(
            SeededTask(lm, self.params),
            lambda: DataPipeline(train, batch_size=B, seed=self.pipe_seed),
            evals, default_optimizer="adamw", device=self.device)
        self.rounds_run = 0
        from hippo_bench.reference.lm import flat
        self.recorder = RungRecorder(self.backend, flat(self.params),
                                     self.mix["tuner"]["min_steps"])

    def round(self, store=None) -> Round:
        """One round of the mix; ends when every study has its answer and
        the device has finished."""
        t0 = time.perf_counter()
        self.recorder.records = {}
        stats, tuners, trials, _ = studies.run_round(
            self.backend, self.mix, self.workload, self.rounds_run,
            store=store)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rounds_run += 1
        return Round(time.perf_counter() - t0, stats, tuners, trials,
                     self.recorder.records)

    def batch(self, step: int) -> torch.Tensor:
        """The training rows of ``step``, as the reference takes them."""
        rows = weights.batch_rows(self.pipe_seed, self.cfg["n_train"],
                                  self.cfg["batch"], step)
        return self.tokens[torch.as_tensor(np.asarray(rows),
                                           device=self.device)]

    @property
    def eval_tokens(self) -> torch.Tensor:
        return self.tokens[self.cfg["n_train"]:]

    def release(self) -> None:
        """Drop the port's state: its trainer and the weights it holds."""
        self.backend = self.recorder = None
        self.params = None
