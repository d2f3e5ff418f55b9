"""The plain reference: a configuration's language model, its loss, its
gradients, AdamW and evaluation, in float32 with TF32 off.

It imports nothing of the port.  It reads a configuration file's
published keys, takes the weights and tokens the benchmark drew (as
float32 copies of the served bits) and replays trials' schedules step by
step.  Each block is a module of this folder named by the file's
``"block"`` key.  Every product goes through one ``mm`` function, so the
control (:mod:`hippo_bench.reference.fp8`) can run the same model with
its products in float8.  Each layer runs under ``torch.utils.checkpoint``
and the rows of a batch one at a time (the loss is the mean over all the
batch's positions, so the rows' gradients add up to the batch's), so the
full-width models fit beside nothing else on one card.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def precise() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def flat(tree: Any, path: Tuple = ()) -> Dict[Tuple, torch.Tensor]:
    """``{path: leaf}`` of a nested dict / list of tensors."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in flat(tree[k], path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in flat(t, path + (i,)).items()}
    return {path: tree}


def _nest(items: Dict[Tuple, torch.Tensor]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in items.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


class ReferenceLM:
    """One configuration's model over flat float32 parameters ``{path:
    tensor}`` in the benchmark's tree (``embed``, ``final_norm``,
    ``cycles/0/<leaf>`` stacked over the layers)."""

    def __init__(self, cfg: Dict[str, Any], mm: Matmul = torch.matmul):
        self.cfg = cfg
        self.mm = mm
        self.block = importlib.import_module(
            f"hippo_bench.reference.{cfg['block']}")
        self.eps = self.block.norm_eps(cfg)

    def layers(self, params: Dict[Tuple, torch.Tensor]) -> List[Dict]:
        """Per-layer parameter dicts: each stacked leaf unbound once (its
        backward is one stack, not a zero tensor per layer)."""
        stacked = {p[2:]: v for p, v in params.items() if p[0] == "cycles"}
        parts = {p: v.unbind(0) for p, v in stacked.items()}
        n = len(next(iter(parts.values())))
        return [_nest({p: parts[p][i] for p in parts}) for i in range(n)]

    def nll(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token negative log-likelihood of ``tokens`` (B, S)."""
        x = F.embedding(tokens.long(), params[("embed",)])
        for p in self.layers(params):
            def run(h, p=p):
                return self.block.forward(p, h, self.cfg, self.mm)
            x = checkpoint(run, x, use_reentrant=False) \
                if torch.is_grad_enabled() else run(x)
        x = rms_norm(x, params[("final_norm",)], self.eps)
        logits = self.mm(x, params[("embed",)].t())
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        return -logp.gather(-1, tokens[:, 1:].long()[..., None]).mean()

    def loss_and_grads(self, params, tokens: torch.Tensor):
        """The batch's loss and its gradients, one row at a time."""
        leaves = {p: v.detach().requires_grad_(True)
                  for p, v in params.items()}
        total, grads = 0.0, None
        B = tokens.shape[0]
        for r in range(B):
            loss = self.nll(leaves, tokens[r:r + 1]) / B
            g = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
            grads = list(g) if grads is None else [a + b for a, b in
                                                   zip(grads, g)]
            total += float(loss.detach())
        return total, dict(zip(leaves, grads))

    @torch.no_grad()
    def evaluate(self, params, tokens: torch.Tensor) -> float:
        B = tokens.shape[0]
        return sum(float(self.nll(params, tokens[r:r + 1]))
                   for r in range(B)) / B


def adamw(params, grads, state, lr: float, wd: float, step: int,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One AdamW update in float32 (decoupled decay, bias-corrected);
    ``step`` is 0-based.  Returns the new parameters and state."""
    t = step + 1
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = b1 * state["m"][k] + (1 - b1) * g
        v = b2 * state["v"][k] + (1 - b2) * g * g
        new_p[k] = p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p)
        new_m[k], new_v[k] = m, v
    return new_p, {"m": new_m, "v": new_v}


def leaf_norms(params, state, params0) -> Dict[str, torch.Tensor]:
    """Per leaf: the norm of the parameters' change from ``params0`` and
    the root of the summed second moment."""
    return {"update": torch.stack([torch.linalg.vector_norm(params[k] - p0)
                                   for k, p0 in params0.items()]),
            "grad_rms": torch.stack([state["v"][k].sum().sqrt()
                                     for k in params0])}


def replay(model: ReferenceLM, params0: Dict[Tuple, torch.Tensor],
           batches: Callable[[int], torch.Tensor], eval_tokens: torch.Tensor,
           schedules: Dict[Any, List[Tuple[float, float]]],
           evals: Dict[Any, Iterable[int]], look_at: int = -1,
           store: Callable = lambda tree: tree):
    """Train each schedule from ``params0`` and evaluate it after the
    steps ``evals[key]`` asks for; ``schedules[key]`` is the ``(lr, wd)``
    of each step and ``batches(step)`` the step's tokens.  Schedules that
    agree up to a step share the work up to it (one state, branched where
    they part).  ``store`` maps the parameters and each optimizer slot as
    they are kept between steps (the control rounds them).  Returns
    ``({(key, step): eval loss}, {schedule prefix: leaf_norms})``, the
    norms of the states after ``look_at`` steps."""
    out: Dict[Tuple[Any, int], float] = {}
    states: Dict[Tuple, Dict[str, torch.Tensor]] = {}
    zero = {k: torch.zeros_like(v) for k, v in params0.items()}
    start = store(dict(params0))
    todo = [(0, start, {"m": zero, "v": dict(zero)}, list(schedules))]
    while todo:
        step, params, state, keys = todo.pop()
        if step == look_at:
            states[tuple(schedules[keys[0]][:step])] = leaf_norms(
                params, state, start)
        want = [k for k in keys if step in set(evals[k])]
        if want:
            loss = model.evaluate(params, eval_tokens)
            out.update({(k, step): loss for k in want})
        keys = [k for k in keys if step < max(evals[k], default=0)]
        if not keys:
            continue
        branches: Dict[Tuple[float, float], List] = {}
        for k in keys:
            branches.setdefault(tuple(schedules[k][step]), []).append(k)
        _, grads = model.loss_and_grads(params, batches(step))
        for (lr, wd), ks in branches.items():
            p, s = adamw(params, grads, state, lr, wd, step)
            todo.append((step + 1, store(p),
                         {slot: store(t) for slot, t in s.items()}, ks))
        del grads, params, state
    return out, states
