"""Hyper-parameter-sequence-aware optimizers (SGD/momentum, Adam, AdamW).

Hippo's whole premise is that training knobs are *functions of the step*,
so every knob here (lr, momentum, weight decay) enters the update as a
**value** — a Python float or a 0-d tensor on the parameters' device —
never as something code is specialised on: one train step serves every
stage of every trial regardless of its hyper-parameter values.

The optimizer choice itself is a static hyper-parameter (paper Table 2
tunes {Adam, vanilla SGD, SGD+momentum}); switching optimizers mid-trial
would change the state tree and is not part of the paper's search spaces.

:func:`leaf_update` is one leaf's update in plain PyTorch — f32 math, cast
back to the leaf dtype, results in fresh tensors.  It is the plain version
of the fused kernel in :mod:`repro_torch.kernels.optim`, which evaluates
the same formulas in the same order.  :func:`apply_update_stacked` is the
update of a sibling group: member-stacked ``(M, ...)`` leaves, per-member
``(M,)`` hyper-parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["init_opt_state", "apply_update", "apply_update_stacked",
           "leaf_update", "OPTIMIZERS"]

OPTIMIZERS = ("sgd", "momentum", "adam", "adamw")


def init_opt_state(name: str, params: Any) -> Dict[str, Any]:
    zeros = lambda: tree_map(torch.zeros_like, params)
    if name == "sgd":
        return {}
    if name == "momentum":
        return {"m": zeros()}
    if name in ("adam", "adamw"):
        return {"m": zeros(), "v": zeros()}
    raise ValueError(f"unknown optimizer {name!r}; choose from {OPTIMIZERS}")


def leaf_update(name: str, p, g, m=None, v=None, *, lr, wd=0.0, mom=0.9,
                b1=0.9, b2=0.999, eps=1e-8, bc1=None, bc2=None):
    """One leaf's update.  Scalars are floats or tensors broadcastable
    against the leaf (``(M, 1, ...)`` for a member-stacked leaf).  Returns
    ``(p,)``, ``(p, m)`` or ``(p, m, v)`` by optimizer."""
    pf, gf = p.float(), g.float()
    if name == "sgd":
        return ((pf - lr * (gf + wd * pf)).to(p.dtype),)
    if name == "momentum":
        m2 = mom * m.float() + gf
        return ((pf - lr * (m2 + wd * pf)).to(p.dtype), m2.to(m.dtype))
    if name in ("adam", "adamw"):
        m2 = b1 * m.float() + (1 - b1) * gf
        v2 = b2 * v.float() + (1 - b2) * gf * gf
        mh = m2 / bc1
        vh = v2 / bc2
        if name == "adamw":
            new = pf - lr * (mh / (torch.sqrt(vh) + eps) + wd * pf)
        else:  # adam: wd folded into the gradient (L2), paper-era behaviour
            new = pf - lr * mh / (torch.sqrt(vh) + eps) - lr * wd * pf
        return (new.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype))
    raise ValueError(name)


def _pick(params: Any, outs, i: int) -> Any:
    it = iter(outs)
    return tree_map(lambda _: next(it)[i], params)


def apply_update(name: str, params: Any, grads: Any, state: Dict[str, Any],
                 hp: Dict[str, Any], step: Any
                 ) -> Tuple[Any, Dict[str, Any]]:
    """One optimizer update over a whole tree.  ``hp`` supplies the scalar
    values: lr (required), momentum (default .9), wd (default 0),
    b1/b2/eps; ``step`` is the 0-based global step (int or 0-d tensor)."""
    lr = hp["lr"]
    wd = hp.get("wd", 0.0)
    ps, gs = tree_leaves(params), tree_leaves(grads)

    if name == "sgd":
        outs = [leaf_update("sgd", p, g, lr=lr, wd=wd)
                for p, g in zip(ps, gs)]
        return _pick(params, outs, 0), state

    if name == "momentum":
        mom = hp.get("momentum", 0.9)
        outs = [leaf_update("momentum", p, g, m, lr=lr, wd=wd, mom=mom)
                for p, g, m in zip(ps, gs, tree_leaves(state["m"]))]
        return _pick(params, outs, 0), {"m": _pick(params, outs, 1)}

    if name in ("adam", "adamw"):
        b1 = hp.get("b1", 0.9)
        b2 = hp.get("b2", 0.999)
        eps = hp.get("eps", 1e-8)
        t = torch.as_tensor(step, dtype=torch.float32,
                            device=ps[0].device) + 1.0
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        outs = [leaf_update(name, p, g, m, v, lr=lr, wd=wd, b1=b1, b2=b2,
                            eps=eps, bc1=bc1, bc2=bc2)
                for p, g, m, v in zip(ps, gs, tree_leaves(state["m"]),
                                      tree_leaves(state["v"]))]
        return (_pick(params, outs, 0),
                {"m": _pick(params, outs, 1), "v": _pick(params, outs, 2)})

    raise ValueError(name)


_SLOTS = {"sgd": (), "momentum": ("m",), "adam": ("m", "v"),
          "adamw": ("m", "v")}


def apply_update_stacked(name: str, params: Any, grads: Any,
                         state: Dict[str, Any], hp: Dict[str, Any],
                         step: Any) -> Tuple[Any, Dict[str, Any]]:
    """:func:`apply_update` over member-stacked trees: every leaf is
    ``(M, ...)``, every hyper-parameter a number or an ``(M,)`` f32 tensor
    of per-member values, broadcast as ``(M, 1, ...)`` against each leaf.
    The update is elementwise, so member ``i`` gets the formulas of
    :func:`apply_update` on its own slice."""
    if name not in _SLOTS:
        raise ValueError(name)
    ps = tree_leaves(params)
    M, device = ps[0].shape[0], ps[0].device

    def vec(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=device).reshape(-1).expand(M)

    kw = {"lr": vec(hp["lr"]), "wd": vec(hp.get("wd", 0.0))}
    if name == "momentum":
        kw["mom"] = vec(hp.get("momentum", 0.9))
    elif name in ("adam", "adamw"):
        b1, b2 = vec(hp.get("b1", 0.9)), vec(hp.get("b2", 0.999))
        t = vec(step) + 1.0
        kw.update(b1=b1, b2=b2, eps=vec(hp.get("eps", 1e-8)),
                  bc1=1 - b1 ** t, bc2=1 - b2 ** t)
    slots = _SLOTS[name]
    outs = []
    for leaf in zip(ps, tree_leaves(grads),
                    *[tree_leaves(state[s]) for s in slots]):
        shape = (M,) + (1,) * (leaf[0].dim() - 1)
        outs.append(leaf_update(name, *leaf, **{k: v.reshape(shape)
                                                for k, v in kw.items()}))
    return (_pick(params, outs, 0),
            {s: _pick(params, outs, i + 1) for i, s in enumerate(slots)})
