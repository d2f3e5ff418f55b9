"""Hyper-parameter sequence functions (Hippo §2.1, §3.1, Figure 10).

A hyper-parameter in Hippo is not a scalar but a *function of the training
step*.  Trials are identified by the exact sequence of values their
hyper-parameters take, so two trials share computation exactly on the step
range where *all* of their hyper-parameter functions agree.

Every sequence function here provides:

  * ``value(step)``       — the hyper-parameter value at a global step,
  * ``boundaries(total)`` — the steps at which the function's *piece*
                            changes (used to derive canonical stage
                            boundaries, §3.1 "we follow the convention of
                            dividing hyper-parameter sequences to set stage
                            boundaries"),
  * ``to_json()``         — canonical encoding, making structural equality
                            (and therefore prefix matching) well defined,
  * ``prefix_equal(other, upto)`` — True iff the two functions produce the
                            same values on ``[0, upto)``.

``Seq`` composition (e.g. warm-up followed by decay) concatenates functions
along the step axis, matching the paper's "sequential combinations of
functions".

The catalogue mirrors Tables 2-4 of the paper: Constant, MultiStep/StepLR,
Exponential, Linear, Cosine annealing (with warm restarts), CyclicLR,
Warmup, and Piecewise for arbitrary user-defined sequences.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.utils import stable_hash

__all__ = [
    "HpFunction",
    "Constant",
    "MultiStep",
    "StepLR",
    "Exponential",
    "Linear",
    "Cosine",
    "CosineWarmRestarts",
    "Cyclic",
    "Warmup",
    "Seq",
    "Piecewise",
    "from_json",
    "HpConfig",
]


class HpFunction:
    """Base class for a hyper-parameter as a function of training step."""

    kind: str = "base"

    # ------------------------------------------------------------------ value
    def value(self, step: int) -> float:
        raise NotImplementedError

    def values(self, start: int, stop: int) -> List[float]:
        return [self.value(s) for s in range(start, stop)]

    # ------------------------------------------------------------- boundaries
    def boundaries(self, total_steps: int) -> List[int]:
        """Steps in ``(0, total_steps)`` at which the functional *piece*
        changes.  Smooth functions (exponential, cosine...) have no interior
        boundaries — a stage may hold a non-constant sequence (§3.1)."""
        return []

    # ------------------------------------------------------------- canonical
    def to_json(self) -> Dict[str, Any]:
        raise NotImplementedError

    def __eq__(self, other: object) -> bool:
        return isinstance(other, HpFunction) and self.to_json() == other.to_json()

    def __hash__(self) -> int:
        return hash(stable_hash(self.to_json()))

    def __repr__(self) -> str:
        d = self.to_json()
        kind = d.pop("kind")
        args = ", ".join(f"{k}={v}" for k, v in d.items())
        return f"{kind}({args})"

    # ------------------------------------------------------- prefix equality
    def prefix_equal(self, other: "HpFunction", upto: int) -> bool:
        """True iff self and other agree on every step in [0, upto).

        Structural fast path first; falls back to piecewise comparison at
        boundary-delimited sample points for mixed kinds.
        """
        if self.to_json() == other.to_json():
            return True
        pts = sorted(
            set([0, max(0, upto - 1)])
            | {b for b in self.boundaries(upto) if 0 <= b < upto}
            | {b - 1 for b in self.boundaries(upto) if 1 <= b <= upto}
            | {b for b in other.boundaries(upto) if 0 <= b < upto}
            | {b - 1 for b in other.boundaries(upto) if 1 <= b <= upto}
        )
        # Piecewise-*constant* pieces are fully determined by their endpoint
        # samples; smooth pieces need structural equality of the piece.
        sp, op = self.pieces(upto), other.pieces(upto)
        if _pieces_prefix_equal(sp, op, upto):
            return True
        # Last resort: exact pointwise check (bounded; only for small ranges)
        if upto <= 4096:
            return all(self.value(s) == other.value(s) for s in range(upto))
        return all(self.value(s) == other.value(s) for s in pts)

    # ------------------------------------------------------------ pieces
    def pieces(self, total_steps: int) -> List[Tuple[int, int, Dict[str, Any]]]:
        """Decompose into (start, stop, canonical-piece-descriptor) tuples.

        The descriptor of a piece is normalized so that the same value
        trajectory yields the same descriptor regardless of how it was
        constructed (e.g. Constant(0.1) vs the first piece of
        MultiStep(0.1, [100], 0.1)).
        """
        bs = [0] + [b for b in self.boundaries(total_steps) if 0 < b < total_steps] + [total_steps]
        out = []
        for a, b in zip(bs[:-1], bs[1:]):
            out.append((a, b, self.piece_descriptor(a, b)))
        return out

    def piece_descriptor(self, start: int, stop: int) -> Dict[str, Any]:
        """Canonical descriptor of this function restricted to [start, stop).

        Default: if the restriction is constant, normalize to a constant
        descriptor; otherwise describe by kind + offset so that identical
        trajectories compare equal only when structurally identical.
        """
        v0 = self.value(start)
        if stop - start <= 1 or all(
            self.value(s) == v0 for s in _probe_steps(start, stop)
        ):
            # constant on the probes: verify cheaply via boundaries contract —
            # pieces are maximal intervals without interior boundaries, so a
            # piecewise-constant function is constant on each piece.
            if self._piecewise_constant():
                return {"kind": "const", "value": float(v0)}
        return {"kind": self.kind, "fn": self.to_json(), "offset": start}

    def _piecewise_constant(self) -> bool:
        return False


def _probe_steps(start: int, stop: int, k: int = 5) -> List[int]:
    if stop - start <= k:
        return list(range(start, stop))
    stride = (stop - start) // k
    return sorted({start, stop - 1, *range(start, stop, stride)})


def _pieces_prefix_equal(a, b, upto: int) -> bool:
    """Compare two piece decompositions on [0, upto)."""
    # Refine both to the union of boundaries.
    cuts = sorted({p[0] for p in a} | {p[1] for p in a} | {p[0] for p in b} | {p[1] for p in b})
    cuts = [c for c in cuts if 0 <= c <= upto]
    if not cuts or cuts[0] != 0 or cuts[-1] != upto:
        return False

    def find(pieces, s, e):
        for (pa, pb, d) in pieces:
            if pa <= s and e <= pb:
                return d
        return None

    for s, e in zip(cuts[:-1], cuts[1:]):
        da, db = find(a, s, e), find(b, s, e)
        if da is None or db is None:
            return False
        if da.get("kind") == "const" and db.get("kind") == "const":
            if da["value"] != db["value"]:
                return False
        elif da != db:
            return False
    return True


# ---------------------------------------------------------------------------
# Concrete function families
# ---------------------------------------------------------------------------


class Constant(HpFunction):
    kind = "constant"

    def __init__(self, v: float):
        self.v = float(v)

    def value(self, step: int) -> float:
        return self.v

    def to_json(self):
        return {"kind": self.kind, "v": self.v}

    def piece_descriptor(self, start, stop):
        return {"kind": "const", "value": float(self.v)}

    def _piecewise_constant(self):
        return True


class MultiStep(HpFunction):
    """Piecewise-constant: value -> value*gamma at each milestone.

    ``MultiStep(128, [40], 2)`` == batch size 128 then 256 from step 40
    (Figure 10).  ``values`` form: explicit per-segment values.
    """

    kind = "multistep"

    def __init__(self, base: float, milestones: Sequence[int], gamma: float = None,
                 values: Sequence[float] = None):
        self.base = base
        self.milestones = sorted(int(m) for m in milestones)
        if values is not None:
            assert len(values) == len(self.milestones) + 1
            self.segment_values = [float(v) for v in values]
            self.gamma = None
        else:
            g = 0.1 if gamma is None else gamma
            self.gamma = g
            self.segment_values = [base * (g ** i) for i in range(len(self.milestones) + 1)]

    @classmethod
    def from_values(cls, values: Sequence[float], milestones: Sequence[int]) -> "MultiStep":
        return cls(values[0], milestones, values=values)

    def value(self, step: int) -> float:
        i = 0
        for m in self.milestones:
            if step >= m:
                i += 1
        return self.segment_values[i]

    def boundaries(self, total_steps: int) -> List[int]:
        return [m for m in self.milestones if 0 < m < total_steps]

    def to_json(self):
        return {"kind": self.kind, "base": self.base,
                "milestones": list(self.milestones),
                "values": list(self.segment_values)}

    def piece_descriptor(self, start, stop):
        return {"kind": "const", "value": float(self.value(start))}

    def _piecewise_constant(self):
        return True


def StepLR(base: float, gamma: float, milestones: Sequence[int]) -> MultiStep:
    """PyTorch-style alias used in the paper's Tables 2-3."""
    return MultiStep(base, milestones, gamma=gamma)


class Exponential(HpFunction):
    """v(step) = base * gamma**(step / period)."""

    kind = "exponential"

    def __init__(self, base: float, gamma: float, period: int = 1):
        self.base, self.gamma, self.period = base, gamma, int(period)

    def value(self, step: int) -> float:
        return self.base * (self.gamma ** (step / self.period))

    def to_json(self):
        return {"kind": self.kind, "base": self.base, "gamma": self.gamma,
                "period": self.period}


class Linear(HpFunction):
    """Linear from ``base`` to ``end`` over ``total`` steps, then clamped."""

    kind = "linear"

    def __init__(self, base: float, total: int, end: float = 0.0):
        self.base, self.total, self.end = base, int(total), end

    def value(self, step: int) -> float:
        if step >= self.total:
            return self.end
        f = step / self.total
        return self.base + (self.end - self.base) * f

    def boundaries(self, total_steps: int) -> List[int]:
        return [self.total] if 0 < self.total < total_steps else []

    def to_json(self):
        return {"kind": self.kind, "base": self.base, "total": self.total,
                "end": self.end}


class Cosine(HpFunction):
    """Cosine annealing from base to eta_min over t_max steps."""

    kind = "cosine"

    def __init__(self, base: float, t_max: int, eta_min: float = 0.0):
        self.base, self.t_max, self.eta_min = base, int(t_max), eta_min

    def value(self, step: int) -> float:
        s = min(step, self.t_max)
        return self.eta_min + 0.5 * (self.base - self.eta_min) * (
            1 + math.cos(math.pi * s / self.t_max))

    def boundaries(self, total_steps: int) -> List[int]:
        return [self.t_max] if 0 < self.t_max < total_steps else []

    def to_json(self):
        return {"kind": self.kind, "base": self.base, "t_max": self.t_max,
                "eta_min": self.eta_min}


class CosineWarmRestarts(HpFunction):
    """SGDR: cosine annealing with period t_0 (optionally growing by t_mult)."""

    kind = "cosine_warm_restarts"

    def __init__(self, base: float, t_0: int, t_mult: int = 1, eta_min: float = 0.0):
        self.base, self.t_0, self.t_mult, self.eta_min = base, int(t_0), int(t_mult), eta_min

    def _cycle(self, step: int) -> Tuple[int, int]:
        """Return (position within cycle, cycle length)."""
        t, length = step, self.t_0
        while t >= length:
            t -= length
            length *= self.t_mult if self.t_mult > 1 else 1
            if self.t_mult == 1:
                # fixed-length cycles: position is just modulo
                return step % self.t_0, self.t_0
        return t, length

    def value(self, step: int) -> float:
        t, length = self._cycle(step)
        return self.eta_min + 0.5 * (self.base - self.eta_min) * (
            1 + math.cos(math.pi * t / length))

    def boundaries(self, total_steps: int) -> List[int]:
        out, t, length = [], self.t_0, self.t_0
        while t < total_steps:
            out.append(t)
            length = length * self.t_mult if self.t_mult > 1 else length
            t += length
        return out

    def to_json(self):
        return {"kind": self.kind, "base": self.base, "t_0": self.t_0,
                "t_mult": self.t_mult, "eta_min": self.eta_min}


class Cyclic(HpFunction):
    """CyclicLR (triangular): base_lr <-> max_lr with step_size_up."""

    kind = "cyclic"

    def __init__(self, base_lr: float, max_lr: float, step_size_up: int,
                 step_size_down: int = None):
        self.base_lr, self.max_lr = base_lr, max_lr
        self.step_size_up = int(step_size_up)
        self.step_size_down = int(step_size_down or step_size_up)

    def value(self, step: int) -> float:
        cycle_len = self.step_size_up + self.step_size_down
        t = step % cycle_len
        if t < self.step_size_up:
            f = t / self.step_size_up
        else:
            f = 1.0 - (t - self.step_size_up) / self.step_size_down
        return self.base_lr + (self.max_lr - self.base_lr) * f

    def boundaries(self, total_steps: int) -> List[int]:
        out, cycle_len = [], self.step_size_up + self.step_size_down
        t = self.step_size_up
        while t < total_steps:
            out.append(t)
            t += self.step_size_down if (len(out) % 2 == 1) else self.step_size_up
        return out

    def to_json(self):
        return {"kind": self.kind, "base_lr": self.base_lr, "max_lr": self.max_lr,
                "step_size_up": self.step_size_up,
                "step_size_down": self.step_size_down}


class Seq(HpFunction):
    """Sequential composition: fn_i applies for dur_i steps, last runs forever.

    ``Seq((Linear(0,5,0.1), 5), (MultiStep(0.1,[90,135]), None))`` is the
    paper's "Warmup(5, 0.1), StepLR(...)" row of Table 2.
    """

    kind = "seq"

    def __init__(self, *parts: Tuple[HpFunction, int]):
        assert parts, "Seq needs at least one part"
        self.parts = []
        for fn, dur in parts:
            self.parts.append((fn, None if dur is None else int(dur)))
        for fn, dur in self.parts[:-1]:
            assert dur is not None, "only the final Seq part may be unbounded"

    def _locate(self, step: int) -> Tuple[HpFunction, int]:
        offset = 0
        for fn, dur in self.parts:
            if dur is None or step < offset + dur:
                return fn, step - offset
            offset += dur
        fn, dur = self.parts[-1]
        return fn, step - (offset - (dur or 0))

    def value(self, step: int) -> float:
        fn, local = self._locate(step)
        return fn.value(local)

    def boundaries(self, total_steps: int) -> List[int]:
        out, offset = [], 0
        for fn, dur in self.parts:
            horizon = total_steps - offset if dur is None else min(dur, total_steps - offset)
            if horizon <= 0:
                break
            out.extend(offset + b for b in fn.boundaries(horizon))
            if dur is not None:
                offset += dur
                if 0 < offset < total_steps:
                    out.append(offset)
        return sorted(set(b for b in out if 0 < b < total_steps))

    def to_json(self):
        return {"kind": self.kind,
                "parts": [[fn.to_json(), dur] for fn, dur in self.parts]}

    def piece_descriptor(self, start, stop):
        fn, local = self._locate(start)
        fn_end, local_end = self._locate(max(start, stop - 1))
        if fn is fn_end:
            return fn.piece_descriptor(local, local + (stop - start))
        return super().piece_descriptor(start, stop)

    def _piecewise_constant(self):
        return all(fn._piecewise_constant() for fn, _ in self.parts)


def Warmup(duration: int, target: float, then: HpFunction = None,
           start: float = 0.0) -> HpFunction:
    """Paper Table 2 notation: linear warm-up to ``target`` over ``duration``
    steps, followed by ``then`` (which sees local step 0 at the hand-off)."""
    ramp = Linear(start, duration, end=target)
    if then is None:
        return Seq((ramp, duration), (Constant(target), None))
    return Seq((ramp, duration), (then, None))


class Piecewise(HpFunction):
    """Arbitrary user-defined piecewise-constant sequence.

    ``Piecewise([(0, 0.1), (100, 0.01)])`` == 0.1 on [0,100), 0.01 after.
    """

    kind = "piecewise"

    def __init__(self, points: Sequence[Tuple[int, float]]):
        pts = sorted((int(s), float(v)) for s, v in points)
        assert pts and pts[0][0] == 0, "Piecewise must start at step 0"
        self.points = pts

    def value(self, step: int) -> float:
        v = self.points[0][1]
        for s, pv in self.points:
            if step >= s:
                v = pv
        return v

    def boundaries(self, total_steps: int) -> List[int]:
        return [s for s, _ in self.points if 0 < s < total_steps]

    def to_json(self):
        return {"kind": self.kind, "points": [[s, v] for s, v in self.points]}

    def piece_descriptor(self, start, stop):
        return {"kind": "const", "value": float(self.value(start))}

    def _piecewise_constant(self):
        return True


# ---------------------------------------------------------------------------
# Deserialization
# ---------------------------------------------------------------------------

def from_json(d: Dict[str, Any]) -> HpFunction:
    kind = d["kind"]
    if kind == "constant":
        return Constant(d["v"])
    if kind == "multistep":
        return MultiStep(d["base"], d["milestones"], values=d["values"])
    if kind == "exponential":
        return Exponential(d["base"], d["gamma"], d.get("period", 1))
    if kind == "linear":
        return Linear(d["base"], d["total"], d.get("end", 0.0))
    if kind == "cosine":
        return Cosine(d["base"], d["t_max"], d.get("eta_min", 0.0))
    if kind == "cosine_warm_restarts":
        return CosineWarmRestarts(d["base"], d["t_0"], d.get("t_mult", 1),
                                  d.get("eta_min", 0.0))
    if kind == "cyclic":
        return Cyclic(d["base_lr"], d["max_lr"], d["step_size_up"],
                      d.get("step_size_down"))
    if kind == "seq":
        return Seq(*[(from_json(fj), dur) for fj, dur in d["parts"]])
    if kind == "piecewise":
        return Piecewise([(s, v) for s, v in d["points"]])
    raise ValueError(f"unknown hp function kind {kind!r}")


# ---------------------------------------------------------------------------
# HpConfig: a named bundle of hyper-parameter functions
# ---------------------------------------------------------------------------


class HpConfig:
    """A full hyper-parameter configuration: name -> HpFunction.

    Non-numeric hyper-parameters tuned as single values (optimizer choice,
    weight decay in the paper's search spaces) are wrapped as ``Constant`` or
    carried in ``static`` (strings: optimizer name, etc.)."""

    def __init__(self, fns: Dict[str, HpFunction], static: Dict[str, Any] = None):
        self.fns = dict(sorted(fns.items()))
        self.static = dict(sorted((static or {}).items()))

    def value(self, step: int) -> Dict[str, float]:
        return {k: fn.value(step) for k, fn in self.fns.items()}

    def values_dict(self, step: int) -> Dict[str, Any]:
        d = self.value(step)
        d.update(self.static)
        return d

    def boundaries(self, total_steps: int) -> List[int]:
        out = set()
        for fn in self.fns.values():
            out.update(fn.boundaries(total_steps))
        return sorted(b for b in out if 0 < b < total_steps)

    def prefix_equal(self, other: "HpConfig", upto: int) -> bool:
        if set(self.fns) != set(other.fns) or self.static != other.static:
            return False
        return all(self.fns[k].prefix_equal(other.fns[k], upto) for k in self.fns)

    def to_json(self):
        return {"fns": {k: fn.to_json() for k, fn in self.fns.items()},
                "static": self.static}

    @classmethod
    def from_json(cls, d) -> "HpConfig":
        return cls({k: from_json(v) for k, v in d["fns"].items()}, d.get("static"))

    def __eq__(self, other):
        return isinstance(other, HpConfig) and self.to_json() == other.to_json()

    def __hash__(self):
        return hash(stable_hash(self.to_json()))

    def __repr__(self):
        inner = ", ".join(f"{k}={fn!r}" for k, fn in self.fns.items())
        if self.static:
            inner += ", " + ", ".join(f"{k}={v!r}" for k, v in self.static.items())
        return f"HpConfig({inner})"
