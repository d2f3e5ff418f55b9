"""Compact CIFAR ResNet (the paper-faithful example model family).

The paper's single-study experiments tune ResNet56/MobileNetV2 on
CIFAR-10.  This is a functional PyTorch ResNet of the same shape family
(3 stages × n blocks, channels 16/32/64, stride-2 stage transitions) —
``n=9`` gives ResNet56; small examples use ``n=1`` (ResNet8).
Normalization is channel RMS-norm (stateless — keeps training a pure
function of (params, batch), which the losslessness property relies on).

Layouts are those of the JAX package at every public function:
activations NHWC, convolution weights HWIO, the parameter tree a dict with
the same keys and nesting.  ``F.conv2d`` wants NCHW / OIHW, so ``_conv``
permutes at the call site: the NHWC activation becomes a channels-last
view (no copy), the small weight is copied.  Padding is XLA's ``"SAME"``,
computed explicitly — for a 3×3 stride-2 convolution on an even input it
is ``(0, 1)``, not PyTorch's symmetric ``padding=1``, and the two give
different numbers.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.utils.tree import tree_map

__all__ = ["ResNet"]


def _trunc_normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return t * scale


def _conv_init(gen, k, cin, cout):
    fan_in = k * k * cin
    return _trunc_normal(gen, (k, k, cin, cout), (2.0 / fan_in) ** 0.5)


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA ``"SAME"`` padding ``(lo, hi)`` along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """NHWC activation ⊛ HWIO weight with ``"SAME"`` padding → NHWC."""
    kh, kw = w.shape[0], w.shape[1]
    ph = _same_pad(x.shape[1], kh, stride)
    pw = _same_pad(x.shape[2], kw, stride)
    x = x.permute(0, 3, 1, 2)                       # NCHW view, channels-last
    if ph[0] == ph[1] and pw[0] == pw[1]:
        padding = (ph[0], pw[0])
    else:
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        padding = 0
    y = F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _norm(x, g):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * g


class ResNet:
    def __init__(self, n: int = 1, num_classes: int = 10, width: int = 16):
        self.n = n
        self.num_classes = num_classes
        self.width = width
        self.depth = 6 * n + 2

    # ------------------------------------------------------------------ init
    def init(self, rng: Union[int, torch.Generator],
             device: Union[str, torch.device, None] = None) -> Dict[str, Any]:
        """Fresh f32 parameters drawn from ``rng`` (a seed or a CPU
        ``torch.Generator``) — the same distributions as the JAX package's
        ``init``, not the same bits.  The draw is always made on the host,
        so a seed gives the same bits wherever the tensors end up;
        ``device`` moves them there (default: they stay on the CPU)."""
        gen = rng if isinstance(rng, torch.Generator) else \
            torch.Generator().manual_seed(int(rng))
        w = self.width
        chans = [w, 2 * w, 4 * w]
        params: Dict[str, Any] = {
            "stem": _conv_init(gen, 3, 3, w), "stem_g": torch.ones((w,))}
        stages = []
        cin = w
        for s, c in enumerate(chans):
            blocks = []
            for b in range(self.n):
                stride = 2 if (s > 0 and b == 0) else 1
                blk = {
                    "c1": _conv_init(gen, 3, cin, c), "g1": torch.ones((c,)),
                    "c2": _conv_init(gen, 3, c, c), "g2": torch.ones((c,)),
                }
                if stride != 1 or cin != c:
                    blk["proj"] = _conv_init(gen, 1, cin, c)
                blocks.append(blk)
                cin = c
            stages.append(blocks)
        params["stages"] = stages
        params["head"] = _trunc_normal(
            gen, (chans[-1], self.num_classes), chans[-1] ** -0.5)
        params["head_b"] = torch.zeros((self.num_classes,))
        if device is not None:
            params = tree_map(lambda x: x.to(device), params)
        return params

    # --------------------------------------------------------------- forward
    def forward(self, params, batch) -> torch.Tensor:
        x = batch["images"]
        x = F.relu(_norm(_conv(x, params["stem"]), params["stem_g"]))
        for s, blocks in enumerate(params["stages"]):
            for b, blk in enumerate(blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                h = F.relu(_norm(_conv(x, blk["c1"], stride), blk["g1"]))
                h = _norm(_conv(h, blk["c2"]), blk["g2"])
                sc = _conv(x, blk["proj"], stride) if "proj" in blk else x
                x = F.relu(sc + h)
        x = torch.mean(x, dim=(1, 2))
        return x @ params["head"] + params["head_b"]

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``batch["labels"]`` is int64 (the trainer converts the dataset's
        int32 labels once, at upload)."""
        logits = self.forward(params, batch)
        labels = batch["labels"]
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
        acc = torch.mean((torch.argmax(logits, -1) == labels).float())
        return torch.mean(nll), {"acc": acc}
