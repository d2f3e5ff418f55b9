"""Carry weights between numpy and the port's tensor trees.

The JAX package's parameter trees are nested dicts / lists / tuples of
arrays (the ResNet's is a dict holding a list of lists of dicts).  These
helpers move such trees leaf for leaf between numpy and torch — the way
weights initialised or trained by the JAX package reach the port and go
back.  Nothing here imports JAX: a caller holding JAX arrays applies
``np.asarray`` to the leaves first.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.utils.tree import tree_map

__all__ = ["tree_from_numpy", "tree_to_numpy", "state_from_numpy"]


def _leaf_from_numpy(x: Any, device, dtype: Optional[torch.dtype]):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 (what np.asarray gives for a JAX bf16 array)
        # is not a dtype torch.tensor takes: widen to f32 (exact), then
        # cast back to bfloat16 on the torch side
        return torch.tensor(x.astype(np.float32), device=device,
                            dtype=dtype or torch.bfloat16)
    return torch.tensor(x, device=device, dtype=dtype)


def tree_from_numpy(tree: Any, device: Union[str, torch.device],
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Numpy leaves → tensors on ``device`` (copied; cast to ``dtype`` when
    given), same container structure.  ``ml_dtypes.bfloat16`` leaves
    become ``torch.bfloat16`` bit for bit."""
    return tree_map(lambda x: _leaf_from_numpy(x, device, dtype), tree)


def tree_to_numpy(tree: Any) -> Any:
    """Tensor leaves → numpy arrays on the host.  bfloat16 has no numpy
    dtype and is widened to float32."""
    def leaf(x: torch.Tensor) -> np.ndarray:
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return tree_map(leaf, tree)


def state_from_numpy(state: Dict[str, Any],
                     device: Union[str, torch.device]) -> Dict[str, Any]:
    """A whole trainer state ``{"params", "opt", "opt_name", "data",
    "step"}`` with numpy leaves → the port's state on ``device``.  ``opt``
    may be ``None`` (optimizer slots are created lazily)."""
    return {
        "params": tree_from_numpy(state["params"], device),
        "opt": tree_from_numpy(state["opt"], device),
        "opt_name": state["opt_name"],
        "data": tuple(int(v) for v in state["data"]),
        "step": int(state["step"]),
    }
