"""int8 gradient compression with error feedback, the reference's
``optim/compression.py`` on PyTorch.

Each gradient, with the error left over from the last step added, is
quantised to int8 around a float32 scale ``max|g| / 127 + 1e-12``
(rounding half to even, as ``jnp.round``); what the quantisation lost is
the next step's error.  The reference takes one scale a leaf of its tree,
so one scale covers all the layers of a stacked segment; the port holds a
tensor a layer, and ``groups`` (each leaf's path → its reference leaf,
:func:`repro_torch.models.convert.leaf_map`) makes the leaves of one
reference leaf share their scale.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .tree import leaves

_LEVELS = 127.0


def _rebuild(tree: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return values[prefix[:-1]]


@torch.no_grad()
def compress_gradients(grads: Any, error: Optional[Any],
                       groups: Optional[Dict[str, str]] = None
                       ) -> Tuple[Dict[str, Any], Any]:
    """Returns ({"q": int8 tree, "scale": float32 0-d tree}, the new error
    tree).  ``groups`` maps a leaf's path to the key of the leaves that
    share its scale (by default each leaf its own)."""
    flat = leaves(grads)
    err = dict(leaves(error)) if error is not None else {}
    g32 = {}
    for path, g in flat:
        e = err.get(path)
        g32[path] = g.float() + (e if e is not None
                                 else torch.zeros_like(g, dtype=torch.float32))
    key = {path: (groups or {}).get(path, path) for path, _ in flat}
    peaks: Dict[str, list] = {}
    for path, _ in flat:
        peaks.setdefault(key[path], []).append(g32[path].abs().max())
    scales = {k: torch.stack(v).max() / _LEVELS + 1e-12
              for k, v in peaks.items()}
    qs, ss, errs = {}, {}, {}
    for path, _ in flat:
        s = scales[key[path]]
        q = torch.clamp(torch.round(g32[path] / s), -_LEVELS,
                        _LEVELS).to(torch.int8)
        qs[path], ss[path] = q, s
        errs[path] = g32[path] - q.float() * s
    return ({"q": _rebuild(grads, qs), "scale": _rebuild(grads, ss)},
            _rebuild(grads, errs))


def decompress_gradients(compressed: Dict[str, Any]) -> Any:
    """The float32 gradients ``q · scale``."""
    scale = dict(leaves(compressed["scale"]))
    return _rebuild(compressed["q"], {
        path: q.float() * scale[path]
        for path, q in leaves(compressed["q"])})

