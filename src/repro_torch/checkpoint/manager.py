"""Atomic, async checkpointing of nested dicts of arrays or tensors.

Layout per step (the reference package's, so a checkpoint written by
either package loads in the other)::

    <dir>/step_<k>.tmp/          # written first
        manifest.json            # step, leaves (key/file/shape/dtype), extra
        arr_<i>.npy              # one file per leaf, host arrays
    <dir>/step_<k>/              # atomic rename on completion

* **atomic** — a crashed writer never leaves a readable-but-corrupt step;
  restore picks the newest complete directory.
* **async** — ``save(..., blocking=False)`` copies the tree to host memory
  and writes on a background thread; the caller continues.
* **bfloat16** — a bfloat16 leaf is written as the reference writes it:
  its raw 2-byte words in an ``.npy`` of void dtype ``V2``, ``"bfloat16"``
  in the manifest.

Leaves are flattened depth-first with dict keys sorted and list or tuple
items by index, named by their path joined with ``/``; ``None`` is an
empty subtree.  This is the order and naming of the reference's
``jax.tree`` flattening, so the ``arr_<i>`` numbering agrees too.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


# bfloat16 on disk: the raw 2-byte words in an ``.npy`` of void dtype,
# named "bfloat16" in the manifest, as the reference writes them (numpy
# has no bfloat16 of its own)
_BF16_WORDS = np.dtype("V2")


def _host(leaf) -> np.ndarray:
    """A host numpy array of one leaf (torch tensors are copied off the
    device; uint32 tensors move as their int32 bits, bfloat16 tensors as
    their raw words)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.uint32:
            return t.view(torch.int32).cpu().numpy().view(np.uint32).copy()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(
                _BF16_WORDS).copy()
        return t.cpu().numpy().copy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_WORDS else str(arr.dtype)


def _dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _restored(arr: np.ndarray, tmpl):
    """A checkpoint's array in the template leaf's dtype: a bfloat16 tensor
    (from the raw words) for a bfloat16 tensor template, else a numpy
    array."""
    if isinstance(tmpl, torch.Tensor) and tmpl.dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return arr.astype(_dtype(tmpl)) if hasattr(tmpl, "dtype") else arr


def _flatten_with_paths(tree: Any, prefix: Tuple = ()
                        ) -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [("/".join(str(p) for p in prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for k, sub in items:
        out += _flatten_with_paths(sub, prefix + (k,))
    return out


def _unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with its leaves taken from ``leaves`` in
    flattening order (consumed from the front)."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, leaves) for x in template)
    return leaves.pop(0)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        # serializes publish (rename) + GC: without it a blocking save can
        # overlap an in-flight async write and GC against a half-published
        # directory listing, deleting steps that should have been retained
        self._io_lock = threading.Lock()

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True,
             extra: Optional[Dict] = None) -> None:
        # device tensors are copied to host memory first, so the caller may
        # go on updating them in place while an async write runs
        leaves = [(k, _host(v)) for k, v in _flatten_with_paths(tree)]
        # never overlap writes: a blocking save issued while an async write
        # is still in flight must drain it first (write order = save order,
        # so GC's newest-K decision matches the caller's step order)
        self.wait()
        if blocking:
            self._write(step, leaves, extra)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves, extra), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None

    def _write(self, step: int, leaves: List[Tuple[str, np.ndarray]],
               extra: Optional[Dict]) -> None:
        tmp = os.path.join(self.directory, f"step_{step}.tmp")
        final = os.path.join(self.directory, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        for i, (key, arr) in enumerate(leaves):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            manifest["leaves"].append(
                {"key": key, "file": f"arr_{i}.npy",
                 "shape": list(arr.shape), "dtype": _dtype_name(arr)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with self._io_lock:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)   # atomic publish
            self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                path = os.path.join(self.directory, name)
                if os.path.exists(os.path.join(path, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_arrays(self, step: Optional[int] = None
                    ) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Template-free restore: ``(key → array, extra)`` of one step.

        The manifest records each leaf's key/shape/dtype, so a caller that
        knows its own layout (e.g. the streaming-engine recovery layer,
        which may *rescale* lanes on restore) can read a checkpoint without
        first building a shape-identical template tree.
        """
        # under the lock of the writer's publish and GC: an async write
        # that lands meanwhile cannot delete the step being read
        with self._io_lock:
            step = step if step is not None else self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints in {self.directory}")
            path = os.path.join(self.directory, f"step_{step}")
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            arrays = {leaf["key"]: np.load(os.path.join(path, leaf["file"]))
                      for leaf in manifest["leaves"]}
        return arrays, manifest["extra"]

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, Dict]:
        """Restore into the structure of ``template`` (shapes must match);
        the leaves come back as numpy arrays of the template's dtypes,
        except that a bfloat16 tensor leaf comes back as a bfloat16
        tensor on the CPU (numpy has no bfloat16) and a numpy leaf of
        void dtype ``V2`` as the raw bfloat16 words."""
        arrays, extra = self.load_arrays(step)
        restored = []
        for key, tmpl in _flatten_with_paths(template):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = arrays[key]
            want = tuple(tmpl.shape) if hasattr(tmpl, "shape") \
                else np.shape(tmpl)
            if tuple(arr.shape) != tuple(want):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(want)}")
            restored.append(_restored(arr, tmpl))
        return _unflatten(template, restored), extra


@dataclass(frozen=True)
class LaneShard:
    """A placement: this rank's block of axis ``axis`` on the group's
    device (``group`` a :class:`repro_torch.launch.mesh.StreamGroup`)."""

    group: Any
    axis: int = 0


def _tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32)).view(torch.uint32)
    return torch.from_numpy(arr)


def _place(arr: np.ndarray, placement) -> torch.Tensor:
    if isinstance(placement, LaneShard):
        block = placement.group.block(_tensor(arr), placement.axis)
        return block.contiguous().to(placement.group.device)
    if isinstance(placement, (str, torch.device)):
        return _tensor(arr).to(torch.device(placement))
    raise TypeError(f"a placement is a torch.device or a LaneShard, got "
                    f"{placement!r}")


def restore_resharded(manager: CheckpointManager, template: Any,
                      placements: Any, step: Optional[int] = None
                      ) -> Tuple[Any, Dict]:
    """Restore a checkpoint and place every leaf by ``placements`` (an
    elastic restart onto another group: the checkpoint stores global
    arrays, and each rank keeps the part its placement names).

    ``placements`` has ``template``'s structure; a leaf is a
    ``torch.device`` (or its name), which puts the whole array there, or a
    :class:`LaneShard`, which keeps this rank's block of one axis on the
    group's device.  Returns ``(tree of tensors, extra)``.
    """
    tree, extra = manager.restore(template, step)
    leaves = _flatten_with_paths(tree)
    where = _flatten_with_paths(placements)
    if [k for k, _ in leaves] != [k for k, _ in where]:
        raise ValueError(f"placements name the leaves "
                         f"{[k for k, _ in where]}, the template "
                         f"{[k for k, _ in leaves]}")
    return _unflatten(tree, [_place(arr, p) for (_, arr), (_, p)
                             in zip(leaves, where)]), extra
