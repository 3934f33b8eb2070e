"""Tree checkpoints in the JAX package's on-disk format.

Re-implementation of ``repro/checkpoint/checkpoint.py`` over tensors
(the original imports jax), so either package restores what the other
wrote:

* leaves are flattened under ``/``-joined key paths, dict keys by name
  and sequence positions as ``[i]`` (``cur/[0]``, ``opt/m/embed``), into
  one compressed ``.npz``; a json sidecar holds the step, the sorted keys
  and a description of the structure (``treedef``, never read back);
* a bf16 leaf is stored as its raw 16 bits with numpy's ``<V2`` header,
  byte for byte what numpy writes for JAX's bfloat16 arrays, and is read
  back through an int16 view (no ``ml_dtypes`` needed);
* writes are atomic and ordered (DESIGN.md §10): both files are staged
  in a temp dir beside the checkpoint and renamed npz first, sidecar
  last, so the sidecar commits the step and :func:`latest_step` only
  returns steps that pass :func:`is_complete`.

:func:`save` is :func:`encode` (tree -> dict of numpy arrays on the
host) then the files; :func:`restore` is the files then :func:`decode`
(dict -> tree shaped like ``like``, on the caller's device).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import zipfile
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# numpy's header for a 2-byte void array, as it writes JAX's bfloat16
BF16_DESCR = "<V2"
_BF16_BITS = np.dtype("V2")
# file names: ckpt_{step:08d}.npz / .json, as the JAX package writes them
_PREFIX = "ckpt"


def _is_seq(x) -> bool:
    return isinstance(x, (tuple, list))


def _items(tree, prefix: str = ""):
    """(key path, leaf) in ``jax.tree_util`` order: dict keys sorted and
    named, sequence positions as ``[i]``."""
    if isinstance(tree, Mapping):
        kids = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_seq(tree):
        kids = [(f"[{i}]", c) for i, c in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for k, child in kids:
        yield from _items(child, f"{prefix}/{k}" if prefix else k)


def _structure(tree) -> str:
    """The tree's containers with ``*`` for each leaf (the sidecar's
    ``treedef``)."""
    if isinstance(tree, Mapping):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_seq(tree):
        inner = ", ".join(_structure(c) for c in tree)
        if isinstance(tree, tuple):
            return f"({inner},)" if len(tree) == 1 else f"({inner})"
        return f"[{inner}]"
    return "*"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.asarray(leaf)


def encode(tree) -> Dict[str, np.ndarray]:
    """Every leaf of ``tree`` as a host numpy array under its key path
    (a leaf already on the host is not copied; a bf16 leaf is its raw
    16 bits as a 2-byte void array)."""
    return {k: _to_numpy(leaf) for k, leaf in _items(tree)}


def _to_tensor(arr: np.ndarray, dtype: Optional[torch.dtype], device
               ) -> torch.Tensor:
    if arr.dtype == _BF16_BITS:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def _rebuild(like, leaves):
    if isinstance(like, Mapping):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if _is_seq(like):
        return type(like)(_rebuild(c, leaves) for c in like)
    return next(leaves)


def decode(arrays: Mapping, like, *, device="cuda"):
    """Tensors shaped like ``like`` (a tree of tensors, meta ones work)
    from :func:`encode`'s dict: each leaf's shape is checked and the
    result takes the leaf's dtype, on ``device``."""
    out = []
    for key, leaf in _items(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        if hasattr(leaf, "shape") and tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        out.append(_to_tensor(arr, getattr(leaf, "dtype", None), device))
    return _rebuild(like, iter(out))


def _write_npz(f, arrays: Mapping) -> None:
    """``np.savez_compressed``'s archive (deflated members written
    through ``zipf.open(..., force_zip64=True)``), with a bf16 member's
    header naming ``<V2`` as numpy does for JAX's arrays."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_DEFLATED,
                         allowZip64=True) as zipf:
        for key, val in arrays.items():
            val = np.asanyarray(val)
            with zipf.open(key + ".npy", "w", force_zip64=True) as fid:
                if val.dtype != _BF16_BITS:
                    np.lib.format.write_array(fid, val)
                    continue
                np.lib.format.write_array_header_1_0(fid, {
                    "descr": BF16_DESCR, "fortran_order": False,
                    "shape": val.shape})
                fid.write(np.ascontiguousarray(val).tobytes())


def save(directory: str, step: int, tree) -> str:
    """Write ``tree`` as checkpoint ``step`` (see the module docstring);
    returns the npz path."""
    os.makedirs(directory, exist_ok=True)
    arrays = encode(tree)
    meta = {"step": step, "treedef": _structure(tree), "keys": sorted(arrays)}
    base = os.path.join(directory, f"{_PREFIX}_{step:08d}")
    tmpdir = tempfile.mkdtemp(dir=directory,
                              prefix=f".{_PREFIX}_{step:08d}_")
    try:
        npz_tmp = os.path.join(tmpdir, "arrays.npz")
        with open(npz_tmp, "wb") as f:
            _write_npz(f, arrays)
        json_tmp = os.path.join(tmpdir, "meta.json")
        with open(json_tmp, "w") as f:
            json.dump(meta, f)
        # npz first, sidecar last: the sidecar commits the step
        os.replace(npz_tmp, base + ".npz")
        os.replace(json_tmp, base + ".json")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return base + ".npz"


def load_arrays(directory: str, step: int) -> Dict[str, np.ndarray]:
    """Every array of checkpoint ``step``, on the host."""
    base = os.path.join(directory, f"{_PREFIX}_{step:08d}")
    with np.load(base + ".npz") as data:
        return {k: data[k] for k in data.files}


def restore(directory: str, step: int, like, *, device="cuda"):
    """Checkpoint ``step`` as a tree shaped like ``like`` (shapes checked,
    ``like``'s dtypes), its tensors on ``device``."""
    return decode(load_arrays(directory, step), like, device=device)


def saved_keys(directory: str, step: int) -> list:
    """The leaf key paths a checkpoint holds (from its sidecar)."""
    base = os.path.join(directory, f"{_PREFIX}_{step:08d}")
    with open(base + ".json") as f:
        return list(json.load(f)["keys"])


def is_complete(directory: str, step: int) -> bool:
    """True iff the sidecar (the commit marker) exists, the npz opens as
    a zip (a truncated write loses the central directory at its end), and
    every key the sidecar promises is a member."""
    base = os.path.join(directory, f"{_PREFIX}_{step:08d}")
    if not (os.path.isfile(base + ".npz") and os.path.isfile(base + ".json")):
        return False
    try:
        with open(base + ".json") as f:
            meta = json.load(f)
        with zipfile.ZipFile(base + ".npz") as z:
            names = set(z.namelist())
        return all(f"{k}.npy" in names for k in meta.get("keys", []))
    except Exception:
        return False


def _steps_on_disk(directory: str) -> List[int]:
    pat = re.compile(rf"{_PREFIX}_(\d+)\.npz$")
    return sorted({int(m.group(1)) for f in os.listdir(directory)
                   if (m := pat.match(f))})


def valid_steps(directory: str) -> List[int]:
    """Every complete checkpoint step, ascending."""
    if not os.path.isdir(directory):
        return []
    return [s for s in _steps_on_disk(directory) if is_complete(directory, s)]


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint step (None if there is none)."""
    steps = valid_steps(directory)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# Layout and schedule sidecar (cross-layout and mid-cycle resume, §9)
# ---------------------------------------------------------------------------
def schedule_digest(schedule) -> str:
    """Fingerprint of a schedule's phases: the repr of frozen dataclasses
    of primitives, equal to the JAX package's for the same plan."""
    return hashlib.sha1(repr(schedule.phases).encode()).hexdigest()[:16]


def save_layout_descriptor(directory: str, step: int, layout,
                           next_phase: int = 0, digest: str = "",
                           divisors: Sequence[Optional[int]] = ()) -> None:
    """``layout_{step}.json``: the BucketLayout checkpoint ``step`` was
    written under (partition, shard count, precision), the cycle position
    the next step would run and the schedule's digest.  ``divisors``, the
    update divisors a hot swap's hand-over still owes the coming steps
    (``DeftRuntime.pending_divisors``), go in as ``handover_divisors``
    only when there are any, so an ordinary sidecar is the JAX package's
    byte for byte (its loader reads the keys it knows)."""
    path = os.path.join(directory, f"layout_{step:08d}.json")
    doc = {"bucket_of": list(layout.bucket_of_leaf),
           "n_buckets": layout.n_buckets,
           "shards": layout.shards,
           "next_phase": next_phase,
           "schedule_digest": digest}
    if layout.precision is not None:
        doc["precision"] = {"wire": list(layout.precision.wire),
                            "master": layout.precision.master}
    if divisors:
        doc["handover_divisors"] = list(divisors)
    with open(path + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(path + ".tmp", path)


def load_layout_descriptor(directory: str, step: int, params_abs
                           ) -> Tuple[Any, int, str, List[Optional[int]]]:
    """(layout, next_phase, digest, divisors) of checkpoint ``step``, the
    layout rebuilt over ``params_abs`` (meta tensors work) and
    ``divisors`` the hand-over's pending update divisors ([] when none
    were saved); (None, 0, "", []) when the checkpoint has no
    descriptor."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.train.bucketing import build_bucket_layout

    path = os.path.join(directory, f"layout_{step:08d}.json")
    if not os.path.exists(path):
        return None, 0, "", []
    with open(path) as f:
        d = json.load(f)
    layout = build_bucket_layout(params_abs, tuple(d["bucket_of"]),
                                 d["n_buckets"], shard_count=d["shards"])
    if d.get("precision") is not None:
        layout = layout.with_precision(PrecisionPolicy(
            wire=tuple(d["precision"]["wire"]),
            master=d["precision"]["master"]))
    return layout, int(d.get("next_phase", 0)), \
        str(d.get("schedule_digest", "")), \
        list(d.get("handover_divisors", []))
