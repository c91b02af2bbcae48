"""Checkpointing of parameter and optimizer-state trees with atomic commit.

The port's copy of the JAX package's ``checkpoint/checkpoint.py``, with
the same layout on disk (one directory per step):

    <dir>/step_00000042/
        manifest.json        # leaf names/shapes/dtypes, step, metadata
        shard_00000.npz      # leaves, chunked into ~512 MB files
        ...
    <dir>/LATEST             # atomically updated pointer

Writes go to ``step_xxx.tmp`` and are renamed into place, so a crash
mid-save never corrupts the previous checkpoint (restart -> restore ->
resume the data stream from the recorded offset).

A tree is nested dicts, tuples/lists and ``NamedTuple``s (``AdamWState``)
of tensors and ints (the step count). Leaf names are the JAX package's tree paths
joined by ``/`` (dict key, sequence index, named-tuple field), so the
port's ``(params, opt_state)`` is named as the JAX package's: ``0/embed``,
``0/layers/attn/wq``, ``1/step``, ``1/mu/embed``, ... (the port's flat
parameter names already hold the ``/`` of JAX's nesting). In the ``.npz``
files ``/`` is stored as ``|``.

bf16 has no numpy dtype without an extension package, so a bf16 leaf is
stored as its 2-byte words in a ``V2`` array with the manifest dtype
``"bfloat16"``: the bytes the JAX package writes for a bf16 leaf (numpy
saves its bf16 extension-dtype array as ``|V2`` too), and restored
from them.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SHARD_BYTES = 512 * 1024 * 1024


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` in the JAX package's flattening order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in _leaves(getattr(tree, f), prefix + (f,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree) for kv in _leaves(x, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _rebuild(template: Any, values: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Any:
    if isinstance(template, dict):
        return {k: _rebuild(v, values, prefix + (str(k),)) for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(getattr(template, f), values, prefix + (f,)) for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(x, values, prefix + (str(i),)) for i, x in enumerate(template))
    return values["/".join(prefix)]


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, int):
        a = np.asarray(leaf, dtype=np.int32)  # the step count, an int32 scalar as in JAX
        return a, str(a.dtype)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2"), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save(directory: str, step: int, tree: Any, *, metadata: Optional[Dict] = None) -> str:
    """Atomically write a checkpoint; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    named = {name: _to_numpy(leaf) for name, leaf in _leaves(tree)}
    shards, cur, cur_bytes = [], {}, 0
    for name in sorted(named):
        arr, _ = named[name]
        if cur and cur_bytes + arr.nbytes > _SHARD_BYTES:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[name] = arr
        cur_bytes += arr.nbytes
    if cur:
        shards.append(cur)

    leaf_index = {}
    for i, shard in enumerate(shards):
        fname = f"shard_{i:05d}.npz"
        np.savez(os.path.join(tmp, fname), **{n.replace("/", "|"): a for n, a in shard.items()})
        for n, a in shard.items():
            leaf_index[n] = {"file": fname, "shape": list(a.shape), "dtype": named[n][1]}

    manifest = {"step": step, "leaves": leaf_index, "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    fd, latest_tmp = tempfile.mkstemp(dir=directory)
    with os.fdopen(fd, "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    if not os.path.isdir(path):
        return None
    return int(name.split("_")[1])


def _from_numpy(arr: np.ndarray, dtype_name: str, leaf: Any) -> Any:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if isinstance(leaf, int):
        return int(t)
    return t.to(device=leaf.device, dtype=leaf.dtype)


def restore(directory: str, template: Any, *, step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``template`` (new tensors, each on its
    template leaf's device and in its dtype); returns (tree, step,
    metadata)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    files: Dict[str, Any] = {}
    values = {}
    for name, leaf in _leaves(template):
        info = manifest["leaves"][name]
        if info["file"] not in files:
            files[info["file"]] = np.load(os.path.join(path, info["file"]))
        values[name] = _from_numpy(files[info["file"]][name.replace("/", "|")], info["dtype"], leaf)
    return _rebuild(template, values), manifest["step"], manifest["metadata"]
