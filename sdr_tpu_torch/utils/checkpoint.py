"""Checkpoint / resume for streaming receiver state.

Port of sdr_tpu/utils/checkpoint.py, in its v2 format, so that a file
crosses between the two packages in both directions: an npz of the
leaves (`leaf_<i>`) plus a structural manifest, one key-path string
(`__paths__`) and one numpy dtype name (`__dtypes__`) per leaf, and
`__format_version__` (2).  bfloat16 leaves are stored as their uint16
bit patterns.

The key paths are the strings the reference gets from
`jax.tree_util.keystr`, built here from the port's own tree: a
NamedTuple field is `.field`, a dict key `['key']` (dicts flatten in
sorted key order, as jax flattens them), a tuple or list index `[i]`,
and a None slot has no leaves and no path.  So a receiver state gives
`.front.i_tail` ... `.rds.rrc_tail`, and WidebandReceiver's
(channelizer dict, ReceiverState) pair `[0]['phase']` ... `[1].mono.deemph`.
"""

from __future__ import annotations

import numpy as np
import torch

FORMAT_VERSION = 2


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(key path, leaf) pairs in jax's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if _is_namedtuple(tree):
        return [p for f in tree._fields
                for p in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in _flatten(v, f"{prefix}[{i}]")]
    raise TypeError(f"unsupported state node {type(tree).__name__} at "
                    f"{prefix or 'the root'}")


def _unflatten(like, leaves):
    """Rebuild `like`'s structure from an iterator over its new leaves."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, dict):
        new = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return type(like)((k, new[k]) for k in like)
    return type(like)(_unflatten(v, leaves) for v in like)


def leaf_paths(tree) -> list[str]:
    """Stable per-leaf key-path strings for a state tree (the manifest)."""
    return [p for p, _ in _flatten(tree)]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_state(path: str, state) -> None:
    """Serialize a receiver state tree to an .npz file (reference v2)."""
    flat = _flatten(state)
    arrays = {f"leaf_{i}": _to_numpy(t) for i, (_, t) in enumerate(flat)}
    arrays["__format_version__"] = np.array(FORMAT_VERSION)
    arrays["__paths__"] = np.array([p for p, _ in flat])
    # torch's dtype names are numpy's (float32, bfloat16, uint8, ...)
    arrays["__dtypes__"] = np.array([str(t.dtype).removeprefix("torch.")
                                     for _, t in flat])
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_state(path: str, like):
    """Restore a state saved by save_state (or by the reference's).

    `like` gives the structure (e.g. rx.init_state(batch_shape)); key
    paths and shapes are checked leaf by leaf against it, and the leaves
    land on the device of like's leaves.  A v1 file (no manifest) is
    checked by leaf count and shapes only."""
    flat = _flatten(like)
    n = len(flat)
    with np.load(path, allow_pickle=False) as data:
        if "__paths__" in data:
            saved_paths = [str(p) for p in data["__paths__"]]
            want_paths = [p for p, _ in flat]
            if saved_paths != want_paths:
                missing = [p for p in want_paths if p not in saved_paths]
                extra = [p for p in saved_paths if p not in want_paths]
                raise ValueError(
                    "checkpoint structure mismatch:\n"
                    f"  leaves only in checkpoint: {extra}\n"
                    f"  leaves only in expected state: {missing}"
                    if (missing or extra) else
                    "checkpoint structure mismatch: same leaf set, "
                    f"different order:\n  saved:    {saved_paths}\n"
                    f"  expected: {want_paths}")
        saved = [data[f"leaf_{i}"] for i in range(n)]
        if f"leaf_{n}" in data:
            raise ValueError(
                f"checkpoint has more than the expected {n} leaves")
        dts = ([str(d) for d in data["__dtypes__"]]
               if "__dtypes__" in data else [None] * n)
    leaves = []
    for i, (s, d, (_, l)) in enumerate(zip(saved, dts, flat)):
        if s.shape != tuple(l.shape):
            raise ValueError(f"leaf {i}: saved shape {s.shape} != expected "
                             f"{tuple(l.shape)}")
        s = np.array(s)    # owned and C-ordered; 0-d leaves stay 0-d
        if d == "bfloat16" and s.dtype == np.uint16:
            t = torch.from_numpy(s.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(s)
        leaves.append(t.to(l.device))
    return _unflatten(like, iter(leaves))
