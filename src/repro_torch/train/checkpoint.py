"""Checkpoints with an atomic two-phase commit and a sha256 per shard
(counterpart of repro/train/checkpoint.py), in the reference's layout on
disk, so that a checkpoint crosses between the two packages:

    <dir>/step_<N:08d>/
        shard_<host>.npz    this host's leaves, keyed by their tree path
                            ("0/embed/tok", "1/.step", "1/.master/...")
        meta.json           step, keys, dtypes, shapes, checksums
        COMMITTED           written last: a checkpoint without it is torn
                            and ignored

A save writes into a temporary directory and moves it into place with
os.replace, so a crash mid-save never damages the previous checkpoint.
bf16 leaves are stored as their uint16 bits with "bfloat16" in meta.json
and come back through torch views of those bits (no ml_dtypes). Restore
re-hashes the shard before np.load and raises `CheckpointCorrupt`, naming
the damaged file, on a mismatch or an unreadable archive.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from .tree import leaves_with_paths, tree_unflatten


class CheckpointCorrupt(RuntimeError):
    """A committed checkpoint failed integrity validation on restore.
    `path` names the corrupt file; `detail` says how it failed."""

    def __init__(self, path: str, detail: str):
        self.path = path
        self.detail = detail
        super().__init__(f"corrupt checkpoint file {path}: {detail}")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array as stored, dtype name): bf16 as its uint16 bits."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")   # np.load's own, fresh array
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"stored {arr.dtype} for a {dtype} leaf")
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir: str, step: int, tree, host: int = 0) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=ckpt_dir)
    try:
        leaves = leaves_with_paths(tree)
        arrays, dtypes, shapes = {}, {}, {}
        for k, v in leaves:
            arrays[k], dtypes[k] = _to_numpy(v)
            shapes[k] = list(arrays[k].shape)
        shard = f"shard_{host}.npz"
        np.savez(os.path.join(tmp, shard), **arrays)
        del arrays
        meta = {
            "step": step,
            "keys": [k for k, _ in leaves],
            "dtypes": dtypes,
            "shapes": shapes,
            # the digest of the bytes on disk, checked before np.load
            "checksums": {shard: _sha256_file(os.path.join(tmp, shard))},
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and \
                os.path.exists(os.path.join(ckpt_dir, name, "COMMITTED")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, tree_like, step: int | None = None,
                       host: int = 0):
    """Restore into the structure of `tree_like` (shapes must match); each
    tensor lands on the device of its `tree_like` leaf. Returns (tree,
    step), or (None, None) when no committed checkpoint exists."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        raise FileNotFoundError(f"checkpoint at step {step} not committed")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    shard = f"shard_{host}.npz"
    shard_path = os.path.join(path, shard)
    # the integrity gate: re-hash the shard against the digest recorded at
    # save (a checkpoint without "checksums" skips it), and only then hand
    # the archive to np.load, naming the file on any parse failure
    want_sum = meta.get("checksums", {}).get(shard)
    if want_sum is not None:
        got_sum = _sha256_file(shard_path)
        if got_sum != want_sum:
            raise CheckpointCorrupt(
                shard_path, f"sha256 mismatch (expected {want_sum[:12]}…, "
                            f"got {got_sum[:12]}…)")
    try:
        data = np.load(shard_path)
    except FileNotFoundError:
        raise
    except Exception as err:
        raise CheckpointCorrupt(shard_path, f"unreadable archive: {err}")
    restored = []
    with data:
        for key, like in leaves_with_paths(tree_like):
            arr = data[key]
            t = _from_numpy(arr, meta["dtypes"].get(key, str(arr.dtype)))
            assert tuple(t.shape) == tuple(like.shape), (
                key, tuple(t.shape), tuple(like.shape))
            restored.append(t.to(like.device))
    return tree_unflatten(tree_like, restored), step


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(s for s in (
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
