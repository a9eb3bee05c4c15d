"""Fault-tolerant checkpointing: the port of ``repro.checkpoint``, with
its on-disk format, so a checkpoint written by either package restores
into the other.

  * **Format**: ``step_<N:09d>/arrays.npz`` (one array per leaf, named
    by its tree path with ``/`` written ``__``: ``params__w0``,
    ``opt__mu__w0``, ``step``) and ``manifest.json`` (step, and each
    array's shape, dtype and crc32). A bf16 leaf is stored as ``repro``
    stores it: raw 2-byte records (``|V2``) in the npz, ``"dtype":
    "bfloat16"`` in the manifest, its crc32 over those bytes; it
    restores as ``torch.bfloat16`` (``core/sync.py``).
  * **Atomic**: write to ``step_<N>.tmp`` then ``os.rename`` — a crash
    mid-save never corrupts the latest checkpoint.
  * **Integrity**: the manifest is verified on restore; corrupt or
    partial checkpoints are skipped and the previous step is used.
  * **Async**: ``CheckpointManager.maybe_save`` copies the state to the
    host (``snapshot``: one counted ``host_read`` for all its tensors)
    before the writer thread starts. The copy matters on the CPU too,
    where a tensor's numpy view shares its memory: without it, an
    in-place update after the call would change a checkpoint still
    being written.
  * **Elastic**: arrays are stored whole on the host (a DTensor leaf is
    gathered first: every rank takes part, rank 0 writes), so
    ``restore`` may place them on another device (``device=``) or lay
    them out on another mesh (``shardings=``, a tree of
    ``distributed.sharding.NamedSharding``: ``repro``'s re-shard for
    elastic restarts). A DTensor leaf of ``state_like`` without
    ``shardings`` comes back in its own layout.
  * **Retention**: keep the last ``keep`` checkpoints, delete older.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.sync import host_read, is_bf16_host, upload
from repro_torch.kernels.backend import resolve_device
from repro_torch.tree import flatten_with_paths, tree_map, unflatten_paths


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a world, or a
    process outside any."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def snapshot(state):
    """``state`` as a tree of numpy arrays that share no memory with it:
    every tensor leaf through one counted ``host_read`` (a copy; a
    DTensor gathered whole first), every other leaf copied by
    ``np.array``."""
    from repro_torch.distributed.sharding import gather
    flat = [(k, gather(v) if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_with_paths(state)]
    tensors = tuple(leaf for _, leaf in flat if isinstance(leaf, torch.Tensor))
    read = iter(host_read(tensors) if tensors else ())
    return unflatten_paths(
        (path, next(read) if isinstance(leaf, torch.Tensor)
         else np.array(leaf)) for path, leaf in flat)


def state_from_tree(tree, device=None):
    """A tree of numpy arrays (``repro``'s parameter or state tree, or a
    checkpoint's) as the port's state: every leaf a tensor on
    ``device`` (the card unless the caller names the CPU). With
    ``snapshot`` back, this carries a whole train state (``{"params",
    "opt", "step"}``: AdamW's ``mu``/``nu`` or Adafactor's
    ``vr``/``vc``/``v``) between the packages, bf16 leaves bitwise."""
    device = resolve_device(device)
    return tree_map(lambda a: upload(np.asarray(a), device), tree)


def save_checkpoint(ckpt_dir, step: int, state, keep: int = 3) -> Path:
    """Synchronous atomic save. Returns the final directory path. In a
    world of several ranks every rank calls it (DTensor leaves are
    gathered) and rank 0 writes."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:09d}"
    host = snapshot(state)
    if not _writer():
        return final
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "arrays": {}}
    arrays = {}
    for name, arr in flatten_with_paths(host):
        arrays[name] = arr
        manifest["arrays"][name] = {
            "shape": list(arr.shape),
            "dtype": "bfloat16" if is_bf16_host(arr.dtype) else str(arr.dtype),
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF,
        }
    np.savez(tmp / "arrays.npz",
             **{k.replace("/", "__"): v for k, v in arrays.items()})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    return steps[-1] if steps else None


def _verify(d: Path) -> bool:
    try:
        manifest = json.loads((d / "manifest.json").read_text())
        z = np.load(d / "arrays.npz")
        for name, meta in manifest["arrays"].items():
            arr = z[name.replace("/", "__")]
            if list(arr.shape) != meta["shape"]:
                return False
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF
            if crc != meta["crc32"]:
                return False
        return True
    except Exception:       # any unreadable checkpoint is skipped
        return False


def restore_checkpoint(ckpt_dir, state_like, step: int | None = None,
                       device=None, shardings=None):
    """Restore the newest valid checkpoint into the structure of
    ``state_like``. A leaf that is a tensor there comes back as a
    tensor on ``device`` (by default that leaf's own device), laid out
    by its ``shardings`` leaf when given, else as a DTensor in the
    ``state_like`` leaf's own layout when that is one; any other leaf as
    a numpy array. Returns (state, step), or (None, None) when nothing
    valid exists."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as SHD
    shards = dict(flatten_with_paths(shardings)) if shardings else {}
    ckpt_dir = Path(ckpt_dir)
    candidates = sorted((p for p in ckpt_dir.glob("step_*") if p.is_dir()
                         and not p.name.endswith(".tmp")), reverse=True)
    if step is not None:
        candidates = [p for p in candidates
                      if int(p.name.split("_")[1]) == step]
    for d in candidates:
        if not _verify(d):
            continue
        z = np.load(d / "arrays.npz")
        flat = flatten_with_paths(state_like)
        if any(name.replace("/", "__") not in z.files for name, _ in flat):
            continue
        leaves = []
        for name, like in flat:
            arr = z[name.replace("/", "__")]
            if isinstance(like, torch.Tensor):
                arr = upload(arr, like.device if device is None else device)
                if name in shards:
                    arr = SHD.place(arr, shards[name])
                elif isinstance(like, DTensor):
                    arr = SHD.place(arr, SHD.NamedSharding(
                        like.device_mesh, layout=like.placements))
            leaves.append((name, arr))
        return unflatten_paths(leaves), int(d.name.split("_")[1])
    return None, None


class CheckpointManager:
    """Async checkpointing + restore-latest for the fault-tolerant runner."""

    def __init__(self, ckpt_dir, keep: int = 3, every: int = 100):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.every = every
        self._thread: threading.Thread | None = None
        self.saved_steps: list[int] = []

    def maybe_save(self, step: int, state, force: bool = False):
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        self.wait()
        host_state = snapshot(state)

        def work():
            save_checkpoint(self.dir, step, host_state, keep=self.keep)
            self.saved_steps.append(step)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, state_like):
        import torch.distributed as dist
        self.wait()
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()        # rank 0's last write is on disk
        return restore_checkpoint(self.dir, state_like)
