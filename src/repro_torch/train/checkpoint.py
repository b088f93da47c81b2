"""Checkpoints: atomic, CRC-verified, in the JAX package's on-disk format.

Layout (``repro.train.checkpoint``'s, so each package restores the
other's checkpoints):  <dir>/step_<N>/
            arrays.npz     stored leaves as ``leaf_<i>``
            meta.json      step, dp_total, leaf paths, None leaves, CRC32s

* Leaves go in the JAX package's flatten order: the TrainState fields in
  order (params, opt, residuals, step, inflight), dict keys sorted, and
  ``meta["paths"]`` holds ``jax.tree_util.keystr`` of each leaf
  (``.params['embed']``, ``.opt['mu']['embed']``, ``.step``). ``step`` is
  a 0-d int32 leaf; a None field (``residuals`` in dense mode,
  ``inflight`` of a synchronous state) is a leaf listed in
  ``none_leaves``. ``restore`` refuses a checkpoint whose paths differ.
* Atomic and durable: written to step_<N>.tmp, each file fsync'd, then
  renamed with ``os.replace`` and the parent directory fsync'd, so a
  crash mid-save never corrupts the latest checkpoint.
* Integrity: meta.json records a CRC32 per stored array;
  ``verify_checkpoint`` recomputes them, ``restore(..., verify=True)``
  raises :class:`CheckpointCorrupt` on a mismatch, and
  ``latest_valid_step`` walks newest to oldest to the first checkpoint
  that verifies: keep-N retention doubles as the fallback window.

The optimizer state is always in the "full" layout (param-shaped
moments): ZeRO-1 and the scattered mode are not ported, so neither are
``remesh`` and ``convert_opt_layout`` (ROADMAP Queue 1 items 6 and 10).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.train.state import TrainState

OPT_LAYOUTS = ("full", "zero1_leaf", "zero_scattered")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed CRC verification (or could not be read)."""


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _fsync_path(path: str) -> None:
    """fsync an already-written file (or directory) by path."""
    flags = os.O_RDONLY | (os.O_DIRECTORY if os.path.isdir(path) else 0)
    fd = os.open(path, flags)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten_with_paths(state: TrainState) -> tuple[list[str], list]:
    """(keystr paths, leaves) in the JAX package's flatten order."""
    paths, leaves = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{path}[{key!r}]")
        else:
            paths.append(path)
            leaves.append(node)

    for name in TrainState._fields:
        walk(getattr(state, name), f".{name}")
    return paths, leaves


def _to_host(leaf, path: str) -> Optional[np.ndarray]:
    if leaf is None:
        return None
    if path == ".step":
        return np.asarray(int(leaf), dtype=np.int32)
    return leaf.detach().cpu().numpy()


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, state: TrainState, *, dp_total: int,
         keep_last: int = 3, extra_meta: Optional[dict] = None,
         opt_layout: Optional[str] = None) -> str:
    """Write ``state`` as checkpoint ``step_<state.step>`` and keep the
    newest ``keep_last``. ``extra_meta`` (JSON-serialisable) is merged
    into meta.json; ``opt_layout`` (one of ``OPT_LAYOUTS``) stamps the
    optimizer-state layout. Device tensors are copied to the host here:
    a caller with work still queued on another stream drains it first."""
    if opt_layout is not None and opt_layout not in OPT_LAYOUTS:
        raise ValueError(f"unknown opt_layout {opt_layout!r}")
    step = int(state.step)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    paths, leaves = _flatten_with_paths(state)
    host = [_to_host(leaf, p) for p, leaf in zip(paths, leaves)]
    arrays = {f"leaf_{i}": a for i, a in enumerate(host) if a is not None}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {
        "step": step,
        "dp_total": dp_total,
        "paths": paths,
        "none_leaves": [i for i, a in enumerate(host) if a is None],
        "crc32": {k: _crc32(a) for k, a in arrays.items()},
    }
    if opt_layout is not None:
        meta["opt_layout"] = opt_layout
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    # durability: file contents, then the rename, then the dirent
    _fsync_path(os.path.join(tmp, "arrays.npz"))
    _fsync_path(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_path(directory)
    _gc(directory, keep_last)
    return final


def _steps(directory: str) -> list[int]:
    """Checkpointed steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if re.fullmatch(r"step_\d{8}", d))


def _gc(directory: str, keep_last: int) -> None:
    for step in _steps(directory)[:-keep_last]:
        shutil.rmtree(_step_dir(directory, step), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def load_meta(directory: str, step: Optional[int] = None) -> dict:
    """The meta.json of one checkpoint (the latest by default)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    with open(os.path.join(_step_dir(directory, step), "meta.json")) as f:
        return json.load(f)


def verify_checkpoint(directory: str, step: int) -> bool:
    """True iff the checkpoint is readable and every stored array's CRC32
    matches meta.json (one with no CRC record verifies by readability)."""
    d = _step_dir(directory, step)
    try:
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            crcs = meta.get("crc32")
            if crcs is None:
                _ = [data[k].shape for k in data.files]
                return True
            if set(crcs) != set(data.files):
                return False
            return all(_crc32(data[k]) == int(crcs[k]) for k in data.files)
    except Exception:  # any unreadable file is a failed verification
        return False


def latest_valid_step(directory: str) -> Optional[int]:
    """Newest step whose checkpoint passes :func:`verify_checkpoint`;
    None when nothing under ``directory`` verifies."""
    for step in reversed(_steps(directory)):
        if verify_checkpoint(directory, step):
            return step
    return None


def restore(directory: str, like: TrainState, *, dp_total: int,
            step: Optional[int] = None, remesh: bool = False,
            verify: bool = False) -> TrainState:
    """Restore into the structure, dtypes and devices of ``like``.

    verify=True recomputes the CRC32s before any value is consumed and
    raises :class:`CheckpointCorrupt` on a mismatch. ``remesh`` (an
    elastic restart onto another replica count) waits for the ZeRO
    layouts (ROADMAP Queue 1 item 10)."""
    if remesh:
        raise NotImplementedError(
            "remesh re-chunks ZeRO-1 state, which is not ported (ROADMAP "
            "Queue 1 items 6 and 10)")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    if verify and not verify_checkpoint(directory, step):
        raise CheckpointCorrupt(
            f"checkpoint step_{step:08d} under {directory} fails CRC "
            "verification")
    meta = load_meta(directory, step)
    paths, like_leaves = _flatten_with_paths(like)
    if paths != meta["paths"]:
        raise ValueError("checkpoint/state structure mismatch: "
                         f"{len(meta['paths'])} stored paths, "
                         f"{len(paths)} in the state")
    none_set = set(meta["none_leaves"])
    out = []
    with np.load(os.path.join(_step_dir(directory, step),
                              "arrays.npz")) as data:
        for i, (path, ll) in enumerate(zip(paths, like_leaves)):
            if ll is None or i in none_set:
                out.append(None)
                continue
            arr = data[f"leaf_{i}"]
            if path == ".step":
                out.append(int(arr))
                continue
            if arr.shape != tuple(ll.shape):
                raise ValueError(
                    f"shape mismatch at {path}: ckpt {arr.shape} vs "
                    f"{tuple(ll.shape)} (written at dp_total "
                    f"{meta['dp_total']}, restored at {dp_total})")
            out.append(torch.from_numpy(np.array(arr)).to(device=ll.device,
                                                          dtype=ll.dtype))
    return _unflatten(like, out)


def _unflatten(like: TrainState, leaves: list) -> TrainState:
    """``like``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return TrainState(*[build(getattr(like, name))
                        for name in TrainState._fields])


def opt_layout_of(tcfg) -> str:
    """The optimizer-state layout a TrainConfig trains under: always
    "full" in the port (no ZeRO-1, no scattered mode yet)."""
    return "full"


def convert_opt_layout(state: TrainState, plan, source: str,
                       target: str) -> TrainState:
    """Identity between equal layouts; the ZeRO layouts' conversions wait
    for their slices (ROADMAP Queue 1 item 10)."""
    if source == target:
        return state
    raise NotImplementedError(
        f"converting the optimizer state {source!r} -> {target!r} needs the "
        "ZeRO layouts (ROADMAP Queue 1 item 10)")
