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
  checks each array as it reads it (one read of the file) and raises
  :class:`CheckpointCorrupt` on a mismatch before it returns anything,
  and ``latest_valid_step`` / ``restore_newest_valid`` walk newest to
  oldest to the first checkpoint that verifies: keep-N retention doubles
  as the fallback window.
* Optimizer layouts (``OPT_LAYOUTS``, stamped as ``meta["opt_layout"]``):
  "full" (param-shaped moments), "zero1_leaf" (per-leaf canonical
  (dp, rows, cols/dp) chunks) and "zero_scattered" (per-bucket owned
  (dp, rows, cols/dp) chunks). The two ZeRO layouts partition the same
  canonical coordinates and the optimizer is elementwise, so
  ``convert_opt_layout`` maps one into the other through the full group
  buffer, value for value; full <-> ZeRO is refused (the reference's
  rule).
* Elastic restarts (``restore(remesh=True)``): leaves that depend on the
  replica count are re-partitioned (ZeRO chunks) or reset (EF residuals,
  a lossy accumulator) when a checkpoint written at another dp_total is
  restored.
* One format for every form of a run. A run with one rank a process
  (``coll``, a ``ProcessGroupCollectives``) writes what the stacked run
  writes: rank 0 gathers every rank's EF residuals and ZeRO chunks,
  writes, and then every process passes a barrier; a restore (its CRC
  checks in every process) keeps only the process's own rank's slices.
  fsdp's shards (``fsdp``, the ``models.specs.fsdp_layout`` tree) are
  written whole, param-shaped, in the "full" layout the reference's
  fsdp state has, and cut again at restore, for the ranks there (another
  world size included).
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
import torch.distributed as dist

from repro_torch.train.state import TrainState

OPT_LAYOUTS = ("full", "zero1_leaf", "zero_scattered")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed CRC verification (or could not be read). The
    retry supervisor classifies it by its class NAME ("ckpt_corrupt",
    ``runtime/faults.py``): keep the name if renaming."""


def _crc32(arr: np.ndarray) -> int:
    """The reference's digest (the CRC32 of the array's C-order bytes),
    read through a view: no copy of a multi-GB leaf."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    return zlib.crc32(memoryview(flat).cast("B")) & 0xFFFFFFFF


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


# A leaf's role in a checkpoint (see :func:`_roles`): the same on every
# rank (None), a leading axis of the ranks (RANKS), or an FsdpLeaf.
RANKS = "ranks"


def one_rank_a_process(coll) -> bool:
    """True when the context holds one rank of a process group."""
    return coll is not None and coll.local_ranks < coll.p


def _roles(state: TrainState, opt_layout: str, fsdp) -> list:
    """Each leaf's role, in flatten order: EF residuals and ZeRO moment
    chunks carry the ranks; fsdp's params and moments are shards of the
    ``fsdp`` layout; the rest is the same on every rank."""
    def like(tree, role):
        if isinstance(tree, dict):
            return {k: like(v, role) for k, v in tree.items()}
        return role

    def moments(tree):
        if fsdp is not None:
            return fsdp
        return like(tree, RANKS if opt_layout in ("zero1_leaf",
                                                  "zero_scattered") else None)

    opt = state.opt
    if isinstance(opt, dict):
        opt = {k: like(v, None) if k == "count" else moments(v)
               for k, v in opt.items()}
    roles = TrainState(
        params=fsdp if fsdp is not None else like(state.params, None),
        opt=opt, residuals=like(state.residuals, RANKS), step=None,
        inflight=like(state.inflight, None))
    return _flatten_with_paths(roles)[1]


def _every_rank(x: torch.Tensor, coll) -> torch.Tensor:
    """A leaf with a leading axis of the held ranks -> every rank's,
    (p, ...): one all_gather when a process holds one rank."""
    if not one_rank_a_process(coll):
        return x
    return coll.all_gather(x[:, None], axis=0)[0]


def _whole(x: torch.Tensor, lay, coll) -> torch.Tensor:
    """An fsdp leaf from the held ranks' shards (whole where replicated)."""
    if lay.dim is None:
        return x
    every = _every_rank(x, coll)                       # (p, *shard)
    return lay.unpad(torch.cat(list(every.unbind(0)), dim=lay.dim))


def barrier(coll) -> None:
    """Every process of a run with one rank a process waits here (no-op
    otherwise): after a save lands, before any process reads it."""
    if one_rank_a_process(coll):
        dist.barrier(group=coll.group)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, state: TrainState, *, dp_total: int,
         keep_last: int = 3, extra_meta: Optional[dict] = None,
         opt_layout: Optional[str] = None, coll=None,
         fsdp: Optional[dict] = None) -> Optional[str]:
    """Write ``state`` as checkpoint ``step_<state.step>`` and keep the
    newest ``keep_last``. ``extra_meta`` (JSON-serialisable) is merged
    into meta.json; ``opt_layout`` (one of ``OPT_LAYOUTS``) stamps the
    optimizer-state layout. ``coll``: the run's context when a process
    holds one rank (every process calls save; rank 0 writes and returns
    the path, the others None); ``fsdp``: the layout of a state held as
    fsdp shards. Device tensors are copied to the host here: a caller with
    work still queued on another stream drains it first."""
    if opt_layout is not None and opt_layout not in OPT_LAYOUTS:
        raise ValueError(f"unknown opt_layout {opt_layout!r}")
    root = not one_rank_a_process(coll) or coll.rank == 0
    paths, leaves = _flatten_with_paths(state)
    roles = _roles(state, opt_layout or "full", fsdp)
    host = []
    for path, leaf, role in zip(paths, leaves, roles):
        if leaf is not None and role == RANKS:
            leaf = _every_rank(leaf, coll)
        elif leaf is not None and role is not None:
            leaf = _whole(leaf, role, coll)
        host.append(_to_host(leaf, path) if root else None)
    if not root:
        barrier(coll)
        return None
    try:
        return _write(directory, int(state.step), paths, host, dp_total,
                      keep_last, extra_meta, opt_layout)
    finally:
        barrier(coll)


def _write(directory: str, step: int, paths: list, host: list,
           dp_total: int, keep_last: int, extra_meta: Optional[dict],
           opt_layout: Optional[str]) -> str:
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
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


def restore_newest_valid(directory: str, restore_step) -> tuple:
    """(step, ``restore_step(step)``) for the newest step whose restore
    verifies, walking newest to oldest past those whose ``restore_step``
    (a restore with ``verify=True``) raises :class:`CheckpointCorrupt`;
    raises it when none verifies."""
    for step in reversed(_steps(directory)):
        try:
            load_meta(directory, step)
            return step, restore_step(step)
        except (CheckpointCorrupt, OSError, json.JSONDecodeError):
            continue
    raise CheckpointCorrupt(f"no checkpoint under {directory} passes CRC "
                            "verification (retention window exhausted)")


def _corrupt(directory: str, step: int) -> CheckpointCorrupt:
    return CheckpointCorrupt(f"checkpoint step_{step:08d} under {directory} "
                             "fails CRC verification")


def restore(directory: str, like: TrainState, *, dp_total: int,
            step: Optional[int] = None, remesh: bool = False,
            verify: bool = False, coll=None,
            fsdp: Optional[dict] = None) -> TrainState:
    """Restore into the structure, dtypes and devices of ``like``.

    verify=True recomputes each stored array's CRC32 as it is read (the
    leaves the state does not hold too) and raises
    :class:`CheckpointCorrupt` on a mismatch or an unreadable file; no
    value is returned before every array verified. ``remesh=True``
    restores a checkpoint written at another dp_total: a leaf whose
    shape depends on the replica count is re-chunked (ZeRO chunks) or
    reset to zeros (EF residuals), see :func:`_rechunk`. ``coll`` (one
    rank a process) keeps the process's own rank's slice of every leaf
    that carries the ranks; ``fsdp`` cuts the whole params and moments
    into the held ranks' shards of that layout."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    try:
        meta = load_meta(directory, step)
    except (OSError, json.JSONDecodeError) as exc:
        if verify:
            raise _corrupt(directory, step) from exc
        raise
    crcs = meta.get("crc32") if verify else None
    paths, like_leaves = _flatten_with_paths(like)
    if paths != meta["paths"]:
        raise ValueError("checkpoint/state structure mismatch: "
                         f"{len(meta['paths'])} stored paths, "
                         f"{len(paths)} in the state")
    none_set = set(meta["none_leaves"])
    roles = _roles(like, meta.get("opt_layout", "full"), fsdp)
    own = one_rank_a_process(coll)
    out = []

    def read(data, key):
        """One stored array, checked against its CRC32 under verify."""
        try:
            arr = data[key]
        except Exception as exc:  # any unreadable array fails verification
            if verify:
                raise _corrupt(directory, step) from exc
            raise
        if crcs is not None and _crc32(arr) != int(crcs[key]):
            raise _corrupt(directory, step)
        return arr

    try:
        data = np.load(os.path.join(_step_dir(directory, step),
                                    "arrays.npz"))
    except Exception as exc:  # an unreadable file fails verification
        if verify:
            raise _corrupt(directory, step) from exc
        raise
    with data:
        if crcs is not None and set(crcs) != set(data.files):
            raise _corrupt(directory, step)
        for i, (path, ll, role) in enumerate(zip(paths, like_leaves,
                                                 roles)):
            if ll is None or i in none_set:
                if verify and i not in none_set:
                    read(data, f"leaf_{i}")      # stored: checked all the same
                out.append(None)
                continue
            arr = read(data, f"leaf_{i}")
            if path == ".step":
                out.append(int(arr))
                continue
            if role is not None and role != RANKS:
                cut = role.cut(torch.from_numpy(np.array(arr)).to(
                    device=ll.device, dtype=ll.dtype),
                    [coll.rank] if own else range(role.p))
                if cut.shape != ll.shape or (
                        role.dim is not None
                        and arr.shape[role.dim] != role.size):
                    raise ValueError(f"shape mismatch at {path}: ckpt "
                                     f"{arr.shape} does not cut into "
                                     f"{tuple(ll.shape)}")
                out.append(cut)
                continue
            want = tuple(ll.shape)
            if role == RANKS and own:
                want = (dp_total,) + want[1:]
            if arr.shape != want:
                if remesh and meta["dp_total"] != dp_total:
                    arr = _rechunk(arr, want, meta["dp_total"], dp_total)
                else:
                    raise ValueError(
                        f"shape mismatch at {path}: ckpt {arr.shape} vs "
                        f"{want} (written at dp_total "
                        f"{meta['dp_total']}, restored at {dp_total}; "
                        "remesh=True for an elastic restart)")
            if role == RANKS and own:
                arr = arr[coll.rank:coll.rank + 1]
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


# --------------------------------------------------------------------------
# Optimizer-layout interop
# --------------------------------------------------------------------------

def opt_layout_of(tcfg) -> str:
    """The optimizer-state layout a TrainConfig trains under:
    "zero_scattered" for the scattered output mode, "zero1_leaf" for
    ZeRO-1, else "full" (dense mode has no plan to chunk against)."""
    if tcfg.sync.mode == "sparcml":
        if tcfg.sync.output_mode == "scattered":
            return "zero_scattered"
        if tcfg.zero1:
            return "zero1_leaf"
    return "full"


def _chunk(seg: torch.Tensor, p: int) -> torch.Tensor:
    """(rows, cols) -> its (p, rows, cols/p) column chunks, contiguous."""
    rows, cols = seg.shape
    return seg.reshape(rows, p, cols // p).permute(1, 0, 2).contiguous()


def _unchunk(ch: torch.Tensor) -> torch.Tensor:
    p, rows, w = ch.shape
    return ch.permute(1, 0, 2).reshape(rows, p * w)


def _moment_scattered_to_leaf(moment: dict, plan, params) -> dict:
    """{bucket: (dp, rows, w)} -> the params-structured tree of per-leaf
    (dp, rows, cols_leaf/dp) chunks, through the full group buffer."""
    from repro_torch.utils.tree import tree_flatten, tree_unflatten

    p = plan.dp_total
    chunks: list = [None] * plan.num_leaves
    for g in plan.groups:
        first = moment[g.buckets[0].name]
        buf = first.new_zeros((g.rows, g.cols))
        for b in g.buckets:
            buf[:, b.col_start:b.col_start + b.cols] = _unchunk(moment[b.name])
        for slot in g.slots:
            chunks[slot.leaf_id] = _chunk(
                buf[:, slot.offset:slot.offset + slot.cols], p)
    return tree_unflatten(tree_flatten(params)[1], chunks)


def _moment_leaf_to_scattered(moment, plan) -> dict:
    """The params-structured tree of per-leaf chunks -> {bucket: (dp, rows,
    w)} owned chunks. Padding and gap columns are zero (they carry no
    parameter, and their moments start, and in the leaf layout stay,
    zero)."""
    from repro_torch.utils.tree import tree_leaves

    p = plan.dp_total
    leaves = tree_leaves(moment)                    # leaf-id order
    out: dict = {}
    for g in plan.groups:
        buf = leaves[g.slots[0].leaf_id].new_zeros((g.rows, g.cols))
        for slot in g.slots:
            buf[:, slot.offset:slot.offset + slot.cols] = \
                _unchunk(leaves[slot.leaf_id])
        for b in g.buckets:
            out[b.name] = _chunk(buf[:, b.col_start:b.col_start + b.cols], p)
    return out


def convert_opt_layout(state: TrainState, plan, source: str,
                       target: str) -> TrainState:
    """``state.opt`` from one ZeRO layout to the other, value for value
    (see the module). ``plan`` is the SyncPlan both layouts chunk against
    (the ranks all held: the chunks' leading axis is dp_total); the
    moments stay on their device. full <-> ZeRO raises: the full layout
    has no canonical chunking to map through."""
    if source == target:
        return state
    if {source, target} != {"zero1_leaf", "zero_scattered"}:
        raise ValueError(
            f"cannot convert opt layout {source!r} -> {target!r}; only "
            "zero1_leaf <-> zero_scattered interop is supported")
    if target == "zero_scattered":
        conv = lambda m: _moment_leaf_to_scattered(m, plan)
    else:
        conv = lambda m: _moment_scattered_to_leaf(m, plan, state.params)
    opt = dict(state.opt)
    opt["mu"] = conv(state.opt["mu"])
    if "nu" in state.opt:
        opt["nu"] = conv(state.opt["nu"])
    return state._replace(opt=opt)


def _rechunk(arr: np.ndarray, want: tuple, old_dp: int,
             new_dp: int) -> np.ndarray:
    """A replica-dependent leaf re-partitioned over another dp size (the
    reference's rule): ZeRO chunks (old_dp, rows, w_old) are gathered
    along their columns and re-split; an EF residual (old_dp, rows, cols)
    is a lossy accumulator and restarts at zero."""
    if arr.ndim == 3 and arr.shape[0] == old_dp and want[0] == new_dp:
        if (arr.shape[1] == want[1]
                and arr.shape[2] * old_dp == want[2] * new_dp):
            full = np.concatenate([arr[i] for i in range(old_dp)], axis=1)
            return np.stack(np.split(full, new_dp, axis=1))
        return np.zeros(want, arr.dtype)
    raise ValueError(f"cannot rechunk {arr.shape} -> {want}")
