"""``mx.checkpoint`` — atomic, integrity-checked, asynchronous checkpoints
with bit-exact resume; port of ``mxnet_tpu/checkpoint.py``.

- **Commit or invisible.**  A step is written to a hidden temp directory
  (``.tmp-step_XXXXXXXX-<pid>-<nonce>``); every array file and the
  manifest are fsynced, then the directory, and only then is it renamed
  to ``step_XXXXXXXX``.  A process killed mid-save leaves a temp
  directory that the next restore reports (``checkpoint_corrupt``) and
  removes, never a half checkpoint that parses.
- **Verified restore.**  ``MANIFEST.json`` records each array's file,
  shape, dtype, byte size and CRC32.  ``restore(step=None)`` walks the
  steps newest first, reports each damaged one with a
  ``checkpoint_corrupt`` event and restores the newest that verifies; an
  explicit ``step=`` that fails raises ``MXNetError``.
- **Asynchronous save.**  ``save()`` copies every device tensor to pinned
  host memory (non-blocking copies, then one event synchronize) before it
  returns, so the next replay of a captured step may overwrite the
  weights, states and ring; the write happens on a writer thread, and a
  failed write raises at the next ``save()``/``wait_until_finished()``.
- **Bit-exact resume.**  A checkpoint holds the parameters, the
  optimizer's states and counts, the accumulation window's position and
  every fused step's device ring (a mid-window save on the non-fused path
  refuses, as in the reference), the amp loss scaler, ``mx.random``'s
  state and an ``extra`` tree (the data cursor).  Restore writes *into*
  the tensors that exist (``copy_``): a captured step's weights, states,
  ring and generators are static graph addresses, so nothing is rebound
  and no new capture follows; a ring no fused step holds yet is staged on
  ``trainer._pending_accum`` for the next one to adopt.
- **The reference's format** (``FORMAT_VERSION`` 1, ``arr_NNNNN.npy``,
  the ``@arr/@val/@seq/@dict`` tree) with ``"library": "mxnet_tpu_torch"``;
  each package restores the other's parameters and optimizer states.
  A bfloat16 leaf is written as its raw uint16 bits with the manifest's
  ``"dtype": "bfloat16"``, readable by numpy without ``ml_dtypes``; the
  restore takes the dtype from the manifest, so the reference's ``<V2``
  bf16 files restore too (the reference's own restore of those raises).
- **The RNG subtree does not cross.**  The reference's is a threefry key,
  the port's ``{seed, root, generators}``: restoring a reference
  checkpoint restores all else and warns; the reference's restore of a
  port checkpoint raises in its ``random.set_state``.

Fault sites: ``checkpoint.save`` fires once the temp files are durable
and before the commit rename (``MXNET_FAULT_INJECT=checkpoint.save:
kill:N`` is the preempted-mid-save case), ``checkpoint.restore`` at
restore entry.
"""
from __future__ import annotations

import io
import json
import os
import queue as _queue
import re
import shutil
import threading
import time
import uuid
import warnings
import zlib

import numpy as np
import torch

from . import telemetry
from .base import MXNetError
from .ndarray.ndarray import NDArray
from .telemetry.faults import fault_point

__all__ = ["CheckpointManager", "save", "restore", "latest_step",
           "verify_step", "restart_count", "FORMAT_VERSION"]

FORMAT_VERSION = 1
_MANIFEST = "MANIFEST.json"
_STEP_RE = re.compile(r"^step_(\d{8,})$")
_TMP_PREFIX = ".tmp-"
_BF16 = "bfloat16"


def _step_dirname(step):
    return f"step_{int(step):08d}"


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def restart_count():
    """This process's restart generation (``MXNET_RESTART_COUNT``, set by
    a supervisor that respawns ranks): 0 on the first launch."""
    try:
        return int(os.environ.get("MXNET_RESTART_COUNT", "0"))
    except ValueError:
        return 0


# --------------------------------------------------------------------- #
# tree <-> (JSON structure, host leaves)
# --------------------------------------------------------------------- #

class _Snapshot:
    """The host copies of one save's leaves.  Device tensors go into
    pinned memory by non-blocking copies; ``finish`` waits for them
    once (an event on the current stream) and gives numpy arrays and
    their manifest dtypes."""

    def __init__(self):
        self.leaves = []
        self._event_device = None

    def add(self, x):
        if isinstance(x, NDArray):
            x = x._data
        if isinstance(x, torch.Tensor):
            t = x.detach()
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._event_device = t.device
            else:
                h = t.clone()
            self.leaves.append(h)
        else:
            self.leaves.append(np.array(x))
        return len(self.leaves) - 1

    def finish(self):
        if self._event_device is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self._event_device))
            ev.synchronize()
        arrays, dtypes = [], []
        for h in self.leaves:
            if isinstance(h, torch.Tensor) and h.dtype == torch.bfloat16:
                arrays.append(h.view(torch.int16).numpy().view(np.uint16))
                dtypes.append(_BF16)
            elif isinstance(h, torch.Tensor):
                a = h.numpy()
                arrays.append(a)
                dtypes.append(str(a.dtype))
            else:
                arrays.append(h)
                dtypes.append(str(h.dtype))
        return arrays, dtypes


def _is_array(x):
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, NDArray))


def _enc(x, snap):
    """Encode a checkpoint tree into a JSON-able structure, adding its
    array leaves to ``snap``."""
    if _is_array(x):
        return {"@arr": snap.add(x)}
    if x is None or isinstance(x, (bool, int, float, str)):
        return {"@val": x}
    if isinstance(x, (list, tuple)):
        return {"@seq": [_enc(v, snap) for v in x],
                "tuple": isinstance(x, tuple)}
    if isinstance(x, dict):
        items = []
        for k, v in x.items():
            if not isinstance(k, (str, int)):
                raise MXNetError(
                    f"checkpoint: unsupported dict key type "
                    f"{type(k).__name__} (str/int only)")
            items.append([["i" if isinstance(k, int) else "s", k],
                          _enc(v, snap)])
        return {"@dict": items}
    raise MXNetError(
        f"checkpoint: unsupported leaf type {type(x).__name__}")


def _dec(node, leaf_fn):
    if "@arr" in node:
        return leaf_fn(node["@arr"])
    if "@val" in node:
        return node["@val"]
    if "@seq" in node:
        seq = [_dec(v, leaf_fn) for v in node["@seq"]]
        return tuple(seq) if node.get("tuple") else seq
    if "@dict" in node:
        out = {}
        for (kt, k), v in node["@dict"]:
            out[int(k) if kt == "i" else k] = _dec(v, leaf_fn)
        return out
    raise MXNetError(f"checkpoint: malformed structure node {node!r}")


def _torch_leaf(a, dtype):
    """A loaded leaf as a CPU tensor: a bfloat16 leaf (the port's uint16
    bits or the reference's ``<V2`` bytes) by the manifest's dtype."""
    if dtype == _BF16:
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------- #
# training-state capture
# --------------------------------------------------------------------- #

def _block_tree(block):
    """The block's parameters by structured name."""
    out = {}
    for name, p in block._collect_params_with_prefix().items():
        if p._data is None:
            raise MXNetError(f"checkpoint: parameter {name} uninitialized")
        out[name] = p._data._data
    return out


def _trainer_tree(trainer):
    """What the step consumes beyond the parameters: the optimizer's
    states and counts, the window position and the fused steps' device
    rings, and the amp loss scaler."""
    if trainer is None:
        return None
    rings = [list(fs._accum) for fs in trainer._fused_steps.values()
             if getattr(fs, "_accum", None)]
    if trainer._window_pos != 0 and not rings:
        raise MXNetError(
            f"checkpoint: mid-accumulation-window save (micro-batch "
            f"{trainer._window_pos}/{trainer._update_interval}) without "
            "a fused-step accumulator ring: the partial window lives in "
            "grad buffers this checkpoint does not capture, so resume "
            "could not be bit-exact. Save at the window boundary, or "
            "drive the window with fused_step() (its device ring is "
            "captured).")
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    opt = trainer._optimizer
    return {
        "states": list(trainer._states),
        "created": list(trainer._states_created),
        "num_update": int(opt.num_update),
        "index_update_count": {int(k): int(v) for k, v in
                               opt._index_update_count.items()},
        "window_pos": int(trainer._window_pos),
        "accum": rings,
        "loss_scaler": None if scaler is None else {
            "loss_scale": float(scaler.loss_scale),
            "unskipped": int(scaler._unskipped)},
    }


def _mesh_info():
    gpu = torch.cuda.is_available()
    return {"device_count": torch.cuda.device_count() if gpu else 1,
            "platform": "gpu" if gpu else "cpu",
            "process_index": 0, "process_count": 1}


def _apply_params(block, loaded, saved_mesh):
    """Write each saved value into its parameter's tensor in place (cast
    to its dtype); a parameter not created yet is created from it."""
    here = _mesh_info()
    for name, p in block._collect_params_with_prefix().items():
        if name not in loaded:
            raise MXNetError(f"checkpoint missing parameter {name}")
        arr = loaded[name]
        if p.shape and 0 not in p.shape and None not in p.shape and \
                tuple(arr.shape) != tuple(p.shape):
            raise MXNetError(
                f"checkpoint: parameter {name} was saved with shape "
                f"{tuple(arr.shape)} on a {saved_mesh.get('device_count')}"
                f"-device {saved_mesh.get('platform')} host but the "
                f"current parameter has shape {tuple(p.shape)} on a "
                f"{here['device_count']}-device {here['platform']} host")
        if p._data is not None:
            p._write(arr)
        else:
            p._load_init(NDArray(arr))


def _same_ring(ring, like):
    return len(ring) == len(like) and all(
        tuple(r.shape) == tuple(a.shape) and r.dtype == a.dtype
        for r, a in zip(ring, like))


def _apply_trainer(trainer, t):
    trainer._restore_states(t["states"], t["created"], t["num_update"],
                            t["index_update_count"])
    trainer._window_pos = int(t.get("window_pos", 0))
    staged = [list(ring) for ring in t.get("accum", [])]
    for fs in trainer._fused_steps.values():
        fs._legacy_accum = None
        if fs._accum is None:
            continue
        match = next((i for i, ring in enumerate(staged)
                      if _same_ring(ring, fs._accum)), None)
        with torch.no_grad():
            if match is not None:
                for a, r in zip(fs._accum, staged.pop(match)):
                    a.copy_(r)
            elif trainer._window_pos != 0:
                raise MXNetError(
                    "checkpoint: restored mid-accumulation window but no "
                    "saved ring matches a fused step's ring")
            else:
                for a in fs._accum:
                    a.zero_()
    trainer._pending_accum = staged
    ls = t.get("loss_scaler")
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if ls is not None and scaler is not None:
        scaler.loss_scale = float(ls["loss_scale"])
        scaler._unskipped = int(ls["unskipped"])


def _apply_rng(rng):
    from . import random as mxrandom

    if isinstance(rng, dict) and "root" in rng and "generators" in rng:
        mxrandom.set_state(rng)
        return
    warnings.warn(
        "checkpoint: the RNG state was written by another package (the "
        "reference's threefry key); mx.random is not restored",
        RuntimeWarning, stacklevel=3)


# --------------------------------------------------------------------- #
# manager
# --------------------------------------------------------------------- #

class _Corrupt(Exception):
    """A step directory failed verification (why in args)."""


class CheckpointManager:
    """Step-indexed directory of atomic checkpoints with retention
    (``max_to_keep``), asynchronous save, verified auto-resume and the
    training state a bit-exact resume needs.  ``directory=None`` uses
    ``MXNET_CHECKPOINT_DIR``."""

    def __init__(self, directory=None, max_to_keep=5, async_save=True):
        directory = directory or os.environ.get("MXNET_CHECKPOINT_DIR")
        if not directory:
            raise MXNetError(
                "CheckpointManager: no directory given and "
                "MXNET_CHECKPOINT_DIR is unset")
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        if max_to_keep is not None and int(max_to_keep) < 1:
            raise MXNetError("max_to_keep must be >= 1 (or None)")
        self._max_to_keep = None if max_to_keep is None else int(max_to_keep)
        self._async = bool(async_save)
        self._lock = threading.Lock()
        self._jobs = None
        self._writer = None
        self._error = None
        self._closed = False

    @property
    def directory(self):
        return self._dir

    # -- save ----------------------------------------------------------- #
    def save(self, step, block, trainer=None, extra=None):
        """Checkpoint ``step``: the parameters, the trainer's training
        state and an ``extra`` tree.  Returns once every device tensor is
        copied to the host; with ``async_save`` the write then runs on
        the writer thread."""
        self._raise_pending()
        if self._closed:
            raise MXNetError("CheckpointManager is closed")
        step = int(step)
        t0 = time.perf_counter()
        from . import random as mxrandom

        tree = {"params": _block_tree(block), "rng": mxrandom.get_state()}
        tt = _trainer_tree(trainer)
        if tt is not None:
            tree["trainer"] = tt
        if extra is not None:
            tree["extra"] = extra
        snap = _Snapshot()
        struct = _enc(tree, snap)
        arrays, dtypes = snap.finish()
        snapshot_s = time.perf_counter() - t0
        telemetry.histogram("checkpoint_save_seconds",
                            phase="snapshot").observe(snapshot_s)
        job = (step, struct, arrays, dtypes, snapshot_s)
        if self._async:
            self._ensure_writer()
            self._jobs.put(job)
        else:
            self._write_step(*job)
        return step

    def _ensure_writer(self):
        with self._lock:
            if self._writer is None or not self._writer.is_alive():
                self._jobs = _queue.Queue()
                self._writer = threading.Thread(
                    target=self._writer_loop, name="mxnet-ckpt-writer",
                    daemon=True)
                self._writer.start()

    def _writer_loop(self):
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                try:
                    self._write_step(*job)
                except Exception as e:
                    with self._lock:
                        if self._error is None:
                            self._error = e
            finally:
                self._jobs.task_done()

    def _raise_pending(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise MXNetError(
                f"checkpoint: a background save failed: {err}") from err

    def _write_step(self, step, struct, leaves, dtypes, snapshot_s):
        t0 = time.perf_counter()
        final = os.path.join(self._dir, _step_dirname(step))
        tmp = os.path.join(
            self._dir, f"{_TMP_PREFIX}{_step_dirname(step)}-"
                       f"{os.getpid()}-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        try:
            arrays = []
            total = 0
            for i, (a, dt) in enumerate(zip(leaves, dtypes)):
                buf = io.BytesIO()
                np.save(buf, a, allow_pickle=False)
                data = buf.getvalue()
                fname = f"arr_{i:05d}.npy"
                with open(os.path.join(tmp, fname), "wb") as fh:
                    fh.write(data)
                    fh.flush()
                    os.fsync(fh.fileno())
                arrays.append({"file": fname, "shape": list(a.shape),
                               "dtype": dt, "bytes": len(data),
                               "crc32": zlib.crc32(data) & 0xFFFFFFFF})
                total += len(data)
            manifest = {"format": FORMAT_VERSION, "step": step,
                        "saved_unix": time.time(),
                        "library": "mxnet_tpu_torch",
                        "mesh": _mesh_info(), "tree": struct,
                        "arrays": arrays}
            with open(os.path.join(tmp, _MANIFEST), "w",
                      encoding="utf-8") as fh:
                json.dump(manifest, fh)
                fh.flush()
                os.fsync(fh.fileno())
            _fsync_dir(tmp)
            # the preemption point: durable in the temp dir, not committed
            fault_point("checkpoint.save", step=step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            # this process's temp dirs are exempt from the restore-time
            # sweep (they may be a live writer's), so a failed one goes now
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _fsync_dir(self._dir)
        write_s = time.perf_counter() - t0
        telemetry.histogram("checkpoint_save_seconds",
                            phase="write").observe(write_s)
        telemetry.counter("checkpoints_saved_total").inc()
        telemetry.emit("checkpoint_saved", step=step, dir=self._dir,
                       bytes=total, arrays=len(arrays),
                       snapshot_s=round(snapshot_s, 6),
                       write_s=round(write_s, 6),
                       async_save=self._async)
        self._retain()

    def _retain(self):
        if self._max_to_keep is None:
            return
        steps = self.all_steps()
        while len(steps) > self._max_to_keep:
            victim = steps.pop(0)
            shutil.rmtree(os.path.join(self._dir, _step_dirname(victim)),
                          ignore_errors=True)

    # -- discovery / verification --------------------------------------- #
    def all_steps(self):
        """Committed step numbers, ascending (unverified)."""
        out = []
        try:
            names = os.listdir(self._dir)
        except OSError:
            return out
        for name in names:
            m = _STEP_RE.match(name)
            if m and os.path.isdir(os.path.join(self._dir, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def _load_verified(self, step, keep_arrays=True):
        """Read and check one step (manifest, each array's size and
        CRC32): ``(manifest, numpy leaves)`` or :class:`_Corrupt`."""
        d = os.path.join(self._dir, _step_dirname(step))
        try:
            with open(os.path.join(d, _MANIFEST), "r",
                      encoding="utf-8") as fh:
                manifest = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            raise _Corrupt(f"manifest unreadable ({e})")
        if manifest.get("format") != FORMAT_VERSION:
            raise _Corrupt(
                f"format {manifest.get('format')!r} != {FORMAT_VERSION}")
        leaves = []
        for meta in manifest.get("arrays", []):
            try:
                with open(os.path.join(d, meta["file"]), "rb") as fh:
                    data = fh.read()
            except OSError as e:
                raise _Corrupt(f"array {meta['file']} unreadable ({e})")
            if len(data) != meta["bytes"]:
                raise _Corrupt(
                    f"array {meta['file']} truncated "
                    f"({len(data)} != {meta['bytes']} bytes)")
            if (zlib.crc32(data) & 0xFFFFFFFF) != meta["crc32"]:
                raise _Corrupt(f"array {meta['file']} checksum mismatch")
            if keep_arrays:
                try:
                    leaves.append(np.load(io.BytesIO(data),
                                          allow_pickle=False))
                except ValueError as e:
                    raise _Corrupt(
                        f"array {meta['file']} undecodable ({e})")
        return manifest, leaves

    def verify(self, step):
        """``(ok, why)`` for one committed step; ``why`` is None when it
        is complete and every checksum matches."""
        try:
            self._load_verified(step, keep_arrays=False)
            return True, None
        except _Corrupt as e:
            return False, str(e)

    def latest_step(self):
        """The newest step that verifies; newer corrupt ones are reported
        (``checkpoint_corrupt``) and skipped."""
        for step in reversed(self.all_steps()):
            ok, why = self.verify(step)
            if ok:
                return step
            self._report_corrupt(step, why)
        return None

    def _report_corrupt(self, step, why):
        telemetry.counter("checkpoints_corrupt_total").inc()
        telemetry.emit("checkpoint_corrupt", dir=self._dir, step=step,
                       why=why)

    def _sweep_tmp(self):
        """Report and remove the temp directories of saves that another
        (dead) process never committed; this process's own may be a live
        writer's and stay."""
        try:
            names = os.listdir(self._dir)
        except OSError:
            return
        own = f"-{os.getpid()}-"
        for name in names:
            if not name.startswith(_TMP_PREFIX) or own in name:
                continue
            self._report_corrupt(
                None, f"interrupted save (uncommitted {name})")
            shutil.rmtree(os.path.join(self._dir, name),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------- #
    def restore(self, block, trainer=None, step=None, return_extra=False):
        """Restore into ``block`` (and ``trainer``), in place.
        ``step=None`` resumes from the newest verifiable step, skipping
        damaged ones with a ``checkpoint_corrupt`` event each.  Returns
        the step (``(step, extra)`` with ``return_extra``), or None when
        nothing restorable exists; an explicit ``step=`` that is missing
        or fails verification raises ``MXNetError``."""
        fault_point("checkpoint.restore", step=step)
        self._sweep_tmp()
        if step is not None:
            step = int(step)
            if step not in self.all_steps():
                raise MXNetError(
                    f"checkpoint: no step {step} in {self._dir}")
            try:
                manifest, leaves = self._load_verified(step)
            except _Corrupt as e:
                self._report_corrupt(step, str(e))
                raise MXNetError(
                    f"checkpoint: step {step} in {self._dir} failed "
                    f"verification: {e}") from e
            return self._apply(manifest, leaves, block, trainer,
                               return_extra)
        for s in reversed(self.all_steps()):
            try:
                manifest, leaves = self._load_verified(s)
            except _Corrupt as e:
                self._report_corrupt(s, str(e))
                continue
            return self._apply(manifest, leaves, block, trainer,
                               return_extra)
        return None

    def _apply(self, manifest, leaves, block, trainer, return_extra):
        dtypes = [m["dtype"] for m in manifest["arrays"]]
        tree = manifest["tree"]
        node = {k: v for (_, k), v in tree["@dict"]}
        as_torch = lambda i: _torch_leaf(leaves[i], dtypes[i])  # noqa: E731
        _apply_params(block, _dec(node["params"], as_torch),
                      manifest.get("mesh", {}))
        if trainer is not None and "trainer" in node:
            t = _dec(node["trainer"], as_torch)
            if t is not None:
                _apply_trainer(trainer, t)
        if "rng" in node:
            rng = _dec(node["rng"], as_torch)
            if rng is not None:
                _apply_rng(rng)
        step = int(manifest["step"])
        telemetry.emit("checkpoint_restored", dir=self._dir, step=step,
                       arrays=len(leaves))
        if return_extra:
            extra = None
            if "extra" in node:
                extra = _dec(node["extra"], lambda i: leaves[i]
                             if dtypes[i] != _BF16 else as_torch(i))
            return step, extra
        return step

    # -- lifecycle ------------------------------------------------------ #
    def wait_until_finished(self):
        """Block until pending saves are committed; surface any
        background write error."""
        if self._jobs is not None:
            self._jobs.join()
        self._raise_pending()

    def close(self, timeout=60.0):
        """Flush pending saves and stop the writer; a pending write error,
        or a writer still writing after ``timeout`` seconds, raises."""
        with self._lock:
            if self._closed:
                writer = None
            else:
                self._closed = True
                writer = self._writer
        if writer is not None:
            self._jobs.put(None)
            writer.join(timeout=timeout)
            if writer.is_alive():
                raise MXNetError(
                    f"checkpoint: the background writer is still "
                    f"writing after {timeout}s — the pending save has "
                    "NOT committed; wait_until_finished() (or a larger "
                    "close timeout) before exiting, or the next run "
                    "will sweep it as an interrupted save")
        self._raise_pending()


# --------------------------------------------------------------------- #
# one-shot functions
# --------------------------------------------------------------------- #

def save(directory, step, block, trainer=None, extra=None):
    """One synchronous atomic save."""
    mgr = CheckpointManager(directory, max_to_keep=None, async_save=False)
    try:
        mgr.save(step, block, trainer, extra=extra)
    finally:
        mgr.close()
    return step


def restore(directory, block, trainer=None, step=None, return_extra=False):
    """One restore; ``step=None`` resumes from the newest verifiable."""
    mgr = CheckpointManager(directory, max_to_keep=None, async_save=False)
    try:
        return mgr.restore(block, trainer, step, return_extra=return_extra)
    finally:
        mgr.close()


def latest_step(directory):
    mgr = CheckpointManager(directory, max_to_keep=None, async_save=False)
    try:
        return mgr.latest_step()
    finally:
        mgr.close()


def verify_step(directory, step):
    """``(ok, why)`` for one step: is this checkpoint loadable."""
    mgr = CheckpointManager(directory, max_to_keep=None, async_save=False)
    try:
        return mgr.verify(int(step))
    finally:
        mgr.close()
