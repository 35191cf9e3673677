"""Full train-state checkpointing (numpy files) with best-metric retention.

The reference keeps only a whole-module pickle of the best-val-NDCG model,
deleting prior files (``src/train.py:117-124``), and cannot resume training
(no optimizer/RNG state). Here:

* ``best/`` — best-val-NDCG **params only**, one checkpoint kept (the
  reference's retention policy kept as a feature; its ``.pth`` pickle is
  likewise weights-only — final test eval needs no optimizer moments, and
  params are ~1/3 the bytes of the full state at large table sizes);
* ``latest/`` — rolling full state (params + optimizer moments + PRNG +
  step) for crash-resume (SURVEY.md §5), refreshed every
  ``TrainConfig.checkpoint_interval`` epochs; ``ema/`` beside it.

A checkpoint is a directory ``<kind>/<step>/`` holding one ``.npy`` file
per pytree leaf and ``manifest.json`` (leaf key paths, shapes, dtypes, and
the metrics of a ``best/`` save). Writes are atomic: the files go to a
temporary sibling directory that ``os.replace`` renames to ``<step>``, so
a reader (or a resume after a crash) only ever sees complete checkpoints.

Saves are **asynchronous** in a single process: ``save``/``save_latest``
block only for the device→host copy, then a background thread writes the
files — the next epoch's forward/backward overlaps the write. Each kind
waits for its own previous in-flight save first, so back-to-back epochs
never race on the same directory. With several processes the arrays are
gathered to every host (``multihost_utils.process_allgather``), process 0
writes synchronously, and the others wait at a barrier.

Restore ``device_put``s every leaf into the template leaf's sharding, so a
checkpoint written on one device resumes onto a mesh and vice versa. A
template whose leaves (key paths, shapes, dtypes) differ from the saved
ones raises ``ValueError``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_MANIFEST = "manifest.json"


def _selection_metric(metrics: Dict[str, Any], select_by: str = "ndcg") -> float:
    """The value ``fit`` compared when it decided to save, mirroring
    ``loop.py::selection_value`` exactly: under ``select_by=ndcg`` the
    sampled ndcg; under ``select_by=retrieval_*`` the saved ``select``
    entry — but ONLY when the checkpoint was saved under the SAME regime
    (its metrics carry a matching ``select_by``). A stale-regime
    checkpoint scores 0.0 so the new regime's first save outranks it —
    comparing an old retrieval-HR ``select`` against a new sampled ndcg
    (or vice versa) is incommensurable and could pin retention on the
    wrong epoch across a resume whose ``select_by`` changed."""
    if select_by == "ndcg":
        return metrics["ndcg"]
    if metrics.get("select_by") == select_by:
        return metrics["select"]
    return 0.0


def _to_host(tree):
    """Device→host copy of every leaf (the only blocking part of a save).
    With several processes every host gets the full global arrays."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        return jax.tree_util.tree_map(
            np.asarray, multihost_utils.process_allgather(tree, tiled=True))
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _write(directory: str, step: int, host_tree, metrics=None) -> None:
    """Atomically write ``host_tree`` to ``directory/<step>`` and drop every
    other step directory (one checkpoint is kept per kind)."""
    tmp = os.path.join(directory, f".tmp-{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    leaves = []
    for i, (path, leaf) in enumerate(
            jax.tree_util.tree_flatten_with_path(host_tree)[0]):
        arr = np.asarray(leaf)
        # non-numpy dtypes (bfloat16, PRNG-key words) are stored as raw
        # unsigned words and re-viewed on load
        raw = arr.view(f"u{arr.itemsize}") if arr.dtype.kind == "V" else arr
        np.save(os.path.join(tmp, f"{i}.npy"), raw, allow_pickle=False)
        leaves.append({"path": jax.tree_util.keystr(path),
                       "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, _MANIFEST), "w") as fh:
        json.dump({"step": step, "leaves": leaves, "metrics": metrics}, fh)
    final = os.path.join(directory, str(step))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    for name in os.listdir(directory):
        if name.isdigit() and name != str(step):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit())


def _manifest(directory: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(directory, str(step), _MANIFEST)) as fh:
        return json.load(fh)


def _restore(directory: str, step: int, template):
    """Load ``directory/<step>`` into ``template``'s structure, placing each
    leaf with the template leaf's sharding."""
    man = _manifest(directory, step)
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    saved = man["leaves"]
    want = [(jax.tree_util.keystr(p), list(np.shape(l)),
             str(jnp.result_type(l))) for p, l in flat]
    got = [(s["path"], s["shape"], s["dtype"]) for s in saved]
    if want != got:
        diff = next(((w, g) for w, g in zip(want, got) if w != g),
                    (len(want), len(got)))
        raise ValueError(
            f"checkpoint {directory}/{step} does not match the restore "
            f"template (first difference: template {diff[0]} vs saved "
            f"{diff[1]})")
    out = []
    for i, ((_, leaf), meta) in enumerate(zip(flat, saved)):
        arr = np.load(os.path.join(directory, str(step), f"{i}.npy"),
                      allow_pickle=False)
        dtype = jnp.dtype(meta["dtype"])
        if arr.dtype != dtype:
            arr = arr.view(dtype)
        sharding = getattr(leaf, "sharding", None)
        out.append(jax.device_put(arr, sharding) if sharding is not None
                   else jnp.asarray(arr))
    return jax.tree_util.tree_unflatten(treedef, out)


class _Writer:
    """One checkpoint kind (``best``, ``latest`` or ``ema``): at most one
    save in flight, written by a background thread (single process) or
    synchronously by process 0 behind a barrier (several processes)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"checkpoint write to {self.directory} failed") from err

    def save(self, step: int, tree, metrics=None) -> None:
        self.wait()
        host = _to_host(tree)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            if jax.process_index() == 0:
                _write(self.directory, step, host, metrics)
            multihost_utils.sync_global_devices(
                f"carca_ckpt:{self.directory}:{step}")
            return

        def run():
            try:
                _write(self.directory, step, host, metrics)
            except BaseException as e:  # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"ckpt-{step}")
        self._thread.start()


class CheckpointKeeper:
    def __init__(self, directory: str, select_by: str = "ndcg"):
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        # Retention keys on the metric fit() actually selected on: under
        # select_by=retrieval_* the saved metrics carry a "select" entry
        # (loop.py) and retention must compare by IT, not by sampled ndcg
        # — keying on ndcg reloads the wrong checkpoint exactly when the
        # two curves diverge, which is the only regime the flag exists for
        # (config.py select_by rationale).
        self._select_by = select_by
        self._best = _Writer(os.path.join(directory, "best"))
        self._latest = _Writer(os.path.join(directory, "latest"))
        self._ema = _Writer(os.path.join(directory, "ema"))
        # metrics of the retained best/ checkpoint, known without waiting
        # for an in-flight write
        self._best_metrics = self._read_best_metrics()

    def _read_best_metrics(self) -> Optional[Dict[str, Any]]:
        steps = _steps(self._best.directory)
        if not steps:
            return None
        return _manifest(self._best.directory, steps[-1])["metrics"]

    def save(self, epoch: int, state: Any, metrics: Dict[str, float]) -> None:
        """Best-val-NDCG save (improving epochs): params only. A save that
        does not beat the retained checkpoint's selection metric is not
        written (one best checkpoint is kept; ties go to the newer)."""
        prev = self._best_metrics
        metrics = dict(metrics)
        if prev is not None and (
                _selection_metric(metrics, self._select_by)
                < _selection_metric(prev, self._select_by)):
            return
        self._best.save(epoch, state.params, metrics)
        self._best_metrics = metrics
        # human-browsable sidecar: the reference encodes
        # {epoch:03d}_{HR:.4f}_{NDCG:.4f}.pth in the checkpoint FILENAME
        # (src/train.py:124); checkpoint paths here are step-numbered, so
        # the at-a-glance contract moves to best/metrics.json
        if jax.process_index() == 0:
            with open(os.path.join(self._best.directory, "metrics.json"),
                      "w") as fh:
                json.dump(dict(metrics, epoch=epoch), fh)

    def save_latest(self, epoch: int, state: Any, ema: Any = None) -> None:
        """Refresh the resume checkpoint.

        ``ema`` (a params pytree) is the optional EMA shadow
        (``TrainConfig.ema_decay``); it lives in a sibling ``ema/``
        directory rather than inside the state tree so enabling/disabling
        EMA never changes the on-disk structure of ``latest/`` (existing
        resumes keep restoring against the plain TrainState template)."""
        self._latest.save(epoch, state)
        if ema is not None:
            self._ema.save(epoch, ema)

    def restore_latest_ema(self, template: Any) -> Optional[Any]:
        """The EMA shadow saved alongside the latest resume state, or None
        for runs that never saved one (fit re-seeds from the live weights
        — exact for resumes interrupted before the first save_latest)."""
        self._ema.wait()
        steps = _steps(self._ema.directory)
        if not steps:
            return None
        return _restore(self._ema.directory, steps[-1], template)

    def _wait(self) -> None:
        self._best.wait()
        self._latest.wait()
        self._ema.wait()

    def restore_latest(self, template: Any) -> Optional[Tuple[int, Any]]:
        self._wait()
        steps = _steps(self._latest.directory)
        if not steps:
            return None
        return steps[-1], _restore(self._latest.directory, steps[-1],
                                   template)

    def restore_best(self, template: Any) -> Optional[Tuple[int, Any]]:
        """Best params restored into ``template``'s (state's) params slot —
        the returned object is a full state with the best weights."""
        self._wait()
        steps = _steps(self._best.directory)
        if not steps:
            return None
        params = _restore(self._best.directory, steps[-1], template.params)
        return steps[-1], template.replace(params=params)

    def best_metrics(self) -> Optional[Dict[str, float]]:
        return None if self._best_metrics is None else dict(self._best_metrics)

    def close(self) -> None:
        self._wait()
