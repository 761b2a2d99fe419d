"""LSM-style checkpointing (paper §4.3-4.4 applied to training state; the
reference's ``checkpoint/manager.py``).

Every checkpoint is an immutable *component*:

  write   -> a shadow directory ``step_N.tmp/`` (one .npy per tree leaf +
             manifest.json carrying the tree paths, dtypes and shapes);
  install -> atomic rename to ``step_N/`` then an fsync'd ``VALID`` marker:
             the validity bit.  A crash mid-write leaves no VALID file and
             recovery ignores (and removes) the component (shadowing,
             §4.4);
  merge   -> retention works like a merge policy: keep the newest ``keep``
             components, delete older ones (GC never touches the newest
             VALID component);
  WAL     -> a step-metadata journal (jsonl) appended and fsync'd every
             step; a torn tail line is ignored on read.

Leaves are tensors (on any device), numpy arrays or scalars, in trees of
dicts and lists (the port's parameter layout); each is saved from a CPU
copy.  A bfloat16 leaf, which numpy has no type for, is saved as its
16-bit pattern (``int16``) with ``bfloat16`` as its dtype in the
manifest.  ``load`` returns tensors on the CPU, or on ``device``.  The
reference also records each leaf's logical axes for elastic resharding;
that comes with the port's sharding slice.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["CheckpointManager"]

Path_ = Tuple[Union[str, int], ...]


def _flatten(tree: Any, prefix: Path_ = ()) -> Dict[Path_, Any]:
    """Leaves by path: dict keys (sorted) as strings, list positions as
    ints."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _unflatten(flat: Dict[Path_, Any]) -> Any:
    if () in flat:
        return flat[()]
    groups: Dict[Union[str, int], Dict[Path_, Any]] = {}
    for path, v in flat.items():
        groups.setdefault(path[0], {})[path[1:]] = v
    if all(isinstance(k, int) for k in groups):
        return [_unflatten(groups[i]) for i in sorted(groups)]
    return {k: _unflatten(g) for k, g in groups.items()}


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(numpy array, manifest dtype) of a leaf, copied to the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy(), "bfloat16"
        arr = t.numpy().copy()
        return arr, str(arr.dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _restore(arr: np.ndarray, dtype: str,
             device: Optional[torch.device]) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))   # a copy; 0-d stays 0-d
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t if device is None else t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.wal_path = self.dir / "steps.wal"
        self._async_thread: Optional[threading.Thread] = None

    # -- WAL (step metadata journal) ----------------------------------------
    def log_step(self, record: Dict[str, Any]) -> None:
        with open(self.wal_path, "a") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def read_wal(self) -> List[Dict[str, Any]]:
        if not self.wal_path.exists():
            return []
        out = []
        for line in self.wal_path.read_text().splitlines():
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                break  # torn tail write: ignore the rest (no-steal WAL)
        return out

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None,
             crash_before_validity: bool = False,
             asynchronous: bool = False) -> Path:
        """Shadow-install a checkpoint component.  ``crash_before_validity``
        simulates dying between the data write and the validity install;
        ``asynchronous`` copies the leaves to the host now and writes them
        on a thread (``wait`` joins it)."""
        flat = {p: _host(v) for p, v in _flatten(state).items()}
        if asynchronous:
            t = threading.Thread(
                target=self._save_sync,
                args=(step, flat, extra, crash_before_validity))
            self.wait()
            self._async_thread = t
            t.start()
            return self.dir / f"step_{step}"
        return self._save_sync(step, flat, extra, crash_before_validity)

    def _save_sync(self, step, flat, extra, crash_before_validity) -> Path:
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        for i, (path, (arr, dtype)) in enumerate(flat.items()):
            np.save(tmp / f"leaf_{i}.npy", arr)
            manifest["leaves"].append({
                "path": list(path), "file": f"leaf_{i}.npy",
                "dtype": dtype, "shape": list(arr.shape)})
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        if crash_before_validity:
            return final                    # no VALID marker: invisible
        with open(final / "VALID", "w") as f:
            f.write("1")
            f.flush()
            os.fsync(f.fileno())
        self._gc()
        return final

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    # -- load ----------------------------------------------------------------
    def valid_steps(self) -> List[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp") \
                    and (p / "VALID").exists():
                steps.append(int(p.name.split("_")[1]))
        return sorted(steps)

    def load(self, step: int, device: Optional[torch.device] = None
             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Returns (state, extra); leaves are tensors on the CPU, or on
        ``device``."""
        final = self.dir / f"step_{step}"
        manifest = json.loads((final / "manifest.json").read_text())
        flat: Dict[Path_, Any] = {}
        for leaf in manifest["leaves"]:
            flat[tuple(leaf["path"])] = _restore(
                np.load(final / leaf["file"]), leaf["dtype"], device)
        return _unflatten(flat), manifest["extra"]

    def load_latest(self, device: Optional[torch.device] = None
                    ) -> Optional[Tuple[int, Dict[str, Any], Dict[str, Any]]]:
        """Crash recovery: the newest VALID component (invalid shadow
        directories are removed, paper §4.4), plus its extra state."""
        for p in self.dir.glob("step_*.tmp"):
            shutil.rmtree(p)                # torn writes
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not (p / "VALID").exists():
                shutil.rmtree(p)            # shadow without validity bit
        steps = self.valid_steps()
        if not steps:
            return None
        state, extra = self.load(steps[-1], device)
        return steps[-1], state, extra

    def _gc(self) -> None:
        steps = self.valid_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s}")
