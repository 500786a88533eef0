"""Restart-exact checkpoints of the training state as numpy files.

Layout: ``<dir>/step_<N>/``
  meta.json       — step, caller's metadata, bf16 leaf manifest
  shard_0.npz     — every tensor leaf under its "/"-joined path

``save`` snapshots the state to host memory (one device-to-host copy per
leaf) and writes on a background thread, so the training loop does not
wait on the file system; ``wait`` joins the write.  numpy has no bf16:
bf16 leaves are stored as their uint16 bit patterns and listed in the
manifest, so a restore is bit-identical.  The data pipeline is a pure
function of the step, so (params, optimizer state, step) is the whole
job state.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_set

def _to_numpy(t: torch.Tensor) -> tuple:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _from_numpy(a: np.ndarray, dtype: Optional[str], device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, state: dict, meta: Optional[dict] = None, *,
             blocking: bool = False) -> str:
        """Snapshot `state` ({"params", "opt", "step"}) now, write it in
        the background."""
        self.wait()
        flat, dtypes = {}, {}
        for key in ("params", "opt"):
            for path, leaf in tree_leaves(state[key], key + "/"):
                flat[path], dt = _to_numpy(leaf)
                if dt is not None:
                    dtypes[path] = dt
        path = os.path.join(self.dir, f"step_{step:08d}")

        def write():
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_0.npz"), **flat)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "state_step": int(state["step"]),
                           "_dtypes": dtypes, **(meta or {})}, f)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._gc()

        self._pending = threading.Thread(target=write, daemon=True)
        self._pending.start()
        if blocking:
            self.wait()
        return path

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def all_steps(self) -> list:
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device="cpu") -> tuple:
        """(state on `device`, step, meta) of checkpoint `step` (default:
        the latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        dtypes = meta.pop("_dtypes", {})
        state: dict = {"params": {}, "opt": {}}
        with np.load(os.path.join(path, "shard_0.npz")) as z:
            for key in z.files:
                tree_set(state, key, _from_numpy(z[key], dtypes.get(key),
                                                 device))
        state["step"] = meta.pop("state_step")
        return state, step, meta
