"""Checkpoint lifecycle: rotation, async save, auto-resume.

Port of ``repro/checkpoint/manager.py``: the same rotation, debris pruning
and discovery; ``save_async`` snapshots the tree to host memory before its
thread starts.

Fault-tolerance contract (DESIGN.md §8): training must survive
kill-at-any-instant. Saves are atomic (see checkpointer); the manager keeps
the last `keep` complete checkpoints, prunes stragglers from crashed
writers, and `latest()`/`restore_latest()` always return the newest
*committed* step. `save_async` offloads serialization to a worker thread so
the train loop only blocks on the previous save (double-buffering — the
standard overlap trick).
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint.checkpointer import (
    restore_checkpoint, save_checkpoint, snapshot,
)

Pytree = Any

_STEP_RE = re.compile(r"^step_(\d{8})$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._pending_err: List[BaseException] = []

    # -- discovery ---------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, "_COMPLETE")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Pytree, metadata: Optional[Dict] = None,
             ) -> str:
        path = save_checkpoint(self.directory, step, tree, metadata)
        self._rotate()
        return path

    def save_async(self, step: int, tree: Pytree,
                   metadata: Optional[Dict] = None) -> None:
        """Non-blocking save; blocks only if the previous one is unfinished.
        The tree is copied to host memory here, before the thread starts, so
        training may update it in place meanwhile."""
        self.wait()
        host = snapshot(tree)   # host copy, frees the device to run on

        def work():
            try:
                save_checkpoint(self.directory, step, host, metadata)
                self._rotate()
            except BaseException as e:   # surfaced on next wait()
                self._pending_err.append(e)

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_err:
            raise self._pending_err.pop()

    # -- restore -------------------------------------------------------------
    def restore_latest(self, like: Pytree) -> Optional[Tuple[int, Pytree, Dict]]:
        latest = self.latest()
        if latest is None:
            return None
        return restore_checkpoint(self.path_for(latest), like)

    # -- housekeeping ----------------------------------------------------------
    def _rotate(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.path_for(s), ignore_errors=True)
        # prune uncommitted debris from crashed writers
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if name.startswith(".tmp_ckpt_"):
                shutil.rmtree(full, ignore_errors=True)
            m = _STEP_RE.match(name)
            if m and not os.path.exists(os.path.join(full, "_COMPLETE")):
                shutil.rmtree(full, ignore_errors=True)
