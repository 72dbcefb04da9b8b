"""View checkpoints + log compaction: bounded restart.

The reference restarts from materialized views — scheduler state lives in
Postgres tables with monotone serials that the scheduler delta-polls
(scheduler.go syncState), lookout rows are pruned on retention, and
Pulsar retention drops acknowledged history. Here the same bound comes
from periodic view checkpoints: each registered view serializes (cursor,
state) atomically to disk; a restarted process loads the checkpoint and
replays only the log suffix past its cursor (recover = checkpoint +
delta). Once every view has a checkpoint at or past an offset, the log
segments below it are fully materialized everywhere and can be deleted
(the log's `compact`), which also bounds disk and the in-memory index.

Checkpoint files are pickles (same trust domain as the log on local disk),
crc-guarded and written via tmp+fsync+rename so a crash mid-write leaves
the previous good checkpoint in place.

This is the port's copy of the JAX package's services/checkpoint.py and
keeps its on-disk format, so either package reads a checkpoint the other
wrote. A state that holds the JAX package's classes loads as the port's
classes of the same module path and name (`_PortUnpickler`): loading
imports nothing of the JAX package.
"""

from __future__ import annotations

import io
import os
import pickle
import zlib

from ..utils.carry import PORT_PACKAGE, REFERENCE_PACKAGE

FORMAT_VERSION = 1


class _PortUnpickler(pickle.Unpickler):
    """Resolves `armada_tpu.<path>` classes to `armada_tpu_torch.<path>`."""

    def find_class(self, module, name):
        head, _, rest = module.partition(".")
        if head == REFERENCE_PACKAGE:
            module = f"{PORT_PACKAGE}.{rest}" if rest else PORT_PACKAGE
        return super().find_class(module, name)


class CheckpointStore:
    """One atomic (cursor, state) file per view name."""

    def __init__(self, directory: str, crash_hook=None):
        self.dir = directory
        # Crash-point seam (the checkpoint fuzz tests): called with a
        # site label at each durability boundary; a hook that raises
        # simulates a process crash at exactly that point.
        self.crash_hook = crash_hook
        os.makedirs(directory, exist_ok=True)
        # A crash between tmp-write and rename strands a stale ".tmp":
        # never loaded (load reads only the renamed file) but never
        # cleaned up either. Sweep on open — any writer of these files
        # is dead by the time a store is constructed over the directory.
        for fn in os.listdir(directory):
            if fn.endswith(".ckpt.tmp"):
                try:
                    os.remove(os.path.join(directory, fn))
                except OSError:
                    pass

    def _crash_point(self, site: str) -> None:
        if self.crash_hook is not None:
            self.crash_hook(site)

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.ckpt")

    def save(self, name: str, cursor: int, state) -> None:
        payload = pickle.dumps(
            (FORMAT_VERSION, cursor, state), protocol=pickle.HIGHEST_PROTOCOL
        )
        tmp = self._path(name) + ".tmp"
        self._crash_point(f"save:{name}:before-tmp")
        with open(tmp, "wb") as f:
            f.write(zlib.crc32(payload).to_bytes(4, "big") + payload)
            f.flush()
            os.fsync(f.fileno())
        self._crash_point(f"save:{name}:after-tmp")
        os.replace(tmp, self._path(name))
        self._crash_point(f"save:{name}:after-rename")

    def load(self, name: str):
        """Returns (cursor, state) or None (absent/corrupt — corrupt means
        the tmp+rename contract was bypassed; the caller falls back to
        whatever log replay is still possible)."""
        try:
            with open(self._path(name), "rb") as f:
                rec = f.read()
        except FileNotFoundError:
            return None
        if len(rec) < 4:
            return None
        payload = rec[4:]
        if zlib.crc32(payload) != int.from_bytes(rec[:4], "big"):
            return None
        try:
            version, cursor, state = _PortUnpickler(io.BytesIO(payload)).load()
        except Exception:
            return None
        if version != FORMAT_VERSION:
            return None
        return cursor, state


class CheckpointManager:
    """Checkpoints registered views and compacts the log behind them.

    Views implement `checkpoint_state() -> (cursor, state)`. Compaction
    uses the min cursor across the views saved in THIS pass, so a segment
    is only deleted once every registered view has durably materialized
    it. Callers must register every log consumer that replays on restart —
    an unregistered consumer would lose its history to compaction.
    """

    def __init__(self, store: CheckpointStore, log):
        self.store = store
        self.log = log
        self._views: dict[str, object] = {}

    def register(self, name: str, view) -> None:
        self._views[name] = view

    def save_all(self) -> int:
        """Checkpoint every view; returns the min checkpointed cursor."""
        cursors = []
        for name, view in self._views.items():
            cursor, state = view.checkpoint_state()
            self.store.save(name, cursor, state)
            cursors.append(cursor)
        return min(cursors) if cursors else 0

    def checkpoint_and_compact(self) -> int:
        """One maintenance pass: save all views, drop fully-covered log
        segments. Returns the number of segments removed."""
        cursor = self.save_all()
        self.store._crash_point("compact:before")
        return self.log.compact(cursor)
