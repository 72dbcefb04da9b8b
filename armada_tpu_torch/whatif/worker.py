"""The what-if planner's rollout processes.

A plan's rollout (mutations, a `ForkRollout` of a few cycles, the diff
into a `Plan`) is host Python around many small torch calls. Run on a
thread of the live process, it would share the interpreter lock with the
live round, whose solve hands the lock over at every torch call and then
waits for the rollout's Python to give it back: on an H100 host a live
cycle took about 10x its time beside two 100k-job rollouts, and a live
round with a budget would commit a shorter prefix. So rollouts run in worker processes:

- started with `spawn` (a CUDA context cannot be forked), one for each
  plan in flight at the first plan that finds none idle, and stopped
  with the planner (`close`, or when it is collected);
- each process resolves devices as the live process does (the same
  `device.DEFAULT_DEVICE`), so on the card it is a second CUDA context
  that launches the same hand-written kernels;
- what crosses is host data, pickled by the caller's thread, and the
  result is plain data;
- a process keeps the objects of its last job that the caller passed
  through `share` (a fork's job and node specs, which are frozen), and
  the caller sends only the keys of those it already holds. A plan whose
  fork differs from the last one by a cycle's leases pickles the new
  specs, not the whole fork;
- the specs it does send cross field by field (`_Columns`): a list of
  values a field, a field empty in every object as its type. Pickling
  100k job specs one by one holds the interpreter lock about 2x as
  long, and would carry the rows the snapshot code caches on them.

A job that raises in a worker raises the same exception in the caller,
with the worker's traceback as its cause. A worker that dies fails the
job it holds with `RolloutWorkerDied`; the next job starts a fresh
process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
import threading
import traceback
import weakref
from operator import itemgetter

import numpy as np


class RolloutWorkerDied(RuntimeError):
    """A rollout process exited while it held a job: the job failed, and
    the next one runs in a fresh process."""


class _RemoteTraceback(Exception):
    def __init__(self, tb: str):
        super().__init__(tb)
        self.tb = tb

    def __str__(self) -> str:
        return f'\n"""\n{self.tb}"""'


# ---------------------------------------------------------------------------
# in a rollout process
# ---------------------------------------------------------------------------

# key -> object: what the process holds of its last job (`_HELD`) and of
# the job it is loading (`_LOADING`).
_HELD: dict = {}
_LOADING: dict = {}


def _load_shared(keys, fresh, objects) -> list:
    """A `Shared` list, rebuilt in the rollout process from the objects it
    holds and the `objects` sent at positions `fresh`."""
    sent = dict(zip(keys[fresh].tolist(), objects))
    out = []
    for key in keys.tolist():
        obj = sent[key] if key in sent else _HELD[key]
        _LOADING[key] = obj
        out.append(obj)
    return out


def _from_columns(cls, names, columns, n) -> list:
    """The objects of a `_Columns`, built as pickle builds them (their
    fields set, no __init__)."""
    values = [[col() for _ in range(n)] if col in (dict, list)
              else [col()] * n if isinstance(col, type)
              else col
              for col in columns]
    out = []
    for row in zip(*values) if values else [()] * n:
        obj = object.__new__(cls)
        obj.__dict__.update(zip(names, row))
        out.append(obj)
    return out


def _serve(conn, default_device: str) -> None:
    global _HELD, _LOADING
    from .. import device

    device.DEFAULT_DEVICE = default_device
    while True:
        try:
            msg = conn.recv_bytes()
        except EOFError:
            return
        _LOADING = {}
        try:
            fn, job = pickle.loads(msg)
            del msg
            _HELD, _LOADING = _LOADING, {}
            reply = ("ok", fn(job))
        except BaseException as e:  # noqa: BLE001 - sent to the caller
            _HELD, _LOADING = {}, {}
            tb = traceback.format_exc()
            try:
                pickle.dumps(e)
            except Exception:  # noqa: BLE001 - an exception that cannot cross
                e = RuntimeError(repr(e))
            reply = ("err", e, tb)
        try:
            conn.send_bytes(pickle.dumps(reply, protocol=pickle.HIGHEST_PROTOCOL))
        except (BrokenPipeError, OSError):
            return


# ---------------------------------------------------------------------------
# in the live process
# ---------------------------------------------------------------------------


# The types whose empty value stands for a field that is empty in every
# object (dicts and lists are made anew for each object).
_EMPTY_TYPES = (dict, list, tuple, str, int, bool, frozenset, type(None))


def _column(values: list):
    """A field's values, or its type where it is empty in every object."""
    if not any(values):
        kinds = set(map(type, values))
        if len(kinds) == 1 and (kind := kinds.pop()) in _EMPTY_TYPES:
            return kind
    return values


class _Columns:
    """Dataclass instances of one class, pickled a field at a time; what
    the objects cache outside their fields stays behind."""

    def __init__(self, objs: list):
        cls = type(objs[0])
        self.cls, self.n = cls, len(objs)
        self.names = [f.name for f in dataclasses.fields(cls)]
        fields = list(map(vars, objs))
        self.columns = [_column(list(map(itemgetter(name), fields))) for name in self.names]

    @staticmethod
    def of(objs: list):
        """`objs` as columns, or as the list where they are not instances
        of one dataclass."""
        if objs and len(set(map(type, objs))) == 1 and dataclasses.is_dataclass(objs[0]):
            return _Columns(objs)
        return objs

    def __reduce__(self):
        return _from_columns, (self.cls, self.names, self.columns, self.n)


class Shared:
    """A list of objects that the rollout process may keep for its next
    job: pickled as the keys of the objects it holds and the objects it
    does not, and loaded there as a plain list."""

    __slots__ = ("keys", "fresh", "objects")

    def __init__(self, keys, fresh, objects):
        self.keys, self.fresh, self.objects = keys, fresh, objects

    def __reduce__(self):
        return _load_shared, (self.keys, self.fresh, self.objects)


class _Table:
    """The live process's record of the objects one rollout process holds,
    by identity: sorted `id`s, their keys, and the lists that keep those
    objects alive (so that no other object takes one of their ids)."""

    def __init__(self):
        self.clear()
        self.next_key = 0

    def clear(self) -> None:
        self.ids = np.empty(0, np.int64)
        self.keys = np.empty(0, np.int64)
        self.alive: list = []
        self._pending: list = []

    def share(self, objs) -> Shared:
        objs = list(objs)
        ids = np.fromiter(map(id, objs), np.int64, len(objs))
        keys = np.full(len(objs), -1, np.int64)
        if len(self.ids):
            pos = np.minimum(np.searchsorted(self.ids, ids), len(self.ids) - 1)
            hit = self.ids[pos] == ids
            keys[hit] = self.keys[pos[hit]]
        fresh = np.flatnonzero(keys < 0)
        keys[fresh] = np.arange(self.next_key, self.next_key + len(fresh))
        self.next_key += len(fresh)
        sent = [objs[i] for i in fresh.tolist()]
        self._pending.append((ids, keys, objs, len(sent)))
        return Shared(keys, fresh, _Columns.of(sent))

    def pending_fresh(self) -> int:
        """How many objects the job being built sends (the rest it names
        by key)."""
        return sum(p[3] for p in self._pending)

    def drop_pending(self) -> None:
        self._pending = []

    def commit(self) -> None:
        """The job sent since the last commit loaded: the process now holds
        its shared objects and no others."""
        pending = self._pending
        ids = np.concatenate([p[0] for p in pending]) if pending else np.empty(0, np.int64)
        keys = np.concatenate([p[1] for p in pending]) if pending else np.empty(0, np.int64)
        order = np.argsort(ids, kind="stable")
        self.ids, self.keys = ids[order], keys[order]
        self.alive = [p[2] for p in pending]
        self._pending = []


class Worker:
    """One rollout process and the live process's end of its pipe."""

    def __init__(self, ctx, default_device: str):
        self.conn, child = ctx.Pipe()
        self.process = ctx.Process(target=_serve, args=(child, default_device),
                                   name="whatif-rollout", daemon=True)
        self.process.start()
        child.close()
        self.table = _Table()
        self.dead = False

    @property
    def pid(self) -> int:
        return self.process.pid

    def share(self, objs) -> Shared:
        """`objs` as a list the process keeps for the next job (frozen
        objects only: the process's copies are not updated)."""
        return self.table.share(objs)

    def dumps(self, fn, job) -> bytes:
        """The message that runs `fn(job)`, for a module-level `fn`."""
        return pickle.dumps((fn, job), protocol=pickle.HIGHEST_PROTOCOL)

    def call(self, payload: bytes):
        """Send a message from `dumps` and wait for its result; blocks the
        calling thread, which holds no interpreter lock while it waits."""
        try:
            self.conn.send_bytes(payload)
            reply = pickle.loads(self.conn.recv_bytes())
        except (EOFError, OSError) as e:
            self.dead = True
            self.table.clear()
            raise RolloutWorkerDied(
                "a what-if rollout process died while it ran this plan; the "
                "plan failed, and the next plan starts a fresh process"
            ) from e
        if reply[0] == "ok":
            self.table.commit()
            return reply[1]
        self.table.clear()
        _, exc, tb = reply
        exc.__cause__ = _RemoteTraceback(tb)
        raise exc

    def stop(self) -> None:
        with contextlib.suppress(OSError):
            self.conn.close()
        self.process.join(timeout=5)
        if self.process.is_alive():
            self.process.kill()
            self.process.join(timeout=5)


def _stop_all(workers: set) -> None:
    for w in list(workers):
        w.stop()


class RolloutWorkers:
    """Spawned rollout processes, one for each job in flight: `worker()`
    lends an idle one (starting it if there is none), for `share`,
    `dumps` and `call`."""

    def __init__(self):
        self.restarts = 0
        self._all: set = set()
        self._idle: list = []
        self._lock = threading.Lock()
        self._closed = False
        # A planner dropped without close() still stops its processes.
        weakref.finalize(self, _stop_all, self._all)

    @contextlib.contextmanager
    def worker(self):
        with self._lock:
            if self._closed:
                raise RuntimeError("the what-if planner's rollout workers are closed")
            w = self._idle.pop() if self._idle else None
        if w is None:
            import multiprocessing

            from .. import device

            w = Worker(multiprocessing.get_context("spawn"), device.DEFAULT_DEVICE)
            with self._lock:
                self._all.add(w)
        try:
            yield w
        finally:
            # A job built but never sent leaves nothing held.
            w.table.drop_pending()
            with self._lock:
                keep = not (w.dead or self._closed)
                if keep:
                    self._idle.append(w)
                else:
                    self._all.discard(w)
                    if w.dead and not self._closed:
                        self.restarts += 1
            if not keep:
                w.stop()

    def pids(self) -> list:
        """The live worker processes' ids (empty before the first job)."""
        with self._lock:
            return sorted(w.pid for w in self._all if not w.dead)

    def close(self) -> None:
        """Stop the idle processes; a process that holds a job is killed,
        and its job fails with RolloutWorkerDied."""
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
            busy = [w for w in self._all if w not in idle]
            self._all.clear()
        for w in idle:
            w.stop()
        for w in busy:
            w.process.kill()

