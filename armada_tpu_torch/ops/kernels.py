"""The solve's hand-written CUDA kernels, their plain torch versions, and
the code that builds and binds them.

Two kernels carry the batched fill loop (once per loop each):

- `score_nodes` (csrc/score_nodes.cu): one job's fit mask, per-node
  placement caps and packed best-fit key over every node. Replaces the
  JAX package's Pallas `_score_kernel`. The fill loop calls it through a
  per-round `ScorePlan` (`plan.score(alloc0, j)`), which checks the
  round's tables once and lets the kernel read job j's rows itself.
- `fill_take` (csrc/fill_take.cu): the B smallest packed keys in
  stable-sort order, a radix select over a thread block cluster, the
  survivors sorted in shared memory up to FILL_TAKE_MAX of them and in
  global memory past it (`fill_take_config` picks its shape;
  `fill_take_cluster_simulate` is its algorithm on the CPU). Replaces the
  JAX package's lax `fill_take`.

One closes both stages of every candidate selection of the node-sharded
round on a (hosts, chips) mesh (solver/dist_cuda.py):

- `winner_reduce` (csrc/winner_reduce.cu): the lexicographic minimum of
  gathered winner rows, once over the chips of a host and once over the
  hosts, the host stage's launch also writing the select's (gid, found).
  Replaces the JAX package's Pallas `_winner_kernel`.

One is a collective of a process shard group (parallel/pgroup.py):

- `ring_winner_exchange` (csrc/ring_exchange.cu): the same minimum as
  the reference's n - 1 step ring defines it, computed in one exchange
  over peer memory, one member per process. Replaces the JAX package's
  Pallas `ring_winner_exchange`; as there, the round does not call it.

One carries the round's integer scatter-adds on the "cuda" path
(ops/segment.py):

- `segment_add` (csrc/segment_add.cu): `x.index_add(dim, index, values)`
  (`segment_add`) and the same sum into zeros (`segment_sum`) for int32
  and int64 tensors, exact in any order, so it needs none of torch's
  deterministic switch. Replaces the reference's integer
  `jax.ops.segment_sum` calls, which XLA lowers to a scatter. One launch a
  sum into an output allocated with `torch.empty`, by one of three
  strategies that `segment_plan` picks on the host from the shapes: rows
  (a thread a row, warp-aggregated atomics), shared (each CTA sums into
  its own copy in shared memory, then adds it to the output) and gather
  (a few rows added onto x, each output element written once). Rows and
  shared add into an output the C function fills first on the stream (a
  memset, or a copy of x), as the plan says.

Each wrapper takes the plain version for CPU tensors (the tests) and, for
CUDA tensors, launches the kernel or raises; nothing falls back. Each
counts its kernel launches in `LAUNCHES`, under a lock: the shards of a
sharded round launch from threads of their own.

Build: each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its
own shared library with a plain C interface, loaded with ctypes, at first
use (or all at once, in parallel, by `build_all`). Libraries land under
`build/kernels/` at the repository root, named by a hash of their source,
so an edited source is rebuilt and a stale library is never loaded. A
build writes under a name of its own process and renames the library
into place, so processes that build at once never load a partial file.

The same builder makes one piece of host code, not a kernel:
`csrc/quantity.cpp`, the exact quantity parser of the snapshot's
resource encoding (core/resources.py), a CPython extension compiled by
the host C++ compiler against this interpreter's headers and loaded by
`load_quantity` at first use (and by `build_all`). A failed build or load
raises with the compiler's message.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import sysconfig
import threading
import time

import numpy as np
import torch

from ..observe.compiles import TELEMETRY
from .select import lex_argmin, lexsort, masked_keys

_ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = _ROOT / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
KERNELS = ("score_nodes", "fill_take", "winner_reduce", "ring_exchange", "segment_add")

# Kernel launches since the last reset_launches(); only a wrapper's
# kernel launch counts, never its plain version. "fill_take_global_sort"
# counts the fill_take launches that also sort the survivors in the global
# scratch. _LAUNCH_LOCK guards the read-modify-write of a count.
LAUNCHES = {name: 0 for name in KERNELS + ("fill_take_global_sort",)}
_LAUNCH_LOCK = threading.Lock()

BIG_I32 = 2**30
FILL_TAKE_MAX = 2048  # csrc/fill_take.cu kMaxTake: most survivors sorted in shared memory
FILL_TAKE_MAX_KEYS = 2**31 - 2**11  # index arithmetic stays in int32
FILL_TAKE_CTA_KEYS = 8192  # keys a CTA of the cluster aims at
FILL_TAKE_MAX_CLUSTER = 8  # the portable cluster size
FILL_TAKE_RESIDENT_KEYS = 16384  # csrc/fill_take.cu kResidentKeys: most keys a CTA holds
WINNER_MAX_ROWS = 1024  # csrc/winner_reduce.cu kMaxRows: one block, a row per thread
WINNER_MAX_WIDTH = 16  # csrc/winner_reduce.cu kMaxWidth: a row in registers
RING_MAX_WIDTH = 32  # csrc/ring_exchange.cu kMaxWidth: one warp, a lane per column
RING_MAX_MEMBERS = 32  # csrc/ring_exchange.cu kMaxMembers: a lane per peer's flag
RING_TIMEOUT_S = 5.0  # csrc/ring_exchange.cu: the spin's bound

_libs: dict = {}
# Shard threads may reach a kernel's first use together: one builds and
# loads it, the others wait.
_BUILD_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Add one to `name`'s launch count; safe from any thread."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] = LAUNCHES[name] + 1


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if found is None:
        raise RuntimeError("no host C++ compiler found (set CXX or put c++ on PATH)")
    return found


@dataclasses.dataclass(frozen=True)
class _Target:
    """One library the builder makes from csrc/: its source file, the
    compiler that builds it, its flags, and its file name's stem and
    suffix. `kernel` says whether it is a CUDA kernel, which counts in
    the compile telemetry."""

    source: str
    compiler: object
    flags: tuple
    stem: str
    suffix: str
    kernel: bool


QUANTITY = "quantity"
# The host parser's flags name this interpreter's headers and its file
# suffix the extension ABI, so its hash names the Python it was built for.
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC",
             f"-I{sysconfig.get_paths()['include']}")
TARGETS = {
    **{name: _Target(f"{name}.cu", _nvcc, NVCC_FLAGS, f"lib{name}", ".so", True)
       for name in KERNELS},
    QUANTITY: _Target("quantity.cpp", _cxx, CXX_FLAGS, "_armada_quantity",
                      sysconfig.get_config_var("EXT_SUFFIX") or ".so", False),
}


def _lib_path(name: str) -> pathlib.Path:
    t = TARGETS[name]
    src = (CSRC / t.source).read_bytes()
    tag = hashlib.sha256(src + " ".join(t.flags + (t.suffix,)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{t.stem}-{tag}{t.suffix}"


def _start_build(name: str):
    """Start the compiler for one library unless it is already built;
    returns (process, tmp path, final path, start time) or None."""
    t = TARGETS[name]
    out = _lib_path(name)
    if out.exists():
        if t.kernel:
            TELEMETRY.note_cache(hit=True)
        return None
    if t.kernel:
        TELEMETRY.note_cache(hit=False)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [t.compiler(), *t.flags, "-o", str(tmp), str(CSRC / t.source)]
    started = time.monotonic()
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, started


def _finish_build(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out, started = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)
        raise RuntimeError(f"{proc.args[0]} failed for {TARGETS[name].source}:\n{log}")
    os.replace(tmp, out)
    if TARGETS[name].kernel:
        TELEMETRY.note_compile(time.monotonic() - started)


def build_all() -> dict:
    """Build every kernel library and the host parser, one compiler per
    source, all started together. Returns {name: library path}."""
    jobs = {name: _start_build(name) for name in TARGETS}
    for name, job in jobs.items():
        _finish_build(name, job)
    return {name: str(_lib_path(name)) for name in TARGETS}


def load_quantity():
    """The host quantity parser (`csrc/quantity.cpp`, module
    `_armada_quantity`), built and loaded at first use. Raises if it does
    not build or load."""
    module = _libs.get(QUANTITY)
    if module is None:
        with _BUILD_LOCK:
            module = _libs.get(QUANTITY)
            if module is None:
                import importlib.machinery
                import importlib.util

                _finish_build(QUANTITY, _start_build(QUANTITY))
                path = str(_lib_path(QUANTITY))
                loader = importlib.machinery.ExtensionFileLoader("_armada_quantity", path)
                spec = importlib.util.spec_from_file_location("_armada_quantity", path,
                                                              loader=loader)
                module = importlib.util.module_from_spec(spec)
                loader.exec_module(module)
                _libs[QUANTITY] = module
    return module


# csrc/score_nodes.cu struct ScorePlan: the same fields in the same order
# (tests/test_torch_kernels.py parses the source and holds them together).
_PLAN_POINTERS = (
    "node_total", "taints", "labels", "rank", "gid", "unsched", "tolerated",
    "selector", "req_fit", "excl", "aff_group", "possible", "affinity", "oidx",
    "ores", "bits",
)
_PLAN_INTS = (
    "n", "r", "wt", "wl", "k_excl", "n_order", "n_aff", "aff_words", "batch_window",
)


class _ScorePlanC(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in _PLAN_POINTERS] + [
        (f, ctypes.c_int) for f in _PLAN_INTS
    ]


class _RingPeersC(ctypes.Structure):
    """csrc/ring_exchange.cu struct RingPeers: every member's buffer."""

    _fields_ = [("buf", ctypes.c_void_p * RING_MAX_MEMBERS)]


_SIGNATURES = {
    "score_nodes": {
        "armada_score_plan": [_ScorePlanC, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4,
    },
    "fill_take": {
        "armada_fill_take": [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4,
        "armada_fill_take_prepare": [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)],
    },
    "winner_reduce": {
        "armada_winner_reduce": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4,
    },
    "ring_exchange": {
        "armada_ring_exchange": [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _RingPeersC,
            ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ],
        "armada_ring_bytes": [ctypes.c_int, ctypes.c_int],
        "armada_ring_alloc": [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
        "armada_ring_open": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
        "armada_ring_close": [ctypes.c_int, ctypes.c_void_p],
        "armada_ring_free": [ctypes.c_int, ctypes.c_void_p],
    },
    "segment_add": {
        "armada_segment_add": [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 4
        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    },
}
_RESTYPES = {"armada_ring_bytes": ctypes.c_longlong}


def _fn(name: str, sym: str | None = None):
    """The C function `sym` (default: the kernel's launcher, the first
    entry of its signatures) of kernel library `name`, built and loaded
    at first use."""
    sym = sym or next(iter(_SIGNATURES[name]))
    fn = _libs.get((name, sym))
    if fn is None:
        with _BUILD_LOCK:
            fn = _libs.get((name, sym))
            if fn is None:
                lib = _libs.get(name)
                if lib is None:
                    _finish_build(name, _start_build(name))
                    lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
                    TELEMETRY.note_load()
                fn = getattr(lib, sym)
                TELEMETRY.note_load()
                fn.argtypes = _SIGNATURES[name][sym]
                fn.restype = _RESTYPES.get(sym, ctypes.c_int)
                _libs[(name, sym)] = fn
    return fn


def _check(name, t, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(name, *args):
    rc = _fn(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
    count_launch(name)


def _stream(device):
    """The device's current CUDA stream as a pointer, read without building
    the Stream object that `torch.cuda.current_stream` returns, which the
    fill loop would otherwise build twice per loop."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _ptr(t):
    return t.data_ptr() if t is not None else None


# ---------------------------------------------------------------------------
# Fused scoring
# ---------------------------------------------------------------------------


def pack_plan(dev, n_shards: int = 1):
    """Static bit widths of the fused fill key, or None when the fused
    path is ineligible (widths overflow the 62-bit budget or one exceeds
    31 bits). The fused path engages only where the unfused graph would
    have packed to one int64 too, so both compare bit for bit."""
    n_local = int(dev.node_id_rank.shape[0])
    rank_bits = max(1, (n_local * n_shards - 1).bit_length())
    bits = tuple([max(1, int(b)) for b in dev.order_key_bits] + [rank_bits])
    if sum(bits) > 62 or max(bits) > 31:
        return None
    return bits


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def score_nodes_plain(
    alloc0, node_total, taints, labels, rank, gid, unsched, aff_row,
    tolerated, selector, req_fit, excl, order_res_idx, order_res_resolution,
    bits, batch_window, job_ok,
):
    """Plain torch version of `score_nodes` (the reference's
    `_score_values`): (fit0 bool[N], caps int32[N], key int64[N])."""
    taints_ok = torch.all((taints & ~tolerated[None, :]) == 0, dim=-1)
    sel_ok = torch.all((selector[None, :] & ~labels) == 0, dim=-1)
    total_ok = torch.all(req_fit[None, :] <= node_total, dim=-1)
    excl_ok = torch.all(gid[:, None] != excl[None, :], dim=-1)
    ok = taints_ok & sel_ok & total_ok & excl_ok & ~unsched
    if aff_row is not None:
        word = aff_row[torch.div(gid, 32, rounding_mode="floor").long()]
        ok = ok & (((word >> (gid % 32)) & 1) != 0)
    if not job_ok:
        ok = torch.zeros_like(ok)
    fit0 = ok & torch.all(req_fit[None, :] <= alloc0, dim=-1)
    safe_req = torch.clamp(req_fit, min=1)
    caps = torch.where(
        req_fit[None, :] > 0, _floor_div(alloc0, safe_req[None, :]), BIG_I32
    ).min(dim=-1).values
    caps = torch.clamp(caps, 0, int(batch_window)).to(torch.int32)
    widths = [int(b) for b in bits.tolist()]
    oidx = order_res_idx.tolist()
    ores = order_res_resolution.tolist()
    key = torch.zeros(alloc0.shape[0], dtype=torch.int64, device=alloc0.device)
    for k, b in enumerate(widths[:-1]):
        v = _floor_div(alloc0[:, oidx[k]], ores[k])
        key = (key << b) | torch.clamp(v, 0, (1 << b) - 1).to(torch.int64)
    b = widths[-1]
    key = (key << b) | torch.clamp(rank, 0, (1 << b) - 1).to(torch.int64)
    return fit0, caps, key


class ScorePlan:
    """The round's node and job tables for `score_nodes`, checked once, so
    that the fill loop scores job j with `plan.score(alloc0, j)`.

    Node tables: node_total int32[N, R], taints/labels int32[N, W] (uint32
    bit patterns), rank/gid int32[N], unsched bool[N]. Job tables, one row
    per job: tolerated/selector int32[J, W], req_fit int32[J, R], excl
    int32[J, K], aff_group int32[J] (-1: no group), possible bool[J];
    affinity int32[A, ceil(N_global / 32)] (None: no job has a group).
    Order keys: order_res_idx and order_res_resolution int32[Ko], bits
    int32[Ko + 1] (the pack plan). On the CPU, `score` indexes job j's rows
    and takes the plain version; on a card, the tables are checked here and
    their pointers go into one C struct that every launch passes by value."""

    def __init__(
        self, node_total, taints, labels, rank, gid, unsched, tolerated,
        selector, req_fit, excl, aff_group, possible, affinity,
        order_res_idx, order_res_resolution, bits, batch_window,
    ):
        self.node_total, self.taints, self.labels = node_total, taints, labels
        self.rank, self.gid, self.unsched = rank, gid, unsched
        self.tolerated, self.selector, self.req_fit = tolerated, selector, req_fit
        self.excl, self.aff_group, self.possible = excl, aff_group, possible
        self.affinity = affinity
        self.order_res_idx, self.order_res_resolution = order_res_idx, order_res_resolution
        self.bits, self.batch_window = bits, int(batch_window)
        self.device = node_total.device
        self.n, self.r = node_total.shape
        self.jobs = tolerated.shape[0]
        self.c_plan = None
        if self.device.type == "cuda":
            self.c_plan = self.struct()
        elif self.device.type != "cpu":
            raise ValueError(f"score_nodes: unsupported device {self.device}")

    def struct(self) -> _ScorePlanC:
        """Check every table (device, dtype, rank, contiguity, shapes) and
        return the C struct of their pointers and widths."""
        i32 = torch.int32
        tables = {
            "node_total": (self.node_total, i32, 2), "taints": (self.taints, i32, 2),
            "labels": (self.labels, i32, 2), "rank": (self.rank, i32, 1),
            "gid": (self.gid, i32, 1), "unsched": (self.unsched, torch.bool, 1),
            "tolerated": (self.tolerated, i32, 2), "selector": (self.selector, i32, 2),
            "req_fit": (self.req_fit, i32, 2), "excl": (self.excl, i32, 2),
            "aff_group": (self.aff_group, i32, 1), "possible": (self.possible, torch.bool, 1),
            "affinity": (self.affinity, i32, 2), "oidx": (self.order_res_idx, i32, 1),
            "ores": (self.order_res_resolution, i32, 1), "bits": (self.bits, i32, 1),
        }
        for name, (t, dtype, ndim) in tables.items():
            if t is not None or name != "affinity":
                _check(f"score_nodes.{name}", t, dtype, ndim, self.device)
        n, r, jobs = self.n, self.r, self.jobs
        wt, wl = self.taints.shape[1], self.labels.shape[1]
        n_order = self.order_res_idx.shape[0]
        n_aff, aff_words = (0, 0) if self.affinity is None else self.affinity.shape
        if (
            self.taints.shape[0] != n or self.labels.shape[0] != n
            or self.rank.shape[0] != n or self.gid.shape[0] != n
            or self.unsched.shape[0] != n or self.tolerated.shape != (jobs, wt)
            or self.selector.shape != (jobs, wl) or self.req_fit.shape != (jobs, r)
            or self.excl.shape[0] != jobs or self.aff_group.shape[0] != jobs
            or self.possible.shape[0] != jobs
            or self.order_res_resolution.shape[0] != n_order
            or self.bits.shape[0] != n_order + 1
        ):
            raise ValueError("score_nodes: inconsistent shapes")
        if self.affinity is not None and (n_aff == 0 or aff_words * 32 < n):
            raise ValueError("score_nodes: affinity rows have fewer words than nodes")
        return _ScorePlanC(
            **{name: None if t is None else t.data_ptr() for name, (t, _, _) in tables.items()},
            n=n, r=r, wt=wt, wl=wl, k_excl=self.excl.shape[1], n_order=n_order,
            n_aff=n_aff, aff_words=aff_words, batch_window=self.batch_window,
        )

    @classmethod
    def one_job(
        cls, node_total, taints, labels, rank, gid, unsched, aff_row, tolerated,
        selector, req_fit, excl, order_res_idx, order_res_resolution, bits,
        batch_window, job_ok,
    ):
        """A plan of a single job (index 0) from its vectors, as
        `score_nodes` takes them."""
        device = node_total.device
        group = torch.tensor([-1 if aff_row is None else 0], dtype=torch.int32, device=device)
        possible = torch.tensor([bool(job_ok)], dtype=torch.bool, device=device)

        def row(t):
            return t[None] if isinstance(t, torch.Tensor) else t

        return cls(
            node_total, taints, labels, rank, gid, unsched, row(tolerated), row(selector),
            row(req_fit), row(excl), group, possible, row(aff_row), order_res_idx,
            order_res_resolution, bits, batch_window,
        )

    def score(self, alloc0, j: int):
        """Job j against every node at capacity alloc0 int32[N, R]:
        (fit0 bool[N], caps int32[N], key int64[N])."""
        if self.c_plan is None:
            a = int(self.aff_group[j])
            aff_row = self.affinity[min(a, self.affinity.shape[0] - 1)] if a >= 0 else None
            return score_nodes_plain(
                alloc0, self.node_total, self.taints, self.labels, self.rank,
                self.gid, self.unsched, aff_row, self.tolerated[j], self.selector[j],
                self.req_fit[j], self.excl[j], self.order_res_idx,
                self.order_res_resolution, self.bits, self.batch_window,
                bool(self.possible[j]),
            )
        if not 0 <= j < self.jobs:
            raise IndexError(f"score_nodes: job {j} outside [0, {self.jobs})")
        if not (
            isinstance(alloc0, torch.Tensor) and alloc0.device == self.device
            and alloc0.dtype == torch.int32 and alloc0.is_contiguous()
            and alloc0.shape == (self.n, self.r)
        ):
            _check("score_nodes.alloc0", alloc0, torch.int32, 2, self.device)
            raise ValueError("score_nodes: alloc0 does not match the plan's nodes")
        # One allocation per output: on the card's host, views of a shared
        # buffer cost more than the allocations they would save.
        key = torch.empty(self.n, dtype=torch.int64, device=self.device)
        caps = torch.empty(self.n, dtype=torch.int32, device=self.device)
        fit0 = torch.empty(self.n, dtype=torch.bool, device=self.device)
        _launch(
            "score_nodes", self.c_plan, _ptr(alloc0), j, _ptr(key), _ptr(caps),
            _ptr(fit0), _stream(self.device),
        )
        return fit0, caps, key


def score_nodes(
    alloc0, node_total, taints, labels, rank, gid, unsched, aff_row,
    tolerated, selector, req_fit, excl, order_res_idx, order_res_resolution,
    bits, batch_window, job_ok,
):
    """One job scored against every node: (fit0 bool[N], caps int32[N],
    key int64[N]). Node arrays: alloc0/node_total int32[N, R], taint and
    label words int32[N, W] (uint32 bit patterns), rank/gid int32[N],
    unsched bool[N]. Job vectors: aff_row int32[ceil(N/32)] (None when the
    job has no affinity group), tolerated/selector int32[W], req_fit
    int32[R], excl int32[K]. Order keys: order_res_idx and
    order_res_resolution int32[Ko], bits int32[Ko + 1] (the pack plan).
    On a card it builds a one-job `ScorePlan` and launches its kernel; the
    round scores through its own plan instead."""
    if alloc0.device.type == "cpu":
        return score_nodes_plain(
            alloc0, node_total, taints, labels, rank, gid, unsched, aff_row,
            tolerated, selector, req_fit, excl, order_res_idx,
            order_res_resolution, bits, batch_window, job_ok,
        )
    plan = ScorePlan.one_job(
        node_total, taints, labels, rank, gid, unsched, aff_row, tolerated,
        selector, req_fit, excl, order_res_idx, order_res_resolution, bits,
        batch_window, job_ok,
    )
    return plan.score(alloc0, 0)


# ---------------------------------------------------------------------------
# Top-B selection (the fill sort replacement)
# ---------------------------------------------------------------------------


def fill_take_plain(key, B):
    """Plain torch version of `fill_take`: a stable sort's first
    min(B, N) entries. Returns (take int32, key[take] int64)."""
    want = min(int(B), key.shape[0])
    order = torch.sort(key, stable=True).indices[:want]
    return order.to(torch.int32), key[order]


@dataclasses.dataclass(frozen=True)
class FillTakeConfig:
    """The launch shape of csrc/fill_take.cu for N keys and want outputs:
    `cluster` CTAs, each owning `keys_per_cta` keys (even, so every slice of
    an aligned tensor starts 16-byte aligned); `resident` when a CTA holds
    its slice in shared memory; `smem_bytes` of dynamic shared memory;
    `global_sort` when want > FILL_TAKE_MAX survivors are sorted in global
    memory (a scratch of `scratch_bytes(want)`) instead of CTA 0's shared
    memory."""

    cluster: int
    keys_per_cta: int
    smem_bytes: int
    resident: bool
    global_sort: bool = False

    @staticmethod
    def scratch_bytes(want: int) -> int:
        """The global sort's scratch: two buffers of want keys (8 bytes)
        and want indices (4 bytes)."""
        return 24 * want


@functools.lru_cache(maxsize=256)
def fill_take_config(n: int, want: int) -> FillTakeConfig:
    """The smallest power-of-two cluster (at most FILL_TAKE_MAX_CLUSTER)
    whose CTAs take at most FILL_TAKE_CTA_KEYS keys each; past 8 x 8,192
    the CTAs take more, resident in shared memory up to
    FILL_TAKE_RESIDENT_KEYS each and streamed from global memory beyond.
    The shared-memory layout is the kernel's: survivor keys and indices
    (want rounded up to a power of two, 12 bytes each; none when want >
    FILL_TAKE_MAX, whose survivors are sorted in global memory), then from
    a 16-byte boundary the resident keys with one slot of slack. Takes any
    1 <= want <= N <= FILL_TAKE_MAX_KEYS."""
    if not 1 <= want <= n:
        raise ValueError(f"fill_take: min(B, N) = {want} outside [1, N = {n}]")
    if n > FILL_TAKE_MAX_KEYS:
        raise ValueError(f"fill_take: more than {FILL_TAKE_MAX_KEYS} keys")
    cluster = 1
    while cluster < FILL_TAKE_MAX_CLUSTER and -(-n // cluster) > FILL_TAKE_CTA_KEYS:
        cluster *= 2
    per_cta = -(-n // cluster)
    per_cta += per_cta & 1
    resident = per_cta <= FILL_TAKE_RESIDENT_KEYS
    global_sort = want > FILL_TAKE_MAX
    p2 = 0 if global_sort else 1 << (want - 1).bit_length()
    smem = (p2 * 12 + 15) // 16 * 16 + ((per_cta + 1) * 8 if resident else 0)
    return FillTakeConfig(cluster, per_cta, smem, resident, global_sort)


def fill_take_cluster_simulate(key, B, n_ctas):
    """The cluster kernel's algorithm on the CPU, CTA by CTA, for any
    cluster size: (take int32[want], key[take] int64). Slices of
    `fill_take_config`'s width in index order; per byte pass, each slice's
    histogram of the keys matching the prefix, summed in rank order to
    pick the digit, down to T, the want-th key, and need_eq, the keys == T
    among the first want. When the k-th key is the last of its bin the
    select stops at that pass: T is the bin's largest possible key, every
    key <= T is kept and none == T is budgeted. Then each slice counts its
    keys < T and == T, keeps its keys < T and its first max(0, need_eq -
    (== T in earlier slices)) keys == T at the offset of the earlier
    slices' survivors, and the index-ordered survivors are sorted by (key,
    index): at once up to FILL_TAKE_MAX of them, as CTA 0 sorts them; past
    it as the global path does, runs of FILL_TAKE_MAX sorted, then merge
    levels that move each survivor to its index in its run plus the count
    of the partner run's survivors below it."""
    keys = key.cpu().numpy().astype(np.int64)
    n = keys.shape[0]
    want = min(int(B), n)
    u = keys.view(np.uint64) ^ np.uint64(1 << 63)
    per_cta = -(-n // n_ctas)
    per_cta += per_cta & 1
    starts = [min(q * per_cta, n) for q in range(n_ctas)]
    slices = [u[s:min(s + per_cta, n)] for s in starts]
    prefix, mask, rank = 0, 0, want
    inclusive = False
    for shift in range(56, -1, -8):
        hists = [
            np.bincount(((s[(s & np.uint64(mask)) == np.uint64(prefix)] >> np.uint64(shift))
                         & np.uint64(255)).astype(np.int64), minlength=256)
            for s in slices
        ]
        cum = np.cumsum(np.sum(hists, axis=0))
        digit = int(np.searchsorted(cum, rank))
        # The k-th key is the last of its bin: stop, keeping every key up
        # to the bin.
        inclusive = int(cum[digit]) == rank
        prefix |= digit << shift
        if inclusive:
            prefix |= (1 << shift) - 1
            rank = 0
            break
        rank -= int(cum[digit - 1]) if digit else 0
        mask |= 255 << shift
    thr, need_eq = np.uint64(prefix), rank
    is_lt = [(s < thr) | ((s == thr) & inclusive) for s in slices]
    is_eq = [(s == thr) & (not inclusive) for s in slices]
    eq = [int(m.sum()) for m in is_eq]
    out_key = np.empty(want, np.uint64)
    out_idx = np.empty(want, np.int64)
    off = eq_before = 0
    for q, s in enumerate(slices):
        budget = max(0, need_eq - eq_before)
        keep = is_lt[q] | (is_eq[q] & (np.cumsum(is_eq[q]) <= budget))
        kept = np.nonzero(keep)[0]
        out_key[off:off + len(kept)] = s[kept]
        out_idx[off:off + len(kept)] = kept + starts[q]
        off += len(kept)
        eq_before += eq[q]
    if off != want:
        raise AssertionError("fill_take_cluster_simulate: survivors disagree")
    if want <= FILL_TAKE_MAX:
        order = np.argsort(out_key, kind="stable")
        out_key, out_idx = out_key[order], out_idx[order]
    else:
        out_key, out_idx = _global_sort_simulate(out_key, out_idx)
    take = torch.as_tensor(out_idx.astype(np.int32))
    return take, torch.as_tensor((out_key ^ np.uint64(1 << 63)).view(np.int64))


def _global_sort_simulate(key, idx):
    """The global path's sort of index-ordered survivors (csrc/fill_take.cu
    sort_runs_kernel and merge_kernel): runs of FILL_TAKE_MAX sorted by
    (key, index), then per level w each survivor moves to its index in
    its run plus the count of the partner run's survivors below it; the
    (key, index) pairs are distinct, so the counts form a permutation."""
    pairs = np.empty(key.shape[0], dtype=[("k", np.uint64), ("i", np.int64)])
    pairs["k"], pairs["i"] = key, idx
    want = pairs.shape[0]
    for s in range(0, want, FILL_TAKE_MAX):
        pairs[s:s + FILL_TAKE_MAX] = np.sort(pairs[s:s + FILL_TAKE_MAX], order=("k", "i"))
    w = FILL_TAKE_MAX
    while w < want:
        out = np.empty_like(pairs)
        for run0 in range(0, want, 2 * w):
            left, right = pairs[run0:run0 + w], pairs[run0 + w:run0 + 2 * w]
            for own, other in ((left, right), (right, left)):
                below = np.searchsorted(other, own)
                out[run0 + np.arange(own.shape[0]) + below] = own
        pairs, w = out, 2 * w
    return pairs["k"], pairs["i"]


_cluster_checked: set = set()


def _fill_take_fits(device, cfg: FillTakeConfig) -> None:
    """Once per device and launch shape: raise the kernel's shared-memory
    limit and check that at least one cluster of this shape can run."""
    tag = (device.index, cfg)
    if tag in _cluster_checked:
        return
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _fn("fill_take", "armada_fill_take_prepare")(
            cfg.cluster, cfg.smem_bytes, int(cfg.resident), ctypes.byref(count)
        )
    if rc != 0:
        raise RuntimeError(f"fill_take: cluster occupancy query failed (cudaError {rc})")
    if count.value < 1:
        raise RuntimeError(
            f"fill_take: a cluster of {cfg.cluster} CTAs with {cfg.smem_bytes} bytes of "
            "shared memory each does not fit on this card"
        )
    _cluster_checked.add(tag)


def fill_take(key, B):
    """Indices of the B smallest entries of an int64 key in stable-sort
    order, masked sentinel tail included: (take int32[min(B, N)],
    key[take] int64). The kernel takes any 1 <= min(B, N) and N <=
    FILL_TAKE_MAX_KEYS; past FILL_TAKE_MAX it sorts the survivors in a
    global scratch, one allocation per call."""
    if key.device.type == "cpu":
        return fill_take_plain(key, B)
    device = key.device
    if device.type != "cuda":
        raise ValueError(f"fill_take: unsupported device {device}")
    _check("fill_take.key", key, torch.int64, 1, device)
    n = key.shape[0]
    want = min(int(B), n)
    cfg = fill_take_config(n, want)
    _fill_take_fits(device, cfg)
    take = torch.empty(want, dtype=torch.int32, device=device)
    take_key = torch.empty(want, dtype=torch.int64, device=device)
    scratch = None
    if cfg.global_sort:
        scratch = torch.empty(cfg.scratch_bytes(want), dtype=torch.uint8, device=device)
    _launch(
        "fill_take", _ptr(key), n, want, cfg.keys_per_cta, cfg.cluster, int(cfg.resident),
        cfg.smem_bytes, _ptr(take), _ptr(take_key), _ptr(scratch), _stream(device),
    )
    if cfg.global_sort:
        count_launch("fill_take_global_sort")
    return take, take_key


def fill_sort_path(keys, mask, B, path, nbits):
    """The fill sort with the kernel path's selection: the top-B kernel
    engages only for the fused single-int64 key (where it is provably
    equal to the stable sort); every other key list keeps the chained
    stable sort. Returns (take, masked keys list)."""
    mk = masked_keys(keys, mask)
    if (
        path == "cuda"
        and nbits is not None
        and len(mk) == 1
        and mk[0].dtype == torch.int64
    ):
        take, _ = fill_take(mk[0], B)
        return take, mk
    return lexsort(mk)[:B], mk


# ---------------------------------------------------------------------------
# Winner reduction (both stages of a hierarchical candidate selection)
# ---------------------------------------------------------------------------

_I32_MAX = int(np.iinfo(np.int32).max)


def _check_winner_dtypes(keys, gids):
    for i, k in enumerate(keys):
        if k.dtype != torch.int32:
            raise TypeError(f"winner_reduce: key {i} has dtype {k.dtype}, expected torch.int32")
    if gids.dtype != torch.int32:
        raise TypeError(f"winner_reduce: gids have dtype {gids.dtype}, expected torch.int32")


def winner_rows(keys, found, gids):
    """The reduction's input rows, built as the reference builds them
    (`armada_tpu/ops/pallas_kernels.py:474-490`): int32[P, K + 2] of
    (notfound, keys..., gid) per host, keys of not-found hosts replaced by
    the int32 sentinel, then padded to P = the host count rounded up to a
    power of two with not-found sentinel rows of gid 0.

    keys: K int32[H] tensors; found: bool[H]; gids: int32[H]. Nothing is
    cast: the reference casts every key to int32 (`:478`), and a key that
    does not fit must fail here rather than wrap."""
    _check_winner_dtypes(keys, gids)
    if found.dtype != torch.bool:
        raise TypeError(f"winner_reduce: found has dtype {found.dtype}, expected torch.bool")
    h = int(found.shape[0])
    p = 1 << max(0, (h - 1).bit_length())
    nf = torch.where(found, 0, 1).to(torch.int32)
    cols = [nf] + [torch.where(found, k, _I32_MAX) for k in keys] + [gids]
    rows = torch.stack(cols, dim=1)
    if p != h:
        pad = torch.full((p - h, len(keys) + 2), _I32_MAX, dtype=torch.int32, device=rows.device)
        pad[:, 0] = 1
        pad[:, -1] = 0
        rows = torch.cat([rows, pad])
    return rows


def winner_row(keys, mask, gids):
    """One shard's local select as one row in the reference's layout:
    int32[K + 2] of (notfound, keys at the winner..., gid at the winner),
    the keys the int32 sentinel when no entry is masked in. The winner is
    `lex_argmin(keys, mask)`'s (index 0 when none is masked in); each
    key's masked minimum is the winner's key, since the last key is unique
    among masked entries, so the row costs 4 ops a key and 6 more.

    keys: K int32[N] tensors; mask: bool[N]; gids: int32[N]. A key that is
    not int32 raises, as in `winner_rows`: nothing is cast."""
    _check_winner_dtypes(keys, gids)
    m = mask
    bests = []
    for k in keys:
        best = torch.where(m, k, _I32_MAX).min()
        m = m & (k == best)
        bests.append(best)
    # argmax takes the first maximal entry: index 0 when m is all False.
    idx = torch.argmax(m.to(torch.int8))
    nf = torch.logical_not(torch.any(mask)).to(torch.int32)
    return torch.stack([nf, *bests, gids.index_select(0, idx.reshape(1)).squeeze(0)])


def winner_reduce_plain(rows):
    """Plain torch version of the winner kernel: the row whose columns
    0..K (notfound, keys) are lexicographically smallest, the lowest row
    index on a tie; the gid column (last) is carried, not compared.
    rows int32[P, K + 2] -> int32[K + 2]."""
    width = rows.shape[1]
    alive = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    idx, _ = lex_argmin([rows[:, c] for c in range(width - 1)], alive)
    return rows.index_select(0, idx.reshape(1).to(torch.int64)).squeeze(0)


def winner_pick_plain(row):
    """Plain torch version of the kernel's select outputs from a winning
    row: (gid int32 0-d, 0 when not found; found bool 0-d)."""
    found = row[0] == 0
    return torch.where(found, row[-1], 0).to(torch.int32), found


def winner_reduce_rows(rows, pick=False):
    """The winning row of int32[P, K + 2] (see `winner_reduce_plain`),
    1 <= P <= WINNER_MAX_ROWS and K + 2 <= WINNER_MAX_WIDTH, by the
    kernel on a CUDA tensor. With
    `pick`, (row, gid, found): the select's result besides the row, as
    `winner_pick_plain` defines it, written by the same launch."""
    if rows.device.type == "cpu":
        row = winner_reduce_plain(rows)
        return (row, *winner_pick_plain(row)) if pick else row
    device = rows.device
    if device.type != "cuda":
        raise ValueError(f"winner_reduce: unsupported device {device}")
    _check("winner_reduce.rows", rows, torch.int32, 2, device)
    p, width = rows.shape
    if not 1 <= p <= WINNER_MAX_ROWS:
        raise ValueError(f"winner_reduce: {p} rows outside [1, {WINNER_MAX_ROWS}]")
    if not 2 <= width <= WINNER_MAX_WIDTH:
        raise ValueError(f"winner_reduce: width {width} outside [2, {WINNER_MAX_WIDTH}]")
    out = torch.empty(width, dtype=torch.int32, device=device)
    gid = found = None
    if pick:
        gid = torch.empty((), dtype=torch.int32, device=device)
        found = torch.empty((), dtype=torch.bool, device=device)
    _launch(
        "winner_reduce", _ptr(rows), p, width, _ptr(out), _ptr(gid), _ptr(found),
        _stream(device),
    )
    return (out, gid, found) if pick else out


# ---------------------------------------------------------------------------
# Integer scatter-add (the round's segment sums)
# ---------------------------------------------------------------------------

# csrc/segment_add.cu's strategies, in the order of its Strategy enum.
SEGMENT_STRATEGIES = ("rows", "shared", "gather")
_SEGMENT_CODE = {s: i for i, s in enumerate(SEGMENT_STRATEGIES)}
SEGMENT_GATHER_MAX_K = 16  # rows a gather adds
SEGMENT_GATHER_MAX_VALUES = 4096  # the contributions a gather holds in shared memory
SEGMENT_SMEM_BYTES = 184 * 1024  # a privatised CTA's copy: 227 KB less the warps' stages
SEGMENT_CTA_VALUES = 4096  # values a privatised CTA (1,024 threads) takes
SEGMENT_PRIVATE_RATIO = 4  # privatise when the values are this many times the entries flushed
SEGMENT_PRIVATE_MIN_VALUES = 2**16  # and past this many values (below it rows are faster)
SEGMENT_ROW_THREADS = 256  # csrc/segment_add.cu kRowThreads and kGatherThreads
SEGMENT_BLOCKS_PER_SM = 8  # the rows and gather grids' cap, per SM
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """How csrc/segment_add.cu computes one sum: the strategy, its grid of
    CTAs, and 64-bit index arithmetic (`wide`)."""

    strategy: str
    grid: int
    wide: bool

    @property
    def init(self) -> bool:
        """Whether the C function fills the output (a memset, or a copy of
        x) before the kernel: rows and shared add into it with atomics, a
        gather writes every element."""
        return self.strategy != "gather"


def segment_strategies(outer, n, k, inner, elem_bytes) -> tuple:
    """The strategies that can compute a sum of [outer, k, inner] values
    into [outer, n, inner]: rows always; shared when the output fits one
    CTA's copy; gather for at most SEGMENT_GATHER_MAX_K rows whose values
    fit its shared memory."""
    ok = ["rows"]
    if outer * n * inner * elem_bytes <= SEGMENT_SMEM_BYTES:
        ok.append("shared")
    if k <= SEGMENT_GATHER_MAX_K and outer * k * inner <= SEGMENT_GATHER_MAX_VALUES:
        ok.append("gather")
    return tuple(ok)


@functools.lru_cache(maxsize=4096)
def segment_plan(outer, n, k, inner, elem_bytes, sms=H100_SMS, strategy=None) -> SegmentPlan:
    """The plan of csrc/segment_add.cu for a sum of [outer, k, inner]
    values into [outer, n, inner] of `elem_bytes`-byte integers on a card
    of `sms` SMs; `strategy` forces one that segment_strategies accepts.

    The choice: gather for a few rows (a bind's column add); shared for a
    sum of at least SEGMENT_PRIVATE_MIN_VALUES values that are
    SEGMENT_PRIVATE_RATIO times the entries its CTAs (one a
    SEGMENT_CTA_VALUES values) flush (the setup's class and queue sums,
    every row into one segment); else rows (job rows into nodes, a fill's
    rows, queue and group counts), where a flush would cost about as many
    adds as it saves, or a few CTAs would leave the card idle. The
    thresholds are the card's measurements (PERF.md §6)."""
    entries, values, rows = outer * n * inner, outer * k * inner, outer * k
    accepted = segment_strategies(outer, n, k, inner, elem_bytes)
    ctas = max(1, -(-values // SEGMENT_CTA_VALUES))
    if strategy is None:
        if "gather" in accepted:
            strategy = "gather"
        elif "shared" in accepted and values >= max(SEGMENT_PRIVATE_MIN_VALUES,
                                                    SEGMENT_PRIVATE_RATIO * entries * ctas):
            strategy = "shared"
        else:
            strategy = "rows"
    elif strategy not in accepted:
        raise ValueError(f"segment_plan: {strategy} does not take [{outer}, {k}, {inner}] into "
                         f"[{outer}, {n}, {inner}] of {elem_bytes} bytes (accepted: {accepted})")
    wide = max(entries, values) >= 2**31
    cap = sms * SEGMENT_BLOCKS_PER_SM
    if strategy == "rows":
        return SegmentPlan("rows", min(max(1, -(-rows // SEGMENT_ROW_THREADS)), cap), wide)
    if strategy == "gather":
        per_block = SEGMENT_ROW_THREADS * (16 // elem_bytes)
        return SegmentPlan("gather", min(max(1, -(-entries // per_block)), cap), wide)
    return SegmentPlan("shared", ctas, wide)


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def segment_add_plain(x, dim, index, values):
    """Plain torch version of the segment kernel: `x.index_add(dim, index,
    values)`, a new tensor."""
    return x.index_add(dim, index, values)


def segment_sum_plain(values, segments, n):
    """Plain torch version of the segment kernel into zeros: the rows of
    `values` [K, ...] summed into `n` segments by `segments` [K]."""
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_add(0, segments, values)


def _segment_launch(out, x, index, values, outer, n, k, inner, plan):
    """One sum on the card into `out` (uninitialised), onto x or into
    zeros (x None). The round calls this every loop: its host checks stay
    cheap."""
    device = out.device
    if out.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_add: int32 or int64 only, not {out.dtype}")
    if index.dim() != 1:
        index = index.reshape(k)
    index, values = index.contiguous(), values.contiguous()
    _check("segment_add.index", index, torch.int64, 1, device)
    _check("segment_add.values", values, out.dtype, values.dim(), device)
    eb = out.element_size()
    if plan is None:
        plan = segment_plan(outer, n, k, inner, eb, _sm_count(device.index))
    elif plan.strategy not in segment_strategies(outer, n, k, inner, eb):
        raise ValueError(f"segment_add: {plan.strategy} does not take this sum")
    rc = _fn("segment_add")(
        _ptr(out), _ptr(x), _ptr(index), _ptr(values), eb, outer, n, k, inner,
        _SEGMENT_CODE[plan.strategy], plan.grid, int(plan.init or not (outer and k and inner)),
        int(plan.wide), _stream(device),
    )
    if rc != 0:
        raise RuntimeError(f"segment_add: CUDA launch failed (cudaError {rc}) for {plan}")
    if outer and k and inner:
        count_launch("segment_add")
    return out


def segment_add(x, dim, index, values, plan=None):
    """`x.index_add(dim, index, values)` for int32 or int64 `x`, as a new
    tensor: `values` has x's dtype and x's shape with `index.numel()` at
    `dim`, `index` int64 positions in [0, x.shape[dim]). By the kernel on a
    CUDA tensor, one launch by `plan` (default: `segment_plan`'s; an index
    outside that range adds nothing there, where index_add raises)."""
    if x.device.type == "cpu":
        return segment_add_plain(x, dim, index, values)
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"segment_add: unsupported device {device}")
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_add: int32 or int64 only, not {x.dtype}")
    shape = x.shape
    dim = dim % len(shape)
    k = index.numel()
    want = shape[:dim] + (k,) + shape[dim + 1:]
    if values.shape != want:
        raise ValueError(f"segment_add: values {tuple(values.shape)}, expected {tuple(want)}")
    if values.dtype != x.dtype:
        raise TypeError(f"segment_add: values {values.dtype}, expected {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    outer, inner = math.prod(shape[:dim]), math.prod(shape[dim + 1:])
    return _segment_launch(out, x, index, values, outer, shape[dim], k, inner, plan)


def segment_sum(values, segments, n, plan=None):
    """The rows of int32 or int64 `values` [K, ...] summed into `n`
    segments by int64 `segments` [K] (one outside [0, n) adds nothing on
    the card), a new tensor. By the kernel on a CUDA tensor, one launch by
    `plan` (default: `segment_plan`'s) into an output it never zeroes
    apart from the plan's memset."""
    if values.device.type == "cpu":
        return segment_sum_plain(values, segments, n)
    device = values.device
    if device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {device}")
    if values.dim() < 1 or segments.numel() != values.shape[0]:
        raise ValueError(f"segment_sum: {segments.numel()} segments for values {tuple(values.shape)}")
    rest = tuple(values.shape[1:])
    out = torch.empty((n,) + rest, dtype=values.dtype, device=device)
    if out.numel() == 0:
        return out
    return _segment_launch(out, None, segments, values, 1, n, values.shape[0], math.prod(rest), plan)


# ---------------------------------------------------------------------------
# Ring winner exchange (a collective of a process shard group)
# ---------------------------------------------------------------------------

IPC_HANDLE_BYTES = 64  # sizeof(cudaIpcMemHandle_t)


def _lex_less(a, b):
    """Row-wise a < b lexicographically over the columns of [n, c]."""
    differ = a != b
    first = differ.to(torch.int8).argmax(dim=1, keepdim=True)
    return differ.any(dim=1) & (a < b).gather(1, first).squeeze(1)


def ring_simulate(rows):
    """Every member's result of the ring exchange, member i holding row i
    of int32[n, w]: the reference loop (`armada_tpu/ops/pallas_kernels.py:
    532-563`) for all members at once. Each of the n - 1 steps hands
    member i the running best of member i - 1 (mod n), which replaces its
    own, gid column included, only if strictly less over columns 0..w-2.
    On ties a member keeps its row: with every row not-found each member
    ends with its own gid, where `winner_reduce` returns row 0's."""
    best = rows
    for _ in range(rows.shape[0] - 1):
        cand = torch.roll(best, 1, dims=0)
        less = _lex_less(cand[:, :-1], best[:, :-1])
        best = torch.where(less[:, None], cand, best)
    return best


def ring_oneshot_simulate(rows):
    """The one-shot kernel's fold on the CPU, for every member at once:
    member i folds rows i - 1, i - 2, ..., i - n + 1 (mod n), in that
    order, into its own, each replacing the held row only if strictly less
    over columns 0..w-2. Equal to `ring_simulate` for every input, ties
    included (csrc/ring_exchange.cu gives the argument)."""
    best = rows
    for s in range(1, rows.shape[0]):
        cand = torch.roll(rows, s, dims=0)
        less = _lex_less(cand[:, :-1], best[:, :-1])
        best = torch.where(less[:, None], cand, best)
    return best


def ring_winner_exchange_plain(row, group, axis):
    """Plain torch version of the ring kernel: the axis's rows gathered
    through the group, the reference loop simulated, this member's row."""
    return ring_simulate(group.all_gather(row, axis))[group.axis_index(axis)]


@dataclasses.dataclass
class RingBuffers:
    """One member's exchange buffers over one axis at one row width: every
    member's buffer as a device pointer in axis order (`peers`), this
    member's own (exported) at `index` and the others opened; empty on an
    axis of one member, which exchanges nothing. `epoch` counts the calls;
    each call's parity picks its slots and flags. `c_peers` is `peers` as
    the kernel's struct, built once when the buffers are open."""

    device_index: int
    n: int
    index: int = 0
    peers: list = dataclasses.field(default_factory=list)
    epoch: int = 0
    c_peers: _RingPeersC = dataclasses.field(default_factory=_RingPeersC, repr=False)

    @property
    def mine(self) -> int:
        return self.peers[self.index] if self.peers else 0


def _rc(sym, rc):
    if rc != 0:
        raise RuntimeError(f"ring_exchange: {sym} failed (cudaError {rc})")


def ring_open(group, axis, width) -> RingBuffers:
    """Allocate this member's buffer over `axis` (cudaMalloc in the
    kernel's library, not torch's allocator: an IPC handle names a whole
    allocation), gather every member's handle over the axis and open every
    other member's buffer (an IPC handle does not open in the process that
    exported it). Collective over the axis: every member calls it."""
    n = group.axis_size(axis)
    if n > RING_MAX_MEMBERS:
        raise ValueError(f"ring_exchange: {n} members over {axis}, at most {RING_MAX_MEMBERS}")
    index = group.device.index if group.device.index is not None else torch.cuda.current_device()
    me = group.axis_index(axis)
    ring = RingBuffers(index, n, me)
    if n == 1:
        return ring
    nbytes = _fn("ring_exchange", "armada_ring_bytes")(n, width)
    mine = ctypes.c_void_p()
    handle = (ctypes.c_uint8 * IPC_HANDLE_BYTES)()
    _rc("cudaMalloc", _fn("ring_exchange", "armada_ring_alloc")(index, nbytes, ctypes.byref(mine), handle))
    ring.peers = [0] * n
    ring.peers[me] = mine.value
    try:
        mine_handle = torch.tensor(list(bytes(handle)), dtype=torch.uint8, device=group.device)
        handles = group.all_gather(mine_handle, axis).cpu().numpy()
        for j in range(n):
            if j != me:
                peer = ctypes.c_void_p()
                _rc("cudaIpcOpenMemHandle", _fn("ring_exchange", "armada_ring_open")(
                    index, handles[j].tobytes(), ctypes.byref(peer)))
                ring.peers[j] = peer.value
    except BaseException:
        ring_close(ring)
        ring_free(ring)
        raise
    ring.c_peers.buf[:n] = ring.peers
    return ring


def ring_close(ring: RingBuffers) -> None:
    """Close every other member's buffer; every member of the axis closes
    before any frees its own (ring_free)."""
    for j, ptr in enumerate(ring.peers):
        if j != ring.index and ptr:
            ring.peers[j] = 0
            _rc("cudaIpcCloseMemHandle",
                _fn("ring_exchange", "armada_ring_close")(ring.device_index, ctypes.c_void_p(ptr)))


def ring_free(ring: RingBuffers) -> None:
    mine = ring.mine
    if mine:
        ring.peers[ring.index] = 0
        _rc("cudaFree", _fn("ring_exchange", "armada_ring_free")(ring.device_index, ctypes.c_void_p(mine)))


def ring_winner_exchange(row, group, axis):
    """The lexicographic minimum of every member's winner tuple over `axis`
    of a process shard group (parallel/pgroup.py), as `ring_simulate`
    defines it: row int32[K + 2] (notfound, keys..., gid) on this member's
    device; returns this member's result row. A collective: every member
    of the axis calls it with a row of the same width.

    On a CUDA tensor the kernel exchanges the rows in one shot over peer
    memory and the call waits for it; a wait longer than RING_TIMEOUT_S for
    a peer's row raises. A CPU tensor takes the plain version. Nothing is
    booked in CollectiveStats, as the reference books nothing for it."""
    if not isinstance(row, torch.Tensor):
        raise TypeError("ring_winner_exchange: expected a tensor")
    if row.dtype != torch.int32 or row.dim() != 1:
        raise TypeError(f"ring_winner_exchange: expected int32[K + 2], got {row.dtype} {tuple(row.shape)}")
    width = int(row.shape[0])
    if not 2 <= width <= RING_MAX_WIDTH:
        raise ValueError(f"ring_winner_exchange: width {width} outside [2, {RING_MAX_WIDTH}]")
    if row.device.type == "cpu":
        return ring_winner_exchange_plain(row, group, axis)
    device = row.device
    if device.type != "cuda":
        raise ValueError(f"ring_winner_exchange: unsupported device {device}")
    _check("ring_winner_exchange.row", row, torch.int32, 1, device)
    ring = group.ring(axis, width)
    ring.epoch += 1
    out = torch.empty(width + 1, dtype=torch.int32, device=device)
    _launch(
        "ring_exchange", _ptr(row), width, ring.n, ring.index, ring.c_peers, ring.epoch,
        int(RING_TIMEOUT_S * 1e9), _ptr(out), _stream(device),
    )
    status = int(out[width])
    if status:
        raise RuntimeError(
            f"ring_winner_exchange: member {ring.index} of {ring.n} over {axis} waited more "
            f"than {RING_TIMEOUT_S} s for the row of member {status - 1}"
        )
    return out[:width]
