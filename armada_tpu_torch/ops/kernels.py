"""The solve's hand-written CUDA kernels, their plain torch versions, and
the code that builds and binds them.

Two kernels carry the batched fill loop (once per loop each):

- `score_nodes` (csrc/score_nodes.cu): one job's fit mask, per-node
  placement caps and packed best-fit key over every node. Replaces the
  JAX package's Pallas `_score_kernel`.
- `fill_take` (csrc/fill_take.cu): the B smallest packed keys in
  stable-sort order. Replaces the JAX package's lax `fill_take`.

One closes every candidate selection of the node-sharded round on a
(hosts, chips) mesh (solver/dist_cuda.py):

- `winner_reduce` (csrc/winner_reduce.cu): the lexicographic minimum of
  the gathered per-host winner tuples. Replaces the JAX package's Pallas
  `_winner_kernel`.

One is a collective of a process shard group (parallel/pgroup.py):

- `ring_winner_exchange` (csrc/ring_exchange.cu): the same minimum as an
  n - 1 step ring over peer memory, one member per process. Replaces the
  JAX package's Pallas `ring_winner_exchange`; as there, the round does
  not call it.

Each wrapper takes the plain version for CPU tensors (the tests) and, for
CUDA tensors, launches the kernel or raises; nothing falls back. Each
counts its kernel launches in `LAUNCHES`, under a lock: the shards of a
sharded round launch from threads of their own.

Build: each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its
own shared library with a plain C interface, loaded with ctypes, at first
use (or all at once, in parallel, by `build_all`). Libraries land under
`build/kernels/` at the repository root, named by a hash of their source,
so an edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np
import torch

from .select import lex_argmin, lexsort, masked_keys

_ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = _ROOT / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
KERNELS = ("score_nodes", "fill_take", "winner_reduce", "ring_exchange")

# Kernel launches since the last reset_launches(); only a wrapper's
# kernel launch counts, never its plain version. _LAUNCH_LOCK guards the
# read-modify-write of a count.
LAUNCHES = {name: 0 for name in KERNELS}
_LAUNCH_LOCK = threading.Lock()

BIG_I32 = 2**30
FILL_TAKE_MAX = 2048  # csrc/fill_take.cu kMaxTake: survivors sorted in shared memory
WINNER_MAX_ROWS = 1024  # csrc/winner_reduce.cu: one block of at most 1024 threads
RING_MAX_WIDTH = 32  # csrc/ring_exchange.cu: one warp, a lane per column
RING_TIMEOUT_S = 5.0  # csrc/ring_exchange.cu: the spin's bound per step

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


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start_build(name: str):
    """Start nvcc for one kernel unless its library is already built;
    returns (process, tmp path, final path) or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> dict:
    """Build every kernel library, one nvcc per source, all started
    together. Returns {name: library path}."""
    jobs = {name: _start_build(name) for name in KERNELS}
    for name, job in jobs.items():
        _finish_build(name, job)
    return {name: str(_lib_path(name)) for name in KERNELS}


_SIGNATURES = {
    "score_nodes": {
        "armada_score_nodes": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4,
    },
    "fill_take": {
        "armada_fill_take": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3,
    },
    "winner_reduce": {
        "armada_winner_reduce": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2,
    },
    "ring_exchange": {
        "armada_ring_exchange": [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ],
        "armada_ring_bytes": [ctypes.c_int, ctypes.c_int],
        "armada_ring_alloc": [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
        "armada_ring_open": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
        "armada_ring_close": [ctypes.c_int, ctypes.c_void_p],
        "armada_ring_free": [ctypes.c_int, ctypes.c_void_p],
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
                fn = getattr(lib, sym)
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
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(None)


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
    order_res_resolution int32[Ko], bits int32[Ko + 1] (the pack plan)."""
    if alloc0.device.type == "cpu":
        return score_nodes_plain(
            alloc0, node_total, taints, labels, rank, gid, unsched, aff_row,
            tolerated, selector, req_fit, excl, order_res_idx,
            order_res_resolution, bits, batch_window, job_ok,
        )
    device = alloc0.device
    if device.type != "cuda":
        raise ValueError(f"score_nodes: unsupported device {device}")
    n, r = alloc0.shape
    i32 = torch.int32
    for nm, t, dt, nd in (
        ("alloc0", alloc0, i32, 2), ("node_total", node_total, i32, 2),
        ("taints", taints, i32, 2), ("labels", labels, i32, 2),
        ("rank", rank, i32, 1), ("gid", gid, i32, 1),
        ("unsched", unsched, torch.bool, 1), ("tolerated", tolerated, i32, 1),
        ("selector", selector, i32, 1), ("req_fit", req_fit, i32, 1),
        ("excl", excl, i32, 1), ("order_res_idx", order_res_idx, i32, 1),
        ("order_res_resolution", order_res_resolution, i32, 1),
        ("bits", bits, i32, 1),
    ):
        _check(f"score_nodes.{nm}", t, dt, nd, device)
    if aff_row is not None:
        _check("score_nodes.aff_row", aff_row, i32, 1, device)
        if aff_row.shape[0] * 32 < n:
            raise ValueError("score_nodes: aff_row has fewer words than nodes")
    wt, wl = taints.shape[1], labels.shape[1]
    n_order = order_res_idx.shape[0]
    if (
        node_total.shape != (n, r) or taints.shape[0] != n or labels.shape[0] != n
        or rank.shape[0] != n or gid.shape[0] != n or unsched.shape[0] != n
        or tolerated.shape[0] != wt or selector.shape[0] != wl
        or req_fit.shape[0] != r or order_res_resolution.shape[0] != n_order
        or bits.shape[0] != n_order + 1
    ):
        raise ValueError("score_nodes: inconsistent shapes")
    fit0 = torch.empty(n, dtype=torch.bool, device=device)
    caps = torch.empty(n, dtype=i32, device=device)
    key = torch.empty(n, dtype=torch.int64, device=device)
    _launch(
        "score_nodes",
        _ptr(alloc0), _ptr(node_total), _ptr(taints), _ptr(labels), _ptr(rank),
        _ptr(gid), _ptr(unsched), _ptr(aff_row), _ptr(tolerated),
        _ptr(selector), _ptr(req_fit), _ptr(excl), _ptr(order_res_idx),
        _ptr(order_res_resolution), _ptr(bits), n, r, wt, wl, excl.shape[0],
        n_order, int(batch_window), int(bool(job_ok)), _ptr(fit0), _ptr(caps),
        _ptr(key), _stream(device),
    )
    return fit0, caps, key


# ---------------------------------------------------------------------------
# Top-B selection (the fill sort replacement)
# ---------------------------------------------------------------------------


def fill_take_plain(key, B):
    """Plain torch version of `fill_take`: a stable sort's first
    min(B, N) entries. Returns (take int32, key[take] int64)."""
    want = min(int(B), key.shape[0])
    order = torch.sort(key, stable=True).indices[:want]
    return order.to(torch.int32), key[order]


def fill_take(key, B):
    """Indices of the B smallest entries of an int64 key in stable-sort
    order, masked sentinel tail included: (take int32[min(B, N)],
    key[take] int64). The kernel takes 1 <= min(B, N) <= FILL_TAKE_MAX."""
    if key.device.type == "cpu":
        return fill_take_plain(key, B)
    device = key.device
    if device.type != "cuda":
        raise ValueError(f"fill_take: unsupported device {device}")
    _check("fill_take.key", key, torch.int64, 1, device)
    n = key.shape[0]
    want = min(int(B), n)
    if not 1 <= want <= FILL_TAKE_MAX:
        raise ValueError(f"fill_take: min(B, N) = {want} outside [1, {FILL_TAKE_MAX}]")
    if n > 2**31 - 2**11:
        raise ValueError("fill_take: more than 2^31 - 2^11 keys")
    take = torch.empty(want, dtype=torch.int32, device=device)
    take_key = torch.empty(want, dtype=torch.int64, device=device)
    _launch(
        "fill_take", _ptr(key), n, want, _ptr(take), _ptr(take_key),
        _stream(device),
    )
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
# Winner reduction (the host stage of a hierarchical candidate selection)
# ---------------------------------------------------------------------------

_I32_MAX = int(np.iinfo(np.int32).max)


def winner_rows(keys, found, gids):
    """The reduction's input rows, built as the reference builds them
    (`armada_tpu/ops/pallas_kernels.py:474-490`): int32[P, K + 2] of
    (notfound, keys..., gid) per host, keys of not-found hosts replaced by
    the int32 sentinel, then padded to P = the host count rounded up to a
    power of two with not-found sentinel rows of gid 0.

    keys: K int32[H] tensors; found: bool[H]; gids: int32[H]. Nothing is
    cast: the reference casts every key to int32 (`:478`), and a key that
    does not fit must fail here rather than wrap."""
    for i, k in enumerate(keys):
        if k.dtype != torch.int32:
            raise TypeError(f"winner_reduce: key {i} has dtype {k.dtype}, expected torch.int32")
    if gids.dtype != torch.int32:
        raise TypeError(f"winner_reduce: gids have dtype {gids.dtype}, expected torch.int32")
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


def winner_reduce_plain(rows):
    """Plain torch version of the winner kernel: the row whose columns
    0..K (notfound, keys) are lexicographically smallest, the lowest row
    index on a tie; the gid column (last) is carried, not compared.
    rows int32[P, K + 2] -> int32[K + 2]."""
    width = rows.shape[1]
    alive = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    idx, _ = lex_argmin([rows[:, c] for c in range(width - 1)], alive)
    return rows.index_select(0, idx.reshape(1).to(torch.int64)).squeeze(0)


def winner_reduce_rows(rows):
    """The winning row of int32[P, K + 2] (see `winner_reduce_plain`),
    1 <= P <= WINNER_MAX_ROWS, by the kernel on a CUDA tensor."""
    if rows.device.type == "cpu":
        return winner_reduce_plain(rows)
    device = rows.device
    if device.type != "cuda":
        raise ValueError(f"winner_reduce: unsupported device {device}")
    _check("winner_reduce.rows", rows, torch.int32, 2, device)
    p, width = rows.shape
    if not 1 <= p <= WINNER_MAX_ROWS:
        raise ValueError(f"winner_reduce: {p} rows outside [1, {WINNER_MAX_ROWS}]")
    if width < 2:
        raise ValueError("winner_reduce: rows need a notfound and a gid column")
    out = torch.empty(width, dtype=torch.int32, device=device)
    _launch("winner_reduce", _ptr(rows), p, width, _ptr(out), _stream(device))
    return out


def winner_reduce(keys, found, gids, dist=None):
    """The host-level winner argmin: (gid int32 0-d, found bool 0-d) of
    the lexicographically smallest found tuple, exactly `lex_argmin(keys,
    found)` and a gid pick when the last key is unique among found rows
    (the node rank). Books the exchange into `dist.stats` as the
    reference's `_book_winner` does."""
    rows = winner_rows(keys, found, gids)
    out = winner_reduce_rows(rows)
    _book_winner(dist, int(rows.shape[0]), len(keys))
    return out[-1], out[0] == 0


def _book_winner(dist, p, n_keys):
    """The reference's fabric booking of one winner exchange
    (`armada_tpu/ops/pallas_kernels.py:503-513`): log2(P) tree steps, each
    moving one (notfound, keys, gid) int32 tuple; the rows as VMEM bytes."""
    stats = getattr(dist, "stats", None)
    if stats is None or not hasattr(stats, "ring_steps"):
        return
    steps = max(1, int(np.log2(max(p, 2))))
    stats.pallas_calls += 1
    stats.ring_steps += steps
    stats.ring_bytes += steps * (n_keys + 2) * 4
    stats.pallas_vmem_bytes += p * (n_keys + 2) * 4


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


def ring_winner_exchange_plain(row, group, axis):
    """Plain torch version of the ring kernel: the axis's rows gathered
    through the group, the same n - 1 steps simulated, this member's row."""
    return ring_simulate(group.all_gather(row, axis))[group.axis_index(axis)]


@dataclasses.dataclass
class RingBuffers:
    """One member's ring over one axis at one row width: its own buffer
    (`mine`, exported) and its right neighbour's (`right`, opened), both
    device pointers, 0 on an axis of one member (that ring takes no step).
    `epoch` counts the calls; each call's parity picks its slots."""

    device_index: int
    n: int
    mine: int = 0
    right: int = 0
    epoch: int = 0


def _rc(sym, rc):
    if rc != 0:
        raise RuntimeError(f"ring_exchange: {sym} failed (cudaError {rc})")


def ring_open(group, axis, width) -> RingBuffers:
    """Allocate this member's ring buffer over `axis` (cudaMalloc in the
    kernel's library, not torch's allocator: an IPC handle names a whole
    allocation), gather every member's handle over the axis and open the
    right neighbour's. Collective over the axis: every member calls it."""
    n = group.axis_size(axis)
    index = group.device.index if group.device.index is not None else torch.cuda.current_device()
    ring = RingBuffers(index, n)
    if n == 1:
        return ring
    nbytes = _fn("ring_exchange", "armada_ring_bytes")(n, width)
    mine = ctypes.c_void_p()
    handle = (ctypes.c_uint8 * IPC_HANDLE_BYTES)()
    _rc("cudaMalloc", _fn("ring_exchange", "armada_ring_alloc")(index, nbytes, ctypes.byref(mine), handle))
    ring.mine = mine.value
    try:
        mine_handle = torch.tensor(list(bytes(handle)), dtype=torch.uint8, device=group.device)
        handles = group.all_gather(mine_handle, axis).cpu().numpy()
        right_handle = handles[(group.axis_index(axis) + 1) % n].tobytes()
        right = ctypes.c_void_p()
        _rc("cudaIpcOpenMemHandle",
            _fn("ring_exchange", "armada_ring_open")(index, right_handle, ctypes.byref(right)))
        ring.right = right.value
    except BaseException:
        ring_free(ring)
        raise
    return ring


def ring_close(ring: RingBuffers) -> None:
    """Close the right neighbour's buffer; every member of the axis closes
    before any frees its own (ring_free)."""
    if ring.right:
        right, ring.right = ring.right, 0
        _rc("cudaIpcCloseMemHandle",
            _fn("ring_exchange", "armada_ring_close")(ring.device_index, ctypes.c_void_p(right)))


def ring_free(ring: RingBuffers) -> None:
    if ring.mine:
        mine, ring.mine = ring.mine, 0
        _rc("cudaFree", _fn("ring_exchange", "armada_ring_free")(ring.device_index, ctypes.c_void_p(mine)))


def ring_winner_exchange(row, group, axis):
    """The lexicographic minimum of every member's winner tuple over `axis`
    of a process shard group (parallel/pgroup.py), as `ring_simulate`
    defines it: row int32[K + 2] (notfound, keys..., gid) on this member's
    device; returns this member's result row. A collective: every member
    of the axis calls it with a row of the same width.

    On a CUDA tensor the kernel runs the ring over peer memory and the
    call waits for it; a step that waits longer than RING_TIMEOUT_S for
    its neighbour raises. A CPU tensor takes the plain version. Nothing is
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
        "ring_exchange", _ptr(row), width, ring.n, ctypes.c_void_p(ring.mine),
        ctypes.c_void_p(ring.right), ring.epoch, int(RING_TIMEOUT_S * 1e9),
        _ptr(out), _stream(device),
    )
    status = int(out[width])
    if status:
        raise RuntimeError(
            f"ring_winner_exchange: step {status - 1} of {ring.n - 1} over {axis} "
            f"waited more than {RING_TIMEOUT_S} s for its neighbour"
        )
    return out[:width]
