"""The port's integer scatter-adds (ops/segment.py, the segment kernel's
wrappers and `segment_plan`) against the JAX package's
`jax.ops.segment_sum` and `.at[].add`, on the CPU under x64.

Inputs are made with numpy from a seed at scaled-down versions of the
round's call shapes, and compared exactly: int32 sums that wrap, int64
extremes, mostly-zero values, sorted and clustered indices, every row
into one segment, and one-column adds on a [P, N, R] allocation. Both
paths of ops/segment.py run here (`kernel=True` takes the segment
kernel's wrapper, whose CPU tensors take its plain version). On the card,
tests/test_torch_cuda.py holds every strategy of the kernel to the plain
version; `segment_plan`, which picks the strategy, is a plain function
and is held here at the round's shapes."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_cpu  # noqa: F401
import torch

from armada_tpu_torch.ops import kernels as tk
from armada_tpu_torch.ops import segment
from armada_tpu_torch.solver.dist import LocalDist, ShardDist

DTYPES = {"int32": (torch.int32, np.int32), "int64": (torch.int64, np.int64)}

# name -> (segments, rows, lanes, index order, value kind): the round's
# sums at a sixteenth of their rows.
SUM_CASES = {
    "queue_counts": (16, 1280, (), "random", "extremes"),
    "queue_counts_sorted": (16, 1280, (), "sorted", "extremes"),
    "group_counts": (64, 512, (), "clustered", "small"),
    "fill_rows": (512, 128, (4,), "random", "extremes"),
    "rows_to_nodes": (512, 8192, (4,), "random", "extremes"),
    "rows_to_classes": (64, 8192, (4,), "random", "extremes"),
    "rows_to_classes_sorted": (64, 8192, (4,), "sorted", "extremes"),
    "rows_to_one": (1, 8192, (4,), "sorted", "extremes"),
    "mostly_zero": (512, 8192, (4,), "clustered", "sparse"),
    "wide_lanes": (40, 600, (2, 3), "random", "extremes"),
}


def _index(rng, n, k, order):
    idx = rng.integers(0, n, size=k)
    if order == "sorted":
        idx = np.sort(idx)
    elif order == "clustered":  # runs of one segment, in no order
        idx = np.repeat(rng.integers(0, n, size=-(-k // 8)), 8)[:k]
    return idx


def _values(rng, shape, np_dtype, kind):
    info = np.iinfo(np_dtype)
    if kind == "small":
        return rng.integers(0, 2, size=shape).astype(np_dtype)
    v = rng.integers(info.min, info.max, size=shape, dtype=np.int64).astype(np_dtype)
    # the extremes themselves, so that the sums wrap
    v.reshape(-1)[::7] = info.max
    v.reshape(-1)[3::7] = info.min
    v[rng.random(shape) < (0.99 if kind == "sparse" else 0.5)] = 0
    return v


def _jax_segment_sum(values, idx, n):
    return np.asarray(jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(idx), num_segments=n))


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "index_add"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(SUM_CASES))
def test_segment_sum_matches_jax(case, dtype, kernel):
    n, k, rest, order, kind = SUM_CASES[case]
    t_dtype, np_dtype = DTYPES[dtype]
    rng = np.random.default_rng(sorted(SUM_CASES).index(case))
    idx = _index(rng, n, k, order)
    values = _values(rng, (k,) + rest, np_dtype, kind)
    tk.reset_launches()
    got = segment.segment_sum(torch.as_tensor(values), torch.as_tensor(idx), n, kernel)
    want = _jax_segment_sum(values, idx, n)
    assert got.dtype == t_dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert sum(tk.LAUNCHES.values()) == 0  # CPU tensors take the plain version


# name -> (allocation [P, N, R], dim, rows added, index order): a gang
# bind's one-column add, the rescue pass's few rebinds, a row of nodes.
ADD_CASES = {
    "bind_column": ((3, 512, 4), 1, 1, "random"),
    "rebinds": ((3, 512, 4), 1, 5, "random"),
    "rebinds_one_node": ((3, 512, 4), 1, 6, "sorted"),
    "node_rows": ((512, 4), 0, 300, "random"),
}


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "index_add"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(ADD_CASES))
def test_index_add_int_matches_jax(case, dtype, kernel):
    shape, dim, k, order = ADD_CASES[case]
    _, np_dtype = DTYPES[dtype]
    rng = np.random.default_rng(100 + sorted(ADD_CASES).index(case))
    x = _values(rng, shape, np_dtype, "extremes")
    idx = _index(rng, shape[dim], k, order)
    values = _values(rng, shape[:dim] + (k,) + shape[dim + 1:], np_dtype, "extremes")
    got = segment.index_add_int(torch.as_tensor(x), dim, torch.as_tensor(idx),
                                torch.as_tensor(values), kernel)
    at = (slice(None),) * dim + (jnp.asarray(idx),)
    want = np.asarray(jnp.asarray(x).at[at].add(jnp.asarray(values)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_wrappers_refuse_floats_and_keep_inputs():
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(rng.integers(0, 5, size=9))
    vals = torch.as_tensor(rng.integers(-3, 3, size=(9, 2)))
    for kernel in (True, False):
        with pytest.raises(TypeError):
            segment.segment_sum(vals.double(), idx, 5, kernel)
        with pytest.raises(TypeError):
            segment.segment_sum(vals.bool(), idx, 5, kernel)
        x = torch.ones(5, 2, dtype=torch.int64)
        got = segment.index_add_int(x, 0, idx.to(torch.int32), vals.to(torch.int32), kernel)
        assert torch.equal(x, torch.ones(5, 2, dtype=torch.int64))  # a new tensor
        assert torch.equal(got, x.index_add(0, idx, vals))
    assert torch.equal(tk.segment_sum(vals, idx, 5), tk.segment_sum_plain(vals, idx, 5))


# The round's sums as the "cuda" path makes them: (outer, n, k, inner,
# bytes) -> the strategy segment_plan must pick, and whether the output
# is filled before the kernel. Shapes at round_100k (J = 131,072, N =
# 8,192, Q = 16 padded, Q x C = 64, window 512) and the flagship (J =
# 1,048,576, N = 65,536, fill window 2,048 and 10 queues: 20,480 slots);
# the "_round" and "_flagship" cases are shapes that round_100k_fast and
# flagship_fast passed (`tools/solve_ab.py --census`).
PLAN_CASES = {
    # the merged fill's per-queue counts (solver/kernel.py _merged_fill_step)
    "queue_counts": ((1, 16, 20480, 1, 4), "rows", True),
    "queue_counts_round": ((1, 16, 8192, 1, 4), "rows", True),
    "queue_counts_flagship": ((1, 16, 32768, 1, 4), "rows", True),
    # per-group counts of one queue's window (_apply_queue_window)
    "group_counts": ((1, 64, 512, 1, 4), "rows", True),
    "group_counts_flagship": ((1, 8, 2048, 1, 4), "rows", True),
    # the setup's running allocation and the eviction sums into classes
    "rows_to_classes": ((1, 64, 131072, 4, 8), "shared", True),
    "rows_to_classes_round": ((1, 32, 131072, 4, 8), "shared", True),
    "rows_to_classes_flagship": ((1, 32, 1048576, 4, 8), "shared", True),
    "rows_to_queues": ((1, 16, 131072, 4, 8), "shared", True),
    "rows_to_one": ((1, 1, 131072, 4, 8), "shared", True),
    # a fill's rows into the nodes: fewer values than entries
    "fill_rows": ((1, 8192, 2048, 4, 4), "rows", True),
    "fill_rows_int64": ((1, 8192, 2048, 4, 8), "rows", True),
    # an output past one CTA's shared memory, as many values as entries
    "past_shared": ((1, 8192, 8192, 4, 8), "rows", True),
    # job rows into nodes: many segments, few values each
    "rows_to_nodes": ((1, 8192, 131072, 4, 4), "rows", True),
    "rows_to_nodes_int64": ((1, 8192, 131072, 4, 8), "rows", True),
    "flagship_rows_to_nodes": ((1, 65536, 1048576, 4, 4), "rows", True),
    "evicted_slot_hits": ((1, 131072, 262144, 1, 4), "rows", True),
    # a gang bind's one-column add onto [3, N, 4], and add_row_at's flat add
    "bind_column": ((3, 8192, 1, 4, 4), "gather", False),
    "bind_column_flagship": ((3, 65536, 1, 4, 4), "gather", False),
    "add_row_at": ((1, 3 * 8192, 1, 4, 4), "gather", False),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_segment_plan_at_round_shapes(case):
    shape, strategy, init = PLAN_CASES[case]
    outer, n, k, inner, eb = shape
    plan = tk.segment_plan(*shape)
    assert (plan.strategy, plan.init) == (strategy, init)
    assert not plan.wide  # every offset of the round's sums is below 2^31
    accepted = tk.segment_strategies(*shape)
    assert plan.strategy in accepted and "rows" in accepted
    for s in accepted:
        p = tk.segment_plan(*shape, strategy=s)
        assert p.strategy == s and p.grid >= 1 and p.init == (s != "gather")
        if s in ("rows", "gather"):
            assert p.grid <= tk.H100_SMS * tk.SEGMENT_BLOCKS_PER_SM
        if s == "rows":  # a thread a row, the grid from the rows and the SMs
            assert p.grid == min(-(-outer * k // tk.SEGMENT_ROW_THREADS),
                                 tk.H100_SMS * tk.SEGMENT_BLOCKS_PER_SM)
        if s == "shared":  # a CTA a SEGMENT_CTA_VALUES values, each with its copy
            assert p.grid == -(-outer * k * inner // tk.SEGMENT_CTA_VALUES)
            assert outer * n * inner * eb <= tk.SEGMENT_SMEM_BYTES
        if s == "gather":
            assert k <= tk.SEGMENT_GATHER_MAX_K
            assert outer * k * inner <= tk.SEGMENT_GATHER_MAX_VALUES


def test_segment_plan_limits():
    """Outputs past one CTA's shared memory take rows; 64-bit index
    arithmetic from 2^31 entries or values; a strategy that does not
    accept a shape is refused."""
    big = (1, 2**20, 300000, 1, 8)  # 8 MiB of output
    assert tk.segment_strategies(*big) == ("rows",)
    assert tk.segment_plan(*big).strategy == "rows"
    assert tk.segment_plan(1, 2**31, 40, 1, 4).wide
    assert tk.segment_plan(1, 64, 2**29, 4, 4).wide
    assert not tk.segment_plan(1, 2**31 - 1, 40, 1, 4).wide
    with pytest.raises(ValueError):
        tk.segment_plan(*big, strategy="shared")
    with pytest.raises(ValueError):
        tk.segment_plan(1, 64, 17, 1, 4, strategy="gather")
    # a privatised grid needs SEGMENT_PRIVATE_MIN_VALUES values
    few = tk.SEGMENT_PRIVATE_MIN_VALUES
    assert tk.segment_plan(1, 1, few, 1, 4).strategy == "shared"
    assert tk.segment_plan(1, 1, few - 1, 1, 4).strategy == "rows"
    edge = tk.SEGMENT_SMEM_BYTES // 8
    assert "shared" in tk.segment_strategies(1, edge, 10**6, 1, 8)
    assert "shared" not in tk.segment_strategies(1, edge + 1, 10**6, 1, 8)
    assert "gather" not in tk.segment_strategies(1, 64, 8, 1024, 4)  # 8,192 values


def _clone_and_write_back(alloc, row, n, delta, kernel):
    """add_row_at as it was: clone the allocation, add into a copy of the
    row, write the row back."""
    out = alloc.clone()
    out[row] = segment.index_add_int(out[row], 0, n.reshape(1), delta.unsqueeze(0), kernel)
    return out


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "index_add"])
def test_add_row_at_equals_clone_and_write_back(kernel):
    """dist.add_row_at's single add on the flattened allocation equals the
    clone-and-write-back it replaced, on one device and on every shard of
    a 4-way ShardDist (a node another shard owns adds nothing here)."""
    rng = np.random.default_rng(11)
    p, ln, r = 3, 64, 4
    for dtype in (torch.int32, torch.int64):
        alloc = torch.as_tensor(rng.integers(-1000, 1000, size=(p, ln, r))).to(dtype)
        for trial in range(12):
            row = trial % p
            n = torch.tensor(int(rng.integers(0, ln)))
            delta = torch.as_tensor(rng.integers(-50, 50, size=r)).to(dtype)
            got = LocalDist().add_row_at(alloc, row, n, delta, kernel)
            assert torch.equal(got, _clone_and_write_back(alloc, row, n, delta, kernel))
            assert got.shape == alloc.shape
        base = ShardDist("chips", 4)
        for shard in range(4):
            dist = base.bind(types.SimpleNamespace(index=shard, axis_index=lambda axis, s=shard: s))
            for trial in range(8):
                row = trial % p
                n = torch.tensor(int(rng.integers(0, 4 * ln)))
                delta = torch.as_tensor(rng.integers(-50, 50, size=r)).to(dtype)
                local, ok = dist._owned(n, ln)
                want = _clone_and_write_back(alloc, row, local, torch.where(ok, delta, 0), kernel)
                assert torch.equal(dist.add_row_at(alloc, row, n, delta, kernel), want)
