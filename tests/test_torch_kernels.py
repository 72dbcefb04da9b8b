"""The port's kernel functions against the JAX package's.

- `score_nodes_plain` against the Pallas `_score_kernel` (interpret mode,
  through `_pallas_score`) and its body `_score_values`: fit0 and caps
  equal, and the int64 key equal to `combine_hi_lo(hi, lo)`.
- `fill_take_plain` against `jnp.lexsort` (the contract) with a sentinel
  tail, duplicate keys and B > N, and against the reference `fill_take`
  where that one meets the contract. The reference's threshold
  compaction keeps the first `want` entries by index among keys <= the
  threshold, so it drops smaller keys when duplicates straddle the
  threshold, and real keys past index `want` when fewer than `want` keys
  are real (the sentinel becomes the threshold); the port's top-B
  selection equals the stable sort in both cases.
- `pack_plan` agreeing, including the ineligible (None) case.
- `winner_reduce_plain` against the Pallas `_winner_kernel` (interpret
  mode) on the rows the port builds, and the wrapper's select outputs
  (gid, found) against the reference `winner_reduce`, on the cases of
  tests/test_pallas_parity.py plus P = 3 and P = 33: duplicate-heavy
  leading keys with a permutation as the last key, and none found.
- The "cuda" dist's select as rows: each shard's `winner_row` in the
  reference's layout, both stages reduced, equal to the flat `lex_argmin`
  and gid pick on duplicate-heavy blocks at C, H in {1, 2, 3, 4} (none
  found included), the host rows also through the reference's
  `winner_reduce`.
- `ring_oneshot_simulate`, the one-shot kernel's fold, equal to the
  reference loop (`ring_simulate` and the numpy transcription) at n in
  {1, 2, 3, 4, 8}, K in {1, 3, 6}, found shares 0, 1/2 and 1, and on
  tie-heavy rows.
- `ring_winner_exchange_plain` against a numpy transcription of the
  reference ring loop (`pallas_kernels.py:532-563`) for every member, at
  n in {1, 2, 3, 4, 8}, K in {1, 3, 6} and found shares 0, 1/2 and 1,
  all-not-found rows included (each member keeps its own gid), and
  against the reference `winner_reduce` (interpret mode) wherever the
  minimum is unique. The reference ring has no interpret mode (it uses
  `make_async_remote_copy`), so it cannot run here. The ring over two
  gloo processes (plain path) is held to the same transcription.
- On CPU tensors the wrappers take the plain versions and count no launch;
  launch counts survive concurrent increments from shard threads.
The kernels themselves, on the card, are tested in tests/test_torch_cuda.py.
"""

import ctypes
import dataclasses
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_cpu  # noqa: F401
import torch

from jax.experimental import pallas as pl

from armada_tpu.ops import pallas_kernels as pk
from armada_tpu_torch.ops import kernels as tk
from armada_tpu_torch.ops.bitset import as_words
from test_torch_cuda import _TAKE_SPECS, _port_args, _score_inputs, _take_cases


def _reference_args(a):

    n = a["alloc0"].shape[0]
    if a["aff_row"] is None:
        aff_ok = np.ones(n, np.int32)
    else:
        aff_ok = ((a["aff_row"][a["gid"] // 32] >> (a["gid"] % 32).astype(np.uint32)) & 1).astype(np.int32)
    return tuple(
        jnp.asarray(x)
        for x in (
            a["alloc0"], a["node_total"], a["taints"], a["labels"], a["rank"],
            a["gid"], a["unsched"].astype(np.int32), aff_ok, a["tolerated"],
            a["selector"], a["req_fit"], a["excl"],
            np.array([int(a["job_ok"])], np.int32), a["oidx"], a["ores"],
        )
    )



@pytest.mark.parametrize(
    "n,seed,with_aff,job_ok",
    [(1024, 0, True, True), (2048, 1, False, True), (1024, 2, True, False)],
)
def test_score_nodes_plain_matches_pallas_kernel(n, seed, with_aff, job_ok):
    a = _score_inputs(np.random.default_rng(seed), n, with_aff=with_aff, job_ok=job_ok)
    _check_score_against_reference(a)


def test_score_nodes_plain_matches_pallas_kernel_on_a_shard():
    """The last node block of a 4-shard round: gids offset to the block,
    ranks, affinity row and rank bits of the global node count."""
    _check_score_against_reference(_score_inputs(np.random.default_rng(3), 1024, shards=4))


def _check_score_against_reference(a):
    job_ok = a["job_ok"]
    ref = _reference_args(a)
    fit_v, caps_v, hi_v, lo_v = pk._score_values(*ref, a["bits"], a["batch_window"])
    fit_k, caps_k, hi_k, lo_k = pk._pallas_score(ref, a["bits"], a["batch_window"])
    fit, caps, key = tk.score_nodes_plain(**_port_args(a))
    assert fit.dtype == torch.bool and caps.dtype == torch.int32 and key.dtype == torch.int64
    for fit_r, caps_r, hi_r, lo_r in ((fit_v, caps_v, hi_v, lo_v), (fit_k, caps_k, hi_k, lo_k)):
        np.testing.assert_array_equal(fit.numpy(), np.asarray(fit_r).astype(bool))
        np.testing.assert_array_equal(caps.numpy(), np.asarray(caps_r))
        np.testing.assert_array_equal(key.numpy(), np.asarray(pk.combine_hi_lo(hi_r, lo_r)))
    assert fit.numpy().any() or not job_ok
    assert (caps.numpy() > 0).any()


def test_score_nodes_wrapper_takes_plain_version_on_cpu():
    a = _port_args(_score_inputs(np.random.default_rng(4), 256))
    tk.reset_launches()
    got = tk.score_nodes(**a)
    want = tk.score_nodes_plain(**a)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tk.LAUNCHES == {"score_nodes": 0, "fill_take": 0, "winner_reduce": 0, "ring_exchange": 0,
                           "fill_take_global_sort": 0}


@pytest.mark.parametrize("case", range(5))
def test_fill_take_plain_matches_reference(case):
    keys, b = _take_cases()[case]
    jk = jnp.asarray(keys)
    ref_take, ref_key = pk.fill_take(jk, b, nbits=63)
    lex = np.asarray(jnp.lexsort((jk,))[:b])
    take, taken = tk.fill_take_plain(torch.as_tensor(keys), b)
    assert take.dtype == torch.int32 and taken.dtype == torch.int64
    np.testing.assert_array_equal(take.numpy(), lex)
    np.testing.assert_array_equal(taken.numpy(), keys[lex])
    if _TAKE_SPECS[case][4]:
        np.testing.assert_array_equal(take.numpy(), np.asarray(ref_take))
        np.testing.assert_array_equal(taken.numpy(), np.asarray(ref_key))
    else:
        assert not np.array_equal(np.asarray(ref_take), lex)
    # The wrapper takes the plain version on CPU tensors.
    wt, wk = tk.fill_take(torch.as_tensor(keys), b)
    assert torch.equal(wt, take) and torch.equal(wk, taken)


def test_fill_sort_path_matches_reference():
    rng = np.random.default_rng(9)
    n, b = 300, 32
    key = rng.integers(0, 2**20, size=n, dtype=np.int64)
    mask = rng.random(n) < 0.6
    ref_take, _ = pk.fill_sort_path([jnp.asarray(key)], jnp.asarray(mask), b, "blocked", 40)
    take, mk = tk.fill_sort_path([torch.as_tensor(key)], torch.as_tensor(mask), b, "cuda", 40)
    np.testing.assert_array_equal(take.numpy(), np.asarray(ref_take))
    # Multi-key lists keep the chained stable sort.
    k2 = rng.integers(0, 5, size=n).astype(np.int32)
    ref_take, _ = pk.fill_sort_path(
        [jnp.asarray(k2), jnp.asarray(key)], jnp.asarray(mask), b, "blocked", None
    )
    take, _ = tk.fill_sort_path(
        [torch.as_tensor(k2), torch.as_tensor(key)], torch.as_tensor(mask), b, "cuda", None
    )
    np.testing.assert_array_equal(take.numpy(), np.asarray(ref_take))


@dataclasses.dataclass
class _Bits:
    node_id_rank: np.ndarray
    order_key_bits: tuple


@pytest.mark.parametrize(
    "n,bits",
    [(8192, (15, 18)), (65536, (15, 18)), (1024, (31, 25)), (16, (40,)), (64, (20, 20, 20))],
)
def test_pack_plan_matches(n, bits):
    dev = _Bits(np.zeros(n, np.int32), bits)
    want = pk.pack_plan(dev, 1)
    assert tk.pack_plan(dev, 1) == want
    if n == 1024 or n == 16 or len(bits) == 3:
        assert want is None


# (P, key span, found share): the reference's cases, then P = 3 and 33.
_WINNER_SPECS = ((8, 1000, 0.6), (16, 3, 0.6), (5, 2, 0.6), (1, 10, 0.6), (3, 4, 0.6), (33, 3, 0.6), (33, 5, 0.0))


def _winner_case(i):
    from test_torch_cuda import _winner_inputs

    p, span, share = _WINNER_SPECS[i]
    return _winner_inputs(np.random.default_rng(5 + i), p, span, share)


@pytest.mark.parametrize("case", range(len(_WINNER_SPECS)))
def test_winner_reduce_plain_matches_reference(case):
    keys, found, gids = _winner_case(case)
    rows = tk.winner_rows(
        [torch.as_tensor(k) for k in keys], torch.as_tensor(found), torch.as_tensor(gids)
    )
    p = rows.shape[0]
    assert p == 1 << max(0, (len(found) - 1).bit_length()) and rows.dtype == torch.int32
    ref_row = pl.pallas_call(
        functools.partial(pk._winner_kernel, n_rows=p, n_keys=len(keys)),
        out_shape=jax.ShapeDtypeStruct((len(keys) + 2,), jnp.int32),
        interpret=True,
    )(jnp.asarray(rows.numpy()))
    row = tk.winner_reduce_plain(rows)
    np.testing.assert_array_equal(row.numpy(), np.asarray(ref_row))
    # The wrapper's select outputs (plain version on CPU tensors) against
    # the reference's: gid 0 when nothing is found, else the reference's.
    want_gid, want_found = pk.winner_reduce(
        [jnp.asarray(k) for k in keys], jnp.asarray(found), jnp.asarray(gids)
    )
    tk.reset_launches()
    got_row, gid, got_found = tk.winner_reduce_rows(rows, pick=True)
    assert torch.equal(got_row, row)
    assert gid.dtype == torch.int32 and got_found.dtype == torch.bool
    assert bool(got_found) == bool(want_found) == bool(found.any())
    assert int(gid) == (int(want_gid) if found.any() else 0)
    assert tk.LAUNCHES["winner_reduce"] == 0


def test_winner_reduce_refuses_keys_that_are_not_int32():
    keys, found, gids = _winner_case(0)
    found, gids = torch.as_tensor(found), torch.as_tensor(gids)
    with pytest.raises(TypeError):
        tk.winner_rows([torch.as_tensor(k).to(torch.int64) for k in keys], found, gids)
    with pytest.raises(TypeError):
        tk.winner_rows([torch.as_tensor(k) for k in keys], found, gids.to(torch.int64))
    # The sharded select's own row: the same refusal, nothing cast.
    with pytest.raises(TypeError):
        tk.winner_row([torch.as_tensor(k).to(torch.int64) for k in keys], found, gids)
    with pytest.raises(TypeError):
        tk.winner_row([torch.as_tensor(k) for k in keys], found, gids.to(torch.int64))


def _select_blocks(rng, n_shards, n_local, found_share):
    """Keys of one select over n_shards node blocks of n_local nodes each:
    two duplicate-heavy leading keys and a permutation (the node rank) as
    the last, a mask with the given share, the global node ids as gids."""
    n = n_shards * n_local
    keys = [rng.integers(0, 3, size=n).astype(np.int32) for _ in range(2)]
    keys.append(rng.permutation(n).astype(np.int32))
    mask = rng.random(n) < found_share
    return keys, mask, np.arange(n, dtype=np.int32) + 11


def _two_stage_select(keys, mask, gids, h, c):
    """The "cuda" dist's select on the CPU, shard by shard: each shard's
    `winner_row`, the chip stage reducing each host's [C, K + 2] block,
    the host stage reducing the [H, K + 2] block with the select's outputs.
    Returns (gid, found, host rows)."""
    n_local = len(mask) // (h * c)
    host_rows = []
    for host in range(h):
        rows = []
        for chip in range(c):
            s = slice((host * c + chip) * n_local, (host * c + chip + 1) * n_local)
            rows.append(tk.winner_row(
                [torch.as_tensor(k[s]) for k in keys], torch.as_tensor(mask[s]),
                torch.as_tensor(gids[s]),
            ))
        host_rows.append(tk.winner_reduce_rows(torch.stack(rows)) if c > 1 else rows[0])
    host_rows = torch.stack(host_rows)
    _, gid, found = tk.winner_reduce_rows(host_rows, pick=True)
    return gid, found, host_rows


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_two_stage_row_select_matches_lex_argmin(h, c):
    """Both stages of the "cuda" dist's select equal the flat `lex_argmin`
    and gid pick (the single-device select) on duplicate-heavy blocks, none
    found included, and the host stage's rows reduce as the reference's
    `winner_reduce` (interpret mode) reduces them."""
    from armada_tpu_torch.ops.select import lex_argmin

    rng = np.random.default_rng((h, c))
    tk.reset_launches()
    for share in (0.5, 0.05, 0.0):
        for _ in range(4):
            keys, mask, gids = _select_blocks(rng, h * c, 6, share)
            idx, want_found = lex_argmin([torch.as_tensor(k) for k in keys], torch.as_tensor(mask))
            want_gid = int(gids[int(idx)]) if bool(want_found) else 0
            gid, found, host_rows = _two_stage_select(keys, mask, gids, h, c)
            assert gid.dtype == torch.int32 and gid.dim() == 0
            assert found.dtype == torch.bool and found.dim() == 0
            assert (int(gid), bool(found)) == (want_gid, bool(want_found))
            assert bool(found) == bool(mask.any())
            # Not-found rows: notfound 1 and the int32 sentinel in every key.
            lost = host_rows[host_rows[:, 0] == 1]
            assert (lost[:, 1:-1] == np.iinfo(np.int32).max).all()
        rows = host_rows.numpy()
        ref_gid, ref_found = pk.winner_reduce(
            [jnp.asarray(rows[:, 1 + k]) for k in range(3)], jnp.asarray(rows[:, 0] == 0),
            jnp.asarray(rows[:, -1]),
        )
        assert bool(ref_found) == bool(found)
        if bool(found):
            assert int(ref_gid) == int(gid)
    assert tk.LAUNCHES["winner_reduce"] == 0


def test_winner_row_is_the_local_select_in_the_reference_layout():
    from armada_tpu_torch.ops.select import lex_argmin

    rng = np.random.default_rng(3)
    for share in (0.5, 0.0, 1.0):
        keys, mask, gids = _select_blocks(rng, 1, 40, share)
        tkeys = [torch.as_tensor(k) for k in keys]
        row = tk.winner_row(tkeys, torch.as_tensor(mask), torch.as_tensor(gids))
        idx, found = lex_argmin(tkeys, torch.as_tensor(mask))
        want = tk.winner_rows(
            [k[int(idx)].reshape(1) for k in tkeys], found.reshape(1),
            torch.as_tensor(gids[int(idx)]).reshape(1),
        )[0]
        assert row.dtype == torch.int32 and torch.equal(row, want)


class _SlowCounts(dict):
    """A launch table whose reads yield the interpreter, so that an
    unguarded read-modify-write of a count would interleave."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counts_survive_concurrent_shards(monkeypatch):
    monkeypatch.setattr(tk, "LAUNCHES", _SlowCounts({name: 0 for name in tk.KERNELS}))

    def bump():
        for _ in range(200):
            tk.count_launch("winner_reduce")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tk.LAUNCHES["winner_reduce"] == 1600
    tk.reset_launches()
    assert tk.LAUNCHES == {name: 0 for name in tk.KERNELS}


def _ring_reference(rows):
    """Numpy transcription of the reference ring (`armada_tpu/ops/
    pallas_kernels.py:532-563`), member by member: each step every member
    copies its comm buffer into its right neighbour's, then takes the
    arrival when strictly less over columns 0..w-2 (the gid column is not
    compared) and puts its running best back into its comm buffer."""
    n, w = rows.shape
    best = [rows[i].copy() for i in range(n)]
    comm = [rows[i].copy() for i in range(n)]
    for _ in range(n - 1):
        comm = [comm[(i - 1) % n].copy() for i in range(n)]
        for i in range(n):
            cand, b_less = comm[i], False
            for c in range(w - 2, -1, -1):
                b_less = cand[c] < best[i][c] or (cand[c] == best[i][c] and b_less)
            if b_less:
                best[i] = cand.copy()
            comm[i] = best[i].copy()
    return np.stack(best)


class _Gathered:
    """The axis as one member sees it: every member's row is known."""

    def __init__(self, rows, index):
        self.rows, self.index = torch.as_tensor(rows), index

    def all_gather(self, x, axis):
        assert torch.equal(x, self.rows[self.index])
        return self.rows

    def axis_index(self, axis):
        return self.index


@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("n_keys", [1, 3, 6])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_ring_plain_matches_reference_loop(n, n_keys, share):
    from armada_tpu_torch.parallel.launcher import ring_rows

    seed = (n, n_keys, int(share * 2))
    rows = ring_rows(seed, n, n_keys, share)
    # Ties among found rows too: every column drawn from two values.
    tied = np.random.default_rng(seed).integers(0, 2, size=rows.shape).astype(np.int32)
    tk.reset_launches()
    for m in (rows, tied):
        want = _ring_reference(m)
        for i in range(n):
            got = tk.ring_winner_exchange_plain(torch.as_tensor(m[i]), _Gathered(m, i), "x")
            np.testing.assert_array_equal(got.numpy(), want[i])
            wrapped = tk.ring_winner_exchange(torch.as_tensor(m[i]), _Gathered(m, i), "x")
            assert torch.equal(wrapped, got)
    assert tk.LAUNCHES["ring_exchange"] == 0
    found = rows[:, 0] == 0
    result = _ring_reference(rows)
    if not found.any():
        # Every row ties: each member ends with its own gid.
        np.testing.assert_array_equal(result, rows)
        return
    # A unique minimum: every member holds the reference winner_reduce's.
    want_gid, want_found = pk.winner_reduce(
        [jnp.asarray(rows[:, 1 + k]) for k in range(n_keys)], jnp.asarray(found),
        jnp.asarray(rows[:, -1]),
    )
    assert bool(want_found)
    assert (result[:, 0] == 0).all() and (result[:, -1] == int(want_gid)).all()


@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("n_keys", [1, 3, 6])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_ring_oneshot_fold_equals_ring_loop(n, n_keys, share):
    """The one-shot kernel's fold (each member folds the others' rows in
    the order i - 1, i - 2, ...) equals the reference loop for every
    member, on the launcher's rows and on tie-heavy rows (every column
    from two values, found rows tying too)."""
    from armada_tpu_torch.parallel.launcher import ring_rows

    rng = np.random.default_rng((n, n_keys, int(share * 2), 1))
    for call in range(6):
        rows = ring_rows((n, n_keys, int(share * 2), call), n, n_keys, share)
        tied = rng.integers(0, 2, size=rows.shape).astype(np.int32)
        tied[:, 0] = np.where(rows[:, 0] == 0, tied[:, 0], 1)
        for m in (rows, tied):
            got = tk.ring_oneshot_simulate(torch.as_tensor(m))
            assert torch.equal(got, tk.ring_simulate(torch.as_tensor(m)))
            np.testing.assert_array_equal(got.numpy(), _ring_reference(m))


def test_ring_wrapper_refuses_what_the_kernel_does_not_take():
    rows = np.zeros((2, 5), np.int32)
    with pytest.raises(TypeError):
        tk.ring_winner_exchange(torch.zeros(5, dtype=torch.int64), _Gathered(rows, 0), "x")
    with pytest.raises(TypeError):
        tk.ring_winner_exchange(torch.zeros((1, 5), dtype=torch.int32), _Gathered(rows, 0), "x")
    for width in (1, tk.RING_MAX_WIDTH + 1):
        m = np.zeros((2, width), np.int32)
        with pytest.raises(ValueError):
            tk.ring_winner_exchange(torch.zeros(width, dtype=torch.int32), _Gathered(m, 0), "x")


def test_ring_over_two_gloo_processes(tmp_path):
    """The process group's ring on the CPU (the plain path through the
    group's all_gather) on a 1x2 grid: every call of every case, on both
    members, equals the transcription of the reference loop."""
    from armada_tpu_torch.parallel.launcher import RING_KEYS, RING_SHARES, launch

    res = launch(None, 1, 2, devices=["cpu", "cpu"], backend="gloo", timeout_s=120.0,
                 out_dir=tmp_path, ring_calls=3)
    assert res["ok"], res.get("tails")
    for rank, arrays in enumerate(res["arrays"]):
        report = res["workers"][rank]["ring"]
        assert report["chips"]["n"] == 2 and report["hosts"]["n"] == 1
        for axis, member in (("chips", rank), ("hosts", 0)):
            assert report[axis]["mismatches"] == 0 and report[axis]["launches"] == 0
            for k in RING_KEYS:
                for share in RING_SHARES:
                    tag = f"ring:{axis}:{k}:{share}"
                    rows, got = arrays[f"{tag}:rows"], arrays[f"{tag}:got"]
                    assert rows.shape == (3, report[axis]["n"], k + 2)
                    for call in range(3):
                        want = _ring_reference(rows[call])[member]
                        np.testing.assert_array_equal(got[call], want)


# ---------------------------------------------------------------------------
# The cluster fill_take: its CPU model, its launch shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_ctas", [1, 2, 4, 8])
@pytest.mark.parametrize("case", range(len(_TAKE_SPECS)))
def test_fill_take_cluster_model_matches_reference(case, n_ctas):
    """The cluster algorithm, CTA by CTA, equals the stable sort (the plain
    version) and, on the lexsort-exact cases, the reference fill_take."""
    keys, b = _take_cases()[case]
    take, taken = tk.fill_take_cluster_simulate(torch.as_tensor(keys), b, n_ctas)
    want_take, want_key = tk.fill_take_plain(torch.as_tensor(keys), b)
    assert take.dtype == torch.int32 and taken.dtype == torch.int64
    assert torch.equal(take, want_take) and torch.equal(taken, want_key)
    if _TAKE_SPECS[case][4]:
        ref_take, ref_key = pk.fill_take(jnp.asarray(keys), b, nbits=63)
        np.testing.assert_array_equal(take.numpy(), np.asarray(ref_take))
        np.testing.assert_array_equal(taken.numpy(), np.asarray(ref_key))


def _cluster_keys(kind, n, b, rng):
    if kind == "distinct":
        return rng.integers(-(2**62), 2**62, size=n, dtype=np.int64)
    if kind == "dups":
        return rng.integers(0, max(2, n // 64), size=n).astype(np.int64) << 20
    if kind == "equal":
        return np.full(n, 5, np.int64)
    if kind == "two":  # one value and the sentinel, as a masked fill key with one fit
        return np.where(rng.random(n) < 0.5, 3, SENTINEL).astype(np.int64)
    keys = rng.integers(0, 2**40, size=n, dtype=np.int64)  # "tail": fewer real keys than B
    keys[rng.permutation(n)[: max(0, n - b // 3)]] = SENTINEL
    return keys


SENTINEL = np.iinfo(np.int64).max


@pytest.mark.parametrize("n_ctas", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["distinct", "dups", "equal", "two", "tail"])
@pytest.mark.parametrize(
    "n,b",
    [(4097, 512), (8193, 2048), (3001, 2048), (100, 512), (1, 1), (7, 3)],
)
def test_fill_take_cluster_model_matches_stable_sort(n, b, kind, n_ctas):
    """Ragged slices (N not a multiple of the cluster size, empty tail
    slices), all-equal keys, a sentinel tail, B > N and want = 2,048, each
    against the stable sort."""
    rng = np.random.default_rng(n * 31 + b)
    keys = torch.as_tensor(_cluster_keys(kind, n, b, rng))
    take, taken = tk.fill_take_cluster_simulate(keys, b, n_ctas)
    want_take, want_key = tk.fill_take_plain(keys, b)
    assert torch.equal(take, want_take) and torch.equal(taken, want_key)


@pytest.mark.parametrize(
    "n,want,cluster,per_cta,resident",
    [
        (300, 300, 1, 300, True),
        (2048, 512, 1, 2048, True),
        (8192, 512, 1, 8192, True),
        (16384, 512, 2, 8192, True),
        (65536, 512, 8, 8192, True),
        (65536, 2048, 8, 8192, True),
        (4097, 512, 1, 4098, True),
        (8193, 512, 2, 4098, True),
        (131072, 512, 8, 16384, True),
        (131073, 512, 8, 16386, False),
        (262144, 512, 8, 32768, False),
        (65536, 2049, 8, 8192, True),
        (65536, 8192, 8, 8192, True),
        (8192, 8192, 1, 8192, True),
        (262144, 8192, 8, 32768, False),
    ],
)
def test_fill_take_config(n, want, cluster, per_cta, resident):
    cfg = tk.fill_take_config(n, want)
    assert (cfg.cluster, cfg.keys_per_cta, cfg.resident) == (cluster, per_cta, resident)
    assert cfg.cluster * cfg.keys_per_cta >= n and cfg.keys_per_cta % 2 == 0
    # Past FILL_TAKE_MAX the survivors are sorted in global memory, none in
    # shared memory.
    assert cfg.global_sort == (want > tk.FILL_TAKE_MAX)
    p2 = 0 if cfg.global_sort else 1 << (want - 1).bit_length()
    survivors = (p2 * 12 + 15) // 16 * 16
    assert cfg.smem_bytes == survivors + ((per_cta + 1) * 8 if resident else 0)
    # The largest resident launch stays inside a CTA's 227 KB of shared memory.
    assert cfg.smem_bytes <= 232448 - 4096


def test_fill_take_config_refuses_what_the_kernel_does_not_take():
    """The kernel takes any 1 <= want <= N <= FILL_TAKE_MAX_KEYS: a want
    past the shared-memory budget is taken (global sort), want < 1, want
    above N and N past the index range are refused."""
    assert tk.fill_take_config(4096, tk.FILL_TAKE_MAX + 1).global_sort
    assert tk.fill_take_config(4096, 4096).global_sort
    with pytest.raises(ValueError):
        tk.fill_take_config(4096, 0)
    with pytest.raises(ValueError):
        tk.fill_take_config(4096, 4097)
    with pytest.raises(ValueError):
        tk.fill_take_config(tk.FILL_TAKE_MAX_KEYS + 2, 512)


@pytest.mark.parametrize("n_ctas", [1, 8])
@pytest.mark.parametrize("kind", ["distinct", "dups", "tail"])
@pytest.mark.parametrize("want", [2049, 4096, 8192])
def test_fill_take_past_shared_memory_matches_stable_sort(want, kind, n_ctas):
    """want past FILL_TAKE_MAX (the global sort: runs of 2,048, then merge
    levels): the plain version and the cluster model against numpy's
    stable sort, on distinct and tie-heavy keys with a sentinel tail."""
    n = 65536
    rng = np.random.default_rng(want * 7 + n_ctas)
    keys = _cluster_keys(kind, n, want, rng)
    if kind != "tail":
        keys[rng.random(n) < 0.3] = SENTINEL
    order = np.argsort(keys, kind="stable")[:want]
    for take, taken in (
        tk.fill_take_plain(torch.as_tensor(keys), want),
        tk.fill_take_cluster_simulate(torch.as_tensor(keys), want, n_ctas),
    ):
        assert take.dtype == torch.int32 and taken.dtype == torch.int64
        np.testing.assert_array_equal(take.numpy(), order)
        np.testing.assert_array_equal(taken.numpy(), keys[order])


# ---------------------------------------------------------------------------
# The per-round scoring plan
# ---------------------------------------------------------------------------


def _plan_tables(rng, n, shards=1):
    """A round's node tables and four jobs: job 0 in affinity group 0, job 1
    in none, job 2 in group 1 but not possible, job 3 in group 5 (past the
    table: the last row, as the round clamps it)."""
    base = _score_inputs(rng, n, shards=shards)
    jobs = [base] + [_score_inputs(np.random.default_rng(seed), n, shards=shards) for seed in (40, 41, 42)]
    groups = np.array([0, -1, 1, 5], np.int32)
    possible = np.array([True, True, False, True])
    affinity = np.stack([jobs[0]["aff_row"], jobs[2]["aff_row"]])
    tables = dict(
        tolerated=np.stack([j["tolerated"] for j in jobs]),
        selector=np.stack([j["selector"] for j in jobs]),
        req_fit=np.stack([j["req_fit"] for j in jobs]),
        excl=np.stack([j["excl"] for j in jobs]),
        groups=groups, possible=possible, affinity=affinity,
    )
    per_job = []
    for j in range(len(jobs)):
        a = dict(base)
        a.update(
            tolerated=tables["tolerated"][j], selector=tables["selector"][j],
            req_fit=tables["req_fit"][j], excl=tables["excl"][j],
            aff_row=None if groups[j] < 0 else affinity[min(groups[j], len(affinity) - 1)],
            job_ok=bool(possible[j]),
        )
        per_job.append(a)
    return base, tables, per_job


def _plan(base, tables):
    p = _port_args(base)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x))

    return tk.ScorePlan(
        p["node_total"], p["taints"], p["labels"], p["rank"], p["gid"], p["unsched"],
        t(as_words(tables["tolerated"])), t(as_words(tables["selector"])),
        t(tables["req_fit"]), t(tables["excl"]), t(tables["groups"]),
        t(tables["possible"]), t(as_words(tables["affinity"])), p["order_res_idx"],
        p["order_res_resolution"], p["bits"], base["batch_window"],
    )


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("j", range(4))
def test_score_plan_matches_reference(j, shards):
    """plan.score(alloc0, j) on the CPU equals the plain version on job j's
    hand-indexed rows, and the reference's `_score_values` and interpret-mode
    `_pallas_score` on the same rows: with and without an affinity group,
    a job that is not possible, a group past the table, and on a shard
    (gids offset, rank bits and affinity width global)."""
    base, tables, per_job = _plan_tables(np.random.default_rng(30 + j), 512, shards)
    plan = _plan(base, tables)
    tk.reset_launches()
    got = plan.score(torch.as_tensor(base["alloc0"]), j)
    want = tk.score_nodes_plain(**_port_args(per_job[j]))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert tk.LAUNCHES["score_nodes"] == 0
    _check_score_against_reference(per_job[j])


def test_score_plan_struct_mirrors_the_kernel_source():
    """ops/kernels.py's ctypes mirror and csrc/score_nodes.cu's struct
    ScorePlan name the same fields, of the same kinds, in the same order
    (parsed from the source: nothing compiles here)."""
    import re

    src = (tk.CSRC / "score_nodes.cu").read_text()
    body = re.search(r"struct ScorePlan \{(.*?)\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(const )?(\w+)(\*)? (\w+);", line)
        assert m, line
        fields.append((m.group(4), "pointer" if m.group(3) else m.group(2)))
    mirror = [
        (name, "pointer" if ctype is ctypes.c_void_p else "int")
        for name, ctype in tk._ScorePlanC._fields_
    ]
    assert fields == mirror


def test_score_plan_checks_a_rounds_tables():
    """The plan a round builds (`kernel_path="cuda"`) passes its checks and
    fills the C struct with the round's widths; the checks run on a card,
    so here they are called on the CPU tables directly."""
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import _Round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.workload import build_inputs

    dev = pad_device_round(prep_device_round(build_round_snapshot(*build_inputs(200, 16, n_running=10))))
    rd = _Round(dataclasses.replace(dev, kernel_path="cuda"), torch.device("cpu"))
    c = rd.plan.struct()
    assert (c.n, c.r) == tuple(dev.node_total.shape)
    assert rd.plan.jobs == dev.job_req.shape[0] and c.k_excl == dev.job_excluded_nodes.shape[1]
    assert (c.n_aff, c.aff_words) == tuple(dev.affinity_allowed.shape)
    assert c.n_order == len(dev.order_res_idx) and c.batch_window == dev.batch_window
    assert c.node_total == rd.t.node_total.data_ptr() and c.affinity == rd.t.affinity_allowed.data_ptr()
    with pytest.raises(ValueError):
        tk.ScorePlan(
            rd.t.node_total, rd.t.node_taints, rd.t.node_labels, rd.t.node_id_rank,
            rd.t.node_gid, rd.t.node_unschedulable, rd.t.job_tolerated, rd.t.job_selector,
            rd.t.job_req_fit[:, :1].contiguous(), rd.t.job_excluded_nodes, rd.t.job_affinity_group,
            rd.t.job_possible, rd.t.affinity_allowed, rd.t.order_res_idx,
            rd.t.order_res_resolution, rd.plan.bits, dev.batch_window,
        ).struct()
