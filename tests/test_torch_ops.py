"""The port's select and bitset primitives against the JAX package's.

Inputs are made with numpy from a seed and go through both; the words of
the bitset tests include ones with the high bit set (negative in the
port's int32 view of the uint32 words). Also: the integer scatter-add
leaves torch's deterministic switch as it found it when shard threads
call it together."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch_cpu  # noqa: F401
import torch

from armada_tpu.ops import bitset as jbits
from armada_tpu.ops import select as jsel
from armada_tpu_torch.ops import bitset as tbits
from armada_tpu_torch.ops import select as tsel


def _words(rng, shape):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    w[..., 0] |= np.uint32(0x80000000)  # high bit set in every row
    return w


@pytest.mark.parametrize("seed", range(4))
def test_bitset_predicates_match(seed):
    rng = np.random.default_rng(seed)
    avail = _words(rng, (64, 3))
    # Subsets of some rows (so both outcomes occur), random words elsewhere.
    req = np.where(rng.random((64, 1)) < 0.5, avail & _words(rng, (64, 3)), _words(rng, (64, 3)))
    want_sub = np.asarray(jbits.bits_subset(jnp.asarray(req), jnp.asarray(avail)))
    got_sub = tbits.bits_subset(
        torch.as_tensor(tbits.as_words(req)), torch.as_tensor(tbits.as_words(avail))
    ).numpy()
    np.testing.assert_array_equal(got_sub, want_sub)
    assert want_sub.any() and not want_sub.all()
    want_dis = np.asarray(jbits.bits_disjoint(jnp.asarray(req), jnp.asarray(~avail)))
    got_dis = tbits.bits_disjoint(
        torch.as_tensor(tbits.as_words(req)), torch.as_tensor(tbits.as_words(~avail))
    ).numpy()
    np.testing.assert_array_equal(got_dis, want_dis)


def test_high_bit_shift_test_is_exact_on_int32_view():
    """(w >> s) & 1 on the int32 view equals the uint32 bit test."""
    w = np.array([0x80000001, 0xFFFFFFFF, 0x7FFFFFFF, 0], dtype=np.uint32)
    s = np.arange(32, dtype=np.int32)
    want = (w[:, None] >> s[None, :].astype(np.uint32)) & 1
    tw = torch.as_tensor(tbits.as_words(w))
    got = ((tw[:, None] >> torch.as_tensor(s)[None, :]) & 1).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))


@pytest.mark.parametrize(
    "dtype,span", [(np.int32, 4), (np.int64, 2**40), (np.float64, 3)]
)
def test_masked_lexsort_matches(dtype, span):
    rng = np.random.default_rng(11)
    n = 200
    k1 = rng.integers(0, span, size=n).astype(dtype)
    k2 = rng.integers(0, 3, size=n).astype(np.int32)
    mask = rng.random(n) < 0.7
    want = np.asarray(
        jsel.masked_lexsort([jnp.asarray(k1), jnp.asarray(k2)], jnp.asarray(mask))
    )
    got = tsel.masked_lexsort(
        [torch.as_tensor(k1), torch.as_tensor(k2)], torch.as_tensor(mask)
    ).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_lex_argmin_matches(seed):
    """First-index ties and float keys, plus the empty mask."""
    rng = np.random.default_rng(seed)
    n = 50
    keys = [
        rng.integers(0, 3, size=n).astype(np.float64) / 3.0,
        rng.integers(0, 2, size=n).astype(np.int32),
        rng.permutation(n).astype(np.int32),
    ]
    for mask in (rng.random(n) < 0.5, np.zeros(n, bool)):
        wi, wf = jsel.lex_argmin([jnp.asarray(k) for k in keys], jnp.asarray(mask))
        gi, gf = tsel.lex_argmin([torch.as_tensor(k) for k in keys], torch.as_tensor(mask))
        assert int(gi) == int(wi) and bool(gf) == bool(wf)
        assert gi.dtype == torch.int32


def test_masked_keys_and_min_match():
    rng = np.random.default_rng(2)
    mask = rng.random(30) < 0.5
    for k in (rng.normal(size=30), rng.integers(-5, 5, size=30).astype(np.int32)):
        want = [np.asarray(x) for x in jsel.masked_keys([jnp.asarray(k)], jnp.asarray(mask))]
        got = [x.numpy() for x in tsel.masked_keys([torch.as_tensor(k)], torch.as_tensor(mask))]
        np.testing.assert_array_equal(got[0], want[0])
        assert float(tsel.masked_min(torch.as_tensor(k), torch.as_tensor(mask))) == float(
            jsel.masked_min(jnp.asarray(k), jnp.asarray(mask))
        )


def test_integer_scatter_add_matches_and_restores_mode():
    """ops/segment.py: the order-free integer adds equal index_add, refuse
    floats, and leave the deterministic-algorithms mode as they found it."""
    from armada_tpu_torch.ops.segment import index_add_int, segment_sum

    rng = np.random.default_rng(5)
    idx = torch.as_tensor(rng.integers(0, 7, size=40))
    vals = torch.as_tensor(rng.integers(-9, 9, size=(40, 3)).astype(np.int32))
    want = torch.zeros(7, 3, dtype=torch.int32).index_add(0, idx, vals)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        assert torch.equal(segment_sum(vals, idx, 7), want)
        base = torch.ones(7, 3, dtype=torch.int64)
        assert torch.equal(index_add_int(base, 0, idx, vals), base.index_add(0, idx, vals.long()))
        assert torch.are_deterministic_algorithms_enabled()
        with pytest.raises(TypeError):
            index_add_int(torch.zeros(7, 3), 0, idx, vals.double())
    finally:
        torch.use_deterministic_algorithms(before)


def test_index_add_int_keeps_the_deterministic_switch_across_threads(monkeypatch):
    """index_add_int turns the process-wide deterministic switch off around
    its scatter. Threads that flip it unguarded can read another thread's
    "off" and restore that; the switch must end on, as it started."""
    from armada_tpu_torch.ops import segment

    real = torch.use_deterministic_algorithms

    def yielding(mode, *, warn_only=False):
        real(mode, warn_only=warn_only)
        time.sleep(0)  # let another thread run between the flips

    before = torch.are_deterministic_algorithms_enabled()
    real(True)
    monkeypatch.setattr(torch, "use_deterministic_algorithms", yielding)
    x = torch.zeros(8, dtype=torch.int64)
    one = torch.ones(1, dtype=torch.int64)

    def work():
        for _ in range(200):
            segment.index_add_int(x, 0, one, one)

    threads = [threading.Thread(target=work) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        real(before)
