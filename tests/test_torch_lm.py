"""PyTorch port of the delta-LM tables and walk vs catears_tpu/graph/device.py.

Exact throughout: the hash is bit-equal to numpy's uint32 arithmetic, the
tables byte-equal to the JAX build, and the walk gives equal states and
bit-equal weights (float32 sums in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, DLM_META, assert_same, dlm_from_jax
from catears_tpu.graph import device as jdevice
from catears_tpu.graph import fst as jfst
from catears_tpu.graph.fst import DeltaLmFst, LmFst
from catears_tpu.tools.biggraph import make_big_lm
from catears_tpu_torch.graph import device as tdevice
from catears_tpu_torch.graph import fst as tfst
from catears_tpu_torch.tools.biggraph import make_big_lm as t_make_big_lm


@pytest.fixture(scope="module")
def big():
    return make_big_lm(np.random.RandomState(7), num_words=2000)


@pytest.fixture(scope="module")
def tbig():
    """The port's own G' from the same seed."""
    return t_make_big_lm(np.random.RandomState(7), num_words=2000)


def unigram_only_delta(fst=jfst):
    """tests/test_graph.py's G' whose arcs all live on state 0, built by
    `fst` (the JAX package's graph.fst, or the port's)."""
    import types

    labels = np.arange(1, 7, dtype=np.int32)
    lm = fst.LmFst.from_arrays(
        start=0, final=np.zeros(1, np.float32),
        state_of_arc=np.zeros(6, np.int64), arc_next=np.zeros(6),
        arc_ilabel=labels, arc_olabel=labels,
        arc_weight=np.linspace(0.5, 3.0, 6).astype(np.float32))
    return fst.DeltaLmFst(np.zeros(7, np.float32), lm,
                          types.SimpleNamespace(bos_id=1, eos_id=2))


def mixed_queries(big, n=512, seed=3):
    """tests/test_graph.py TestBigLmDevice's mix: unigram state 0, bigram
    histories, trigram states, post-BOS; frequent labels and misses."""
    rng = np.random.RandomState(seed)
    states = np.concatenate([
        np.zeros(64, np.int64),
        rng.randint(1, 2001, size=256),
        rng.randint(2003, big.num_states, size=128),
        np.full(64, 2001),
    ])[:n].astype(np.int32)
    labels = np.where(rng.rand(n) < 0.7,
                      1 + (rng.pareto(1.0, n) * 40).astype(np.int64),
                      rng.randint(0, 2003, size=n)).astype(np.int32)
    return states, np.minimum(labels, 2002)


@pytest.mark.parametrize("seed,mask", [(0x1234, 255), (0x9876 + 21, 2**20 - 1),
                                       (0x1239, 2**31 - 1)])
def test_lm_hash_bit_equal_to_uint32(seed, mask):
    rng = np.random.RandomState(seed)
    n = 100_000
    # Full uint32 range (values >= 2^31 are negative as int32), plus edges.
    s = rng.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    l = rng.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    s[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]
    l[:4] = [2**32 - 1, 2**31, 0, 2**31 - 1]
    s, l = s.view(np.int32), l.view(np.int32)
    ref = jdevice._lm_hash(np, s, l, seed, mask)
    got = tdevice._lm_hash(torch.from_numpy(s), torch.from_numpy(l), seed,
                           mask)
    assert_same(ref, got, "hash")
    assert (s < 0).any() and (l < 0).any()


@pytest.mark.parametrize("which", ["big", "unigram_only"])
def test_device_lm_tables_byte_equal(big, tbig, which):
    if which == "big":
        jl = jdevice.DeviceLm.build(big.delta_lm())
        tl = tdevice.DeviceLm.build(tbig.delta_lm(), device=CPU)
    else:
        jl = jdevice.DeviceLm.build(unigram_only_delta())
        tl = tdevice.DeviceLm.build(unigram_only_delta(tfst), device=CPU)
    for name in tdevice.LM_TABLES:
        assert_same(getattr(jl, name), getattr(tl, name), name)
    assert int(jl.start) == tl.start
    for name in DLM_META:
        assert getattr(jl, name) == getattr(tl, name), name
    if which == "unigram_only":
        assert (tl.hash_tab[:, :4] == -1).all()


def _count_jax_iterations(monkeypatch):
    """Run jax.lax.while_loop as a Python loop (lm_propagate is not jitted)
    and record how many iterations each call took."""
    counts = []

    def while_loop(cond, body, init):
        carry, n = init, 0
        while bool(cond(carry)):
            carry, n = body(carry), n + 1
        counts.append(n)
        return carry

    monkeypatch.setattr(jax.lax, "while_loop", while_loop)
    return counts


@pytest.mark.parametrize("max_backoff", [1, 8])
def test_lm_propagate_matches_jax(big, monkeypatch, max_backoff):
    delta = big.delta_lm()
    jl = jdevice.DeviceLm.build(delta, max_backoff=max_backoff)
    tl = dlm_from_jax(jl)
    states, labels = mixed_queries(big)
    counts = _count_jax_iterations(monkeypatch)
    ref_s, ref_w = jdevice.lm_propagate(jl, jnp.asarray(states),
                                        jnp.asarray(labels))
    got_s, got_w = tdevice.lm_propagate(tl, torch.from_numpy(states),
                                        torch.from_numpy(labels))
    assert_same(ref_s, got_s, "states")
    assert_same(ref_w, got_w, "weights")
    # The static bound is never beaten by the JAX loop's own count.
    assert 0 < counts[0] <= tdevice.lm_iterations(tl)
    # A batch of rows walks each row as the JAX call on it alone.
    got_s2, got_w2 = tdevice.lm_propagate(
        tl, torch.from_numpy(states.reshape(4, -1)),
        torch.from_numpy(labels.reshape(4, -1)))
    assert_same(ref_s, got_s2.reshape(-1), "batched states")
    assert_same(ref_w, got_w2.reshape(-1), "batched weights")


def test_static_iteration_bound_is_reached(monkeypatch):
    """A backoff chain 1 -> 2 -> 3 -> 0 whose first buckets all overflow
    for the queried labels: each state takes both probes, so at
    max_backoff = 2 the JAX loop needs exactly the static 2 * (2 + 1)
    iterations, and at max_backoff = 3 one fewer than its bound (state 0
    resolves in one probe)."""
    import types

    depth, query = 3, 100_000
    seed1, mask = 0x1234, 255  # the build's first attempt at 15 keys
    rng = np.random.RandomState(11)
    cand = np.arange(2, 2**16, dtype=np.int32)
    src, dst, lab, wts = [], [], [], []
    for s in range(1, depth + 1):
        src.append(s)
        dst.append(s + 1 if s < depth else 0)
        lab.append(0)
        wts.append(0.25 * s)
        # Five labels that share the query's first bucket: one is
        # displaced, so that bucket carries the overflow bit.
        h = jdevice._lm_hash(np, np.full(cand.size, s, np.int32), cand,
                             seed1, mask)
        hq = jdevice._lm_hash(np, np.array([s], np.int32),
                              np.array([query], np.int32), seed1, mask)[0]
        for lb in cand[h == hq][:5]:
            src.append(s)
            dst.append(0)
            lab.append(int(lb))
            wts.append(rng.rand())
    src.append(0)
    dst.append(0)
    lab.append(1)
    wts.append(1.5)
    order = np.lexsort((lab, src))
    lm = LmFst.from_arrays(
        start=0, final=np.zeros(depth + 1, np.float32),
        state_of_arc=np.asarray(src, np.int64)[order],
        arc_next=np.asarray(dst)[order],
        arc_ilabel=np.asarray(lab, np.int32)[order],
        arc_olabel=np.asarray(lab, np.int32)[order],
        arc_weight=np.asarray(wts, np.float32)[order])
    delta = DeltaLmFst(np.zeros(query + 1, np.float32), lm,
                       types.SimpleNamespace(bos_id=1, eos_id=2))
    for max_backoff, want in ((depth - 1, 2 * depth), (depth, 2 * depth + 1)):
        jl = jdevice.DeviceLm.build(delta, max_backoff=max_backoff)
        assert (jl.hash_seed1, jl.hash_mask) == (seed1, mask)
        tl = dlm_from_jax(jl)
        states = np.ones(64, np.int32)
        labels = np.concatenate([np.full(32, query), np.full(16, 1),
                                 np.asarray(lab)[rng.randint(0, len(lab),
                                                             16)]]
                                ).astype(np.int32)
        counts = _count_jax_iterations(monkeypatch)
        ref = jdevice.lm_propagate(jl, jnp.asarray(states),
                                   jnp.asarray(labels))
        got = tdevice.lm_propagate(tl, torch.from_numpy(states),
                                   torch.from_numpy(labels))
        monkeypatch.undo()
        assert_same(ref[0], got[0], "states")
        assert_same(ref[1], got[1], "weights")
        assert counts[0] == want <= tdevice.lm_iterations(tl)
    assert want == tdevice.lm_iterations(tl) - 1


def test_unigram_only_propagate():
    jl = jdevice.DeviceLm.build(unigram_only_delta())
    tl = tdevice.DeviceLm.build(unigram_only_delta(tfst), device=CPU)
    qs = np.zeros(8, np.int32)
    ql = np.asarray([0, 1, 2, 3, 4, 5, 6, 6], np.int32)
    ref = jdevice.lm_propagate(jl, jnp.asarray(qs), jnp.asarray(ql))
    got = tdevice.lm_propagate(tl, torch.from_numpy(qs), torch.from_numpy(ql))
    assert_same(ref[0], got[0], "states")
    assert_same(ref[1], got[1], "weights")


@pytest.mark.parametrize("cap", [0, 100, 1000, 5000])
def test_lm_propagate_capped_matches_jax(big, cap):
    """Caps above and below `needed`: same needed, and the same outputs on
    overflow lanes (state kept, weight 0)."""
    jl = jdevice.DeviceLm.build(big.delta_lm())
    tl = dlm_from_jax(jl)
    rng = np.random.RandomState(cap)
    states, labels = mixed_queries(big, n=512, seed=cap + 1)
    e = 2048
    lanes_s = np.zeros((2, e), np.int32)
    lanes_l = np.zeros((2, e), np.int32)
    for u in range(2):  # the 512 queries spread over sparse lanes
        pos = np.sort(rng.choice(e, size=512, replace=False))
        lanes_s[u, pos], lanes_l[u, pos] = states, labels
        lanes_s[u, rng.rand(e) < 0.1] = 7
    got_s, got_w, got_n = tdevice.lm_propagate_capped(
        tl, torch.from_numpy(lanes_s), torch.from_numpy(lanes_l), cap)
    for u in range(2):
        ref_s, ref_w, ref_n = jdevice.lm_propagate_capped(
            jl, jnp.asarray(lanes_s[u]), jnp.asarray(lanes_l[u]), cap)
        assert int(ref_n) == int(got_n[u])
        assert_same(ref_s, got_s[u], f"row {u} states")
        assert_same(ref_w, got_w[u], f"row {u} weights")
    needed = int(got_n.max())
    assert (0 < cap < needed) == (cap in (100,))


@pytest.mark.parametrize("c2", [1, 37, 600])
def test_compact_mask_contract(c2):
    rng = np.random.RandomState(c2)
    keep = rng.rand(3, 517) < np.array([[0.05], [0.5], [0.0]])
    vals = rng.randint(-50, 50, size=(3, 517)).astype(np.int32)
    (got,), valid, total, src = tdevice.compact_mask(
        torch.from_numpy(keep), [torch.from_numpy(vals)], c2)
    for u in range(3):
        (ref,), rvalid, rtotal, rsrc = jdevice.compact_mask(
            jnp.asarray(keep[u]), [jnp.asarray(vals[u])], c2)
        assert int(rtotal) == int(total[u])
        assert np.array_equal(np.asarray(rvalid), valid[u].numpy())
        assert np.array_equal(np.asarray(rsrc), src[u].numpy())
        assert np.array_equal(np.asarray(ref), got[u].numpy())
