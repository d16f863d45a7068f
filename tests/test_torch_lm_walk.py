"""The algorithms of the port's two device-loop kernels, held to JAX on the CPU.

csrc/lm_walk.cu (graph/device.py::lm_propagate_capped and lm_propagate on
the card) and csrc/backtrace.cu (decode/beam.py::backtrace_device) run only
on a CUDA card.  Here a numpy model of each kernel's loop, written as the
kernel runs it, is compared bit for bit with the JAX package's functions:

* the walk: one block per row; lanes in tiles of BLOCK, ranked in lane order
  by a ballot per warp of 32 and a scan of the warp counts; the first `cap`
  active lanes listed (every active lane when uncapped); then one thread per
  listed lane runs the probe / second probe / backoff machine to its own
  end, at most lm_iterations(dlm) probes, in float32 additions in order;
* the backtrace: one thread per utterance chasing its backpointers from
  max(best_slot, 0), zeros once the chain ends.

The card's tests (tests/test_torch_cuda.py) hold each kernel to the same
plain versions bit for bit on the same cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CHAIN_MISS, CHAIN_QUERY, assert_same,
                           backtrace_case, big_lm_queries, chain_delta,
                           dlm_from_jax, walk_lanes)
from catears_tpu.decode import beam as jbeam
from catears_tpu.graph import device as jdevice
from catears_tpu.graph import fst as jfst
from catears_tpu.tools.biggraph import make_big_lm
from catears_tpu_torch import kernels
from catears_tpu_torch.decode import beam as tbeam
from catears_tpu_torch.graph import device as tdevice

BLOCK = 1024  # the kernel's threads per block (lm_walk.cu kThreads)
E = 1024
CAPS = (0, 1, 37, 384, E)


# -- the numpy model of csrc/lm_walk.cu ------------------------------------

def _hash(s, l, seed, mask):
    """lm_hash in uint32 arithmetic, as the kernel computes it."""
    with np.errstate(over="ignore"):
        h = (np.uint32(s & 0xFFFFFFFF) * np.uint32(0x9E3779B1)
             ^ np.uint32(l & 0xFFFFFFFF) * np.uint32(0x85EBCA77)
             ^ np.uint32(seed))
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x2C1B3C6D)
        h ^= h >> np.uint32(13)
    return int(h & np.uint32(mask))


def _walk(lm, state, label, outcomes):
    """One thread's walk: (next state, weight) or None; `outcomes` counts
    how each walk ended."""
    hash_tab, state_tab = lm["hash_tab"], lm["state_tab"]
    lu = min(max(label, 0), lm["uni_next"].size - 1)
    uni_nxt, uni_w = int(lm["uni_next"][lu]), lm["uni_weight"][lu]
    cur, weight, phase2, bo_it = state, np.float32(0.0), False, 0
    for _ in range(lm["iters"]):
        need2 = False
        if cur == 0:
            hit, nxt, w = uni_nxt >= 0, uni_nxt, uni_w
        else:
            seed = lm["seed2"] if phase2 else lm["seed1"]
            row = hash_tab[_hash(cur, label, seed, lm["mask"])]
            match = (row[0:4] == cur) & ((row[4:8] & 0x7FFFFFFF) == label)
            hit = bool(match.any())
            # Wrapping int32 sums of the matching slots.
            nxt = int(np.sum(np.where(match, row[8:12], 0), dtype=np.int32))
            w = np.sum(np.where(match, row[12:16], 0),
                       dtype=np.int32).view(np.float32)
            need2 = not hit and row[4] < 0 and not phase2
        if hit:
            outcomes["found-second-bucket" if phase2 else
                     "found-at-0" if cur == 0 else "found"] += 1
            sub = lm["small_lm"][min(max(label, 0),
                                     lm["small_lm"].size - 1)]
            return nxt, np.float32(np.float32(weight + w) - sub)
        if need2:
            phase2 = True
            continue
        bo_next, bo_bits = state_tab[min(max(cur, 0), len(state_tab) - 1)]
        if bo_next < 0:
            outcomes["no-backoff-arc"] += 1
            return None
        if bo_it >= lm["max_backoff"]:
            outcomes["past-max-backoff"] += 1
            return None
        cur = int(bo_next)
        weight = np.float32(weight + np.int32(bo_bits).view(np.float32))
        bo_it += 1
        phase2 = False
    outcomes["unfinished"] += 1
    return None


def kernel_model(lm, states, labels, cap, outcomes):
    """csrc/lm_walk.cu over [..., E] lanes: (next_states, weights, needed)."""
    shape = states.shape
    e = shape[-1]
    st, lb = states.reshape(-1, e), labels.reshape(-1, e)
    out_s, out_w = st.copy(), np.zeros(st.shape, np.float32)
    needed = np.zeros(st.shape[0], np.int32)
    walkers = e if cap <= 0 or cap >= e else cap
    for r in range(st.shape[0]):
        listed, total = [], 0
        for base in range(0, e, BLOCK):  # one tile of the block's threads
            act = np.zeros(BLOCK, bool)
            n = min(BLOCK, e - base)
            act[:n] = lb[r, base:base + n] > 0
            warps = act.reshape(-1, 32)
            counts = warps.sum(axis=1)
            warp_base = total + np.cumsum(counts) - counts
            below = np.cumsum(warps, axis=1) - warps  # popc(ballot & below)
            rank = (warp_base[:, None] + below).reshape(-1)
            for t in np.flatnonzero(act & (rank < walkers)):
                assert rank[t] == len(listed)  # lane order, no gaps
                listed.append(base + t)
            total += int(counts.sum())
        needed[r] = total
        for i in listed:  # one thread per listed lane
            res = _walk(lm, int(st[r, i]), int(lb[r, i]), outcomes)
            if res is not None:
                out_s[r, i], out_w[r, i] = res
    return (out_s.reshape(shape), out_w.reshape(shape),
            needed.reshape(shape[:-1]))


def model_tables(jl):
    lm = {name: np.asarray(getattr(jl, name)) for name in tdevice.LM_TABLES}
    lm.update(seed1=jl.hash_seed1, seed2=jl.hash_seed2, mask=jl.hash_mask,
              max_backoff=jl.max_backoff, iters=2 * (jl.max_backoff + 1))
    return lm


# -- the cases ----------------------------------------------------------------

@pytest.fixture(scope="module")
def lms():
    """{name: (JAX DeviceLm, lanes (states, labels) [4, E])}: the corner
    case G' at max_backoff 1 and 8, and a make_big_lm G'."""
    delta, queries = chain_delta(jfst)
    out = {}
    for mb in (1, 8):
        jl = jdevice.DeviceLm.build(delta, max_backoff=mb)
        out[f"chain-{mb}"] = jl, walk_lanes(queries, 4, E, seed=mb)
    big = make_big_lm(np.random.RandomState(7), num_words=2000)
    jl = jdevice.DeviceLm.build(big.delta_lm())
    q = np.stack(big_lm_queries(big.num_states, 2000, 600, seed=3), 1)
    out["big"] = jl, walk_lanes(q, 4, E, seed=5)
    return out


@pytest.mark.parametrize("shape", ["E", "BxE"])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("lm", ["chain-1", "chain-8", "big"])
def test_lm_walk_model_matches_jax(lms, lm, cap, shape):
    """The kernel's compaction and per-lane walk == JAX's
    lm_propagate_capped bit for bit, row by row: states, weights, needed
    (rows with needed > cap, = 0 and in between)."""
    jl, (states, labels) = lms[lm]
    if shape == "E":
        states, labels = states[0], labels[0]
    outcomes = _Counter()
    got = kernel_model(model_tables(jl), states, labels, cap, outcomes)
    rows = states.reshape(-1, E), labels.reshape(-1, E)
    for r in range(rows[0].shape[0]):
        ref_s, ref_w, ref_n = jdevice.lm_propagate_capped(
            jl, jnp.asarray(rows[0][r]), jnp.asarray(rows[1][r]), cap)
        assert_same(ref_s, got[0].reshape(-1, E)[r], f"row {r} states")
        assert_same(ref_w, got[1].reshape(-1, E)[r], f"row {r} weights")
        assert int(ref_n) == int(got[2].reshape(-1)[r])
    needed = got[2].reshape(-1)
    assert needed.min() == (0 if shape == "BxE" else needed[0])
    if shape == "BxE" and cap in (1, 37, 384):
        assert needed.max() > cap  # lanes past the cap keep their state
    if lm.startswith("chain") and cap in (0, E):
        # Every branch of the loop was taken.
        assert set(outcomes) >= {"found", "found-at-0", "found-second-bucket",
                                 "no-backoff-arc", "past-max-backoff"}
    assert outcomes["unfinished"] == 0  # the static bound is never hit


def test_chain_walk_corner_cases(lms):
    """The corner-case G' takes the branches it was built for: CHAIN_QUERY
    from state 1 walks the whole chain (past max_backoff 8, so it fails),
    from state depth - 1 it reaches state 0 (2 backoffs, so it fails at
    max_backoff 1 only), CHAIN_MISS misses everywhere, a label past the
    tables reads their last entries."""
    for mb, want_ok in ((1, False), (8, True)):
        jl = lms[f"chain-{mb}"][0]
        s = np.array([1, 9, 0, 5, 0], np.int32)
        past = int(np.asarray(jl.uni_next).size) + 3
        lab = np.array([CHAIN_QUERY, CHAIN_QUERY, CHAIN_MISS, CHAIN_MISS,
                        past], np.int32)
        outcomes = _Counter()
        got = kernel_model(model_tables(jl), s, lab, 0, outcomes)
        ref = jdevice.lm_propagate(jl, jnp.asarray(s), jnp.asarray(lab))
        assert_same(ref[0], got[0], "states")
        assert_same(ref[1], got[1], "weights")
        ok = np.asarray(got[1]) != 0
        assert not ok[0] and ok[1] == want_ok and not ok[2:].any()


@pytest.mark.parametrize("lm", ["chain-8", "big"])
def test_lm_propagate_model_matches_jax(lms, lm):
    """Uncapped (lm_propagate, cap 0) over the flattened lanes."""
    jl, (states, labels) = lms[lm]
    s, lab = states.reshape(-1), labels.reshape(-1)
    got = kernel_model(model_tables(jl), s, lab, 0, _Counter())
    ref = jdevice.lm_propagate(jl, jnp.asarray(s), jnp.asarray(lab))
    assert_same(ref[0], got[0], "states")
    assert_same(ref[1], got[1], "weights")


@pytest.mark.parametrize("cap", CAPS)
def test_lm_walk_public_names_take_the_plain_version_on_cpu(lms, monkeypatch,
                                                            cap):
    """CPU tensors: lm_propagate_capped and lm_propagate give their plain
    versions' outputs exactly, and no kernel is built or counted."""
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(kernels, "load_kernels", no_build)
    jl, (states, labels) = lms["chain-8"]
    tl = dlm_from_jax(jl)
    s, lab = torch.from_numpy(states), torch.from_numpy(labels)
    before = (tdevice.lm_propagate_capped.launches,
              tdevice.lm_propagate.launches)
    got = tdevice.lm_propagate_capped(tl, s, lab, cap)
    ref = tdevice.lm_propagate_capped_ref(tl, s, lab, cap)
    for g, r in zip(got, ref):
        assert_same(r, g)
    got = tdevice.lm_propagate(tl, s, lab)
    ref = tdevice.lm_propagate_ref(tl, s, lab)
    for g, r in zip(got, ref):
        assert_same(r, g)
    assert (tdevice.lm_propagate_capped.launches,
            tdevice.lm_propagate.launches) == before


def test_kernel_wrappers_refuse_other_devices(lms):
    """A tensor on neither the CPU nor a card raises: no path falls back to
    the plain version."""
    jl = lms["chain-8"][0]
    tl = dlm_from_jax(jl, device=torch.device("meta"))
    s = torch.zeros(4, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.lm_propagate_capped(tl, s, s, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.lm_propagate(tl, s, s)
    trace = tbeam.FrameTrace(s.view(2, 2, 8), s.view(2, 2, 4, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        tbeam.backtrace_device(trace, s[0, :2])


class _Counter(dict):
    def __missing__(self, key):
        return 0


# -- the numpy model of csrc/backtrace.cu --------------------------------------

def backtrace_model(prev, words, best):
    """One thread per utterance: [B, T, W] words."""
    t, b, k, w = words.shape
    out = np.empty((b, t, w), np.int32)
    for u in range(b):
        slot, active = max(int(best[u]), 0), True
        for f in range(t - 1, -1, -1):
            if not active:
                out[u, f] = 0
                continue
            at = min(slot, k - 1)
            out[u, f] = words[f, u, at]
            nxt = int(prev[f, u, at])
            active = nxt >= 0
            if active:
                slot = nxt
    return out


@pytest.mark.parametrize("seed,t,b,k,w,cut", [
    (0, 1, 1, 1, 1, None), (1, 9, 3, 5, 2, None), (2, 40, 8, 16, 1, None),
    (3, 120, 5, 64, 2, None), (4, 300, 16, 7, 2, None), (9, 64, 4, 8, 2, 20)])
def test_backtrace_model_matches_jax(seed, t, b, k, w, cut):
    """Early -1 roots, best slots < 0, one-frame and one-slot traces, and
    (cut) every chain ending at one frame."""
    prev, words, best = backtrace_case(seed, t, b, k, w)
    if cut is not None:
        prev[cut] = -1
    ref = jbeam.backtrace_device(
        jbeam.FrameTrace(jnp.asarray(prev), jnp.asarray(words)),
        jnp.asarray(best))
    got = backtrace_model(prev, words, best)
    assert_same(ref, got, "words")
    if cut is not None:
        assert (got[:, :cut] == 0).all() and got[:, cut:].any()
    cpu = tbeam.backtrace_device(
        tbeam.FrameTrace(torch.from_numpy(prev), torch.from_numpy(words)),
        torch.from_numpy(best))
    assert_same(ref, cpu, "the port's plain version")


def test_backtrace_public_name_takes_the_plain_version_on_cpu(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(kernels, "load_kernels", no_build)
    prev, words, best = backtrace_case(7, 50, 4, 9, 2)
    trace = tbeam.FrameTrace(torch.from_numpy(prev), torch.from_numpy(words))
    before = tbeam.backtrace_device.launches
    for slots in (torch.from_numpy(best), torch.from_numpy(best).long()):
        got = tbeam.backtrace_device(trace, slots)
        assert_same(tbeam.backtrace_device_ref(trace, slots), got)
    assert tbeam.backtrace_device.launches == before
