"""Shared helpers for the PyTorch-port parity tests (not a test module).

Every parity test feeds the same numpy inputs, made from a seed, to a JAX
function of `catears_tpu` and to its counterpart in `catears_tpu_torch`
(both on the CPU, which the port's entry points take only when asked:
`CPU`), and compares the numpy results.  Host objects (graphs, LMs,
configs) are built by each package from the same seeds or files: the port's
functions get the port's own objects.
"""

from __future__ import annotations

import numpy as np
import torch

from catears_tpu_torch.graph.fst import FlatFst
from catears_tpu_torch.graph.transform import prepare_decode_graph

CPU = torch.device("cpu")  # every CPU test passes it to the port explicitly

# The suite runs in several worker processes at once (pytest-xdist), each
# of which imports this module while collecting: one intra-op thread per
# process keeps PyTorch's thread pools from oversubscribing the host's
# cores (the port's tests run many small ops, which gain nothing from
# more threads).
torch.set_num_threads(1)

DFST_META = ("eps_depth", "group", "csr_group", "eps_group", "eps_meta_ok",
             "max_emit_fanout", "eps_removed", "has_emit_olabel",
             "emit_compact", "hot_rows")
DLM_META = ("max_backoff", "hash_seed1", "hash_seed2", "hash_mask")


def to_np(x) -> np.ndarray:
    """numpy view of a torch tensor or anything np.asarray takes."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(jax_value, torch_value, what: str = "") -> None:
    """Exact equality: same dtype, shape and bytes (floats bit for bit);
    None (an absent table) equals only None."""
    if jax_value is None or torch_value is None:
        assert jax_value is None and torch_value is None, f"{what}: None"
        return
    a, b = to_np(jax_value), to_np(torch_value)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    if a.tobytes() != b.tobytes():
        bad = np.argwhere(a != b) if a.ndim else []
        raise AssertionError(f"{what}: {len(bad)} entries differ, first "
                             f"{bad[:3].tolist() if len(bad) else '?'}")


def range_error(ref, got) -> float:
    """max |ref - got| as a fraction of ref's range (the 1% criterion of
    the quantized-GEMM tests)."""
    ref, got = to_np(ref).astype(np.float64), to_np(got).astype(np.float64)
    span = ref.max() - ref.min()
    return float(np.abs(ref - got).max() / max(span, 1e-9))


def dfst_from_jax(jd, device=CPU):
    """The port's DeviceFst holding a JAX DeviceFst's tables."""
    from catears_tpu_torch.graph.device import TABLES, DeviceFst

    arrays = {name: None if getattr(jd, name) is None
              else np.asarray(getattr(jd, name)) for name in TABLES}
    arrays["start"] = np.asarray(jd.start)
    meta = {name: getattr(jd, name) for name in DFST_META}
    return DeviceFst.from_numpy(arrays, meta, device=device)


def dlm_from_jax(jl, device=CPU):
    """The port's DeviceLm holding a JAX DeviceLm's tables."""
    from catears_tpu_torch.graph.device import LM_TABLES, DeviceLm

    arrays = {name: np.asarray(getattr(jl, name)) for name in LM_TABLES}
    arrays["start"] = np.asarray(jl.start)
    meta = {name: getattr(jl, name) for name in DLM_META}
    return DeviceLm.from_numpy(arrays, meta, device=device)


def random_fst(rng, num_states=12, num_trans=10, eps_prob=0.25,
               max_olabel=5, flat=FlatFst):
    """Random WFST with emitting and epsilon arcs (tests/test_decoder.py's
    generator), as a `flat` (the port's FlatFst, or the JAX package's)."""
    arcs = []
    for s in range(num_states):
        for _ in range(rng.randint(1, 5)):
            dst = rng.randint(0, num_states)
            if rng.rand() < eps_prob:
                ilabel = 0
                olabel = rng.randint(0, max_olabel + 1)
                weight = rng.rand() * 2 + 0.05
                if dst == s:
                    continue
            else:
                ilabel = rng.randint(1, num_trans + 1)
                olabel = rng.randint(0, max_olabel + 1)
                weight = rng.rand() * 3
            arcs.append((s, dst, ilabel, olabel, weight))
    arr = np.array(arcs, dtype=np.float64)
    final = np.where(rng.rand(num_states) < 0.4,
                     (rng.rand(num_states) * 2).astype(np.float32),
                     np.float32(np.inf))
    return flat.from_arrays(
        start=0, final=final,
        state_of_arc=arr[:, 0].astype(np.int64),
        arc_next=arr[:, 1].astype(np.int32),
        arc_ilabel=arr[:, 2].astype(np.int32),
        arc_olabel=arr[:, 3].astype(np.int32),
        arc_weight=arr[:, 4].astype(np.float32))


def eps_free_random_fst(seed: int, flat=FlatFst):
    """(fst, seed) of the first random graph from `seed` on whose epsilon
    removal reaches the eps-free mode."""
    while True:
        fst = random_fst(np.random.RandomState(seed), flat=flat)
        if prepare_decode_graph(fst)[2] == "eps_free":
            return fst, seed
        seed += 1000


def run_chunks(jd, td, jcfg, tcfg, logp, lengths, jl=None, tl=None,
               chunk=8):
    """Decode [B, T, P] chunk by chunk in both ports (with the delta-LM
    jl / tl when given); assert every chunk's beam and trace are
    identical.  Returns the final (JAX) beam."""
    import jax.numpy as jnp

    from catears_tpu.decode import beam as jbeam
    from catears_tpu_torch.decode import beam as tbeam

    b, t, p = logp.shape
    has_lm = jl is not None
    jb, jtr = jbeam.init_beam_batch(jcfg, has_lm, b, jd, jl)
    tb, ttr = tbeam.init_beam_batch(tcfg, b, td, tl)
    for name, x, y in zip(jtr._fields, jtr, ttr):
        assert_same(x, y, f"init trace {name}")
    for name, x, y in zip(jb._fields, jb, tb):
        assert_same(x, y, f"init beam {name}")
    lens = np.asarray(lengths)
    for off in range(0, t, chunk):
        lp = np.zeros((chunk, b, p), np.float32)
        n = min(chunk, t - off)
        lp[:n] = np.transpose(logp[:, off:off + n], (1, 0, 2))
        valid = (off + np.arange(chunk))[:, None] < lens[None, :]
        jb, jtr = jbeam.decode_chunk(jcfg, has_lm, jd, jl, jb,
                                     jnp.asarray(lp), jnp.asarray(valid))
        tb, ttr = tbeam.decode_chunk(tcfg, td, tb, torch.from_numpy(lp),
                                     torch.from_numpy(valid), tl)
        for name, x, y in zip(jb._fields, jb, tb):
            assert_same(x, y, f"chunk {off}: beam {name}")
        for name, x, y in zip(jtr._fields, jtr, ttr):
            assert_same(x, y, f"chunk {off}: trace {name}")
    return jb


def dirichlet(rng, p, size):
    """Log-probs [*size, p], each row a seeded Dirichlet draw."""
    return np.log(rng.dirichlet(np.ones(p), size=size)).astype(np.float32)


def with_lm_words(fst, delta, rng):
    """The graph with every output label replaced by a word id of the LM
    `delta` (either package's FlatFst and DeltaLmFst)."""
    import dataclasses

    vocab = delta.small_lm.size
    words = rng.randint(3, min(vocab, 200), size=fst.arc_olabel.size)
    return dataclasses.replace(fst, arc_olabel=np.where(
        fst.arc_olabel > 0, words, 0).astype(np.int32))


def add_two_word_eps_path(fst):
    """The graph plus one epsilon path s -eps:1-> s+1 -eps:2-> s+2 on three
    new states, unreachable from the start: prepare_decode_graph returns
    'raw' (close_epsilons refuses a path with two output labels), so every
    frame of a decode runs the closure rounds."""
    n = fst.num_states
    state_of_arc = np.repeat(np.arange(n), np.diff(fst.offsets))
    return type(fst).from_arrays(
        fst.start, np.concatenate([fst.final,
                                   np.full(3, np.inf, np.float32)]),
        np.concatenate([state_of_arc, [n, n + 1]]),
        np.concatenate([fst.arc_next, [n + 1, n + 2]]).astype(np.int32),
        np.concatenate([fst.arc_ilabel, [0, 0]]).astype(np.int32),
        np.concatenate([fst.arc_olabel, [1, 2]]).astype(np.int32),
        np.concatenate([fst.arc_weight, [0.5, 0.5]]).astype(np.float32))


def write_raw_conf(conf: str, name: str, extra=()) -> str:
    """A copy of the model config `conf` whose `fst` is that graph with
    add_two_word_eps_path, plus the `extra` lines; returns its path."""
    import os

    from catears_tpu_torch.io import binfmt
    from catears_tpu_torch.io.config import Configuration

    d = os.path.dirname(conf)
    fst_path = Configuration.read(conf).get_path("fst")
    raw = add_two_word_eps_path(FlatFst.read(fst_path))
    assert prepare_decode_graph(raw)[2] == "raw"
    with open(os.path.join(d, name + ".fst"), "wb") as fd:
        binfmt.write_pkfst(fd, raw.to_raw())
    with open(conf) as src:
        lines = [x for x in src if not x.startswith("fst ")]
    path = os.path.join(d, name + ".conf")
    with open(path, "w") as fd:
        fd.writelines(lines + [f"fst = {name}.fst\n"]
                      + [f"{x}\n" for x in extra])
    return path


def write_scp(path: str, wavs) -> str:
    with open(path, "w") as fd:
        for i, wav in enumerate(wavs):
            fd.write(f"u{i} {wav}\n")
    return path


# The streaming tests' decoder geometry (tests/test_streaming.py's TEST_BEAM).
STREAM_BEAM = dict(beam_size=256, expand_size=2048, eps_expand_size=1024,
                   max_eps_iters=6, beam=1e9, am_scale=0.1)


def write_stream_toy(d: str, data_dir: str, quantized: bool = False,
                     cmvn: bool = False) -> str:
    """tests/test_streaming.py's toy model (5 words, hidden 32, 24 pdfs,
    default seed) in `d`, with `quantized = true` and the CMVN stats of
    tests/data when asked; returns the config path."""
    import os
    import shutil

    from catears_tpu_torch.tools.toy import write_toy_model

    conf = write_toy_model(d, num_words=5, hidden=32, num_pdfs=24)
    extra = []
    if quantized:
        extra.append("quantized = true")
    if cmvn:
        shutil.copy(os.path.join(data_dir, "cmvn_stats.bin"),
                    os.path.join(d, "cmvn_stats.bin"))
        extra.append("cmvn_stats = cmvn_stats.bin")
    with open(conf, "a") as fd:
        fd.write("".join(f"{x}\n" for x in extra))
    return conf


def wav_payload(path: str, truncate: int = 0):
    """(WaveFormat of the port, PCM payload bytes) of a wav file."""
    from catears_tpu_torch.io.wav import read_pcm_header

    with open(path, "rb") as fd:
        fmt = read_pcm_header(fd)
        payload = fd.read()
    return fmt, payload[:truncate] if truncate else payload


# -- the delta-LM walk's corner cases (shared by the CPU parity tests and
# the card's kernel tests, which need no JAX) -------------------------------

CHAIN_QUERY = 3  # a unigram every chain state's first bucket overflows on
CHAIN_MISS = 41  # a label no state has an arc for
CHAIN_UNIGRAMS = 40  # state 0 has labels 1..40


def chain_delta(fst, depth: int = 10, seed: int = 11):
    """(G', queries): a delta-LM G' built by `fst` (the JAX package's
    graph.fst or the port's) whose walks reach every branch of the loop, and
    (state, label) queries that take each branch.

    States 1..depth form a backoff chain 1 -> 2 -> ... -> depth -> 0 with
    weights 0.25 s; state depth + 1 backs off straight to 0.  Each chain
    state has its own label 50 + s and five labels that share
    CHAIN_QUERY's first-choice bucket, so that bucket overflows: one of the
    five sits in its second-choice bucket, and CHAIN_QUERY probes both
    buckets of every chain state before it backs off.  State 0 has
    unigram arcs for labels 1..CHAIN_UNIGRAMS.  The queries: CHAIN_QUERY
    from state 1 (the whole chain, past any max_backoff below depth), own
    labels at every depth, the colliding labels, CHAIN_MISS (a full backoff
    miss), labels past the unigram and small_lm tables, and state 0.
    The colliding labels are the first five from `skip` on whose hash
    build settles on its first seed, which they were chosen for.
    """
    from catears_tpu_torch.graph import fst as tfst
    from catears_tpu_torch.graph.device import lm_arrays

    for skip in range(0, 200, 5):
        delta, queries = _chain_delta(tfst, depth, seed, skip)
        meta = lm_arrays(delta)[1]
        if (meta["hash_seed1"], meta["hash_mask"]) == _CHAIN_HASH:
            return _chain_delta(fst, depth, seed, skip)
    raise AssertionError("no colliding labels settle the hash build")


_CHAIN_HASH = (0x1234, 255)  # the hash build's first attempt at < 512 keys


def _chain_delta(fst, depth: int, seed: int, skip: int):
    import types

    from catears_tpu_torch.graph.device import _lm_hash_np

    seed1, mask = _CHAIN_HASH
    rng = np.random.RandomState(seed)
    cand = np.arange(100, 2**16, dtype=np.int32)
    src, dst, lab, wts = [], [], [], []
    colliding = {}
    for s in range(1, depth + 2):
        src.append(s)
        dst.append(s + 1 if s < depth else 0)
        lab.append(0)
        wts.append(0.25 * s)
        src.append(s)
        dst.append(rng.randint(1, depth + 2))
        lab.append(50 + s)
        wts.append(rng.rand())
        if s > depth:
            continue
        h = _lm_hash_np(np.full(cand.size, s, np.int32), cand, seed1, mask)
        hq = _lm_hash_np(np.array([s], np.int32),
                         np.array([CHAIN_QUERY], np.int32), seed1, mask)[0]
        colliding[s] = [int(lb) for lb in cand[h == hq][skip:skip + 5]]
        for lb in colliding[s]:
            src.append(s)
            dst.append(0)
            lab.append(lb)
            wts.append(rng.rand())
    for u in range(1, CHAIN_UNIGRAMS + 1):
        src.append(0)
        dst.append(rng.randint(1, depth + 2))
        lab.append(u)
        wts.append(3.0 * rng.rand())
    order = np.lexsort((lab, src))
    lm = fst.LmFst.from_arrays(
        start=0, final=np.zeros(depth + 2, np.float32),
        state_of_arc=np.asarray(src, np.int64)[order],
        arc_next=np.asarray(dst)[order],
        arc_ilabel=np.asarray(lab, np.int32)[order],
        arc_olabel=np.asarray(lab, np.int32)[order],
        arc_weight=np.asarray(wts, np.float32)[order])
    small = (rng.rand(60) * 2).astype(np.float32)
    delta = fst.DeltaLmFst(small, lm, types.SimpleNamespace(bos_id=1,
                                                            eos_id=2))
    past = max(lab) + 7  # past both the unigram and the small_lm tables
    queries = [(0, u) for u in range(1, CHAIN_UNIGRAMS + 1)]
    queries += [(0, CHAIN_MISS), (0, past), (depth + 1, 5),
                (depth + 1, CHAIN_MISS), (depth + 1, 50 + depth + 1),
                (depth + 1, past)]
    for s in range(1, depth + 1):
        queries += [(s, CHAIN_QUERY), (s, CHAIN_MISS), (s, past)]
        queries += [(s, 50 + t) for t in range(s, depth + 1)]
        queries += [(s, lb) for lb in colliding[s]]
    return delta, queries


def walk_lanes(queries, rows: int, e: int, seed: int,
               density=(0.45, 0.05, 0.0, 0.7)):
    """[rows, e] int32 (states, labels): row r holds about density[r] * e
    active lanes drawn from `queries` (with repeats) at random positions;
    the other lanes are inactive (label 0 or negative) on random states."""
    rng = np.random.RandomState(seed)
    q = np.asarray(queries, np.int32)
    states = rng.randint(-1, 50, size=(rows, e)).astype(np.int32)
    labels = np.where(rng.rand(rows, e) < 0.5, 0,
                      -rng.randint(1, 5, size=(rows, e))).astype(np.int32)
    for r in range(rows):
        on = rng.rand(e) < density[r % len(density)]
        pick = q[rng.randint(0, len(q), size=int(on.sum()))]
        states[r, on], labels[r, on] = pick[:, 0], pick[:, 1]
    return states, labels


def big_lm_queries(num_states: int, num_words: int, n: int, seed: int):
    """(states, labels) int32 [n]: tests/test_graph.py's mix on a
    make_big_lm G' (unigram state 0, bigram histories, trigram states,
    post-BOS; frequent labels and misses)."""
    rng = np.random.RandomState(seed)
    states = np.concatenate([
        np.zeros(n // 8, np.int64), rng.randint(1, num_words + 1, n // 2),
        rng.randint(num_words + 3, num_states, n - n // 8 - n // 2 - n // 8),
        np.full(n // 8, num_words + 1)]).astype(np.int32)
    labels = np.where(rng.rand(n) < 0.7,
                      1 + (rng.pareto(1.0, n) * 40).astype(np.int64),
                      rng.randint(0, num_words + 3, size=n))
    return states, np.minimum(labels, num_words + 2).astype(np.int32)


def backtrace_case(seed: int, t: int, b: int, k: int, w: int):
    """(prev_slot [T, B, K], words [T, B, K, W], best_slots [B]) int32:
    random backpointers with early -1 roots (about 1 in 40), words with
    zeros, and negative best slots on some utterances."""
    rng = np.random.RandomState(seed)
    prev = rng.randint(0, k, (t, b, k)).astype(np.int32)
    prev[rng.rand(t, b, k) < 0.025] = -1
    prev[0] = -1  # the decode root
    words = np.where(rng.rand(t, b, k, w) < 0.6, 0,
                     rng.randint(1, 50_000, (t, b, k, w))).astype(np.int32)
    best = rng.randint(0, k, b).astype(np.int32)
    best[rng.rand(b) < 0.25] = -1
    return prev, words, best


# The eps-free frame kernels' cases (tests/test_torch_frame_kernels.py on
# the CPU, tests/test_torch_cuda.py on the card).
SENTINEL_STATE = 2**30  # decode/beam.py's


def _bits(u):
    return np.array([u], np.uint32).view(np.float32)[0]


NEG_NAN = _bits(0xFFC00000)  # a NaN with its sign bit set


def adversarial_rows(seed, e=96, k=8):
    """{name: (state, lm, cost, w1, w2, tok, olab2, olabel) of one row}."""
    rng = np.random.RandomState(seed)

    def row(n_states, costs, lm_hi=3):
        s = rng.randint(0, n_states, e).astype(np.int32) + 10
        c = rng.choice(np.asarray(costs, np.float32), e).astype(np.float32)
        lmv = rng.randint(-2, lm_hi, e).astype(np.int32)
        w1 = rng.choice(np.float32([0.0, -0.0, 0.5, 1.25]), e)
        w2 = rng.choice(np.float32([0.0, 0.25, -0.75]), e)
        pay = [rng.randint(0, 1000, e).astype(np.int32) for _ in range(3)]
        return [s, lmv, c, w1.astype(np.float32), w2.astype(np.float32),
                *pay]

    rows = {}
    # Cross-group and in-group cost ties, +-0.0, a negative state.
    r = row(30, [1.0, 2.0, 0.0, -0.0, 3.5])
    r[0][5] = -5
    rows["ties"] = r
    # +inf and NaN lanes (both signs), some in groups with finite lanes.
    r = row(12, [1.0, 2.0, 4.0])
    r[2][::7] = np.inf
    r[2][3::11] = np.nan
    r[2][5::13] = NEG_NAN
    rows["inf-nan"] = r
    # A -inf winner: its slot is empty and sorts first.
    r = row(20, [3.0, 5.0])
    r[2][17] = -np.inf
    rows["neg-inf"] = r
    # Sentinel states (and above) with the cheapest costs: never kept.
    r = row(20, [2.0, 3.0])
    r[0][::3] = SENTINEL_STATE
    r[0][1::9] = 2**31 - 1
    r[2][::3] = -50.0
    rows["sentinel"] = r
    # Finite winners past min + beam (their lm stays in the beam).
    r = row(40, [0.0])
    r[0][:] = 10 + np.arange(e) % 12
    r[1][:] = 3
    r[2][:] = np.where(r[0] < 13, 0.5, 30.0 + r[0]).astype(np.float32)
    rows["threshold"] = r
    # Fewer than K winners, exactly K, more than K.
    r = row(3, [1.0, 2.0])
    r[1][:] = 7
    rows["few"] = r
    r = row(1, [1.0])
    r[0][:] = 10 + np.arange(e) % k
    r[1][:] = 0
    rows["exactly-k"] = r
    rows["many"] = row(e, np.linspace(-3, 20, 57))
    # Every lane dead.
    r = row(5, [1.0])
    r[0][:] = SENTINEL_STATE
    r[2][:] = np.inf
    rows["dead"] = r
    return rows


def random_beam(td, seed, b, k):
    """A beam of k slots per row: tokens on high-fanout states and on any
    state, empty slots (state -1, cost +inf), random LM states."""
    rng = np.random.RandomState(seed)
    n_emit = to_np(td.state_packed)[:, 3]
    wide = np.flatnonzero(n_emit > td.group)
    states = np.where(rng.rand(b, k) < 0.5, rng.choice(wide, (b, k)),
                      rng.randint(0, td.num_states, (b, k))).astype(np.int32)
    states[rng.rand(b, k) < 0.2] = -1
    costs = np.where(states >= 0, rng.uniform(0, 12, (b, k)),
                     np.inf).astype(np.float32)
    lms = rng.randint(0, 50, (b, k)).astype(np.int32)
    return states, costs, lms


def tied_rows(seed, lm_on, e=2000):
    """Three [E] candidate rows with more winners than a beam of 64 whose
    costs tie in bulk (the selection's radix digits run past the cost):
    (state, lm or None, cost, None, w2 or None, tok, olab2, olabel)."""
    rng = np.random.RandomState(seed)
    state = rng.randint(0, 300, (3, e)).astype(np.int32)
    state[1] = rng.randint(0, 5, e)  # few states: the lm digits decide
    lmv = rng.randint(0, 40 if lm_on else 1, (3, e)).astype(np.int32)
    cost = rng.choice(np.float32([0.5, 1.0, -0.0, 0.0, 7.0]),
                      (3, e)).astype(np.float32)
    cost[2] = rng.uniform(-5, 30, e).astype(np.float32)
    w2 = rng.choice(np.float32([0.0, 0.125]), (3, e)).astype(np.float32)
    pay = [rng.randint(0, 10**6, (3, e)).astype(np.int32) for _ in range(3)]
    return [state, lmv if lm_on else None, cost, None,
            w2 if lm_on else None, *pay]


SELECT_HASH = 0x9E3779B97F4A7C15  # csrc/frame_select.cu's group hash


def group_home(state, lm, bits: int) -> np.ndarray:
    """The top `bits` bits of frame_select.cu's hash of each (state, lm)
    group key (lm None: LM off, 0): the CTA, of 2**bits, whose table
    slice holds the group's home slot."""
    lm = np.zeros_like(state) if lm is None else lm
    key = ((np.asarray(state).astype(np.uint64) ^ np.uint64(0x80000000))
           & np.uint64(0xFFFFFFFF)) << np.uint64(32)
    key |= np.asarray(lm).astype(np.int64).astype(np.uint64) & np.uint64(
        0xFFFFFFFF)
    with np.errstate(over="ignore"):
        prod = key * np.uint64(SELECT_HASH)
    return (prod >> np.uint64(64 - bits)).astype(np.int64)


def beam_rows(seed, b, e, lm_on, weights=True, one_slice=False):
    """[B, E] candidate rows shaped like a frame's: a quarter of the lanes
    dead (state SENTINEL_STATE, cost +inf), the rest on about E/3 (state,
    lm) groups with costs 100-120 (some tied across groups), weights w1,
    w2 in eighths.  one_slice: every group's key hashes into CTA 0's table
    slice at every cluster size up to 16 (group_home(.., 4) == 0), so the
    claims probe across the slices.  Returns (state, lm or None, cost, w1,
    w2, tok, olab2, olabel) as select_beam takes them."""
    rng = np.random.RandomState(seed)
    n_groups = max(1, e // 3)
    pool_s = rng.randint(0, 4 * e + 64, 64 * n_groups).astype(np.int32)
    pool_l = (rng.randint(0, 50, 64 * n_groups) if lm_on
              else np.zeros(64 * n_groups, np.int64)).astype(np.int32)
    if one_slice:
        home = group_home(pool_s, pool_l if lm_on else None, 4) == 0
        pool_s, pool_l = pool_s[home], pool_l[home]
    pairs = np.unique(np.stack([pool_s, pool_l], 1), axis=0)
    pairs = pairs[rng.permutation(len(pairs))[:n_groups]]
    pick = rng.randint(0, len(pairs), (b, e))
    state, lmv = pairs[pick, 0], pairs[pick, 1]
    cost = (100 + rng.uniform(0, 20, (b, e))).astype(np.float32)
    tie = rng.rand(b, e) < 0.2
    cost[tie] = np.round(cost[tie] * 4) / 4
    dead = rng.rand(b, e) < 0.25
    state = np.where(dead, SENTINEL_STATE, state).astype(np.int32)
    cost[dead] = np.inf
    w1 = (rng.randint(-8, 8, (b, e)) / 8).astype(np.float32)
    w2 = (rng.randint(0, 8, (b, e)) / 8).astype(np.float32)
    pay = [rng.randint(0, 10**6, (b, e)).astype(np.int32) for _ in range(3)]
    return [state, lmv.astype(np.int32) if lm_on else None, cost,
            w1 if weights else None, w2 if weights else None, *pay]


def with_live_lanes(cols, live, seed):
    """beam_rows' columns with row r holding live[r] live lanes (state <
    SENTINEL_STATE), the rest dead (state SENTINEL_STATE, cost +inf); a
    None keeps every lane live (the dead ones take a live lane's group and
    a cost of 100-120).  Returns new columns; `cols` is left as it was."""
    rng = np.random.RandomState(seed)
    cols = [None if c is None else c.copy() for c in cols]
    state, lmv, cost = cols[0], cols[1], cols[2]
    for r, n in enumerate(live):
        alive = np.flatnonzero(state[r] < SENTINEL_STATE)
        dead = np.flatnonzero(state[r] >= SENTINEL_STATE)
        if n is None:
            src = rng.choice(alive, len(dead))
            state[r, dead] = state[r, src]
            if lmv is not None:
                lmv[r, dead] = lmv[r, src]
            cost[r, dead] = 100 + rng.uniform(0, 20, len(dead))
        else:
            kill = np.setdiff1d(alive, rng.choice(alive, n, replace=False))
            state[r, kill] = SENTINEL_STATE
            cost[r, kill] = np.inf
    return cols


def runner_trie(mode: str, lm: bool, device, chunk: int, cfg):
    """A BatchDecoder of the small planted trie (120 words, with its G'
    when `lm`) in graph mode `mode`: "eps-free" (prepare_decode_graph's),
    "closed" (close_epsilons at depth 1, a prebuilt dfst) or "raw"
    (close_eps=False).  Returns (decoder, TrieGraph)."""
    from catears_tpu_torch.decode.decoder import BatchDecoder
    from catears_tpu_torch.graph.device import DeviceFst
    from catears_tpu_torch.graph.transform import close_epsilons
    from catears_tpu_torch.tools.biggraph import make_big_lm, make_trie_graph

    tg = make_trie_graph(np.random.RandomState(1), num_words=120,
                         num_phones=25, bigram_states=30, variants=2)
    delta = (make_big_lm(np.random.RandomState(9),
                         num_words=tg.num_words).delta_lm() if lm else None)
    if mode == "closed":
        closed = close_epsilons(tg.fst)[0]
        dfst = DeviceFst.build(closed, tg.tid2pdf, group=2, eps_depth_cap=1,
                               csr_group=16, device=device)
        dec = BatchDecoder(closed, tg.tid2pdf, config=cfg, dfst=dfst,
                           delta_lm=delta, chunk_frames=chunk)
    else:
        dec = BatchDecoder(tg.fst, tg.tid2pdf, config=cfg, arc_group=2,
                           csr_group=16, close_eps=mode == "eps-free",
                           delta_lm=delta, chunk_frames=chunk, device=device)
    assert dec.dfst.eps_removed == (mode == "eps-free")
    return dec, tg


def eager_frame_loop(dec, logp, lengths, cfg):
    """BatchDecoder `dec`'s frame loop as the plain eager loop:
    init_beam_batch, then decode_chunk over chunks of the batch's real
    frames (the last one shorter, nothing padded), the traces stacked
    after the zero-padded init trace.  Returns (final beam, [1 + T, ...]
    traces), numpy."""
    from catears_tpu_torch.decode.beam import decode_chunk, init_beam_batch

    dev = dec.dfst.device
    lp = torch.as_tensor(logp, dtype=torch.float32).to(dev)
    b, t, _ = lp.shape
    c = dec.chunk_frames
    beam, init = init_beam_batch(cfg, b, dec.dfst, dec.dlm)
    valid = torch.as_tensor(np.arange(t)[:, None]
                            < np.asarray(lengths)[None, :], device=dev)
    prevs, words = [init.prev_slot[None]], [init.words[None]]
    for off in range(0, t, c):
        beam, tr = decode_chunk(cfg, dec.dfst, beam,
                                lp.transpose(0, 1)[off:off + c],
                                valid[off:off + c], dec.dlm)
        prevs.append(tr.prev_slot)
        words.append(tr.words)
    pad = words[-1].shape[-1] - words[0].shape[-1]
    words[0] = torch.nn.functional.pad(words[0], (0, pad))
    return ([to_np(x) for x in beam],
            [to_np(torch.cat(prevs)), to_np(torch.cat(words))])


def runner_decode(dec, logp, lengths, **kw):
    """dec.decode(logp, lengths, **kw) with what its chunk runner left:
    (hypotheses, the final beam, the decode's [1 + T, ...] traces as the
    device backtrace got them, the config decoded at), numpy."""
    from catears_tpu_torch.decode import decoder as tdecoder

    seen = {}
    runner_for, backtrace = dec._runner, tdecoder._device_backtrace

    def spy_runner(*args):
        seen["runner"] = runner_for(*args)
        return seen["runner"]

    def spy_backtrace(*args):
        seen["traces"] = [to_np(x) for x in args[5]]
        return backtrace(*args)

    dec._runner = spy_runner
    tdecoder._device_backtrace = spy_backtrace
    try:
        hyps = dec.decode(logp, lengths, **kw)
    finally:
        del dec._runner
        tdecoder._device_backtrace = backtrace
    runner = seen["runner"]
    return (hyps, [to_np(x) for x in runner.beam], seen["traces"],
            runner.cfg)


def assert_runner_equals_eager(dec, logp, lengths, **kw):
    """The decode through the chunk runner (padded chunks over static
    buffers; a graph replay on a card) equals the eager loop at the config
    it decoded at, byte for byte: the final beam (overflow and hiwater
    included), the traces, and the words and weights the device backtrace
    gives the eager traces.  Returns the runner's result."""
    from catears_tpu_torch.decode import decoder as tdecoder
    from catears_tpu_torch.decode.beam import FrameTrace
    from catears_tpu_torch.decode.hyp import assemble_words

    got = runner_decode(dec, logp, lengths, **kw)
    hyps, beam, traces, cfg = got
    ref_beam, ref_traces = eager_frame_loop(dec, logp, lengths, cfg)
    for name, x, y in zip(("states", "lm", "costs", "bp", "overflow",
                           "hiwater"), ref_beam, beam):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    for name, x, y in zip(("prev_slot", "words"), ref_traces, traces):
        assert x.shape == y.shape and x.tobytes() == y.tobytes(), name
    dev = dec.dfst.device
    ref = tdecoder._device_backtrace(
        dec.dfst, dec.delta_lm, ref_beam[0], ref_beam[1], ref_beam[2],
        FrameTrace(*(torch.from_numpy(x).to(dev) for x in ref_traces)),
        kw.get("final_fallback", False))
    assert [h.words for h in hyps] == [
        [] if empty else assemble_words(fw) for fw, _, empty in ref]
    assert [h.weight for h in hyps] == [
        0.0 if empty else total for _, total, empty in ref]
    return got
