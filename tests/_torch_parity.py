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
