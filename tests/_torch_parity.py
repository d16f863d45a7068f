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
             "emit_compact")
DLM_META = ("max_backoff", "hash_seed1", "hash_seed2", "hash_mask")


def to_np(x) -> np.ndarray:
    """numpy view of a torch tensor or anything np.asarray takes."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(jax_value, torch_value, what: str = "") -> None:
    """Exact equality: same dtype, shape and bytes (floats bit for bit)."""
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

    arrays = {name: np.asarray(getattr(jd, name)) for name in TABLES}
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
