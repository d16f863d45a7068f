"""The batch decode's host tail on the CPU: the words of a batch assembled
in one numpy pass (decode/hyp.py::assemble_words_batch) against the row
loop it replaced, the final weights the host keeps beside the device table
(DeviceFst.final_host) bit for bit, and the two reads a decode waits for
(counter `decode_host_syncs`).  On a card, tests/test_torch_cuda.py holds
a warmed decode to those two waits with every other synchronising call
raising."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_runner_equals_eager, loop_words,
                           runner_trie)
from catears_tpu_torch.decode.beam import BeamConfig
from catears_tpu_torch.decode.decoder import BatchDecoder, build_decode_graph
from catears_tpu_torch.decode.hyp import assemble_words, assemble_words_batch
from catears_tpu_torch.graph.device import DeviceFst, build_arrays
from catears_tpu_torch.graph.transform import (bfs_order, close_epsilons,
                                               renumber_states)
from catears_tpu_torch.tools.biggraph import make_trie_graph, plant_logp
from catears_tpu_torch.utils import log

CFG = BeamConfig(beam_size=64, expand_size=2048, eps_expand_size=1024,
                 max_eps_iters=4, beam=12.0, lm_expand_size=64)
TINY = BeamConfig(beam_size=64, expand_size=16, eps_expand_size=16,
                  max_eps_iters=4, beam=1e9)


def _frame_words(seed, b, t, w, layout):
    """[B, T, W] int32 words, mostly 0, some negative (never a word), as
    the backtrace gives them: contiguous ("card") or the plain version's
    transposed view ("view")."""
    rng = np.random.RandomState(seed)
    fw = (rng.randint(-2, 9, size=(b, t, w))
          * (rng.rand(b, t, w) < 0.4)).astype(np.int32)
    if layout == "view":
        fw = np.ascontiguousarray(fw.transpose(1, 0, 2)).transpose(1, 0, 2)
    return fw


ASSEMBLY = [
    (1, 0, 2, [0]),  # no rows at all
    (3, 0, 1, [0, 0, 0]),
    (1, 7, 1, [7]),
    (4, 9, 2, [9, 0, 3, 9]),  # an utterance of 0 frames, unequal lengths
    (4, 9, 1, [9, 0, 3, 9]),
    (16, 40, 2, None),  # random lengths in [0, T]
    (5, 12, 1, None),
]


@pytest.mark.parametrize("layout", ["card", "view"])
@pytest.mark.parametrize("b,t,w,rows", ASSEMBLY, ids=[
    f"b{b}-t{t}-w{w}-{'random' if r is None else 'set'}"
    for b, t, w, r in ASSEMBLY])
def test_assemble_words_batch_equals_the_row_loop(b, t, w, rows, layout):
    """Each utterance's words are the row loop's over its own first
    rows[u] rows, as Python ints; `assemble_words` is one row of it."""
    fw = _frame_words(b * 100 + t, b, t, w, layout)
    if rows is None:
        rows = np.random.RandomState(t).randint(0, t + 1, size=b).tolist()
    got = assemble_words_batch(fw, rows)
    assert got == [loop_words(fw[u][:n]) for u, n in enumerate(rows)]
    assert got == [assemble_words(fw[u][:n]) for u, n in enumerate(rows)]
    assert all(type(x) is int for words in got for x in words)
    assert assemble_words_batch(fw, np.asarray(rows) + t) == [
        loop_words(row) for row in fw]


@functools.lru_cache(maxsize=None)
def _trie():
    return make_trie_graph(np.random.RandomState(1), num_words=120,
                           num_phones=25, bigram_states=30, variants=2)


def _renumbered_closed():
    """The trie's closed graph with its states renumbered breadth-first
    (the final weights move with them)."""
    closed = close_epsilons(_trie().fst)[0]
    graph = renumber_states(closed, bfs_order(closed))
    assert not np.array_equal(graph.final, closed.final)
    return graph


@pytest.mark.parametrize("graph", ["eps-free", "closed-renumbered",
                                   "float64"])
def test_final_host_is_the_device_table_bit_for_bit(graph):
    """`final_host` is the device table's values and dtype, bit for bit,
    read-only: for the eps-free graph BatchDecoder builds, a closed graph
    with renumbered states, and a float64 table from numpy."""
    tg = _trie()
    if graph == "eps-free":
        _, dfst, _, _ = build_decode_graph(tg.fst, tg.tid2pdf, 0.1, None,
                                           CFG, 2, True, 16, CPU)
        assert dfst.eps_removed
        want = np.float32
    elif graph == "closed-renumbered":
        g = _renumbered_closed()
        dfst = DeviceFst.build(g, tg.tid2pdf, group=2, eps_depth_cap=1,
                               csr_group=16, device=CPU)
        assert dfst.final_host.tobytes() == g.final.astype(
            np.float32).tobytes()
        want = np.float32
    else:
        arrays, meta = build_arrays(tg.fst, tg.tid2pdf, group=2,
                                    csr_group=16)
        arrays["final"] = arrays["final"].astype(np.float64) / 3
        dfst = DeviceFst.from_numpy(arrays, meta, device=CPU)
        want = np.float64
    assert dfst.final_host.dtype == want
    assert dfst.final.numpy().dtype == want
    assert dfst.final_host.tobytes() == dfst.final.numpy().tobytes()
    assert not dfst.final_host.flags.writeable


@pytest.mark.parametrize("lm", [False, True])
def test_renumbered_closed_decode_equals_the_reference_tail(lm):
    """A closed graph with renumbered states, LM off and on: the decode's
    words and weights equal the eager loop's through the reference tail
    (the final weights read from the device table, the row loop)."""
    from catears_tpu_torch.tools.biggraph import make_big_lm

    tg, g = _trie(), _renumbered_closed()
    delta = (make_big_lm(np.random.RandomState(9),
                         num_words=tg.num_words).delta_lm() if lm else None)
    dfst = DeviceFst.build(g, tg.tid2pdf, group=2, eps_depth_cap=1,
                           csr_group=16, device=CPU)
    dec = BatchDecoder(g, tg.tid2pdf, config=CFG, dfst=dfst, delta_lm=delta,
                       chunk_frames=4)
    logp, _ = plant_logp(np.random.RandomState(6), tg, 3, 80)
    hyps = assert_runner_equals_eager(dec, logp, [80, 80, 23],
                                      final_fallback=True)[0]
    assert any(h.words for h in hyps)


def test_decode_reads_no_final_weight_from_the_device():
    """With the device table's final weights on the meta device (any read
    of them raises), the decode gives the same words and weights: it
    reads only the host's copy."""
    dec, tg = runner_trie("eps-free", False, CPU, 4, CFG)
    logp, _ = plant_logp(np.random.RandomState(2), tg, 3, 60)
    lengths = [60, 60, 17]
    want = [(h.words, h.weight) for h in dec.decode(logp, lengths)]
    blind = dataclasses.replace(
        dec.dfst, final=torch.empty(dec.dfst.final.shape, device="meta"))
    dec2 = BatchDecoder(dec.fst, tg.tid2pdf, config=CFG, dfst=blind,
                        chunk_frames=4)
    with pytest.raises(NotImplementedError):
        blind.final.cpu()
    assert [(h.words, h.weight) for h in dec2.decode(logp, lengths)] == want
    assert any(words for words, _ in want)


@pytest.mark.parametrize("mode,lm,tracing,host", [
    ("eps-free", False, False, False), ("eps-free", True, False, False),
    ("closed", False, False, False), ("eps-free", False, True, False),
    ("closed", True, True, False), ("eps-free", False, False, True)])
def test_decode_host_syncs_reads_two_a_decode(mode, lm, tracing, host):
    """Three decodes of a batch read `decode_host_syncs` 6: the beam's
    read and the backtrace's words (with `host`: every frame's trace for
    the host backtrace), tracing on or off, LM off or on."""
    dec, tg = runner_trie(mode, lm, CPU, 4, CFG)
    logp, _ = plant_logp(np.random.RandomState(3), tg, 3, 11)
    log.reset_metrics()
    if tracing:
        log.start_tracing()
    try:
        for _ in range(3):
            dec.decode(logp, [11, 7, 2], device_backtrace=not host,
                       final_fallback=not host)
    finally:
        if tracing:
            log.stop_tracing()
    m = log.metrics()
    log.reset_metrics()
    assert m["decode_host_syncs"] == 6


def test_decode_host_syncs_of_a_retried_decode():
    """An overflow waits once (its read) before the retry's two."""
    dec, tg = runner_trie("eps-free", False, CPU, 4, TINY)
    logp, _ = plant_logp(np.random.RandomState(5), tg, 2, 11)
    log.reset_metrics()
    dec.decode(logp, [11, 8], final_fallback=True)
    m = log.metrics()
    log.reset_metrics()
    assert m["overflow_retries"] == 1 and m["decode_host_syncs"] == 3
