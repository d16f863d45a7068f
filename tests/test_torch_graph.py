"""PyTorch port of DeviceFst.build vs the JAX build: tables byte-equal.

Covers the classic [S, G*5+8] row (arc groups 1 and 4) and the compact
9-lane row (G=2, eps-removed), on the toy model's graph, the phone loop
and a small trie; plus the static graph measures the decoder keys on.
"""

import numpy as np
import pytest
import torch

from _torch_parity import CPU, DFST_META, assert_same, dfst_from_jax
from catears_tpu.graph import device as jdev
from catears_tpu.graph import fst as jfst
from catears_tpu.graph import transform as jtransform
from catears_tpu.tools import biggraph as jbiggraph
from catears_tpu.tools import toy as jtoy
from catears_tpu_torch.graph import device as tdev
from catears_tpu_torch.graph import fst as tfst
from catears_tpu_torch.graph import transform as ttransform
from catears_tpu_torch.tools import biggraph as tbiggraph
from catears_tpu_torch.tools import toy as ttoy
from catears_tpu_torch.utils.errors import CorruptionError

# Each package builds its own graphs from the same seeds.
JAX = (jtoy, jbiggraph, jfst)
PORT = (ttoy, tbiggraph, tfst)


def _toy(toy, biggraph, fst):
    g = toy.make_phone_loop_graph(np.random.RandomState(0), num_words=6,
                                  num_pdfs=48)
    return fst.FlatFst.from_raw(g.fst), g.tid2pdf


def _loop(toy, biggraph, fst):
    g = toy.make_phone_loop_graph(np.random.RandomState(42), num_words=30,
                                  num_pdfs=32)
    return fst.FlatFst.from_raw(g.fst), g.tid2pdf


def _trie(toy, biggraph, fst):
    g = biggraph.make_trie_graph(np.random.RandomState(1), num_words=120,
                                 num_phones=25, bigram_states=30, variants=2)
    return g.fst, g.tid2pdf


GRAPHS = {"toy": _toy, "loop": _loop, "trie": _trie}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("group,csr_group", [(1, None), (2, None), (2, 16),
                                             (4, None)])
def test_build_byte_equal(graph, group, csr_group):
    fst, tid2pdf = GRAPHS[graph](*JAX)
    g2, olab2, mode = jtransform.prepare_decode_graph(fst)
    assert mode == "eps_free"
    jd = jdev.DeviceFst.build(g2, tid2pdf, group=group, eps_depth_cap=1,
                              csr_group=csr_group, olabel2=olab2)
    fst, tid2pdf = GRAPHS[graph](*PORT)
    g2, olab2, mode = ttransform.prepare_decode_graph(fst)
    assert mode == "eps_free"
    td = tdev.DeviceFst.build(g2, tid2pdf, group=group, eps_depth_cap=1,
                              csr_group=csr_group, olabel2=olab2, device=CPU)
    for name in tdev.TABLES:
        assert_same(getattr(jd, name), getattr(td, name), name)
    assert int(jd.start) == td.start
    for name in DFST_META:
        assert getattr(jd, name) == getattr(td, name), name
    assert td.emit_compact == (group == 2)


def test_raw_graph_layout_and_measures():
    """Without epsilon removal (lane 4 = dest eps metadata)."""
    fst, tid2pdf = _loop(*JAX)
    tfst_, _ = _loop(*PORT)
    jd = jdev.DeviceFst.build(fst, tid2pdf, group=4)
    td = tdev.DeviceFst.build(tfst_, tid2pdf, group=4, device=CPU)
    for name in tdev.TABLES:
        assert_same(getattr(jd, name), getattr(td, name), name)
    assert td.eps_depth == jdev._eps_depth(fst) == tdev._eps_depth(tfst_)
    for a, b in zip(jdev._per_state_arc_counts(fst),
                    tdev._per_state_arc_counts(tfst_)):
        assert np.array_equal(a, b)
    for g, k, distinct in ((1, 2, True), (4, 64, True), (2, 16, False)):
        assert (jdev.expansion_bounds(fst, g, k, distinct, csr_group=8)
                == tdev.expansion_bounds(tfst_, g, k, distinct, csr_group=8))


def test_from_numpy_round_trip():
    fst, tid2pdf = _trie(*JAX)
    g2, olab2, _ = jtransform.prepare_decode_graph(fst)
    jd = jdev.DeviceFst.build(g2, tid2pdf, group=2, eps_depth_cap=1,
                              csr_group=16, olabel2=olab2)
    td = dfst_from_jax(jd)
    assert td.device == torch.device("cpu") and td.num_states == g2.num_states
    for name in tdev.TABLES:
        assert_same(getattr(jd, name), getattr(td, name), name)


def test_corrupt_ilabel_fails_loudly():
    fst, tid2pdf = _toy(*PORT)
    with pytest.raises(CorruptionError):
        tdev.DeviceFst.build(fst, tid2pdf[:tid2pdf.size // 2], device=CPU)
