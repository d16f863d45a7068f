"""The generators: the same arrays for the same seed, others for another,
and the frozen copies equal to the program's tools at seed 0 (so the
cells carry the workload of the earlier records)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from asrbench import gen


def small_trie(seed):
    return gen.make_trie_graph(gen.rng_for(seed, "graph"), num_words=300,
                               num_phones=25, bigram_states=30, variants=2)


def arrays(obj):
    return {k: v for k, v in vars(obj).items() if isinstance(v, np.ndarray)}


def test_same_seed_same_inputs_other_seed_others():
    a, b, c = small_trie(2**40 + 7), small_trie(2**40 + 7), small_trie(8)
    for k, v in arrays(a).items():
        assert np.array_equal(v, arrays(b)[k])
    assert not np.array_equal(a.weight, c.weight) or a.src.size != c.src.size
    la = gen.make_big_lm(gen.rng_for(3, "lm"), 200)
    lb = gen.make_big_lm(gen.rng_for(3, "lm"), 200)
    lc = gen.make_big_lm(gen.rng_for(4, "lm"), 200)
    assert np.array_equal(la.weight, lb.weight)
    assert not np.array_equal(la.weight, lc.weight)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(gen.torch_seed(5, "w"))
    g2.manual_seed(gen.torch_seed(5, "w"))
    w1 = gen.tdnn_device(g1, "cpu", 40, 16, 30, 2, (-1, 0, 1))
    w2 = gen.tdnn_device(g2, "cpu", 40, 16, 30, 2, (-1, 0, 1))
    assert all(torch.equal(x["w"], y["w"]) for x, y in zip(w1, w2)
               if x["kind"] == "linear")
    lens = np.sort(gen.quantile_lengths(64, 7.4, 0.63, 1.5, 35.0))
    b1 = gen.stratified_batches(gen.rng_for(1, "deal"), 64, 4)
    b2 = gen.stratified_batches(gen.rng_for(2, "deal"), 64, 4)
    assert sorted(np.concatenate(b1)) == list(range(64))
    assert np.isclose(sum(lens[b].max() for b in b1),
                      sum(lens[b].max() for b in b2))
    assert not all(np.array_equal(x, y) for x, y in zip(b1, b2))
    p1 = gen.live_phases(gen.rng_for(1, "phase"), 70, 0.2)
    p2 = gen.live_phases(gen.rng_for(2, "phase"), 70, 0.2)
    assert np.allclose(np.sort(p1), np.sort(p2))
    assert not np.allclose(p1, p2)


def test_device_forms_keep_the_distributions():
    g = torch.Generator()
    g.manual_seed(1)
    layers = gen.tdnn_device(g, "cpu", 40, 256, 300, 2, (-1, 0, 1))
    w = [x["w"] for x in layers if x["kind"] == "linear"]
    assert [tuple(x.shape) for x in w] == [(120, 256), (768, 256), (256, 300)]
    assert abs(float(w[1].std()) * np.sqrt(768) - 1) < 0.05
    assert gen.tdnn_context(layers) == (2, 2)
    trie = small_trie(3)
    targets = [gen.plant_targets(gen.rng_for(3, "p"), trie, n)[0]
               for n in (50, 80)]
    lp = gen.plant_device(targets, trie.num_pdfs, 10.0, g, "cpu")
    assert lp.shape == (2, 80, trie.num_pdfs)
    assert torch.equal(lp[1].argmax(-1), torch.as_tensor(
        targets[1], dtype=torch.int64))
    assert torch.allclose(lp[0, :50].exp().sum(-1), torch.ones(50))
    assert float(lp[0, 50:].abs().max()) == 0.0


@pytest.mark.parametrize("num_words", [3000, 50000])
def test_copies_equal_the_programs_tools_at_seed_0(num_words):
    """bench.py's draw order from RandomState(0): the trie, planted
    paths, the TDNN-1024 x 5, the G'."""
    from catears_tpu_torch.graph.fst import FlatFst
    from catears_tpu_torch.tools import biggraph, toy

    from asrbench import system

    ours, theirs = np.random.RandomState(0), np.random.RandomState(0)
    t = gen.make_trie_graph(ours, num_words=num_words)
    p = biggraph.make_trie_graph(theirs, num_words=num_words)
    mine = system.flat_fst(t)
    for k in ("final", "offsets", "arc_next", "arc_ilabel", "arc_olabel",
              "arc_weight"):
        assert np.array_equal(getattr(mine, k), getattr(p.fst, k)), k
    assert isinstance(p.fst, FlatFst) and mine.start == p.fst.start
    assert np.array_equal(t.tid2pdf, p.tid2pdf)
    assert np.array_equal(t.word_pdf_flat, p.word_pdf_flat)
    lp1, w1 = gen.plant_logp(ours, t, 2, 120)
    lp2, w2 = biggraph.plant_logp(theirs, p, 2, 120)
    assert np.array_equal(lp1, lp2) and w1 == w2
    n1 = gen.make_toy_nnet(ours, hidden=1024, num_pdfs=t.num_pdfs,
                           num_tdnn_layers=5)
    n2 = toy.make_toy_nnet(theirs, hidden=1024, num_pdfs=p.num_pdfs,
                           num_tdnn_layers=5)
    got = system.nnet_spec(n1, n2.left_context, n2.right_context).layers
    for a, b in zip(got, n2.layers):
        for k in ("kind", "indices", "narrow_left", "narrow_right"):
            assert getattr(a, k) == getattr(b, k)
        for k in ("weight", "bias", "scale", "offset"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None)
            assert x is None or np.array_equal(x, y)
    l1 = gen.make_big_lm(ours, num_words=num_words)
    l2 = biggraph.make_big_lm(theirs, num_words=num_words)
    mine = system.delta_lm(l1)
    for k in ("final", "offsets", "arc_next", "arc_ilabel", "arc_weight"):
        assert np.array_equal(getattr(mine.lm, k), getattr(l2.lm, k)), k
    assert np.array_equal(mine.small_lm, l2.small_lm)
    assert (l1.bos_id, l1.eos_id) == (l2.bos_id, l2.eos_id)
    if num_words == 50000:
        assert (p.fst.num_states, l2.num_states) == (617_940, 100_003)
