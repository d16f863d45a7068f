"""GPU-only checks of the PyTorch port (marker `cuda`; skipped without a card).

Run on a machine with an NVIDIA card, where JAX need not be installed
(--noconftest skips tests/conftest.py, which imports jax):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

The int8 kernel must equal its plain version exactly, and its fused
dequant epilogue (`qmatmul`) its plain version bit for bit, for dynamic,
static (`rng`) and guarded (`grng`) activation scales, at every tile width
and on misaligned views; operands it does not take raise.  The quantized AM
on cuda, dynamic or calibrated, must be within 1% of the output range of
the same AM on the CPU; the delta-LM tables and walk on cuda must equal the
CPU's (states, bit-equal weights); the two device-loop kernels
(csrc/lm_walk.cu behind lm_propagate_capped / lm_propagate, csrc/backtrace.cu
behind backtrace_device) must equal their plain versions bit for bit on
tests/test_torch_lm_walk.py's cases, on a non-default stream, and refuse
non-contiguous or mistyped inputs; the eps-free frame's two kernels
(csrc/frame_expand.cu behind decode.beam.expand_emitting, csrc/frame_select.cu
behind decode.beam.select_beam) must equal their plain versions bit for bit
on tests/test_torch_frame_kernels.py's cases, both emit row layouts, LM off
and on, with and without the hot/cold split and select_compact, be what an
eps-free decode launches, and refuse what they do not take (the selection
also at B = 1, 8, 16 and K = 1, 2,048, 8,192, on both table storages, on
rows whose groups all hash into one CTA's slice, with its phase
stamps, and with a row mask at both held cells' shapes, also replayed in
a CUDA graph with a new mask each time); the decoder on cuda, LM off and on, on
eps-free, closed and raw graphs, must give the CPU's words and bit-equal
costs, and its replay of one CUDA graph per chunk must equal the eager
decode_chunk loop on the card byte for byte (also after an overflow's
retry, and with no stale buffer between batches), and a warmed decode's
host wait for the card only in its two counted reads.  The sharded pipeline
over logical shards of the card must equal the same mesh on the CPU, and
tools.synth's loss and gradients the CPU's.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from _torch_parity import (adversarial_rows, assert_runner_equals_eager,
                           backtrace_case, beam_rows, big_lm_queries,
                           chain_delta, group_home, random_beam, runner_trie,
                           tied_rows, walk_lanes, with_live_lanes)
from catears_tpu_torch.am import quant
from catears_tpu_torch.am.model import AcousticModel
from catears_tpu_torch.decode.beam import BeamConfig
from catears_tpu_torch.decode.decoder import BatchDecoder
from catears_tpu_torch.graph import device as tdevice
from catears_tpu_torch.graph.fst import FlatFst
from catears_tpu_torch.io.config import Configuration
from catears_tpu_torch.runtime.batch import batched_logp
from catears_tpu_torch.tools.toy import make_phone_loop_graph, write_toy_model

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("b,m,k,n", [(1, 37, 7, 5), (3, 300, 130, 1000),
                                     (2, 129, 33, 17), (8, 1638, 120, 1024),
                                     (2, 1636, 3072, 1024)])
def test_matmul_s8_exact(cuda, b, m, k, n):
    g = torch.Generator().manual_seed(b * m + k * n)
    a = torch.randint(-128, 128, (b, m, k), dtype=torch.int8, generator=g)
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8, generator=g)
    before = quant.matmul_s8.launches
    got = quant.matmul_s8(a.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert quant.matmul_s8.launches == before + 1
    assert torch.equal(got, quant.matmul_s8_ref(a.to(cuda), w.to(cuda)))
    assert torch.equal(got.cpu(), quant.matmul_s8_ref(a, w))


@pytest.mark.parametrize("offset", [1, 8])
def test_matmul_s8_exact_on_misaligned_views(cuda, offset):
    # Contiguous views whose data does not start on a 16-byte boundary, with
    # k and n multiples of 16 (the rows the kernel would load 16 at a time).
    b, m, k, n = 2, 150, 64, 48
    g = torch.Generator().manual_seed(offset)
    a_buf = torch.randint(-128, 128, (offset + b * m * k,), dtype=torch.int8,
                          generator=g)
    w_buf = torch.randint(-128, 128, (offset + k * n,), dtype=torch.int8,
                          generator=g)
    a = a_buf[offset:].view(b, m, k)
    w = w_buf[offset:].view(k, n)
    a_dev = a_buf.to(cuda)[offset:].view(b, m, k)
    w_dev = w_buf.to(cuda)[offset:].view(k, n)
    assert a_dev.data_ptr() % 16 and w_dev.data_ptr() % 16
    got = quant.matmul_s8(a_dev, w_dev)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), quant.matmul_s8_ref(a, w))


def test_matmul_s8_rejects_non_contiguous(cuda):
    a = torch.zeros((4, 8), dtype=torch.int8, device=cuda)
    w = torch.zeros((2, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        quant.matmul_s8(a, w.t())


def _quantized_operands(b, m, k, n, scales, seed):
    """Activations [b, m, k] quantized dynamically, with one static range
    (`rng`) or with the range widened per utterance (`grng`); a quantized
    weight [k, n], its column sums and a bias; all on the CPU."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(b, m, k) * rng.uniform(0.5, 3.0, (b, 1, 1))
                          + rng.uniform(-1, 1, (b, 1, 1))).astype(np.float32))
    if scales == "dynamic":
        aq = quant.quantize(x)
    elif scales == "rng":
        aq = quant.quantize_static(x, torch.tensor(-1.5), torch.tensor(2.0))
    else:
        aq = quant.quantize_static(
            x, torch.minimum(torch.amin(x, dim=(-2, -1)), torch.tensor(-1.5)),
            torch.maximum(torch.amax(x, dim=(-2, -1)), torch.tensor(2.0)))
    wq = quant.quantize(torch.from_numpy(
        (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)))
    colsum = torch.sum(wq.values.to(torch.int32), dim=0).to(torch.float32)
    bias = torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32))
    return aq, wq, colsum, bias


def _to(q, dev):
    return quant.QuantizedTensor(*(t.to(dev) for t in q))


@pytest.mark.parametrize("scales", ["dynamic", "rng", "grng"])
@pytest.mark.parametrize("b,m,k,n,bn", [
    (8, 1638, 120, 1024, 256), (2, 1636, 3072, 1024, 256),
    (2, 1636, 1024, 3600, 240), (3, 37, 7, 5, 128), (2, 129, 33, 250, 256),
    (2, 300, 130, 470, 240), (1, 200, 64, 384, 128)])
def test_qmatmul_fused_bit_equal(cuda, scales, b, m, k, n, bn):
    """The fused epilogue on the card equals the plain version on the card
    bit for bit, with and without the bias, at every tile width (N picks
    it)."""
    assert quant.tile_width(n) == bn
    aq, wq, colsum, bias = _quantized_operands(b, m, k, n, scales, b * m + n)
    aq, wq = _to(aq, cuda), _to(wq, cuda)
    colsum, bias = colsum.to(cuda), bias.to(cuda)
    before = (quant.qmatmul.launches, quant.matmul_s8.launches)
    got = quant.qmatmul(aq, wq, colsum, bias=bias,
                        bt=quant.transpose_pad(wq.values))
    ref = quant.qmatmul_ref(aq, wq, colsum, bias)
    torch.cuda.synchronize()
    assert (quant.qmatmul.launches, quant.matmul_s8.launches) == (
        before[0] + 1, before[1])
    assert got.dtype == torch.float32 and got.shape == (b, m, n)
    assert torch.equal(got, ref)
    assert torch.equal(quant.qmatmul(aq, wq, colsum),
                       quant.qmatmul_ref(aq, wq, colsum))


@pytest.mark.parametrize("bn,n", [(128, 384), (240, 480), (256, 768)])
def test_matmul_s8_exact_at_every_tile_width(cuda, bn, n):
    assert quant.tile_width(n) == bn
    g = torch.Generator().manual_seed(bn)
    a = torch.randint(-128, 128, (3, 300, 200), dtype=torch.int8, generator=g)
    w = torch.randint(-128, 128, (200, n), dtype=torch.int8, generator=g)
    got = quant.matmul_s8(a.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), quant.matmul_s8_ref(a, w))


@pytest.mark.parametrize("offset", [1, 8])
def test_qmatmul_on_misaligned_views(cuda, offset):
    aq, wq, colsum, bias = _quantized_operands(2, 150, 64, 48, "dynamic",
                                               offset)
    buf = torch.zeros(offset + aq.values.numel(), dtype=torch.int8,
                      device=cuda)
    values = buf[offset:].view(aq.values.shape)
    values.copy_(aq.values.to(cuda))
    assert values.data_ptr() % 16
    aq = quant.QuantizedTensor(values, aq.scale.to(cuda),
                               aq.zero_point.to(cuda))
    wq = _to(wq, cuda)
    got = quant.qmatmul(aq, wq, colsum.to(cuda), bias=bias.to(cuda))
    ref = quant.qmatmul_ref(aq, wq, colsum.to(cuda), bias.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_cuda_operands_of_unsupported_shape_or_type_raise(cuda):
    aq, wq, colsum, bias = _quantized_operands(2, 40, 32, 24, "dynamic", 0)
    aq, wq = _to(aq, cuda), _to(wq, cuda)
    colsum, bias = colsum.to(cuda), bias.to(cuda)
    with pytest.raises(TypeError):
        quant.matmul_s8(aq.values.float(), wq.values)
    with pytest.raises(ValueError):
        quant.matmul_s8(aq.values[None], wq.values)
    with pytest.raises(ValueError):  # a transposed weight of another shape
        quant.matmul_s8(aq.values, wq.values,
                        bt=quant.transpose_pad(wq.values)[:, :16])
    with pytest.raises(TypeError):
        quant.qmatmul(aq, wq, colsum, bias=bias.double())
    with pytest.raises(ValueError):
        quant.qmatmul(aq, wq, colsum[:-1], bias=bias)
    with pytest.raises(ValueError):  # 3 scales for 2 matrices
        quant.qmatmul(quant.QuantizedTensor(
            aq.values, torch.ones(3, device=cuda),
            torch.zeros(3, dtype=torch.int32, device=cuda)), wq, colsum)


@pytest.fixture
def toy_quant_conf(tmp_path):
    conf = write_toy_model(str(tmp_path), rng=np.random.RandomState(5),
                           num_words=20, hidden=64, num_pdfs=96)
    with open(conf, "a") as fd:
        fd.write("quantized = true\n")
    return conf


@pytest.mark.parametrize("calibrate", [None, "rng", "grng"])
def test_quantized_am_cuda_vs_cpu(cuda, toy_quant_conf, calibrate):
    from catears_tpu_torch.io.wav import read_16k_pcm
    conf = Configuration.read(toy_quant_conf)
    waves = [read_16k_pcm(os.path.join(DATA, f"en-us-{w}.wav"))
             for w in ("hello", "cat")]
    ams = [AcousticModel.read(conf, device=torch.device("cpu")),
           AcousticModel.read(conf, device=cuda)]
    if calibrate:
        feats = np.random.RandomState(1).randn(60, 40).astype(np.float32)
        for am in ams:
            am.calibrate(feats, guard=calibrate == "grng")
    ref, lengths = batched_logp(ams[0], waves)
    before = quant.qmatmul.launches
    got, _ = batched_logp(ams[1], waves)
    linears = sum(1 for layer in ams[1].nnet_def if layer[0] == "linear")
    assert quant.qmatmul.launches == before + linears
    got = got.cpu().numpy()
    ref = ref.numpy()
    for u, t in enumerate(lengths):
        span = ref[u, :t].max() - ref[u, :t].min()
        assert np.abs(got[u, :t] - ref[u, :t]).max() < 0.01 * span


def test_decoder_cuda_vs_cpu(cuda):
    rng = np.random.RandomState(42)
    g = make_phone_loop_graph(rng, num_words=30, num_pdfs=32)
    fst = FlatFst.from_raw(g.fst)
    logp = np.log(rng.dirichlet(np.ones(32), size=(3, 40))).astype(np.float32)
    cfg = BeamConfig(beam_size=64, expand_size=256, eps_expand_size=64,
                     beam=12.0)
    hyps = [BatchDecoder(fst, g.tid2pdf, config=cfg, arc_group=2,
                         device=dev).decode(logp, [40, 31, 12])
            for dev in (torch.device("cpu"), cuda)]
    assert [h.words for h in hyps[0]] == [h.words for h in hyps[1]]
    assert [h.weight for h in hyps[0]] == [h.weight for h in hyps[1]]


def _big_lm_queries(num_words=2000):
    from catears_tpu_torch.tools.biggraph import make_big_lm

    big = make_big_lm(np.random.RandomState(7), num_words=num_words)
    rng = np.random.RandomState(3)
    n = 4096
    states = np.concatenate([
        np.zeros(n // 8, np.int64),
        rng.randint(1, num_words + 1, size=n // 2),
        rng.randint(num_words + 3, big.num_states, size=n // 4),
        np.full(n // 8, num_words + 1)]).astype(np.int32)
    labels = np.where(rng.rand(n) < 0.7,
                      1 + (rng.pareto(1.0, n) * 40).astype(np.int64),
                      rng.randint(0, num_words + 3, size=n))
    labels = np.minimum(labels, num_words + 2).astype(np.int32)
    return big.delta_lm(), states, labels


def test_lm_walk_cuda_vs_cpu(cuda):
    delta, states, labels = _big_lm_queries()
    lms = [tdevice.DeviceLm.build(delta, device=d)
           for d in (torch.device("cpu"), cuda)]
    for name in tdevice.LM_TABLES:
        assert torch.equal(getattr(lms[0], name),
                           getattr(lms[1], name).cpu()), name
    s = torch.from_numpy(states)
    lab = torch.from_numpy(labels)
    for cap in (0, 512, 4096):
        ref = tdevice.lm_propagate_capped(lms[0], s[None], lab[None], cap)
        got = tdevice.lm_propagate_capped(lms[1], s[None].to(cuda),
                                          lab[None].to(cuda), cap)
        for r, g in zip(ref, got):
            assert r.dtype == g.dtype
            assert r.numpy().tobytes() == g.cpu().numpy().tobytes(), cap
    h = tdevice._lm_hash(s.to(cuda), lab.to(cuda), 0x1234, 2**20 - 1)
    assert torch.equal(h.cpu(), tdevice._lm_hash(s, lab, 0x1234, 2**20 - 1))


def test_decoder_with_lm_cuda_vs_cpu(cuda):
    from catears_tpu_torch.tools.biggraph import (make_big_lm,
                                                  make_trie_graph, plant_logp)

    rng = np.random.RandomState(1)
    g = make_trie_graph(rng, num_words=120, num_phones=25, bigram_states=30,
                        variants=2)
    delta = make_big_lm(np.random.RandomState(9),
                        num_words=g.num_words).delta_lm()
    logp, _ = plant_logp(rng, g, 3, 60)
    for lm_cap in (0, 64):
        cfg = BeamConfig(beam_size=128, expand_size=2048,
                         eps_expand_size=1024, max_eps_iters=4, beam=12.0,
                         lm_expand_size=lm_cap)
        hyps = [BatchDecoder(g.fst, g.tid2pdf, config=cfg, arc_group=2,
                             csr_group=16, device=dev,
                             delta_lm=delta).decode(logp, [60, 41, 17])
                for dev in (torch.device("cpu"), cuda)]
        assert [h.words for h in hyps[0]] == [h.words for h in hyps[1]]
        assert [h.weight for h in hyps[0]] == [h.weight for h in hyps[1]]


@pytest.mark.parametrize("mode,iters,lm", [
    ("closed", 4, False), ("raw", 4, False), ("raw", 1, False),
    ("closed", 4, True), ("raw", 4, True), ("raw", 1, True)])
def test_decoder_closed_and_raw_cuda_vs_cpu(cuda, monkeypatch, mode, iters,
                                            lm):
    """The small trie closed (close_epsilons, depth capped at 1; a
    prebuilt dfst) and raw (close_eps=False, depth 2: static rounds at
    max_eps_iters 4, the arena closure at 1), LM off and on: the CPU's
    words and bit-equal costs, with no read of the device in the decode's
    frame loop."""
    from catears_tpu_torch.decode import decoder as tdecoder
    from catears_tpu_torch.graph.transform import close_epsilons
    from catears_tpu_torch.tools.biggraph import (make_big_lm,
                                                  make_trie_graph, plant_logp)

    rng = np.random.RandomState(1)
    g = make_trie_graph(rng, num_words=120, num_phones=25, bigram_states=30,
                        variants=2)
    delta = (make_big_lm(np.random.RandomState(9),
                         num_words=g.num_words).delta_lm() if lm else None)
    logp, _ = plant_logp(rng, g, 3, 60)
    cfg = BeamConfig(beam_size=128, expand_size=2048, eps_expand_size=1024,
                     max_eps_iters=iters, beam=12.0,
                     lm_expand_size=64 if lm else 0)
    chunk = tdecoder.decode_chunk

    def no_sync(*args):
        torch.cuda.set_sync_debug_mode("error")  # a device read raises
        try:
            return chunk(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(tdecoder, "decode_chunk", no_sync)
    closed = close_epsilons(g.fst)[0]
    hyps = []
    for dev in (torch.device("cpu"), cuda):
        if mode == "closed":
            dfst = tdevice.DeviceFst.build(closed, g.tid2pdf, group=2,
                                           eps_depth_cap=1, csr_group=16,
                                           device=dev)
            dec = BatchDecoder(closed, g.tid2pdf, config=cfg, dfst=dfst,
                               delta_lm=delta)
        else:
            dec = BatchDecoder(g.fst, g.tid2pdf, config=cfg, arc_group=2,
                               close_eps=False, csr_group=16, device=dev,
                               delta_lm=delta)
        hyps.append(dec.decode(logp, [60, 41, 17]))
    assert [h.words for h in hyps[0]] == [h.words for h in hyps[1]]
    assert [h.weight for h in hyps[0]] == [h.weight for h in hyps[1]]
    assert any(h.words for h in hyps[1])


REPLAY_MODES = [("eps-free", 4, False), ("eps-free", 4, True),
                ("closed", 4, False), ("closed", 4, True),
                ("raw", 4, False), ("raw", 1, False), ("raw", 4, True),
                ("raw", 1, True)]


@pytest.mark.parametrize("mode,iters,lm", REPLAY_MODES)
def test_batch_decoder_replay_equals_the_eager_loop(cuda, mode, iters, lm):
    """BatchDecoder on the card replays one CUDA graph per chunk of 16
    frames (T = 60 and 37: the last chunk padded): the final beams
    (overflow, hiwater), the traces, words and weights equal the eager
    decode_chunk loop's on the card byte for byte, in every graph mode
    (raw at max_eps_iters 4: static rounds; at 1: the arena), LM off and
    on.  Batch A, then B, then A again reads A's results; the first
    decode of a shape captures one graph, a later one none, and each
    replays ceil(T / 16) times.  The frame kernels' `.launches` count what
    the card ran: a capture adds nothing, a replay its 16 frames'."""
    from catears_tpu_torch.decode import beam as tbeam
    from catears_tpu_torch.tools.biggraph import plant_logp
    from catears_tpu_torch.utils import log

    cfg = BeamConfig(beam_size=128, expand_size=2048, eps_expand_size=1024,
                     max_eps_iters=iters, beam=12.0,
                     lm_expand_size=64 if lm else 0)
    dec, tg = runner_trie(mode, lm, cuda, 16, cfg)
    a = (plant_logp(np.random.RandomState(2), tg, 3, 60)[0], [60, 41, 17])
    b = (plant_logp(np.random.RandomState(3), tg, 2, 37)[0], [37, 30])
    counts = []
    for logp, lengths in (a, b, a):
        log.reset_metrics()
        counts.append(assert_runner_equals_eager(dec, logp, lengths,
                                                 final_fallback=True))
        m = log.metrics()
        counts[-1] = counts[-1] + ((m.get("frame_graph_captures", 0),
                                    m.get("frame_graph_replays", 0)),)
    log.reset_metrics()
    assert [c[-1] for c in counts] == [(1, 4), (1, 3), (0, 4)]
    # A's shape is captured: its decode launches only by replays (the
    # eager loop of assert_runner_equals_eager is left out here).
    before = (tbeam.expand_emitting.launches, tbeam.select_beam.launches)
    dec.decode(*a, final_fallback=True)
    launched = (tbeam.expand_emitting.launches - before[0],
                tbeam.select_beam.launches - before[1])
    assert launched == ((64, 64) if mode == "eps-free" else (0, 0))
    first, again = counts[0], counts[2]
    assert [(h.words, h.weight) for h in first[0]] == [
        (h.words, h.weight) for h in again[0]]
    assert any(h.words for h in first[0])
    for x, y in zip(first[1] + first[2], again[1] + again[2]):
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("mode", ["eps-free", "closed"])
def test_batch_decoder_replay_retries_an_overflow(cuda, mode):
    """Capacities too small for the trie: the replayed decode overflows,
    regrows them, captures a graph at the new config and decodes once
    more, byte for byte the eager loop's at that config.  The same batch
    again retries at the same regrown config with no capture, and the
    decoder keeps two runners: its own config's and the regrown one."""
    from catears_tpu_torch.tools.biggraph import plant_logp
    from catears_tpu_torch.utils import log

    tiny = BeamConfig(beam_size=128, expand_size=16, eps_expand_size=16,
                      max_eps_iters=4, beam=1e9)
    dec, tg = runner_trie(mode, False, cuda, 16, tiny)
    logp = plant_logp(np.random.RandomState(5), tg, 2, 37)[0]
    log.reset_metrics()
    _, _, _, cfg = assert_runner_equals_eager(dec, logp, [37, 30],
                                              final_fallback=True)
    m = log.metrics()
    log.reset_metrics()
    assert cfg.expand_size > tiny.expand_size
    assert m["overflow_retries"] == 1 and m["frame_graph_captures"] == 2
    assert m["frame_graph_replays"] == 6
    dec.decode(logp, [37, 30], final_fallback=True)
    m = log.metrics()
    log.reset_metrics()
    assert m["overflow_retries"] == 1 and m["frame_graph_replays"] == 6
    assert m.get("frame_graph_captures", 0) == 0
    assert len(dec._runners) == 2


@pytest.mark.parametrize("mode,lm", [("eps-free", False),
                                     ("eps-free", True), ("closed", False)])
def test_batch_decoder_waits_for_the_card_twice(cuda, mode, lm):
    """A warmed decode on the card (its graph captured, its pinned host
    buffers made) runs with every synchronising call raising
    (torch.cuda.set_sync_debug_mode("error")): its uploads do not wait,
    and its host waits only in its two counted reads (the beam and the
    backtrace's words, each on an event).  Its words and weights equal
    the warm decode's and `reference_tail`'s."""
    from catears_tpu_torch.tools.biggraph import plant_logp
    from catears_tpu_torch.utils import log

    cfg = BeamConfig(beam_size=128, expand_size=2048, eps_expand_size=1024,
                     max_eps_iters=4, beam=12.0,
                     lm_expand_size=64 if lm else 0)
    dec, tg = runner_trie(mode, lm, cuda, 16, cfg)
    logp = plant_logp(np.random.RandomState(2), tg, 3, 60)[0]
    lengths = [60, 41, 17]
    warm = assert_runner_equals_eager(dec, logp, lengths,
                                      final_fallback=True)[0]
    log.reset_metrics()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hyps = dec.decode(logp, lengths, final_fallback=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    m = log.metrics()
    log.reset_metrics()
    assert m["decode_host_syncs"] == 2
    assert [(h.words, h.weight) for h in hyps] == [
        (h.words, h.weight) for h in warm]
    assert any(h.words for h in hyps)


@functools.lru_cache(maxsize=None)
def _walk_case(lm):
    """(DeviceLm on the CPU, lanes (states, labels) [4, 1024]) of
    tests/test_torch_lm_walk.py's cases: the corner-case G' at max_backoff
    1 or 8 ("chain-1", "chain-8"), or a make_big_lm G' ("big")."""
    from catears_tpu_torch.graph import fst as tfst
    from catears_tpu_torch.tools.biggraph import make_big_lm

    if lm == "big":
        big = make_big_lm(np.random.RandomState(7), num_words=2000)
        delta, max_backoff, seed = big.delta_lm(), 8, 5
        queries = np.stack(big_lm_queries(big.num_states, 2000, 600, seed=3),
                           1)
    else:
        (delta, queries), max_backoff = chain_delta(tfst), int(lm[-1])
        seed = max_backoff
    return (tdevice.DeviceLm.build(delta, max_backoff=max_backoff,
                                   device=torch.device("cpu")),
            walk_lanes(queries, 4, 1024, seed=seed))


def _lm_on(dlm, dev):
    return dataclasses.replace(dlm, **{name: getattr(dlm, name).to(dev)
                                       for name in tdevice.LM_TABLES})


def _same_bytes(ref, got, what):
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape, what
        assert r.cpu().numpy().tobytes() == g.cpu().numpy().tobytes(), what


@pytest.mark.parametrize("shape", ["E", "BxE"])
@pytest.mark.parametrize("cap", [0, 1, 37, 384, 1024])
@pytest.mark.parametrize("lm", ["chain-1", "chain-8", "big"])
def test_lm_walk_kernel_bit_equal(cuda, lm, cap, shape):
    """csrc/lm_walk.cu (lm_propagate_capped on cuda, launched on a
    non-default stream) == lm_propagate_capped_ref on the card and on the
    CPU: equal states, bit-equal weights, equal needed."""
    dlm_cpu, (states, labels) = _walk_case(lm)
    if shape == "E":
        states, labels = states[0], labels[0]
    s, lab = torch.from_numpy(states), torch.from_numpy(labels)
    dlm = _lm_on(dlm_cpu, cuda)
    side = torch.cuda.Stream()
    before = tdevice.lm_propagate_capped.launches
    with torch.cuda.stream(side):
        s_gpu, lab_gpu = s.to(cuda), lab.to(cuda)
        got = tdevice.lm_propagate_capped(dlm, s_gpu, lab_gpu, cap)
    side.synchronize()
    assert tdevice.lm_propagate_capped.launches == before + 1
    _same_bytes(tdevice.lm_propagate_capped_ref(dlm, s_gpu, lab_gpu, cap),
                got, "the plain version on the card")
    _same_bytes(tdevice.lm_propagate_capped(dlm_cpu, s, lab, cap), got,
                "the plain version on the CPU")
    assert int(got[2].max()) > cap or cap in (0, 1024) or shape == "E"


@pytest.mark.parametrize("lm", ["chain-1", "chain-8", "big"])
def test_lm_propagate_kernel_bit_equal(cuda, lm):
    """lm_propagate on cuda (the kernel uncapped) == lm_propagate_ref."""
    dlm_cpu, (states, labels) = _walk_case(lm)
    s, lab = torch.from_numpy(states), torch.from_numpy(labels)
    dlm = _lm_on(dlm_cpu, cuda)
    before = tdevice.lm_propagate.launches
    got = tdevice.lm_propagate(dlm, s.to(cuda), lab.to(cuda))
    torch.cuda.synchronize()
    assert tdevice.lm_propagate.launches == before + 1
    _same_bytes(tdevice.lm_propagate_ref(dlm_cpu, s, lab), got, lm)


@pytest.mark.parametrize("seed,t,b,k,w", [
    (0, 1, 1, 1, 1), (1, 9, 3, 5, 2), (2, 40, 8, 16, 1), (4, 300, 16, 7, 2),
    (5, 998, 8, 2048, 2)])
def test_backtrace_kernel_bit_equal(cuda, seed, t, b, k, w):
    """csrc/backtrace.cu (backtrace_device on cuda, on a non-default
    stream) == backtrace_device_ref on the card and on the CPU, with int32
    and int64 best slots; the last case is the smoke's 998-frame traces."""
    from catears_tpu_torch.decode.beam import (FrameTrace, backtrace_device,
                                               backtrace_device_ref)

    prev, words, best = backtrace_case(seed, t, b, k, w)
    trace_cpu = FrameTrace(torch.from_numpy(prev), torch.from_numpy(words))
    want = backtrace_device_ref(trace_cpu, torch.from_numpy(best))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        trace = FrameTrace(*(x.to(cuda) for x in trace_cpu))
        for slots in (torch.from_numpy(best), torch.from_numpy(best).long()):
            before = backtrace_device.launches
            got = backtrace_device(trace, slots.to(cuda))
            assert backtrace_device.launches == before + 1
            assert got.is_contiguous() and got.shape == (b, t, w)
            ref = backtrace_device_ref(trace, slots.to(cuda))
            side.synchronize()
            assert torch.equal(got, ref) and torch.equal(got.cpu(), want)


def test_lm_walk_and_backtrace_refuse_what_the_kernels_do_not_take(cuda):
    from catears_tpu_torch.decode.beam import FrameTrace, backtrace_device

    dlm_cpu, (states, labels) = _walk_case("chain-8")
    dlm = _lm_on(dlm_cpu, cuda)
    s = torch.from_numpy(states).to(cuda)
    lab = torch.from_numpy(labels).to(cuda)
    for bad in ((s[:, ::2], lab[:, ::2]), (s.long(), lab.long()),
                (s, lab.float())):
        with pytest.raises(ValueError):
            tdevice.lm_propagate_capped(dlm, *bad, 37)
        with pytest.raises(ValueError):
            tdevice.lm_propagate(dlm, *bad)
    with pytest.raises(ValueError, match="DeviceLm"):  # tables on the CPU
        tdevice.lm_propagate_capped(dlm_cpu, s, lab, 37)
    prev = s[:3].reshape(3, 2, 512)
    words = torch.zeros((3, 2, 512, 2), dtype=torch.int32, device=cuda)
    best = torch.zeros(2, dtype=torch.int32, device=cuda)
    for bad in (FrameTrace(prev.long(), words),
                FrameTrace(prev, words.float()),
                FrameTrace(prev.transpose(1, 2).contiguous().transpose(1, 2),
                           words)):
        with pytest.raises(ValueError):
            backtrace_device(bad, best)
    with pytest.raises(ValueError):
        backtrace_device(FrameTrace(prev, words), best.float())


@functools.lru_cache(maxsize=None)
def _frame_trie():
    """The port's planted trie (tests/test_torch_frame_kernels.py's, built
    by the port) with its G', eps-removed."""
    from catears_tpu_torch.graph.transform import prepare_decode_graph
    from catears_tpu_torch.tools.biggraph import make_big_lm, make_trie_graph

    tg = make_trie_graph(np.random.RandomState(1), num_words=120,
                         num_phones=25, bigram_states=30, variants=2)
    g2, olab2, mode = prepare_decode_graph(tg.fst)
    assert mode == "eps_free"
    delta = make_big_lm(np.random.RandomState(9),
                        num_words=tg.num_words).delta_lm()
    return tg, g2, olab2, delta


# (group, csr_group, compact, hot rows as a share of the states)
FRAME_LAYOUTS = {"compact": (2, 16, None, 0), "classic-g4": (4, 4, None, 0),
                 "classic-g2": (2, 16, False, 0),
                 "classic-hot": (2, 16, None, 3)}


def _frame_tables(layout, dev):
    tg, g2, olab2, _ = _frame_trie()
    g, gc, compact, hot = FRAME_LAYOUTS[layout]
    return tdevice.DeviceFst.build(g2, tg.tid2pdf, group=g, eps_depth_cap=1,
                                   csr_group=gc, olabel2=olab2,
                                   compact=compact, device=dev,
                                   hot_rows=g2.num_states // hot if hot else 0)


@pytest.mark.parametrize("layout", list(FRAME_LAYOUTS))
@pytest.mark.parametrize("expand_size,need_lm", [(512, True), (48, False),
                                                 (9000, False)])
def test_expand_kernel_bit_equal(cuda, layout, expand_size, need_lm):
    """csrc/frame_expand.cu (expand_emitting on cuda, on a non-default
    stream) == expand_emitting_ref on the card and on the CPU in every lane
    (dead lanes are masked alike), with a CSR tail (overflowing at 48
    slots; at 9000 slots three blocks a row), the hot/cold split (5 cold
    lanes at 48 slots, which overflow), pdfs past logp's width, and logp
    as a frame of a [T, B, P] view.  With a row mask (row_valid) the
    kernel's unmasked rows equal the plain version's under the mask, and
    the unmasked call's, byte for byte on the card and on the CPU; a
    masked row reads a dead row's overflow, needed, cold_over and
    cold_needed (0), its lanes unread."""
    from catears_tpu_torch.decode import beam as tbeam

    cpu = torch.device("cpu")
    td_cpu, td = _frame_tables(layout, cpu), _frame_tables(layout, cuda)
    b, k = 3, 32
    states, costs, lms = random_beam(td_cpu, 5, b, k)
    p = int(_frame_trie()[0].tid2pdf.max()) + 1 - 4  # the top pdfs are out
    frames = np.log(np.random.RandomState(6).dirichlet(
        np.ones(p), (b, 4))).astype(np.float32)
    cold = (5 if expand_size == 48 else 100) if td.hot_rows else 0
    cfg = BeamConfig(beam_size=k, expand_size=expand_size, am_scale=0.1,
                     cold_expand_size=cold)

    def beam_on(dev):
        return tbeam.BeamState(
            *(torch.from_numpy(x).to(dev) for x in (states, lms, costs)),
            torch.arange(k, dtype=torch.int32, device=dev).expand(b, k),
            torch.zeros(b, dtype=torch.bool, device=dev),
            torch.zeros((b, 5), dtype=torch.int32, device=dev))

    logp_cpu = torch.from_numpy(frames[:, 2].copy())
    logp = torch.from_numpy(frames).to(cuda).transpose(0, 1)[2]
    assert not logp.is_contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = tbeam.expand_emitting.launches
    with torch.cuda.stream(side):
        got = tbeam.expand_emitting(cfg, td, beam_on(cuda), logp, need_lm)
    side.synchronize()
    assert tbeam.expand_emitting.launches == before + 1
    want = tbeam.expand_emitting_ref(cfg, td_cpu, beam_on(cpu), logp_cpu,
                                     need_lm)
    on_card = tbeam.expand_emitting_ref(cfg, td, beam_on(cuda), logp,
                                        need_lm)
    for ref, what in ((want, "cpu"), (on_card, "card")):
        for name, r, g in zip(tbeam.EmitCands._fields, ref, got):
            if r is None or g is None:
                assert r is None and g is None, name
                continue
            _same_bytes([r], [g], f"{what}: {name}")
    assert bool(got.overflow.any()) == (expand_size == 48)
    assert (got.state[:, k + k * td.group:] < tbeam.SENTINEL_STATE).any()
    assert (got.cold_over is not None) == bool(cold)
    if cold:
        assert bool(got.cold_over.any()) == (cold == 5)
    assert (got.needed > 0).all()  # so a masked row's 0 is written
    # The same rows with row 1 masked: a dead row's per-row outputs there,
    # the unmasked call's lanes and flags on rows 0 and 2.
    valid = torch.tensor([True, False, True])
    unmasked = got
    with torch.cuda.stream(side):
        got = tbeam.expand_emitting(cfg, td, beam_on(cuda), logp, need_lm,
                                    row_valid=valid.to(cuda))
    side.synchronize()
    assert tbeam.expand_emitting.launches == before + 2
    want = tbeam.expand_emitting_ref(cfg, td_cpu, beam_on(cpu), logp_cpu,
                                     need_lm, valid)
    on_card = tbeam.expand_emitting_ref(cfg, td, beam_on(cuda), logp,
                                        need_lm, valid.to(cuda))
    for ref, what in ((want, "cpu"), (on_card, "card"),
                      (unmasked, "unmasked")):
        for name, r, g in zip(tbeam.EmitCands._fields, ref, got):
            if r is None or g is None:
                assert r is None and g is None, name
                continue
            _same_bytes([r[valid.to(r.device)]], [g[valid.to(cuda)]],
                        f"masked call vs {what}: {name}")
    for name in ("overflow", "needed", "cold_over", "cold_needed"):
        x = getattr(got, name)
        if x is not None:
            assert not x[1].item(), name


@pytest.mark.parametrize("beam_size,expand_size", [(128, 2048),
                                                   (1024, 16384)])
def test_ragged_batch_replays_mask_the_expansion(cuda, beam_size,
                                                 expand_size):
    """A ragged batch (rows ending at 60, 41, 17, 33 frames and after one)
    through BatchDecoder on the card, LM off: its chunk runner's graph is
    captured once and replayed for each chunk of 8 frames, whose frame
    masks change from chunk to chunk and reach both frame kernels as
    row_valid (one block a row at 2,432 lanes, five at 19,456).  The
    words and costs equal the CPU decode's, and the expansion ran as many
    launches as the selection."""
    from catears_tpu_torch.decode import beam as tbeam
    from catears_tpu_torch.tools.biggraph import plant_logp
    from catears_tpu_torch.utils import log

    cfg = BeamConfig(beam_size=beam_size, expand_size=expand_size,
                     eps_expand_size=1024, max_eps_iters=4, beam=12.0)
    lengths = [60, 41, 17, 1, 33]
    hyps, metrics = [], []
    for dev in (torch.device("cpu"), cuda):
        dec, tg = runner_trie("eps-free", False, dev, 8, cfg)
        logp = plant_logp(np.random.RandomState(4), tg, 5, 60)[0]
        for _ in range(1 + (dev.type == "cuda")):
            log.reset_metrics()
            before = (tbeam.expand_emitting.launches,
                      tbeam.select_beam.launches)
            hyps.append(dec.decode(logp, lengths, final_fallback=True))
            metrics.append(log.metrics())
            log.reset_metrics()
    launched = (tbeam.expand_emitting.launches - before[0],
                tbeam.select_beam.launches - before[1])
    # The second decode on the card: its captured graph's 8 replays.
    m = metrics[-1]
    assert m.get("frame_graph_captures", 0) == 0
    assert m["frame_graph_replays"] == 8
    assert metrics[1]["frame_graph_captures"] == 1
    assert m["frame_rows_valid"] == sum(lengths)
    assert launched == (64, 64)
    for got in hyps[1:]:
        assert [h.words for h in hyps[0]] == [h.words for h in got]
        assert [h.weight for h in hyps[0]] == [h.weight for h in got]
    assert sum(bool(h.words) for h in hyps[0]) >= 2


def _select_cases():
    adv = adversarial_rows(1)
    return {"adversarial": (8, [np.stack(c) for c in zip(*adv.values())]),
            "tied": (64, None)}


@pytest.mark.parametrize("case", ["adversarial", "tied"])
@pytest.mark.parametrize("lm_on,weights", [(False, "none"), (True, "both"),
                                           (True, "w2")])
@pytest.mark.parametrize("compact", ["off", "k", "wide"])
def test_select_kernel_bit_equal(cuda, case, lm_on, weights, compact):
    """csrc/frame_select.cu (select_beam on cuda, on a non-default stream)
    == select_beam_ref on the card and on the CPU in full: the adversarial
    rows (ties, +-0.0, +-inf, NaN of both signs, sentinel states, the
    threshold, fewer / exactly / more than K winners, a dead row) and rows
    whose ties carry the radix select into the state and lm digits;
    select_compact off, at K (the beam in (state, lm) order) and wider than
    K, with rows that overflow it."""
    from catears_tpu_torch.decode import beam as tbeam

    k, cols = _select_cases()[case]
    if cols is None:
        cols = tied_rows(3, lm_on)
        if weights == "both":
            cols[3] = np.zeros_like(cols[2]) + np.float32(0.5)
    else:
        cols = list(cols)
        if not lm_on:
            cols[1] = None
        if weights != "both":
            cols[3] = None
        if weights == "none":
            cols[4] = None
    c2 = {"off": 0, "k": k, "wide": 2 * k - 3}[compact]
    cfg = BeamConfig(beam_size=k, beam=16.0, select_compact=c2)
    cpu_cols = [None if c is None else torch.from_numpy(np.ascontiguousarray(
        c)) for c in cols]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = tbeam.select_beam.launches
    with torch.cuda.stream(side):
        card_cols = [None if c is None else c.to(cuda) for c in cpu_cols]
        got = tbeam.select_beam(cfg, *card_cols)
    side.synchronize()
    assert tbeam.select_beam.launches == before + 1
    for ref, what in ((tbeam.select_beam_ref(cfg, *cpu_cols), "cpu"),
                      (tbeam.select_beam_ref(cfg, *card_cols), "card")):
        for name in ("states", "lms", "costs", "prev_slot", "words",
                     "demand"):
            _same_bytes([getattr(ref, name)], [getattr(got, name)],
                        f"{what}: {name}")
        if c2:
            _same_bytes([ref.overflow], [got.overflow], f"{what}: overflow")
    assert (got.overflow is None) == (not c2)
    if c2:
        assert bool(got.overflow.any())


def _select_on_card(cuda, cfg, cols, row_valid=None, stamps=None):
    """select_beam on the card (a non-default stream) against
    select_beam_ref on the card, bit for bit, both under row_valid;
    returns the kernel's.  cols: numpy arrays or card tensors."""
    from catears_tpu_torch.decode import beam as tbeam

    card_cols = [c if c is None or isinstance(c, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(c)).to(cuda)
                 for c in cols]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = tbeam.select_beam.launches
    with torch.cuda.stream(side):
        got = tbeam.select_beam(cfg, *card_cols, stamps=stamps,
                                row_valid=row_valid)
    side.synchronize()
    assert tbeam.select_beam.launches == before + 1
    ref = tbeam.select_beam_ref(cfg, *card_cols, row_valid=row_valid)
    for name in tbeam.Selected._fields:
        r, g = getattr(ref, name), getattr(got, name)
        if r is None or g is None:
            assert r is None and g is None, name
            continue
        _same_bytes([r], [g], name)
    return got


# Lanes a row holds at each beam: the bench's 38,912 (8 CTAs, the table
# in shared memory); at K = 8192, 100,000 (16 CTAs, the table in global
# memory); at K = 1, 4,096.
SELECT_LANES = {1: 4096, 2048: 38912, 8192: 100_000}


@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("k", [1, 2048, 8192])
@pytest.mark.parametrize("lm_on", [False, True])
def test_select_kernel_shapes(cuda, b, k, lm_on):
    """csrc/frame_select.cu == select_beam_ref bit for bit at B rows of
    frame-like candidates (tests/_torch_parity.py::beam_rows), for each
    cluster size and table storage the shapes take, select_compact off,
    at K and wider than K."""
    from catears_tpu_torch.decode import beam as tbeam

    e = SELECT_LANES[k]
    cols = beam_rows(10 + b, b, e, lm_on, weights=lm_on)
    cluster, _, shared = tbeam.select_geometry(e)
    assert (cluster, shared) == ((16, False) if k == 8192 else (8, True))
    for c2 in (0, k, 2 * k + 5):
        got = _select_on_card(cuda, BeamConfig(beam_size=k, beam=16.0,
                                               select_compact=c2), cols)
        assert (got.demand > 2 * k + 5).all()  # the selects run
        assert c2 == 0 or bool(got.overflow.all())


@pytest.mark.parametrize("lm_on", [False, True])
@pytest.mark.parametrize("k", [64, 2048])
def test_select_kernel_one_slice_rows(cuda, lm_on, k):
    """Rows whose (state, lm) groups all hash into CTA 0's table slice:
    the claims probe across the cluster's slices; the kernel still equals
    select_beam_ref bit for bit, select_compact off, at K and wider."""
    cols = beam_rows(12, 4, 8192, lm_on, weights=lm_on, one_slice=True)
    live = cols[0] < 2**30
    assert (group_home(cols[0][live], None if cols[1] is None
                       else cols[1][live], 4) == 0).all()
    for c2 in (0, k, 2 * k + 5):
        _select_on_card(cuda, BeamConfig(beam_size=k, beam=16.0,
                                         select_compact=c2), cols)


def test_select_kernel_phase_stamps(cuda):
    """With a stamp buffer the kernel writes each row's phase times, in
    order, and its radix passes; the outputs are the same as without."""
    from catears_tpu_torch.decode import beam as tbeam

    cols = [None if c is None else torch.from_numpy(c).to(cuda)
            for c in beam_rows(13, 4, 38912, True)]
    cfg = BeamConfig(beam_size=2048, beam=16.0)
    stamps = torch.zeros((4, tbeam.SELECT_STAMPS), dtype=torch.int64,
                         device=cuda)
    got = tbeam.select_beam(cfg, *cols, stamps=stamps)
    ref = tbeam.select_beam(cfg, *cols)
    torch.cuda.synchronize()
    for name in tbeam.Selected._fields:
        if getattr(ref, name) is not None:
            _same_bytes([getattr(ref, name)], [getattr(got, name)], name)
    st = stamps.cpu().numpy()
    assert (np.diff(st[:, :11], axis=1) >= 0).all() and (st[:, 0] > 0).all()
    assert (st[:, -1] >= 1).all()  # the cost select ran
    with pytest.raises(ValueError, match="stamps"):
        tbeam.select_beam(cfg, *cols, stamps=stamps[:, :3])


# The selections of the held cells: bulk-lmoff's 38,912 lanes at beam
# 2,048 (8 CTAs, the table in shared memory) and bulk-chain's 209,416 at
# 7,000 (16 CTAs, the table in global memory, sized to each row).
MASK_SHAPES = {"shared": (38_912, 2048), "global": (209_416, 7000)}
# Each row's live lanes (None: every lane).
MASK_LIVE = [1, 3, 37, None, 1, 200, None, 5, 1, 1000, None, 2, 17, 90_000,
             1, 9000]


def _mask_rows(cuda, shape, lm_on, seed):
    """16 rows of MASK_SHAPES[shape]'s lanes holding MASK_LIVE's live
    lanes, on the card, and each row's live lanes."""
    e, _ = MASK_SHAPES[shape]
    live = [min(n, e // 2) if n else n for n in MASK_LIVE]
    cols = with_live_lanes(beam_rows(seed, 16, e, lm_on, weights=lm_on),
                           live, seed)
    return ([None if c is None else torch.from_numpy(c).to(cuda)
             for c in cols], (cols[0] < 2**30).sum(1))


def _row_masks(seed):
    rng = np.random.RandomState(seed)
    one = np.zeros(16, bool)
    one[3] = True
    return {"random": rng.rand(16) < 0.35, "random-2": rng.rand(16) < 0.35,
            "every-row-masked": np.zeros(16, bool), "one-live-row": one,
            "none-masked": np.ones(16, bool), "no-mask": None}


@pytest.mark.parametrize("shape", list(MASK_SHAPES))
@pytest.mark.parametrize("lm_on", [False, True])
def test_select_kernel_row_mask(cuda, shape, lm_on):
    """csrc/frame_select.cu with row_valid == select_beam_ref under the
    same mask, bit for bit, at both held cells' shapes (the shared table
    and the global one), on rows with 1, a few and every lane live;
    random masks, every row masked, one live row, none; select_compact off
    and wider than K.  An unmasked row equals the call without a mask, and
    each row's table slots (stamp 13) are select_row_log2cap's on the
    global path, the shape's on the shared one, 0 where it is masked."""
    from catears_tpu_torch.decode import beam as tbeam

    e, k = MASK_SHAPES[shape]
    cluster, cap, shared = tbeam.select_geometry(e)
    assert (cluster, shared) == ((8, True) if shape == "shared"
                                 else (16, False))
    cols, live = _mask_rows(cuda, shape, lm_on, 21 + lm_on)
    assert (live == e).sum() == 3 and live.min() == 1
    slots = np.array([1 << tbeam.select_row_log2cap(int(n), e)
                      for n in live])
    if not shared:  # from C = 16 slots to the shape's 2^19
        assert slots.min() == 16 and slots.max() == 1 << cap
        assert len(set(slots)) >= 6
    for c2 in (0, 2 * k + 5):
        cfg = BeamConfig(beam_size=k, beam=16.0, select_compact=c2)
        full = _select_on_card(cuda, cfg, cols)
        for name, valid in _row_masks(7 + c2).items():
            stamps = torch.zeros((16, tbeam.SELECT_STAMPS),
                                 dtype=torch.int64, device=cuda)
            mask = (None if valid is None
                    else torch.from_numpy(valid).to(cuda))
            got = _select_on_card(cuda, cfg, cols, row_valid=mask,
                                  stamps=stamps)
            keep = torch.ones(16, dtype=torch.bool, device=cuda) \
                if mask is None else mask
            for field in tbeam.Selected._fields:
                x, y = getattr(full, field), getattr(got, field)
                if x is not None:
                    _same_bytes([x[keep]], [y[keep]], f"{name}: {field}")
            expect = slots if valid is None else np.where(valid, slots, 0)
            assert stamps[:, 13].cpu().numpy().tolist() == \
                expect.tolist(), name


@pytest.mark.parametrize("shape", list(MASK_SHAPES))
def test_select_kernel_row_mask_in_a_cuda_graph(cuda, shape):
    """select_beam captured in a CUDA graph over a static row mask, then
    replayed with a different mask copied in each time (every row, none,
    random ones): each replay equals select_beam_ref under the mask it
    found, bit for bit; no replay reads a stale mask."""
    from catears_tpu_torch.decode import beam as tbeam

    e, k = MASK_SHAPES[shape]
    cols, _ = _mask_rows(cuda, shape, True, 31)
    cfg = BeamConfig(beam_size=k, beam=16.0)
    mask = torch.ones(16, dtype=torch.bool, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tbeam.select_beam(cfg, *cols, row_valid=mask)  # loads the library
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = tbeam.select_beam(cfg, *cols, row_valid=mask)
    rng = np.random.RandomState(5)
    masks = [np.zeros(16, bool), rng.rand(16) < 0.3, np.ones(16, bool),
             rng.rand(16) < 0.5, rng.rand(16) < 0.1]
    for i, valid in enumerate(masks):
        mask.copy_(torch.from_numpy(valid))
        graph.replay()
        torch.cuda.synchronize()
        ref = tbeam.select_beam_ref(cfg, *cols, row_valid=mask)
        for field in ("states", "lms", "costs", "prev_slot", "words",
                      "demand"):
            _same_bytes([getattr(ref, field)], [getattr(out, field)],
                        f"replay {i}: {field}")


@pytest.mark.parametrize("arc_group,lm", [(2, False), (2, True), (4, True)])
def test_decoder_launches_the_frame_kernels(cuda, arc_group, lm):
    """An eps-free BatchDecoder on cuda launches both frame kernels every
    frame and gives the CPU's words, costs and high-water marks."""
    from catears_tpu_torch.decode import beam as tbeam
    from catears_tpu_torch.tools.biggraph import plant_logp

    tg, _, _, delta = _frame_trie()
    logp, _ = plant_logp(np.random.RandomState(2), tg, 3, 40)
    cfg = BeamConfig(beam_size=128, expand_size=2048, eps_expand_size=1024,
                     max_eps_iters=4, beam=12.0, lm_expand_size=64)
    decs = [BatchDecoder(tg.fst, tg.tid2pdf, config=cfg, arc_group=arc_group,
                         csr_group=16, device=dev,
                         delta_lm=delta if lm else None)
            for dev in (torch.device("cpu"), cuda)]
    before = (tbeam.expand_emitting.launches, tbeam.select_beam.launches)
    hyps = [d.decode(logp, [40, 31, 12]) for d in decs]
    launched = (tbeam.expand_emitting.launches - before[0],
                tbeam.select_beam.launches - before[1])
    assert launched[0] >= 40 and launched[1] >= 40, launched
    assert [h.words for h in hyps[0]] == [h.words for h in hyps[1]]
    assert [h.weight for h in hyps[0]] == [h.weight for h in hyps[1]]
    assert any(h.words for h in hyps[1])
    # The frame loop itself: beams (hiwater included) and traces.
    _, g2, olab2, _ = _frame_trie()
    runs = []
    for dev in (torch.device("cpu"), cuda):
        dfst = tdevice.DeviceFst.build(g2, tg.tid2pdf, group=arc_group,
                                       eps_depth_cap=1, csr_group=16,
                                       olabel2=olab2, device=dev)
        dlm = tdevice.DeviceLm.build(delta, device=dev) if lm else None
        beam, _ = tbeam.init_beam_batch(cfg, 3, dfst, dlm)
        lp = torch.from_numpy(np.ascontiguousarray(
            np.transpose(logp, (1, 0, 2)))).to(dev)
        runs.append(tbeam.decode_chunk(cfg, dfst, beam, lp, torch.ones(
            (40, 3), dtype=torch.bool, device=dev), dlm))
    for name in tbeam.BeamState._fields:
        _same_bytes([getattr(runs[0][0], name)], [getattr(runs[1][0], name)],
                    name)
    _same_bytes(runs[0][1], runs[1][1], "trace")


@pytest.mark.parametrize("lm", [False, True])
def test_decode_knobs_launch_the_frame_kernels(cuda, lm):
    """decode_chunk on cuda with the hot/cold split and select_compact
    (at K LM off, wider LM on) launches both frame kernels every frame and
    gives the CPU's beams, high-water marks and traces bit for bit (LM
    off, select_compact overflows)."""
    from catears_tpu_torch.decode import beam as tbeam
    from catears_tpu_torch.tools.biggraph import plant_logp

    tg, g2, olab2, delta = _frame_trie()
    logp, _ = plant_logp(np.random.RandomState(2), tg, 3, 30)
    cfg = BeamConfig(beam_size=128, expand_size=2048, beam=12.0,
                     lm_expand_size=64, cold_expand_size=100,
                     select_compact=300 if lm else 128)
    runs = []
    for dev in (torch.device("cpu"), cuda):
        dfst = tdevice.DeviceFst.build(g2, tg.tid2pdf, group=2,
                                       eps_depth_cap=1, csr_group=16,
                                       olabel2=olab2, device=dev,
                                       hot_rows=g2.num_states // 4)
        dlm = tdevice.DeviceLm.build(delta, device=dev) if lm else None
        beam, _ = tbeam.init_beam_batch(cfg, 3, dfst, dlm)
        lp = torch.from_numpy(np.ascontiguousarray(
            np.transpose(logp, (1, 0, 2)))).to(dev)
        before = (tbeam.expand_emitting.launches, tbeam.select_beam.launches)
        runs.append(tbeam.decode_chunk(cfg, dfst, beam, lp, torch.ones(
            (30, 3), dtype=torch.bool, device=dev), dlm))
    launched = (tbeam.expand_emitting.launches - before[0],
                tbeam.select_beam.launches - before[1])
    assert launched == (30, 30), launched
    for name in tbeam.BeamState._fields:
        _same_bytes([getattr(runs[0][0], name)], [getattr(runs[1][0], name)],
                    name)
    _same_bytes(runs[0][1], runs[1][1], "trace")
    hiwater = runs[1][0].hiwater.cpu().numpy()
    assert (hiwater[:, 4] > 0).all()  # cold tokens were counted


def test_frame_kernels_refuse_what_they_do_not_take(cuda):
    from catears_tpu_torch.decode import beam as tbeam

    cfg = BeamConfig(beam_size=8, beam=16.0)
    e = torch.zeros((2, 40), dtype=torch.int32, device=cuda)
    c = torch.zeros((2, 40), device=cuda)
    wide = torch.zeros((2, 80), dtype=torch.int32, device=cuda)
    for bad in ((e, c[:, ::1].double()), (wide[:, ::2], c), (e, c.cpu())):
        with pytest.raises(ValueError):
            tbeam.select_beam(cfg, bad[0], None, bad[1], None, None, e, e, e)
    with pytest.raises(ValueError, match="1..8192"):
        tbeam.select_beam(BeamConfig(beam_size=8193), e, None, c, None, None,
                          e, e, e)
    td = _frame_tables("compact", cuda)
    beam = tbeam.BeamState(e[:, :8], e[:, :8], c[:, :8], e[:, :8],
                           torch.zeros(2, dtype=torch.bool, device=cuda),
                           torch.zeros((2, 5), dtype=torch.int32,
                                       device=cuda))
    for bad in (beam._replace(costs=c[:, :8].double()),
                beam._replace(states=e[:, :8].cpu())):
        with pytest.raises(ValueError):
            tbeam.expand_emitting(cfg, td, bad, c[:, :10], False)
    with pytest.raises(ValueError, match="graph's tables"):
        tbeam.expand_emitting(cfg, dataclasses.replace(
            td, over_packed=td.over_packed.t()), beam, c[:, :10], False)


# (rows, K, N) of the TDNN-1024's three linears in one streaming chunk: the
# window is L + 20 + R = 24 rows (L = R = 2), narrowed by 2 per splice.
STREAM_SHAPES = [(22, 120, 1024), (20, 3072, 1024), (20, 1024, 3600)]


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("m,k,n", STREAM_SHAPES)
def test_qmatmul_streaming_shapes_bit_equal(cuda, b, m, k, n):
    aq, wq, colsum, bias = _quantized_operands(b, m, k, n, "dynamic",
                                               b + m + k)
    assert aq.scale.shape == (b,)  # one scale per stream
    aq, wq = _to(aq, cuda), _to(wq, cuda)
    colsum, bias = colsum.to(cuda), bias.to(cuda)
    before = quant.qmatmul.launches
    got = quant.qmatmul(aq, wq, colsum, bias=bias,
                        bt=quant.transpose_pad(wq.values))
    ref = quant.qmatmul_ref(aq, wq, colsum, bias)
    torch.cuda.synchronize()
    assert quant.qmatmul.launches == before + 1
    assert torch.equal(got, ref)


def test_fused_streaming_session_cuda_vs_cpu(cuda, toy_quant_conf):
    """One utterance through the fused int8 session on cuda and on the CPU:
    the first chunk's carried context within 1e-3, the same transcript, and
    the kernel launched once per linear per chunk step."""
    from catears_tpu_torch.io.wav import read_16k_pcm
    from catears_tpu_torch.runtime.recognizer import Recognizer
    from catears_tpu_torch.runtime.streaming import StreamingSession

    cfg = BeamConfig(beam_size=256, expand_size=2048, eps_expand_size=1024,
                     beam=1e9)
    samples = read_16k_pcm(os.path.join(DATA, "en-us-hello.wav"))
    out = []
    for dev in (torch.device("cpu"), cuda):
        rec = Recognizer(toy_quant_conf, beam_config=cfg, device=dev)
        graph = rec._decode_graph()
        sess = StreamingSession(rec.am, rec.fst, None, *graph)
        before = quant.qmatmul.launches
        sess.process(samples[:4000])  # one chunk: 20 + R frames
        ctx = torch.from_numpy(sess.get_state()["ctx"])
        launched = quant.qmatmul.launches - before
        sess.process(samples[4000:])
        sess.end_of_stream()
        out.append((ctx, sess.best_path(end_of_stream=True).words, launched,
                    sess.num_frames_decoded))
    linears = sum(1 for layer in rec.am.nnet_def if layer[0] == "linear")
    assert out[1][2] == linears and out[0][2] == 0
    assert torch.allclose(out[0][0], out[1][0], atol=1e-3)
    assert out[0][1:2] + out[0][3:] == out[1][1:2] + out[1][3:]


def test_sharded_pipeline_cuda_vs_cpu(cuda):
    """ShardedPipeline over 4 logical shards of the card (2 x 2) equals the
    same pipeline on 4 logical CPU devices: states and words equal, costs
    within 1e-3, log-probs within 2e-4 (tests/test_parallel.py's bars)."""
    from catears_tpu_torch.am.nnet import build_nnet
    from catears_tpu_torch.parallel.mesh import (ShardedPipeline,
                                                 logical_devices, make_mesh)
    from catears_tpu_torch.tools.toy import make_toy_nnet

    rng = np.random.RandomState(0)
    graph = make_phone_loop_graph(rng, num_words=6, num_pdfs=32)
    nnet = make_toy_nnet(rng, hidden=64, num_pdfs=32)
    nnet_def, params = build_nnet(nnet)
    fst = FlatFst.from_raw(graph.fst)
    cfg = BeamConfig(beam_size=64, expand_size=512, eps_expand_size=256,
                     max_eps_iters=3)
    wave = torch.from_numpy((np.random.RandomState(1).randn(8, 4000)
                             * 1000).astype(np.float32))
    lengths = torch.tensor([23, 12, 20, 23, 5, 17, 23, 9])
    outs = []
    for dev in (cuda, torch.device("cpu")):
        am = AcousticModel(nnet_def, params, np.log(np.full(32, 1 / 32)),
                           graph.tid2pdf, nnet.left_context,
                           nnet.right_context, 8, 32, device=dev)
        dfst = tdevice.DeviceFst.build(fst, graph.tid2pdf, device=dev)
        pipe = ShardedPipeline(am, dfst, None, cfg, make_mesh(
            4, 2, devices=logical_devices(4, dev)))
        outs.append(pipe.full_step(wave, pipe.make_beam(8), lengths,
                                   n_frames=23))
    (logp, beam, traces), (logp_c, beam_c, traces_c) = outs
    assert logp.device.type == "cuda"
    assert (logp.cpu() - logp_c).abs().max() <= 2e-4
    assert torch.equal(beam.states.cpu(), beam_c.states)
    assert torch.equal(traces.words.cpu(), traces_c.words)
    fin = torch.isfinite(beam_c.costs)
    assert (beam.costs.cpu()[fin] - beam_c.costs[fin]).abs().max() <= 1e-3


def test_train_am_first_step_cuda_vs_cpu(cuda):
    """tools.synth's loss and gradients at one fixed batch on the card
    against the same step on the CPU in float64: loss within 1e-5
    relative, each gradient within 1e-4 of its range."""
    from catears_tpu_torch.am.nnet import apply_layer, build_nnet
    from catears_tpu_torch.tools import synth
    from catears_tpu_torch.tools.toy import make_toy_nnet

    rng = np.random.RandomState(3)
    spec = make_toy_nnet(rng, hidden=256, num_pdfs=300, num_tdnn_layers=3)
    span = 128 + spec.left_context + spec.right_context
    data = [((rng.randn(600, 40) * 3 + 20).astype(np.float32),
             rng.randint(0, 300, 600 - span + 128).astype(np.int32))]
    spec, feats, labs, n_dev = synth.training_windows(spec, data)
    nnet_def, params = build_nnet(spec)

    def loss64(p, x, y):
        for layer, q in zip(nnet_def, p):
            x = (torch.matmul(x, q["w"]) + q["b"] if layer[0] == "linear"
                 else apply_layer(layer[0], layer, x, q))
        return -torch.mean(torch.gather(x, 2, y[:, :, None].long())[..., 0])

    got = []
    for dev, dtype in ((cuda, torch.float32),
                       (torch.device("cpu"), torch.float64)):
        p = [{k: torch.tensor(v, device=dev, dtype=dtype, requires_grad=True)
              for k, v in layer.items()} for layer in params]
        x = torch.from_numpy(feats).to(dev, dtype)
        y = torch.from_numpy(labs).to(dev)
        loss = (synth.loss_fn(nnet_def, p, x, y) if dtype == torch.float32
                else loss64(p, x, y))
        loss.backward()
        got.append((loss.item(), [v.grad.cpu().double() for layer in p
                                  for v in layer.values()]))
    (loss, grads), (loss_ref, grads_ref) = got
    assert abs(loss - loss_ref) <= 1e-5 * abs(loss_ref)
    for a, b in zip(grads, grads_ref):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_device_span_times_the_card_on_the_profilers_clock(cuda):
    """A device span's CUDA-event seconds cover its kernels, and the
    profiler shows those kernels inside the span's host interval (the
    spans' clock is the one kineto gives CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    from catears_tpu_torch.utils import log

    x = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    log.start_tracing()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with log.span("mm", device=True):
                for _ in range(8):
                    y = x @ x
                y.sum().item()  # the host waits: the kernels end inside
            torch.cuda.synchronize()
    finally:
        log.stop_tracing()
    (s,) = log.spans()
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type().name == "CUDA"
               and not e.name().startswith("Mem")]
    assert len(kernels) >= 8
    busy = sum(b - a for a, b in kernels) / 1e9
    assert busy * 0.9 <= s.device_s <= (s.end_ns - s.start_ns) / 1e9
    assert s.start_ns <= min(a for a, _ in kernels)
    assert max(b for _, b in kernels) <= s.end_ns


def test_tdnnf_stack_cuda_vs_cpu(cuda):
    """The chain TDNN-F at the recipe's widths (17 blocks of 1,536,
    bottleneck 160, strides 1,1,1,0,3 x 12, 7,000 pdfs, a 100-wide
    i-vector, MFCC folded into lda, subsampling 3) through batched_logp on
    the card: each utterance's rows as on the CPU and as the float64
    reference's every third row, within 1e-5 of the output's scale
    (tests/test_torch_tdnnf.py's tolerance)."""
    import tdnnf_reference as ref
    from _tdnnf_parity import make_model, nnet_spec
    from catears_tpu_torch.am.nnet import build_nnet

    rng = np.random.RandomState(17)
    model = make_model(rng, dim=1536, neck=160, pdfs=7000, ivector_dim=100,
                       small=256, strides=(1, 1, 1, 0) + (3,) * 12)
    spec = nnet_spec(model)
    nnet_def, params = build_nnet(spec)
    waves = [(rng.randn(n) * 1000).astype(np.float32)
             for n in (16000, 9999, 400 + 160 * 20, 3000)]
    ivs = rng.randn(len(waves), 100).astype(np.float32)
    out = []
    for dev in (torch.device("cpu"), cuda):
        am = AcousticModel(nnet_def, params, None,
                           np.zeros(14001, np.int32), 40, 40, 50, 7000,
                           device=dev, feature_type="mfcc")
        out.append(batched_logp(am, waves, ivs))
    (cpu, lengths), (gpu, lengths_gpu) = out
    assert lengths == lengths_gpu == [33, 20, 7, 6]
    want = ref.logp(model, waves, ivs, cuda)
    for u, n in enumerate(lengths):
        scale = float(want[u].abs().max())
        assert float((gpu[u, :n].cpu() - cpu[u, :n]).abs().max()) \
            <= 1e-5 * scale
        assert float((gpu[u, :n].double() - want[u]).abs().max()) \
            <= 1e-5 * scale


def test_batch_decoder_at_beam_7000_cuda_vs_cpu(cuda):
    """BatchDecoder at the chain cell's beam (7,000 slots, beam 15,
    acoustic scale 1.0) on a chain-topology graph of a few thousand
    states, planted paths at 30 ms frames: the card's words and costs
    equal the CPU's bit for bit, through the frame kernels."""
    from _tdnnf_parity import chain_graph, plant
    from catears_tpu_torch.decode import beam as tbeam

    rng = np.random.RandomState(23)
    fst, tid2pdf, pdfs, pairs = chain_graph(rng, num_words=3000,
                                            num_phones=40, variants=4)
    rows = [plant(rng, pairs, pdfs, n, amp=3.0) for n in (12, 7)]
    t = max(r[0].shape[0] for r in rows)
    logp = np.zeros((2, t, pdfs), np.float32)
    for i, (lp, _) in enumerate(rows):
        logp[i, :lp.shape[0]] = lp
    cfg = BeamConfig(beam_size=7000, expand_size=262144, beam=15.0)
    before = tbeam.select_beam.launches
    hyps = [BatchDecoder(fst, tid2pdf, am_scale=1.0, config=cfg,
                         arc_group=2, csr_group=16, device=dev).decode(
        logp, [r[0].shape[0] for r in rows], final_fallback=True)
        for dev in (torch.device("cpu"), cuda)]
    assert tbeam.select_beam.launches > before
    assert [h.words for h in hyps[0]] == [h.words for h in hyps[1]]
    assert [h.weight for h in hyps[0]] == [h.weight for h in hyps[1]]
    assert any(h.words for h in hyps[1])


def test_full_beam_7000_cuda_vs_cpu(cuda):
    """The chain cell's search where its 7,000-slot beam fills: a
    5,000-word chain graph of 350 phones x 10 variants, planted rows
    scaled by 0.1 at acoustic scale 1.0, beam 15.  Frame by frame through
    the frame kernels the card's beam (states and costs) equals the
    CPU's bit for bit, and it is full on all but the first two frames;
    BatchDecoder's graph-replayed decode gives the CPU's words and
    costs."""
    from _tdnnf_parity import chain_graph, plant
    from catears_tpu_torch.decode import beam as tbeam

    rng = np.random.RandomState(7)
    fst, tid2pdf, pdfs, pairs = chain_graph(rng, num_words=5000,
                                            num_phones=350, variants=10,
                                            phones=(3, 8))
    rows = [plant(rng, pairs, pdfs, 2)[0] for _ in range(2)]
    t = min(r.shape[0] for r in rows)
    logp = (0.1 * np.stack([r[:t] for r in rows])).astype(np.float32)
    cfg = BeamConfig(beam_size=7000, expand_size=16384, beam=15.0,
                     am_scale=1.0)
    decs = [BatchDecoder(fst, tid2pdf, am_scale=1.0, config=cfg,
                         arc_group=2, csr_group=16, device=dev)
            for dev in (torch.device("cpu"), cuda)]
    beams = [tbeam.init_beam_batch(d.cfg, 2, d.dfst, None)[0] for d in decs]
    valid = torch.ones(1, 2, dtype=torch.bool)
    full = 0
    for f in range(t):
        lp = torch.from_numpy(np.ascontiguousarray(
            logp[:, f:f + 1].transpose(1, 0, 2)))
        beams = [tbeam.decode_chunk(d.cfg, d.dfst, b, lp.to(d.dfst.device),
                                    valid.to(d.dfst.device), None)[0]
                 for d, b in zip(decs, beams)]
        for name in ("states", "costs", "bp"):
            x, y = (getattr(b, name) for b in beams)
            assert torch.equal(x, y.cpu()), (f, name)
        full += int(((beams[0].states >= 0).sum(dim=1) == 7000).all())
    assert t >= 20 and full >= t - 2
    hyps = [d.decode(logp, [t, t - 5], final_fallback=True) for d in decs]
    assert [h.words for h in hyps[0]] == [h.words for h in hyps[1]]
    assert [h.weight for h in hyps[0]] == [h.weight for h in hyps[1]]


def _lstm_case(b, t, seed=0, c=1024, r=256, p=256):
    """Recurrence inputs at the chain TDNN-LSTM's widths (cell 1,024,
    projections 256 and 256): gates' input half N(0, 1), W_r and W_rp
    randn / sqrt(fan in) (W_all's fan in 1,280), peepholes 0.5 randn."""
    g = torch.Generator().manual_seed(seed)
    gx = torch.randn(b, t, 4 * c, generator=g)
    w_r = torch.randn(r, 4 * c, generator=g) / np.sqrt(1280.0)
    peep = 0.5 * torch.randn(3, c, generator=g)
    w_rp = torch.randn(c, r + p, generator=g) / np.sqrt(c)
    b_rp = 0.1 * torch.randn(r + p, generator=g)
    return gx, w_r, peep, w_rp, b_rp


@pytest.mark.parametrize("b,t", [(16, 1167), (3, 40), (20, 60), (87, 84)])
def test_lstm_recurrence_kernel_vs_plain_loop(cuda, b, t):
    """csrc/lstm_recurrence.cu against lstm_recurrence_ref's loop run on
    the card (cuBLAS in float32, TF32 off) at the published widths, B 16
    and 1,167 steps (a 35 s utterance's rows), on batches of 3 and 20, and
    at a chunked BLSTM's batch, 87 windows x 84 steps; one launch each (up
    to 1,024 rows a launch).  Tolerance 1e-5 of the output's scale: both
    sum each step's products in float32 in different orders (a few eps of
    the sums' scale for 1,024 terms), and the state carries a step's
    rounding into the next, damped by the forget gate and the scale 0.85;
    the largest gap read on an H100 was 2.4e-7 of a scale of 1.2."""
    from catears_tpu_torch.am.lstm import (MAX_BATCH, lstm_recurrence,
                                           lstm_recurrence_ref)

    args = [x.to(cuda) for x in _lstm_case(b, t)]
    before = lstm_recurrence.launches
    got = lstm_recurrence(*args, 0.85)
    assert lstm_recurrence.launches - before == -(-b // MAX_BATCH) == 1
    want = lstm_recurrence_ref(*args, 0.85)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    print(f"lstm_recurrence b {b} t {t}: max gap {err!r} of {scale!r}")
    assert err <= 1e-5 * scale


# sha256 of the output bytes of csrc/lstm_recurrence.cu as it was before
# the kernel took more than 16 rows a launch, on _lstm_case(16, 84,
# seed=2) at scale 0.85 (NVIDIA H100 80GB HBM3, nvcc of CUDA 12.8): up to
# 16 rows the kernel computes exactly as it did.
NARROW_DIGEST = ("94cc2ffd20a8697450120e39f67bd3b57e145fcbb3cfa1613a752b8"
                 "77ca1c922")


def test_lstm_recurrence_narrow_batches_keep_their_bits(cuda):
    """Up to 16 rows: the output is bit for bit the earlier kernel's
    (`NARROW_DIGEST`); and each row of a wide launch is bit for bit that
    row in a launch of up to 16 rows."""
    import hashlib

    from catears_tpu_torch.am.lstm import lstm_recurrence

    gx, *weights = [x.to(cuda) for x in _lstm_case(16, 84, seed=2)]
    out = lstm_recurrence(gx, *weights, 0.85).cpu().numpy()
    assert hashlib.sha256(out.tobytes()).hexdigest() == NARROW_DIGEST
    wide = torch.cat([gx] * 6)[:90]
    got = lstm_recurrence(wide, *weights, 0.85)
    for lo in range(0, 90, 16):
        assert torch.equal(got[lo:lo + 16],
                           lstm_recurrence(wide[lo:lo + 16], *weights, 0.85))


def test_lstm_recurrence_kernel_is_deterministic(cuda):
    """Two runs give bit-equal outputs; what the kernel does not take
    raises."""
    from catears_tpu_torch.am.lstm import lstm_recurrence

    args = [x.to(cuda) for x in _lstm_case(16, 300, seed=1)]
    a = lstm_recurrence(*args, 0.85)
    b = lstm_recurrence(*args, 0.85)
    assert torch.equal(a, b)
    gx, w_r, peep, w_rp, b_rp = args
    with pytest.raises(ValueError):  # C = 1,020 is not a multiple of 8
        lstm_recurrence(gx[..., :4080], w_r[:, :4080], peep[:, :1020],
                        w_rp[:1020], b_rp, 0.85)
    with pytest.raises(ValueError):
        lstm_recurrence(gx.double(), w_r, peep, w_rp, b_rp, 0.85)


def test_tdnn_lstm_stack_cuda_vs_cpu(cuda):
    """The chain TDNN-LSTM at the recipe's widths (TDNN layers of 1,024,
    three LSTMP layers of 1,024 cells with projections 256 + 256, 7,000
    pdfs, a 100-wide i-vector, MFCC folded into lda, subsampling 3, output
    delay 5) through batched_logp on the card: one recurrence launch a
    LSTM layer and batch, each utterance's rows as on the CPU and as the
    float64 reference's within 1e-5 of the output's scale
    (tests/test_torch_tdnn_lstm.py's tolerance, and the kernel's above)."""
    import tdnn_lstm_reference as ref
    from _tdnn_lstm_parity import make_model, nnet_spec
    from catears_tpu_torch.am.lstm import lstm_recurrence
    from catears_tpu_torch.am.nnet import build_nnet

    rng = np.random.RandomState(21)
    model = make_model(rng, "recipe", dim=1024, cell=1024, rec=256,
                       nonrec=256, pdfs=7000, ivector_dim=100)
    spec = nnet_spec(model)
    assert (spec.left_context, spec.right_context) == (21, 11)
    nnet_def, params = build_nnet(spec)
    waves = [(rng.randn(n) * 1000).astype(np.float32)
             for n in (16000, 9999, 400 + 160 * 20, 3000)]
    ivs = rng.randn(len(waves), 100).astype(np.float32)
    out = []
    for dev in (torch.device("cpu"), cuda):
        am = AcousticModel(nnet_def, params, None,
                           np.zeros(14001, np.int32), 21, 11, 50, 7000,
                           device=dev, feature_type="mfcc")
        before = lstm_recurrence.launches
        out.append(batched_logp(am, waves, ivs))
    assert lstm_recurrence.launches - before == 3
    (cpu, lengths), (gpu, lengths_gpu) = out
    assert lengths == lengths_gpu == [33, 20, 7, 6]
    want = ref.logp(model, waves, ivs, cuda)
    for u, n in enumerate(lengths):
        scale = float(want[u].abs().max())
        assert float((gpu[u, :n].cpu() - cpu[u, :n]).abs().max()) \
            <= 1e-5 * scale
        assert float((gpu[u, :n].double() - want[u]).abs().max()) \
            <= 1e-5 * scale


def test_blstmp_both_directions_at_the_chunk_batch(cuda):
    """am.nnet.blstmp over 87 chunk windows of 20-84 rows x 84 at the
    published widths (cell 1,024, projections 256 + 256, input 1,024) on
    the card: one recurrence launch a direction, each backward chain from
    its window's own last row, the same as the layer on the CPU within
    1e-5 of the output's scale (the kernel's tolerance above)."""
    from catears_tpu_torch.am.lstm import lstm_recurrence
    from catears_tpu_torch.am.nnet import blstmp

    g = torch.Generator().manual_seed(4)
    c, r, d = 1024, 256, 1024

    def side():
        return {"w_x": torch.randn(d, 4 * c, generator=g) / np.sqrt(d + r),
                "w_r": torch.randn(r, 4 * c, generator=g) / np.sqrt(d + r),
                "b": 0.1 * torch.randn(4 * c, generator=g),
                "peephole": torch.randn(3, c, generator=g),
                "w_rp": torch.randn(c, 2 * r, generator=g) / np.sqrt(c),
                "b_rp": 0.1 * torch.randn(2 * r, generator=g)}

    p = {f"{k}_{n}": v for k in ("fw", "bw") for n, v in side().items()}
    x = torch.randn(87, 84, d, generator=g)
    lengths = torch.as_tensor(np.random.RandomState(4).randint(20, 85, 87))
    layer = ("blstmp", 3, 0.85, r, 0.85, r)
    want = blstmp(x, p, layer, 1, lengths=lengths)
    before = lstm_recurrence.launches
    got = blstmp(x.to(cuda), {k: v.to(cuda) for k, v in p.items()}, layer, 1,
                 lengths=lengths.to(cuda))
    assert lstm_recurrence.launches - before == 2
    mask = torch.arange(84)[None, :] < lengths[:, None]
    err = float((got.cpu() - want).abs()[mask].max())
    assert err <= 1e-5 * float(want[mask].abs().max()), err


def test_blstm_stack_cuda_vs_cpu(cuda):
    """The chain BLSTM at the recipe's widths (three BLSTM layers of 1,024
    cells a direction with projections 256 + 256, 7,000 pdfs, a 100-wide
    i-vector, MFCC folded into lda, subsampling 3) in the recipe's chunks
    (150 frames, 50 of extra context, none at the edges) through
    batched_logp on the card: one recurrence launch a layer and direction,
    each utterance's rows as on the CPU and as the float64 reference's
    within 1e-5 of the output's scale (tests/test_torch_blstm.py's
    tolerance, and the kernel's above)."""
    import blstm_reference as ref
    from _blstm_parity import RECIPE_CHUNK, make_model, nnet_spec
    from catears_tpu_torch.am.chunks import ChunkOptions
    from catears_tpu_torch.am.lstm import lstm_recurrence
    from catears_tpu_torch.am.nnet import build_nnet

    rng = np.random.RandomState(22)
    model = make_model(rng, layers=3, cell=1024, rec=256, nonrec=256,
                       pdfs=7000, ivector_dim=100)
    spec = nnet_spec(model)
    assert (spec.left_context, spec.right_context) == (2, 2)
    nnet_def, params = build_nnet(spec)
    waves = [(rng.randn(n) * 1000).astype(np.float32)
             for n in (48000, 16000, 400 + 160 * 149, 3000)]
    ivs = rng.randn(len(waves), 100).astype(np.float32)
    out = []
    for dev in (torch.device("cpu"), cuda):
        am = AcousticModel(nnet_def, params, None,
                           np.zeros(14001, np.int32), 2, 2, 50, 7000,
                           device=dev, feature_type="mfcc",
                           chunking=ChunkOptions(**RECIPE_CHUNK))
        before = lstm_recurrence.launches
        out.append(batched_logp(am, waves, ivs))
    assert lstm_recurrence.launches - before == 6
    (cpu, lengths), (gpu, lengths_gpu) = out
    assert lengths == lengths_gpu == [100, 33, 50, 6]
    want = ref.logp(model, waves, ivs, cuda, RECIPE_CHUNK)
    for u, n in enumerate(lengths):
        scale = float(want[u].abs().max())
        assert float((gpu[u, :n].cpu() - cpu[u, :n]).abs().max()) \
            <= 1e-5 * scale
        assert float((gpu[u, :n].double() - want[u]).abs().max()) \
            <= 1e-5 * scale
