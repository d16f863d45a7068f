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
CPU's (states, bit-equal weights); the decoder on cuda, LM off and on, on
eps-free, closed and raw graphs, must give the CPU's words and bit-equal
costs.
"""

import os

import numpy as np
import pytest
import torch

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
        ctx = sess._ctx.cpu()
        launched = quant.qmatmul.launches - before
        sess.process(samples[4000:])
        sess.end_of_stream()
        out.append((ctx, sess.best_path(end_of_stream=True).words, launched,
                    sess.num_frames_decoded))
    linears = sum(1 for layer in rec.am.nnet_def if layer[0] == "linear")
    assert out[1][2] == linears and out[0][2] == 0
    assert torch.allclose(out[0][0], out[1][0], atol=1e-3)
    assert out[0][1:2] + out[0][3:] == out[1][1:2] + out[1][3:]
