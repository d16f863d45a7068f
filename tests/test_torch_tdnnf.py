"""The port's chain TDNN-F (am/nnet.py, am/model.py, runtime/batch.py)
against the plain reference (tests/tdnnf_reference.py) on the CPU, at a
small size: dim 64, bottleneck 16, strides (1, 0, 3, 3), 48 pdfs, a
10-wide i-vector, MFCC input, frame subsampling 3.  Outputs are compared,
not decoded words.

Tolerance, `TOL` x the reference's largest output: the port runs in
float32 (eps 1.2e-7) through ~30 matmuls of at most 3 x 64-wide sums and
adds, each rounding by about eps times the magnitude it carries; 1e-5 of
the output's scale (about 50 here) leaves it 5-10x room, and the
reference with its matmuls in bfloat16 (eps 7.8e-3) misses by 100x
(`test_bfloat16_reference_fails_the_tolerance`).

Beside it: the MFCC fold against the unfolded MFCC, the NN02 round trip
of the new layer kinds, an end-to-end BatchDecoder decode of planted
chain paths, the chain search's full 7,000-slot beam against the JAX
package's decoder, a Recognizer and the CLI on a chain model directory,
and live streaming's refusal of a subsampled model."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tdnnf_reference as ref
from _tdnnf_parity import (chain_graph, make_model, nnet_spec, plant,
                           write_chain_model)
from catears_tpu_torch.am.model import AcousticModel, AMStream
from catears_tpu_torch.am.nnet import build_nnet, layer_rates
from catears_tpu_torch.decode.beam import BeamConfig
from catears_tpu_torch.decode.decoder import BatchDecoder
from catears_tpu_torch.frontend.fbank import bucket, num_frames
from catears_tpu_torch.frontend.mfcc import mfcc_matrix
from catears_tpu_torch.io import binfmt
from catears_tpu_torch.runtime.batch import (batched_logp, decode_scp,
                                             get_batch_decoder)
from catears_tpu_torch.runtime.recognizer import Recognizer
from catears_tpu_torch.utils import log
from catears_tpu_torch.utils.errors import (CatEarsError, CorruptionError,
                                            NotImplementedError_)

CPU = torch.device("cpu")
TOL = 1e-5


def build_am(model, device=CPU, fold=True):
    spec = nnet_spec(model)
    nnet_def, params = build_nnet(spec)
    pdfs = model["output"]["w"].shape[1]
    return AcousticModel(
        nnet_def, params, None, np.zeros(2 * pdfs + 1, np.int32),
        spec.left_context, spec.right_context, 50, pdfs, device=device,
        feature_type="mfcc" if fold else "fbank")


def waves_of(rng, samples):
    return [(rng.randn(n) * 1000).astype(np.float32) for n in samples]


def assert_close(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| <= TOL x max |want| (see the module docstring)."""
    assert got.shape == want.shape
    err = float((got.double() - want.double()).abs().max())
    assert err <= TOL * float(want.abs().max()), err
    return err


@pytest.fixture(scope="module")
def model():
    return make_model(np.random.RandomState(0))


# 16000 samples: 98 frames (T mod 3 = 2); 9999: 61 (T mod 3 = 1);
# 400 + 160 x 4: 5 frames, fewer than the 8 of context; 3000: 16.
RAGGED = (16000, 9999, 400 + 160 * 4, 3000)


@pytest.mark.parametrize("samples", [(16000,), (400 + 160 * 59,),
                                     (400 + 160 * 4,), RAGGED],
                         ids=["one", "T-mod-3-0", "shorter-than-context",
                              "ragged"])
def test_batched_logp_matches_reference(model, samples):
    """Each utterance's ceil(T / 3) rows equal the reference's every
    third row of the full-rate stack, whatever else shares the batch."""
    rng = np.random.RandomState(len(samples))
    waves = waves_of(rng, samples)
    ivs = rng.randn(len(waves), 10).astype(np.float32)
    got, lengths = batched_logp(build_am(model), waves, ivs)
    want = ref.logp(model, waves, ivs, CPU)
    assert lengths == [-(-ref.num_frames(n) // 3) for n in samples]
    assert got.shape[:2] == (len(waves), max(lengths))
    for u, n in enumerate(lengths):
        assert_close(got[u, :n], want[u])


def test_bfloat16_reference_fails_the_tolerance(model):
    rng = np.random.RandomState(7)
    waves = waves_of(rng, RAGGED)
    ivs = rng.randn(len(waves), 10).astype(np.float32)
    want = ref.logp(model, waves, ivs, CPU)
    low = ref.logp(model, waves, ivs, CPU, "bfloat16")
    for a, b in zip(low, want):
        err = float((a.double() - b).abs().max())
        assert err > 10 * TOL * float(b.abs().max())


def test_single_utterance_ignores_its_batch(model):
    """Row u of utterance i is the same alone and in a ragged batch."""
    rng = np.random.RandomState(3)
    waves = waves_of(rng, RAGGED)
    ivs = rng.randn(len(waves), 10).astype(np.float32)
    am = build_am(model)
    batch, lengths = batched_logp(am, waves, ivs)
    for u, w in enumerate(waves):
        alone, n = batched_logp(am, [w], ivs[u:u + 1])
        assert n == [lengths[u]]
        assert_close(batch[u, :lengths[u]], alone[0, :n[0]])


def test_mfcc_fold_matches_unfolded(model):
    """The stack with the DCT and lifter folded into lda, on log-mel rows,
    equals the unfolded stack on the reference's MFCC of those rows."""
    rng = np.random.RandomState(4)
    logmel = torch.as_tensor(rng.randn(60, 40) * 3 + 15)
    iv = torch.as_tensor(rng.randn(10), dtype=torch.float32)
    folded, plain = build_am(model), build_am(model, fold=False)
    pad = torch.cat([logmel[:1].expand(8, -1), logmel,
                     logmel[-1:].expand(8, -1)]).float()
    mf = ref.mfcc(pad.double(), 40, 22.0).float()
    with torch.no_grad():
        a = folded.forward_padded(pad, iv)
        b = plain.forward_padded(mf, iv)
    assert a.shape == (20, 48)
    assert_close(a, b)
    m = mfcc_matrix()
    assert np.allclose(ref.mfcc(torch.as_tensor(np.eye(40)), 40, 22.0)
                       .numpy(), m, atol=1e-12)


def test_nn02_round_trip_of_the_tdnnf_kinds(tmp_path, model):
    spec = nnet_spec(model)
    path = tmp_path / "am.nnet"
    with open(path, "wb") as fd:
        binfmt.write_nnet(fd, spec)
    back = binfmt.read_nnet_file(str(path))
    assert (back.left_context, back.right_context) == (8, 8)
    kinds = [x.kind for x in back.layers]
    assert kinds == [x.kind for x in spec.layers]
    assert {binfmt.LAYER_SPLICED_LINEAR, binfmt.LAYER_TDNNF,
            binfmt.LAYER_SUBSAMPLE, binfmt.LAYER_IVECTOR} <= set(kinds)
    for a, b in zip(spec.layers, back.layers):
        for key in ("weight", "bias", "scale", "offset", "linear",
                    "affine"):
            x, y = getattr(a, key), getattr(b, key)
            assert (x is None) == (y is None)
            if x is not None:
                assert np.array_equal(np.asarray(x, np.float32), y)
        assert (a.offsets, a.stride, a.factor, a.dim) == (
            b.offsets, b.stride, b.factor, b.dim)
        assert np.float32(a.bypass) == np.float32(b.bypass)
    d1, _ = build_nnet(spec)
    d2, _ = build_nnet(back)
    assert d1 == d2
    assert layer_rates(d1)[-1] == 3


def test_plan_refusals(model):
    """A stride the subsample factor does not divide, a splice after the
    subsample layer, a context the stack does not consume, a feature type
    the model cannot take."""
    bad = nnet_spec(make_model(np.random.RandomState(1),
                               strides=(1, 0, 3, 2)))
    with pytest.raises(CorruptionError):
        build_nnet(bad)
    spec = nnet_spec(model)
    spec.layers.insert(12, binfmt.LayerSpec(binfmt.LAYER_SPLICE,
                                            indices=(-1, 0, 1)))
    with pytest.raises(CorruptionError):
        build_nnet(spec)
    nnet_def, params = build_nnet(nnet_spec(model))
    with pytest.raises(CorruptionError):  # context 8, not 7
        AcousticModel(nnet_def, params, None, np.zeros(97, np.int32), 7, 8,
                      50, 48, device=CPU)
    with pytest.raises(CorruptionError):
        AcousticModel(nnet_def, params, None, np.zeros(97, np.int32), 8, 8,
                      50, 48, device=CPU, feature_type="plp")
    am = AcousticModel(nnet_def, params, None, np.zeros(97, np.int32), 8, 8,
                       50, 48, device=CPU)
    assert (am.frame_subsampling_factor, am.ivector_dim) == (3, 10)


def test_counters_and_spans_of_the_plan(model):
    """am_flops counts the linears as enqueued, am_rows_* the rows each
    part put out; tracing, logp.am holds am.full_rate then
    am.subsampled."""
    rng = np.random.RandomState(5)
    waves = waves_of(rng, RAGGED)
    ivs = rng.randn(len(waves), 10).astype(np.float32)
    am = build_am(model)
    log.reset_metrics()
    log.start_tracing()
    try:
        batched_logp(am, waves, ivs)
    finally:
        log.stop_tracing()
    m = log.metrics()
    log.reset_metrics()
    spans = log.spans()
    (amspan,) = [s for s in spans if s.name == "logp.am"]
    kids = [s.name for s in spans if s.parent == amspan.id]
    assert kids == ["am.full_rate", "am.subsampled"]
    b = len(waves)
    t_b = num_frames(bucket(max(RAGGED), base=4096))  # the padded frames
    assert m["am_rows_full_rate"] == b * (t_b + 12)
    # Hand count of the plan at these widths, per batch row: lda and
    # tdnn1 on T + 14 rows, the stride-1 block's linear on T + 13 and
    # affine on T + 12; after the subsample (ceil((T + 12) / 3) rows),
    # the stride-0 block, two stride-3 blocks, prefinal and output.
    lda, dim, neck, small = 130, 64, 16, 16
    r = t_b + 14
    full = 2 * r * lda * lda + 2 * r * lda * dim \
        + 2 * (r - 1) * 2 * dim * neck + 2 * (r - 2) * 2 * neck * dim
    s = -(-(t_b + 12) // 3)
    sub = 2 * s * (dim * neck + neck * dim) \
        + 2 * (s - 1) * 2 * dim * neck + 2 * (s - 2) * 2 * neck * dim \
        + 2 * (s - 3) * 2 * dim * neck + 2 * (s - 4) * 2 * neck * dim \
        + 2 * (s - 4) * (dim * small + small * dim + dim * small
                         + small * 48)
    assert m["am_rows_subsampled"] == b * (s - 4) == b * -(-t_b // 3)
    assert m["am_flops"] == b * (full + sub)


def test_batch_decoder_recovers_planted_chain_words():
    """Planted chain-topology paths at 30 ms frames decode to their words
    through BatchDecoder at acoustic scale 1.0, ragged."""
    rng = np.random.RandomState(11)
    fst, tid2pdf, pdfs, pairs = chain_graph(rng)
    rows = [plant(rng, pairs, pdfs, n) for n in (6, 3, 9)]
    t = max(r[0].shape[0] for r in rows)
    logp = np.zeros((3, t, pdfs), np.float32)
    for i, (lp, _) in enumerate(rows):
        logp[i, :lp.shape[0]] = lp
    dec = BatchDecoder(fst, tid2pdf, am_scale=1.0,
                       config=BeamConfig(beam_size=256, expand_size=4096,
                                         beam=15.0),
                       arc_group=2, csr_group=16, device=CPU)
    hyps = dec.decode(logp, [r[0].shape[0] for r in rows])
    assert [h.words for h in hyps] == [truth for _, truth in rows]
    assert dec.cfg.am_scale == 1.0


def test_full_7000_slot_beam_equals_jax():
    """The chain decode's settings (beam_size 7,000, beam 15, acoustic
    scale 1.0, planted rows scaled by 0.1, eps-free, arc group 2, CSR
    group 16) on a 5,000-word chain graph of 350 phones x 10 variants,
    whose beam is full from the third frame on: every chunk's beam and
    trace equal the JAX package's decoder's, the selection at 7,000 slots
    included."""
    from _torch_parity import run_chunks

    from catears_tpu.decode import beam as jbeam
    from catears_tpu.graph import device as jdevice
    from catears_tpu.graph import transform as jtransform
    from catears_tpu.graph.fst import FlatFst as JaxFlatFst
    from catears_tpu_torch.decode import beam as tbeam
    from catears_tpu_torch.graph import device as tdevice
    from catears_tpu_torch.graph import transform as ttransform

    rng = np.random.RandomState(7)
    fst, tid2pdf, pdfs, pairs = chain_graph(rng, num_words=5000,
                                            num_phones=350, variants=10,
                                            phones=(3, 8))
    rows = [plant(rng, pairs, pdfs, 2)[0] for _ in range(2)]
    t = min(r.shape[0] for r in rows)
    logp = 0.1 * np.stack([r[:t] for r in rows])
    jfst = JaxFlatFst.from_arrays(
        fst.start, fst.final,
        np.repeat(np.arange(fst.num_states), np.diff(fst.offsets)),
        fst.arc_next, fst.arc_ilabel, fst.arc_olabel, fst.arc_weight)
    tables = []
    for transform, device, g, kw in (
            (jtransform, jdevice, jfst, {}),
            (ttransform, tdevice, fst, {"device": CPU})):
        g2, olab2, mode = transform.prepare_decode_graph(g)
        assert mode == "eps_free"
        tables.append(device.DeviceFst.build(
            g2, tid2pdf, group=2, eps_depth_cap=1, olabel2=olab2,
            csr_group=16, **kw))
    cfg = dict(beam_size=7000, expand_size=16384, eps_expand_size=1024,
               max_eps_iters=3, beam=15.0, am_scale=1.0)
    final = run_chunks(*tables, jbeam.BeamConfig(**cfg),
                       tbeam.BeamConfig(**cfg), logp, [t, t - 5], chunk=10)
    assert t >= 20
    assert ((np.asarray(final.states) >= 0).sum(axis=1) == 7000).all()


def test_recognizer_reads_a_chain_model(tmp_path, data_dir):
    """am_scale comes from the config, the subsampling factor and the
    i-vector width from the nnet; the batch path needs the i-vectors and
    decodes with them."""
    conf, _, dim = write_chain_model(str(tmp_path),
                                     np.random.RandomState(2))
    rec = Recognizer(conf, device=CPU)
    assert rec.am_scale == 1.0 and rec.beam_config.am_scale == 1.0
    assert rec.am.frame_subsampling_factor == 3 and rec.am.ivector_dim == dim
    assert not rec.am.has_prior
    assert get_batch_decoder(rec).cfg.am_scale == 1.0
    scp = tmp_path / "list.scp"
    scp.write_text(f"a {data_dir}/en-us-hello.wav\n"
                   f"b {data_dir}/en-us-cat.wav\n")
    with pytest.raises(CatEarsError):
        decode_scp(rec, str(scp), batch_size=2)
    ivs = {"a": np.zeros(dim, np.float32), "b": np.ones(dim, np.float32)}
    out = decode_scp(rec, str(scp), batch_size=2, ivectors=ivs)
    assert [name for name, _ in out] == ["a", "b"]


def test_cli_decodes_a_chain_model_in_batches(tmp_path, data_dir, capsys):
    from catears_tpu_torch import cli

    conf, _, dim = write_chain_model(str(tmp_path),
                                     np.random.RandomState(2))
    scp = tmp_path / "list.scp"
    scp.write_text(f"a {data_dir}/en-us-hello.wav\n")
    ark = tmp_path / "ivectors.txt"
    ark.write_text("a  [ " + " ".join(["0.5"] * dim) + " ]\n")
    assert cli.main(["--batch=1", "--device=cpu", f"--ivectors={ark}", conf,
                     str(scp)]) == 0
    assert capsys.readouterr().out.startswith("a")
    assert cli.main(["--batch=1", "--device=cpu", conf, str(scp)]) == 1
    assert cli.main(["--device=cpu", conf,
                     f"{data_dir}/en-us-hello.wav"]) == 1
    assert "frame_subsampling_factor 3" in capsys.readouterr().err


def test_streaming_refuses_a_subsampled_model(tmp_path, model):
    conf, _, _ = write_chain_model(str(tmp_path), np.random.RandomState(2))
    rec = Recognizer(conf, device=CPU)
    with pytest.raises(NotImplementedError_):
        rec.create_stream_batch(2)
    with pytest.raises(NotImplementedError_):
        AMStream(rec.am)
    from catears_tpu_torch.io.wav import WaveFormat

    with pytest.raises(NotImplementedError_):
        rec.create_utterance(WaveFormat(1, 16000, 16))
