"""The port's chain TDNN-LSTM (am/nnet.py's lstmp, spliced-affine and delay
kinds, am/lstm.py's recurrence, am/model.py, runtime/batch.py) against the
plain reference (tests/tdnn_lstm_reference.py) on the CPU, at a small
size: cell 32, recurrent and non-recurrent projections 8 and 8, two LSTM
layers of delay 3 frames, TDNN layers of 32, 48 pdfs, a 10-wide
i-vector, MFCC input, frame subsampling 3, recurrence scales 1.0 and
0.85.  Outputs are compared, not decoded words.

Tolerance, `TOL` x the reference's largest output: the port runs in
float32 (eps 1.2e-7) through about 12 matmuls of sums at most 250 wide and
a recurrence of up to 35 steps whose state is damped by the forget gate
and the scale; its largest gap to the float64 reference is about 2e-6 of
the output's scale (about 0.6 here), which 1e-5 leaves 5x room, and the
reference with its matmuls in bfloat16 (eps 7.8e-3) misses by 100x
(`test_bfloat16_reference_fails_the_tolerance`).

Beside it: a ragged batch against each utterance alone, the bucket's
padding changing nothing while each recurrence steps only the rows valid
outputs read, the NN02 round trip of the new kinds, the plan's refusals,
the spans and counters, and the CLI on a TDNN-LSTM model directory."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tdnn_lstm_reference as ref
from _tdnn_lstm_parity import make_model, nnet_spec, write_lstm_model
from catears_tpu_torch.am.lstm import lstm_recurrence, lstm_recurrence_ref
from catears_tpu_torch.am.model import AcousticModel, AMStream
from catears_tpu_torch.am.nnet import build_nnet, context_frames
from catears_tpu_torch.frontend.fbank import bucket, num_frames
from catears_tpu_torch.io import binfmt
from catears_tpu_torch.runtime.batch import _batched_logp, batched_logp
from catears_tpu_torch.runtime.recognizer import Recognizer
from catears_tpu_torch.utils import log
from catears_tpu_torch.utils.errors import (CorruptionError,
                                            NotImplementedError_)

CPU = torch.device("cpu")
TOL = 1e-5
# 16000 samples: 98 frames; 9999: 61; 3000: 17 (T mod 3 = 2, 1, 2).
RAGGED = (16000, 9999, 3000)


def build_am(model, quantized=False):
    spec = nnet_spec(model)
    nnet_def, params = build_nnet(spec)
    pdfs = model["output"]["w"].shape[1]
    return AcousticModel(
        nnet_def, params, None, np.zeros(2 * pdfs + 1, np.int32),
        spec.left_context, spec.right_context, 50, pdfs, device=CPU,
        feature_type="mfcc", quantized=quantized)


def inputs(seed, samples=RAGGED):
    rng = np.random.RandomState(seed)
    waves = [(rng.randn(n) * 1000).astype(np.float32) for n in samples]
    return waves, rng.randn(len(waves), 10).astype(np.float32)


def assert_close(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| <= TOL x max |want| (see the module docstring)."""
    assert got.shape == want.shape
    err = float((got.double() - want.double()).abs().max())
    assert err <= TOL * float(want.abs().max()), err
    return err


@pytest.mark.parametrize("scale", [1.0, 0.85])
@pytest.mark.parametrize("plan", ["sub", "full"])
def test_batched_logp_matches_reference(plan, scale):
    """Each utterance's ceil(T / 3) rows equal the reference's, with the
    LSTMs recurring at the subsampled rate ("sub", the recipe's plan) or
    the first at every frame ("full": three interleaved chains)."""
    model = make_model(np.random.RandomState(0), plan, scale=scale)
    waves, ivs = inputs(1)
    got, lengths = batched_logp(build_am(model), waves, ivs)
    want = ref.logp(model, waves, ivs, CPU)
    assert lengths == [-(-ref.num_frames(n) // 3) for n in RAGGED]
    assert got.shape[:2] == (len(waves), max(lengths))
    for u, n in enumerate(lengths):
        assert_close(got[u, :n], want[u])


def test_bfloat16_reference_fails_the_tolerance():
    model = make_model(np.random.RandomState(0))
    waves, ivs = inputs(7)
    want = ref.logp(model, waves, ivs, CPU)
    low = ref.logp(model, waves, ivs, CPU, "bfloat16")
    for a, b in zip(low, want):
        err = float((a.double() - b).abs().max())
        assert err > 10 * TOL * float(b.abs().max())


def test_single_utterance_ignores_its_batch():
    """Each utterance's rows are the same alone and in a ragged batch."""
    am = build_am(make_model(np.random.RandomState(2)))
    waves, ivs = inputs(3)
    batch, lengths = batched_logp(am, waves, ivs)
    for u, w in enumerate(waves):
        alone, n = batched_logp(am, [w], ivs[u:u + 1])
        assert n == [lengths[u]]
        assert_close(batch[u, :lengths[u]], alone[0, :n[0]])


def test_padding_changes_nothing_and_only_needed_steps_run():
    """A bucket twice as long gives the same valid rows, and each
    recurrence steps the rows valid outputs read (the longest utterance's
    rows plus the context after its layer), not the padded ones."""
    model = make_model(np.random.RandomState(4))
    am = build_am(model)
    waves, ivs = inputs(5)
    frames = [num_frames(w.size) for w in waves]
    out = []
    for s_max in (bucket(max(RAGGED), base=4096),
                  2 * bucket(max(RAGGED), base=4096)):
        padded = torch.zeros(len(waves), s_max)
        for i, w in enumerate(waves):
            padded[i, :w.size] = torch.as_tensor(w)
        log.reset_metrics()
        with torch.no_grad():
            out.append(_batched_logp(am, num_frames(s_max), padded,
                                     torch.as_tensor(frames),
                                     torch.as_tensor(ivs), max(frames)))
        m = log.metrics()
        rows = -(-max(frames) // 3)
        # lstm1 reads 2 rows more than the output (tdnn3's +-3 frames).
        assert m["lstm_steps"] == m["lstm_steps_needed"] \
            == (rows + 2) + rows
    log.reset_metrics()
    for u, t in enumerate(frames):
        n = -(-t // 3)
        assert_close(out[0][u, :n], out[1][u, :n])
    assert out[1].shape[1] > out[0].shape[1]


def test_recurrence_ref_steps_the_equations():
    """lstm_recurrence on CPU tensors is the plain loop; one step from
    zero state, by hand."""
    g = torch.Generator().manual_seed(0)
    b, t, c, r, p = 2, 3, 4, 2, 2
    gx = torch.randn(b, t, 4 * c, generator=g)
    w_r, peep = torch.randn(r, 4 * c, generator=g), \
        torch.randn(3, c, generator=g)
    w_rp, b_rp = torch.randn(c, r + p, generator=g), \
        torch.randn(r + p, generator=g)
    out = lstm_recurrence(gx, w_r, peep, w_rp, b_rp, 0.85)
    assert torch.equal(out, lstm_recurrence_ref(gx, w_r, peep, w_rp, b_rp,
                                                0.85))
    i, f, gg, o = gx[:, 0].split(c, dim=-1)
    cell = torch.sigmoid(i) * torch.tanh(gg)
    m = torch.sigmoid(o + peep[2] * cell) * torch.tanh(cell)
    assert torch.allclose(out[:, 0], m @ w_rp + b_rp, atol=1e-6)
    with pytest.raises(ValueError):
        lstm_recurrence(gx.double(), w_r, peep, w_rp, b_rp, 0.85)


def test_nn02_round_trip_of_the_lstm_kinds(tmp_path):
    model = make_model(np.random.RandomState(6))
    spec = nnet_spec(model)
    path = tmp_path / "am.nnet"
    with open(path, "wb") as fd:
        binfmt.write_nnet(fd, spec)
    back = binfmt.read_nnet_file(str(path))
    assert (back.left_context, back.right_context) == (11, 1) \
        == ref.context(model)
    kinds = [x.kind for x in back.layers]
    assert kinds == [x.kind for x in spec.layers]
    assert {binfmt.LAYER_LSTMP, binfmt.LAYER_SPLICED_AFFINE,
            binfmt.LAYER_DELAY, binfmt.LAYER_SUBSAMPLE} <= set(kinds)
    for a, b in zip(spec.layers, back.layers):
        for key in ("weight", "bias", "scale", "offset", "peephole",
                    "projection", "projection_bias"):
            x, y = getattr(a, key), getattr(b, key)
            assert (x is None) == (y is None)
            if x is not None:
                assert np.array_equal(np.asarray(x, np.float32), y)
        assert (a.offsets, a.delay, a.rec_dim, a.factor, a.dim) == (
            b.offsets, b.delay, b.rec_dim, b.factor, b.dim)
        assert np.float32(a.rec_scale) == np.float32(b.rec_scale)
    d1, _ = build_nnet(spec)
    d2, _ = build_nnet(back)
    assert d1 == d2
    assert context_frames(d1) == (11, 1)


def _bad_delay():
    model = make_model(np.random.RandomState(1))
    model["layers"][4]["delay"] = -2  # at 3 frames a row
    return nnet_spec(model)


@pytest.mark.parametrize("what", ["delay", "quantized", "streaming"])
def test_refusals(what, tmp_path):
    """A recurrence delay the row rate does not divide; `quantized = true`;
    the live path (one row per 10 ms frame, no i-vector)."""
    if what == "delay":
        with pytest.raises(CorruptionError):
            build_nnet(_bad_delay())
    elif what == "quantized":
        with pytest.raises(NotImplementedError_):
            build_am(make_model(np.random.RandomState(1)), quantized=True)
    else:
        conf, _, _ = write_lstm_model(str(tmp_path),
                                      np.random.RandomState(2))
        rec = Recognizer(conf, device=CPU)
        with pytest.raises(NotImplementedError_):
            rec.create_stream_batch(2)
        with pytest.raises(NotImplementedError_):
            AMStream(rec.am)


def test_spans_and_counters_of_the_recurrence():
    """Tracing, am.subsampled holds one am.recurrence a LSTM layer, with
    its layer, steps and batch; am_flops counts the recurrence too."""
    model = make_model(np.random.RandomState(8))
    am = build_am(model)
    waves, ivs = inputs(9)
    log.reset_metrics()
    log.start_tracing()
    try:
        batched_logp(am, waves, ivs)
    finally:
        log.stop_tracing()
    m = log.metrics()
    log.reset_metrics()
    spans = log.spans()
    (sub,) = [s for s in spans if s.name == "am.subsampled"]
    rec = [s for s in spans if s.name == "am.recurrence"]
    assert [s.parent for s in rec] == [sub.id, sub.id]
    rows = -(-num_frames(max(RAGGED)) // 3)
    assert [(s.attrs["steps"], s.attrs["batch"]) for s in rec] == [
        (rows + 2, 3), (rows, 3)]
    assert m["lstm_steps"] == m["lstm_steps_needed"] == 2 * rows + 2
    # The recurrences' matmuls: 2 (R x 4C + C x (R + P)) a row and step.
    assert m["am_flops"] >= 3 * (2 * rows + 2) * 2 * (8 * 128 + 32 * 16)


def test_cli_decodes_a_tdnn_lstm_model(tmp_path, data_dir, capsys):
    """`catears <conf> <scp> --batch --ivectors` through AcousticModel.read,
    batched_logp and BatchDecoder; the Recognizer reads the nnet's
    subsampling and i-vector width."""
    from catears_tpu_torch import cli

    conf, _, dim = write_lstm_model(str(tmp_path), np.random.RandomState(2))
    rec = Recognizer(conf, device=CPU)
    assert rec.am.frame_subsampling_factor == 3 and rec.am.ivector_dim == dim
    scp = tmp_path / "list.scp"
    scp.write_text(f"a {data_dir}/en-us-hello.wav\n"
                   f"b {data_dir}/en-us-cat.wav\n")
    ark = tmp_path / "ivectors.txt"
    ark.write_text("".join(f"{n}  [ " + " ".join(["0.5"] * dim) + " ]\n"
                           for n in "ab"))
    assert cli.main(["--batch=2", "--device=cpu", f"--ivectors={ark}", conf,
                     str(scp)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [x.split()[0] for x in lines] == ["a", "b"]
