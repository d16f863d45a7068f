"""The port's chain BLSTM (NN02 kind 17, am/nnet.py's blstmp, am/chunks.py's
planner, am/model.py's chunked path, runtime/batch.py) against the plain
reference (tests/blstm_reference.py, one utterance and one chunk at a
time) on the CPU, at a small size: two BLSTM layers of 16 cells a
direction, projections 8 + 8, delay 3 frames, 48 pdfs, a 10-wide
i-vector, MFCC input, frame subsampling 3, chunks of 30 frames (10 output
rows) with 12 frames (4 rows) of extra context.  Outputs are compared,
not decoded words.

Tolerance, `TOL` x the reference's largest output: the port runs in
float32 (eps 1.2e-7) through 2 BLSTM layers of sums at most 250 wide and
recurrences of up to 18 steps damped by the forget gate and the scale;
its largest gap to the float64 reference is about 3.5e-6 of the output's
scale (about 0.65 here), which 1e-5 leaves 3x room, and the reference
with its matmuls in bfloat16 (eps 7.8e-3) misses by more than 10x
(`test_bfloat16_reference_fails_the_tolerance`).

Beside it: the chunk plan by hand, a ragged batch whose shorter
utterances' padding would reach a backward chain started at the batch's
end, an utterance shorter than one chunk and one of exactly k chunks, the
utterance edges' extra contexts, the NN02 round trip of kind 17, the
refusals, the spans and counters, the host path and the CLI."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import blstm_reference as ref
from _blstm_parity import (CHUNK, RECIPE_CHUNK, chunk_conf, make_model,
                           nnet_spec, write_blstm_model)
from catears_tpu_torch.am.chunks import ChunkOptions, plan_chunks
from catears_tpu_torch.am.model import AcousticModel, AMStream
from catears_tpu_torch.am.nnet import (blstmp, build_nnet, context_frames,
                                       output_dim, reverse_rows)
from catears_tpu_torch.frontend.fbank import num_frames
from catears_tpu_torch.io import binfmt
from catears_tpu_torch.io.config import Configuration
from catears_tpu_torch.runtime.batch import batched_logp
from catears_tpu_torch.runtime.recognizer import Recognizer
from catears_tpu_torch.utils import log
from catears_tpu_torch.utils.errors import (CorruptionError,
                                            NotImplementedError_)

CPU = torch.device("cpu")
TOL = 1e-5
# 16000 samples: 98 frames, 33 rows (4 chunks, the last of 3 rows); 9840:
# 60 frames, 20 rows (exactly 2 chunks); 3000: 17 frames, 6 rows (shorter
# than one chunk).
RAGGED = (16000, 9840, 3000)


def build_am(model, chunk=CHUNK, quantized=False):
    spec = nnet_spec(model)
    nnet_def, params = build_nnet(spec)
    pdfs = model["output"]["w"].shape[1]
    return AcousticModel(
        nnet_def, params, None, np.zeros(2 * pdfs + 1, np.int32),
        spec.left_context, spec.right_context, 50, pdfs, device=CPU,
        feature_type="mfcc", quantized=quantized,
        chunking=None if chunk is None else ChunkOptions(**chunk))


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


EDGES = dict(CHUNK, extra_left_context_initial=-1,
             extra_right_context_final=-1)
UNEVEN = dict(CHUNK, frames_per_chunk=28, extra_left_context=7,
              extra_right_context=14, extra_right_context_final=5)


@pytest.mark.parametrize("chunk", [CHUNK, EDGES, UNEVEN],
                         ids=["kaldi", "edges", "uneven"])
def test_batched_logp_matches_reference(chunk):
    """Each utterance's ceil(T / 3) rows equal the reference's: chunks
    with no extra context at the utterance's edges (the recipe's decode),
    with it there too (edge frames repeated), and with a chunk and
    contexts that are not multiples of the subsampling factor."""
    model = make_model(np.random.RandomState(0))
    waves, ivs = inputs(1)
    got, lengths = batched_logp(build_am(model, chunk), waves, ivs)
    want = ref.logp(model, waves, ivs, CPU, chunk)
    assert lengths == [33, 20, 6]
    assert got.shape[:2] == (len(waves), max(lengths))
    for u, n in enumerate(lengths):
        assert_close(got[u, :n], want[u])


def test_edge_contexts_change_the_outputs():
    """The initial and final settings matter: the first and last chunks'
    rows differ with and without extra context at the edges, the middle
    chunks' rows not at all."""
    model = make_model(np.random.RandomState(0))
    waves, ivs = inputs(1, samples=(16000,))
    a = ref.logp(model, waves, ivs, CPU, CHUNK)[0]
    b = ref.logp(model, waves, ivs, CPU, EDGES)[0]
    gap = (a - b).abs().amax(dim=1)
    assert float(gap[:10].max()) > 1e-3 and float(gap[30:].max()) > 1e-3
    assert float(gap[10:30].max()) == 0.0


def test_bfloat16_reference_fails_the_tolerance():
    model = make_model(np.random.RandomState(0))
    waves, ivs = inputs(7)
    want = ref.logp(model, waves, ivs, CPU, CHUNK)
    low = ref.logp(model, waves, ivs, CPU, CHUNK, "bfloat16")
    for a, b in zip(low, want):
        err = float((a.double() - b).abs().max())
        assert err > 10 * TOL * float(b.abs().max())


def test_chunk_plan_by_hand():
    """Kaldi's cut: 33 rows at 10 a chunk are 10, 10, 10, 3 with 4 rows of
    extra context inside the utterance and none at its edges; 20 rows are
    exactly two chunks; 6 rows one; windows padded to the widest, 18."""
    plan = plan_chunks([33, 20, 6], ChunkOptions(**CHUNK), 3)
    assert plan.utt.tolist() == [0, 0, 0, 0, 1, 1, 2]
    assert plan.first.tolist() == [0, 10, 20, 30, 0, 10, 0]
    assert plan.kept.tolist() == [10, 10, 10, 3, 10, 10, 6]
    assert plan.left.tolist() == [0, 4, 4, 4, 0, 4, 0]
    assert plan.right.tolist() == [4, 4, 4, 0, 4, 0, 0]
    assert plan.width == 18 and plan.rows_max == 33
    # 28 frames round up to 30 (10 rows); 7 and 14 frames are 2 and 4 rows.
    plan = plan_chunks([12], ChunkOptions(**UNEVEN), 3)
    assert plan.kept.tolist() == [10, 2] and plan.left.tolist() == [0, 2]
    assert plan.right.tolist() == [4, 1]
    assert ChunkOptions(**RECIPE_CHUNK).rows_per_chunk(3) == 50


def test_ragged_padding_never_reaches_a_backward_chain():
    """In a batch of rows of different lengths each backward chain starts
    at its own row's last valid row: each row of blstmp over the padded
    batch equals blstmp over that row alone, though the padding holds
    large values that a chain started at the batch's end would carry."""
    model = make_model(np.random.RandomState(3))
    spec = nnet_spec(model)
    nnet_def, params = build_nnet(spec)
    i = next(k for k, layer in enumerate(nnet_def) if layer[0] == "blstmp")
    p = {k: torch.as_tensor(v) for k, v in params[i].items()}
    g = torch.Generator().manual_seed(0)
    lengths = [18, 7, 12, 1]
    x = 50.0 * torch.randn(len(lengths), 18, p["fw_w_x"].shape[0],
                           generator=g)
    for b, n in enumerate(lengths):
        x[b, n:] = 1e3
    out = blstmp(x, p, nnet_def[i], 1, i, torch.as_tensor(lengths))
    assert out.shape[-1] == 32
    for b, n in enumerate(lengths):
        alone = blstmp(x[b:b + 1, :n], p, nnet_def[i], 1, i)
        assert torch.allclose(out[b, :n], alone[0], atol=1e-6, rtol=0)
    # Reversal within each row's length is its own inverse.
    r = reverse_rows(x, torch.as_tensor(lengths))
    assert torch.equal(reverse_rows(r, torch.as_tensor(lengths)), x)
    assert torch.equal(r[1, :7], x[1, :7].flip(0))
    assert torch.equal(r[1, 7:], x[1, 7:])


def test_single_utterance_ignores_its_batch():
    """Each utterance's rows are the same alone and in a ragged batch, and
    through the host path (`AcousticModel.forward`, numpy)."""
    from catears_tpu_torch.frontend.fbank import Fbank

    am = build_am(make_model(np.random.RandomState(2)))
    waves, ivs = inputs(3)
    batch, lengths = batched_logp(am, waves, ivs)
    fbank = Fbank(device=CPU)
    for u, w in enumerate(waves):
        alone, n = batched_logp(am, [w], ivs[u:u + 1])
        assert n == [lengths[u]]
        assert_close(batch[u, :lengths[u]], alone[0, :n[0]])
        host = am.forward(fbank.compute(w), ivs[u])
        assert host.shape == (lengths[u], 48)
        assert_close(torch.as_tensor(host), alone[0, :n[0]])


def test_nn02_round_trip_of_kind_17(tmp_path):
    model = make_model(np.random.RandomState(6))
    spec = nnet_spec(model)
    path = tmp_path / "am.nnet"
    with open(path, "wb") as fd:
        binfmt.write_nnet(fd, spec)
    back = binfmt.read_nnet_file(str(path))
    assert (back.left_context, back.right_context) == (2, 2) \
        == ref.context(model)
    kinds = [x.kind for x in back.layers]
    assert kinds == [x.kind for x in spec.layers]
    assert kinds.count(binfmt.LAYER_BLSTMP) == 2
    for a, b in zip(spec.layers, back.layers):
        for side_a, side_b in ((a, b), (a.backward, b.backward)):
            if side_a is None:
                assert side_b is None
                continue
            for key in ("weight", "bias", "peephole", "projection",
                        "projection_bias"):
                x, y = getattr(side_a, key), getattr(side_b, key)
                assert (x is None) == (y is None)
                if x is not None:
                    assert np.array_equal(np.asarray(x, np.float32), y)
            assert (side_a.delay, side_a.rec_dim) == (side_b.delay,
                                                      side_b.rec_dim)
            assert np.float32(side_a.rec_scale) == np.float32(
                side_b.rec_scale)
    assert back.layers[5].delay == -3 and back.layers[5].backward.delay == 3
    d1, p1 = build_nnet(spec)
    d2, _ = build_nnet(back)
    assert d1 == d2 and d1[5][:2] == ("blstmp", 3)
    assert context_frames(d1) == (2, 2)
    assert output_dim(d1, p1, 40) == 48


def _bad(what):
    spec = nnet_spec(make_model(np.random.RandomState(1)))
    blstm = spec.layers[5]
    if what == "delay":
        blstm.delay = -2  # at 3 frames a row
    else:  # the backward direction reads another input width
        blstm.backward.weight = blstm.backward.weight[1:]
    return spec


def test_refusals(tmp_path):
    """A backward model without chunk settings (constructor and
    configuration); chunk settings on a looped model; a recurrence delay
    the row rate does not divide; NN02 kind 17 with a delay <= 0 or
    directions of different input widths; `quantized = true`; the live
    path; a chunked stack with context after its first recurrence."""
    model = make_model(np.random.RandomState(1))
    with pytest.raises(CorruptionError, match="frames_per_chunk"):
        build_am(model, chunk=None)
    conf, _, _ = write_blstm_model(str(tmp_path / "none"),
                                   np.random.RandomState(2), chunk=None)
    with pytest.raises(CorruptionError, match="chunks"):
        Recognizer(conf, device=CPU)
    with pytest.raises(CorruptionError, match="without frames_per_chunk"):
        ChunkOptions.from_config(Configuration(
            {"extra_left_context": "50"}))
    from _tdnn_lstm_parity import make_model as lstm_model
    from _tdnn_lstm_parity import nnet_spec as lstm_spec

    spec = lstm_spec(lstm_model(np.random.RandomState(1)))
    nnet_def, params = build_nnet(spec)
    with pytest.raises(CorruptionError, match="runs looped"):
        AcousticModel(nnet_def, params, None, np.zeros(97, np.int32),
                      spec.left_context, spec.right_context, 50, 48,
                      device=CPU, feature_type="mfcc",
                      chunking=ChunkOptions(**CHUNK))
    with pytest.raises(CorruptionError):
        build_nnet(_bad("delay"))
    for what in ("zero", "widths"):
        path = tmp_path / f"{what}.nnet"
        spec = _bad(what)
        if what == "zero":
            spec.layers[5].delay = 0
        with open(path, "wb") as fd:
            binfmt.write_nnet(fd, spec)
        with pytest.raises(CorruptionError, match="blstmp"):
            binfmt.read_nnet_file(str(path))
    with pytest.raises(NotImplementedError_):
        build_am(model, quantized=True)
    conf, _, _ = write_blstm_model(str(tmp_path / "live"),
                                   np.random.RandomState(2))
    rec = Recognizer(conf, device=CPU)
    with pytest.raises(NotImplementedError_):
        rec.create_stream_batch(2)
    with pytest.raises(NotImplementedError_):
        AMStream(rec.am)
    spec = nnet_spec(model)
    spec.layers.insert(6, binfmt.LayerSpec(binfmt.LAYER_SPLICED_AFFINE,
                                           offsets=(-3, 0, 3),
                                           weight=np.zeros((96, 32),
                                                           np.float32),
                                           bias=np.zeros(32, np.float32)))
    spec.right_context, spec.left_context = 5, 5
    nnet_def, params = build_nnet(spec)
    with pytest.raises(CorruptionError, match="row-wise"):
        AcousticModel(nnet_def, params, None, np.zeros(97, np.int32), 5, 5,
                      50, 48, device=CPU, feature_type="mfcc",
                      chunking=ChunkOptions(**CHUNK))


def test_spans_and_counters_of_the_chunks():
    """Tracing, logp.am holds the planner's two `am.chunks` spans (gather
    and scatter, with chunks, window and batch) around am.full_rate and
    am.subsampled, which holds one `am.recurrence` a layer and direction
    (steps: the widest window's rows; batch: the windows); the counters
    count the windows and their rows."""
    am = build_am(make_model(np.random.RandomState(8)))
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
    (top,) = [s for s in spans if s.name == "logp.am"]
    chunks = [s for s in spans if s.name == "am.chunks"]
    assert [s.attrs["part"] for s in chunks] == ["gather", "scatter"]
    assert all(s.parent == top.id and (s.attrs["chunks"], s.attrs["window"],
                                       s.attrs["batch"]) == (7, 18, 3)
               for s in chunks)
    (sub,) = [s for s in spans if s.name == "am.subsampled"]
    rec = [s for s in spans if s.name == "am.recurrence"]
    assert [s.parent for s in rec] == [sub.id] * 4
    assert [s.attrs["direction"] for s in rec] == ["forward", "backward"] * 2
    assert all((s.attrs["steps"], s.attrs["batch"]) == (18, 7) for s in rec)
    assert m["am_chunks"] == 7 and m["am_chunk_rows"] == 7 * 18
    assert m["am_chunk_rows_needed"] == 14 + 18 + 18 + 7 + 14 + 14 + 6
    assert m["lstm_steps"] == m["lstm_steps_needed"] == 4 * 18
    assert m["am_rows_subsampled"] == 33 + 20 + 6


def test_cli_decodes_a_blstm_model(tmp_path, data_dir, capsys):
    """`catears <conf> <scp> --batch --ivectors` through AcousticModel.read
    (the chunk settings from the configuration), batched_logp and
    BatchDecoder."""
    from catears_tpu_torch import cli

    conf, _, dim = write_blstm_model(str(tmp_path), np.random.RandomState(2))
    rec = Recognizer(conf, device=CPU)
    assert rec.am.chunking == ChunkOptions(**CHUNK)
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


def test_chunk_settings_in_a_configuration(tmp_path):
    path = tmp_path / "chunk.conf"
    path.write_text(chunk_conf(RECIPE_CHUNK))
    conf = Configuration.read(str(path))
    assert ChunkOptions.from_config(conf) == ChunkOptions(150, 50, 50, 0, 0)
    conf = Configuration({"frames_per_chunk": "140"})
    assert ChunkOptions.from_config(conf) == ChunkOptions(140, 0, 0, -1, -1)
    assert ChunkOptions.from_config(Configuration({})) is None
    with pytest.raises(CorruptionError):
        ChunkOptions(0)
    assert num_frames(9840) == 60
