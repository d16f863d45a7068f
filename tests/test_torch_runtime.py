"""The PyTorch port's streaming entry points vs the JAX package, on the CPU.

Recognizer -> Utterance (fused and componentized; float and `quantized =
true`; with and without `cmvn_stats`) on en-us-hello.wav and en-us-cat.wav,
chunkings, truncations, edge cases, the per-frame log-likelihood,
checkpoint/resume, the C-API wrappers, the CLI on a .wav and on an scp
without --batch, the geometry tuner, and a `cmvn_stats` config through
--batch.  Transcripts must be the JAX package's strings; the float
log-likelihood per frame within 1e-5 relative; decoder state integers equal
and costs within float tolerance (the two AMs' log-probs differ in the last
bits, so the costs summed from them do too).
"""

import contextlib
import io
import os
import pickle

import numpy as np
import pytest
import torch

from _torch_parity import (CPU, STREAM_BEAM, to_np, wav_payload,
                           write_scp, write_stream_toy)
from catears_tpu import cli as jcli
from catears_tpu.runtime import capi as jcapi
from catears_tpu.runtime import recognizer as jrec
from catears_tpu.tools import tune as jtune
from catears_tpu_torch import cli as tcli
from catears_tpu_torch.decode.beam import BeamConfig
from catears_tpu_torch.runtime import capi as tcapi
from catears_tpu_torch.runtime import recognizer as trec
from catears_tpu_torch.tools import tune as ttune
from catears_tpu_torch.utils import log

WAVS = ("hello", "cat")
# STREAM_BEAM as config keys: the JAX Recognizer then builds a BeamConfig
# equal to the one the module's other decodes use (its compiled programs
# are reused).
GEOMETRY = ["beam_size = 256", "expand_size = 2048", "eps_expand_size = 1024",
            "max_eps_iters = 6", "beam = 1e9"]


def _conf(d, data_dir, quantized, cmvn):
    conf = write_stream_toy(d, data_dir, quantized=quantized, cmvn=cmvn)
    with open(conf, "a") as fd:
        fd.write("".join(f"{x}\n" for x in GEOMETRY))
    return conf


@pytest.fixture(scope="module")
def models(tmp_path_factory, data_dir):
    """{(quantized, cmvn): (conf, JAX Recognizer, port Recognizer)}."""
    out = {}
    for quantized in (False, True):
        for cmvn in (False, True):
            d = str(tmp_path_factory.mktemp(f"rt_{int(quantized)}{int(cmvn)}"))
            conf = _conf(d, data_dir, quantized, cmvn)
            out[quantized, cmvn] = (conf, jrec.Recognizer(conf),
                                    trec.Recognizer(conf, device=CPU))
    return out


def _wav(data_dir, name):
    return os.path.join(data_dir, f"en-us-{name}.wav")


def decode_with(mod, rec, path, fused=True, chunk_bytes=1024, truncate=0):
    """(hyp, loglikelihood_per_frame) of one wav streamed through an
    Utterance of `mod` (the JAX or the port's recognizer module)."""
    fmt, payload = wav_payload(path, truncate)
    utt = mod.Utterance(rec, fmt, fused=fused)
    for off in range(0, len(payload), chunk_bytes):
        utt.process(payload[off:off + chunk_bytes])
    utt.end_of_stream()
    return utt.hyp, utt.loglikelihood_per_frame


@pytest.fixture(scope="module")
def jax_hyps(models, data_dir):
    """The JAX fused session's (hyp, llh) per (quantized, cmvn, wav)."""
    return {(q, c, w): decode_with(jrec, models[q, c][1], _wav(data_dir, w))
            for (q, c) in models for w in WAVS}


@pytest.mark.parametrize("wav", WAVS)
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("cmvn", [False, True])
def test_utterance_matches_jax(models, jax_hyps, data_dir, wav, quantized,
                               cmvn):
    """Fused and componentized give the JAX package's non-empty transcript;
    with the float AM also its log-likelihood per frame (1e-5 relative)."""
    rec = models[quantized, cmvn][2]
    want, want_llh = jax_hyps[quantized, cmvn, wav]
    assert want
    for fused in (True, False):
        hyp, llh = decode_with(trec, rec, _wav(data_dir, wav), fused=fused)
        assert hyp == want, fused
        if not quantized:
            assert abs(llh - want_llh) <= 1e-5 * abs(want_llh), fused


def test_componentized_loglikelihood_matches_jax(models, data_dir):
    """The componentized path's log-likelihood per frame against the JAX
    componentized path's (float AM, 1e-5 relative)."""
    _, jr, tr = models[False, False]
    path = _wav(data_dir, "cat")
    want = decode_with(jrec, jr, path, fused=False)
    got = decode_with(trec, tr, path, fused=False)
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) <= 1e-5 * abs(want[1])


@pytest.mark.parametrize("chunk_bytes", [100, 517, 1024, 100000])
def test_chunk_sizes_give_the_same_transcript(models, jax_hyps, data_dir,
                                              chunk_bytes):
    rec = models[False, False][2]
    hyp, _ = decode_with(trec, rec, _wav(data_dir, "hello"),
                         chunk_bytes=chunk_bytes)
    assert hyp == jax_hyps[False, False, "hello"][0]


@pytest.mark.parametrize("truncate", [500, 4000, 9001])
def test_truncated_audio_matches_jax(models, data_dir, truncate):
    """The end-of-stream flush paths (never started, mid-chunk)."""
    _, jr, tr = models[False, False]
    path = _wav(data_dir, "hello")
    want = decode_with(jrec, jr, path, truncate=truncate)[0]
    for fused in (True, False):
        assert decode_with(trec, tr, path, fused=fused,
                           truncate=truncate)[0] == want


def test_empty_sub_frame_and_after_eos(models):
    from catears_tpu_torch.io.wav import WaveFormat

    rec = models[False, False][2]
    fmt = WaveFormat(1, 16000, 16)
    for fused in (True, False):
        utt = trec.Utterance(rec, fmt, fused=fused)
        utt.end_of_stream()  # no audio at all
        assert utt.hyp == ""
        utt = trec.Utterance(rec, fmt, fused=fused)
        assert utt.process(b"\x00\x01" * 100) == 100  # < one frame
        utt.end_of_stream()
        assert utt.hyp == ""
    utt = trec.Utterance(rec, fmt)
    utt.process(b"\x00\x01" * 8000)
    utt.end_of_stream()
    hyp, frames = utt.hyp, utt.session.num_frames_decoded
    utt.process(b"\x00\x01" * 8000)  # ignored after EOS
    assert utt.hyp == hyp and utt.session.num_frames_decoded == frames


def _same_beam(jbeam, tbeam, what):
    """Integer fields equal; costs equal where infinite and within 1e-4
    relative elsewhere."""
    for name, x, y in zip(("states", "lm", "costs", "bp", "overflow",
                           "hiwater"), jbeam, tbeam):
        x, y = np.asarray(x), to_np(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what} {name}"
        if name == "costs":
            fin = np.isfinite(x)
            assert np.array_equal(fin, np.isfinite(y)), f"{what} {name}"
            assert np.allclose(x[fin], y[fin], rtol=1e-4), f"{what} {name}"
        else:
            assert np.array_equal(x, y), f"{what} {name}"


@pytest.mark.parametrize("fused", [True, False])
def test_checkpoint_resume(models, data_dir, fused):
    """get_state -> pickle -> set_state into a fresh Utterance, then the
    rest of the audio: the uninterrupted transcript; the state has the JAX
    Utterance's keys, and its beam JAX's at the same cut."""
    _, jr, tr = models[False, True]
    fmt, payload = wav_payload(_wav(data_dir, "cat"))
    half = len(payload) // 2 + 1  # an odd cut leaves a byte in the reader
    ref = trec.Utterance(tr, fmt, fused=fused)
    ref.process(payload)
    ref.end_of_stream()
    a = trec.Utterance(tr, fmt, fused=fused)
    a.process(payload[:half])
    state = a.get_state()
    ja = jrec.Utterance(jr, fmt, fused=fused)
    ja.process(payload[:half])
    jstate = ja.get_state()
    assert sorted(state) == sorted(jstate)
    if fused:
        ss, js = state["session"], jstate["session"]
        assert sorted(ss) == sorted(js)
        assert len(ss["traces"]) == len(js["traces"])
        assert ss["consumed_frames"] == js["consumed_frames"]
        assert [x.shape for x in ss["cm"]] == [np.shape(x) for x in js["cm"]]
        _same_beam(js["beam"], ss["beam"], "session beam")
    else:
        ds, js = state["decoder"], jstate["decoder"]
        assert sorted(ds) == sorted(js)
        assert len(ds["traces"]) == len(js["traces"])
        _same_beam(js["beam"], ds["beam"], "decoder beam")
    b = trec.Utterance(tr, fmt, fused=fused)
    b.set_state(pickle.loads(pickle.dumps(state)))
    b.process(payload[half:])
    b.end_of_stream()
    assert b.hyp == ref.hyp and b.hyp


def test_metrics_counters_move(models, data_dir):
    """Audio seconds, decoded frames and stage times are counted."""
    rec = models[False, False][2]
    log.reset_metrics()
    assert log.metrics() == {}
    trec.decode_wav_file(rec, _wav(data_dir, "hello"))
    m = log.metrics()
    assert m["audio_seconds"] > 0.3 and m["frames_decoded"] >= 40
    assert m["process_seconds"] > 0


def test_recognizer_takes_a_beam_config(models):
    conf = models[False, False][0]
    cfg = BeamConfig(beam_size=64, expand_size=512, beam=9.0)
    rec = trec.Recognizer(conf, beam_config=cfg, device=CPU)
    assert rec.beam_config == cfg
    assert trec.Recognizer(conf, device=CPU).beam_config == BeamConfig(
        **STREAM_BEAM)
    assert rec._decode_graph()[0] == cfg
    assert rec._decode_graph()[1] is rec._decode_graph()[1]  # cached


def test_capi_wrappers_match_jax(models, data_dir):
    conf = models[False, False][0]
    hyps = []
    for capi, kw in ((jcapi, {}), (tcapi, {"device": CPU})):
        rec = capi.ce_stt_init(conf, **kw)
        assert rec is not None
        with open(_wav(data_dir, "hello"), "rb") as fd:
            fmt = capi.ce_read_pcm_header(fd)
            assert fmt is not None
            utt = capi.ce_utt_init(rec, fmt)
            assert utt is not None
            while True:
                chunk = fd.read(1024)
                if not chunk:
                    break
                assert capi.ce_stt_process(utt, chunk) != capi.CE_STT_FAILED
        capi.ce_stt_end_of_stream(utt)
        assert utt.loglikelihood_per_frame != 0.0
        hyps.append(utt.hyp)
        capi.ce_utt_destroy(utt)
        capi.ce_stt_destroy(rec)
    assert hyps[0] == hyps[1] and hyps[1]


def test_capi_error_paths_match_jax(models):
    """Each failing wrapper returns None / CE_STT_FAILED and records the
    JAX package's message."""
    conf = models[False, False][0]
    for capi, kw in ((jcapi, {}), (tcapi, {"device": CPU})):
        assert capi.ce_stt_init("/nonexistent/config", **kw) is None
        assert "nonexistent" in capi.ce_stt_last_error()
    msgs = []
    for capi, kw, mod in ((jcapi, {}, jrec), (tcapi, {"device": CPU}, trec)):
        assert capi.ce_read_pcm_header(io.BytesIO(b"RIFX")) is None
        msgs.append(capi.ce_stt_last_error())
        rec = capi.ce_stt_init(conf, **kw)
        utt = capi.ce_utt_init(rec, tcapi.WaveFormat(1, 16000, 16))
        assert capi.ce_stt_process(utt, b"") == capi.CE_STT_FAILED
        msgs.append(capi.ce_stt_last_error())
        assert capi.ce_utt_init(rec, tcapi.WaveFormat(2, 16000, 16)) is None
        msgs.append(capi.ce_stt_last_error())
    assert msgs[:3] == msgs[3:] and all(msgs)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("quantized", [False, True])
def test_cli_wav_and_scp_match_jax(models, data_dir, tmp_path, quantized):
    """A .wav input and an scp without --batch go through the streaming
    Utterance path and print the JAX CLI's lines."""
    conf = models[quantized, False][0]
    scp = write_scp(str(tmp_path / "list.scp"),
                    [_wav(data_dir, w) for w in WAVS])
    for path in (_wav(data_dir, "hello"), scp):
        rc_j, ref, _ = _run(jcli.main, [conf, path])
        rc_t, got, _ = _run(tcli.main, ["--device=cpu", conf, path])
        assert rc_j == rc_t == 0
        assert got == ref and got.strip()


def test_cli_wav_without_a_card_fails_cleanly(models, data_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(tcli.main, [models[False, False][0],
                                    _wav(data_dir, "hello")])
    lines = err.strip().splitlines()
    assert rc == 1 and out == "" and len(lines) == 1
    assert lines[0].startswith("catears: ") and "CUDA" in lines[0]


def test_cmvn_config_decodes_with_batch_as_jax(models, data_dir, tmp_path):
    conf = models[True, True][0]
    scp = write_scp(str(tmp_path / "list.scp"),
                    [_wav(data_dir, w) for w in ("hello", "cat", "hello")])
    rc_j, ref, _ = _run(jcli.main, ["--batch=2", conf, scp])
    rc_t, got, _ = _run(tcli.main, ["--batch=2", "--device=cpu", conf, scp])
    assert rc_j == rc_t == 0
    assert got == ref and len(got.splitlines()) == 3


def test_tune_prints_the_jax_keys(models, data_dir, tmp_path):
    conf = models[False, True][0]
    scp = write_scp(str(tmp_path / "list.scp"),
                    [_wav(data_dir, w) for w in WAVS])
    rc_j, ref, _ = _run(jtune.main, [conf, scp, "--margin=1.5",
                                     "--beam-size=128"])
    rc_t, got, _ = _run(ttune.main, ["--device=cpu", conf, scp,
                                     "--margin=1.5", "--beam-size=128"])
    assert rc_j == rc_t == 0
    assert got == ref
    keys = [line.split(" = ")[0] for line in got.splitlines()[1:]]
    assert keys == ["beam_size", "expand_size", "eps_expand_size"]
    rc, out, err = _run(ttune.main, ["--device=cpu", conf])
    assert rc == 1 and "Usage" in err
