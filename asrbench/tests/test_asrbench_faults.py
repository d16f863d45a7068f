"""`correct` comes out false when the timed path is broken underneath:
a decoder step that returns its state unchanged, half of the batch (or
of the streams) left out, and a word altered where it is produced.  (One
chip: no exchange between chips to leave out.)  The runs are whole
`asrbench.run` runs on the CPU, with the card check skipped."""

from __future__ import annotations

import json

import pytest

from asrbench import run


def unchanged(monkeypatch):
    from catears_tpu_torch.decode import decoder
    from catears_tpu_torch.runtime import streaming

    real = decoder.decode_chunk

    def step(cfg, dfst, beam, logp, valid, dlm=None):
        return beam, real(cfg, dfst, beam, logp, valid, dlm)[1]

    monkeypatch.setattr(decoder, "decode_chunk", step)
    monkeypatch.setattr(streaming, "decode_chunk", step)


def half(monkeypatch):
    from catears_tpu_torch.decode.decoder import BatchDecoder
    from catears_tpu_torch.decode.oracle import Hypothesis
    from catears_tpu_torch.runtime.streaming import BatchStreamingSession

    decode = BatchDecoder.decode
    feed = BatchStreamingSession.process_batch

    def part(self, logp, lengths=None, **kw):
        keep = (len(lengths) + 1) // 2
        hyps = decode(self, logp[:keep], lengths[:keep], **kw)
        return hyps + [Hypothesis([], 0.0)] * (len(lengths) - keep)

    def some(self, chunks):
        keep = (len(chunks) + 1) // 2
        return feed(self, list(chunks[:keep]) + [None] * (len(chunks) - keep))

    monkeypatch.setattr(BatchDecoder, "decode", part)
    monkeypatch.setattr(BatchStreamingSession, "process_batch", some)


def altered(monkeypatch):
    from catears_tpu_torch.decode.decoder import BatchDecoder
    from catears_tpu_torch.decode.oracle import Hypothesis
    from catears_tpu_torch.runtime.streaming import BatchStreamingSession

    decode = BatchDecoder.decode
    partials = BatchStreamingSession.partials

    def change(h):
        words = list(h.words)
        words[-1:] = [words[-1] % 200 + 1] if words else [7]
        return Hypothesis(words, h.weight)

    monkeypatch.setattr(BatchDecoder, "decode", lambda self, *a, **k: [
        change(h) for h in decode(self, *a, **k)])
    monkeypatch.setattr(BatchStreamingSession, "partials", lambda self: [
        change(h) for h in partials(self)])


@pytest.mark.parametrize("fault", [unchanged, half, altered])
@pytest.mark.parametrize("cell", ["bulk-lmoff", "live-streams"])
def test_a_broken_path_is_not_correct(tiny_root, cell, fault, monkeypatch,
                                      capsys):
    args = ["--workload", cell, "--seed", "11", "--seconds", "1",
            "--trace", "0", "--root", tiny_root, "--device", "cpu"]
    assert run.main(args) == 0
    sound = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sound["correct"] is True
    fault(monkeypatch)
    assert run.main(args) == 0
    broken = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert broken["correct"] is False, broken["compared"]
