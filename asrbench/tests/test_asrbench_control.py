"""The control, the reference in the program's place a precision lower
(TF32 matmuls in the AM, bfloat16 sums of the decoder's costs), reads
above every limit where the program reads below it.  At the cells' own
size it runs on the card (`python3 -m asrbench.control`, PERF.md); here
at a size a test run holds."""

from __future__ import annotations

import json

import pytest

from asrbench import control, manifest


def lengthen(root):
    """Utterances and streams long enough that bfloat16 sums of their
    costs drift as they do at the cells' size."""
    base = manifest.data_dir(root)
    for name in ("bulk16-librispeech", "live-200ms"):
        path = f"{base}/traffic/{name}.json"
        t = json.load(open(path))
        if t["kind"] == "bulk":
            t.update(batch=2, pool_batches=1, sample=2)
            t["length_s"].update(mean=14.0, min=12.0, max=16.0)
        json.dump(t, open(path, "w"))


def readings(root, cell, device, capsys):
    lengthen(root)
    seconds = "12" if cell.startswith("live") else "0.5"
    assert control.main(["--workload", cell, "--seeds", "21",
                         "--seconds", seconds, "--root", root,
                         "--device", device]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    return rows, manifest.limits(manifest.data_dir(root), cell)


@pytest.mark.parametrize("cell", ["bulk-lmoff", "bulk-lmon",
                                  "live-streams"])
def test_the_decoders_control_fails_its_limit(tiny_root, cell, capsys):
    rows, limits = readings(tiny_root, cell, "cpu", capsys)
    for row in rows:
        assert row["correct"]
        assert row["control_correct"] is False
        assert row["program"]["cost_gap"] <= limits["cost_gap"]
        assert row["control"]["cost_gap"] > limits["cost_gap"]


@pytest.mark.cuda
def test_the_ams_control_fails_its_limit(tiny_root, card, capsys):
    rows, limits = readings(tiny_root, "bulk-lmoff", "cuda", capsys)
    for row in rows:
        assert row["control_correct"] is False
        assert row["program"]["logp_err"] <= limits["logp_err"]
        assert row["control"]["logp_err"] > limits["logp_err"]


def test_live_answers_judged_by_words_or_their_hash():
    """The live control's answers carry only the hash of their words; it
    is judged as the program's word lists are."""
    from asrbench import judge, ref

    words = [3, 17, 4]
    assert judge._hash(words) == ref.word_hash(words)
    assert judge._hash(ref.word_hash(words)) == ref.word_hash(words)
    assert judge._hash([]) == 0
