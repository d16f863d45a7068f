"""WER/CER scoring (port of catears_tpu/tools/score.py; reference
tool/compute-cer.sh + conv_chartok.sh parity).

The reference shells out to Kaldi's compute-wer after splitting hypotheses
into per-character tokens (CJK CER).  This reimplements both: character
tokenization that keeps ASCII words intact while splitting CJK ideographs,
and Levenshtein-based WER computation over `name tokens...` transcript
files.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List


def char_tokenize(text: str) -> List[str]:
    """Split CJK chars into single tokens; keep other runs as words."""
    tokens: List[str] = []
    word: List[str] = []
    for ch in text:
        if ch.isspace():
            if word:
                tokens.append("".join(word))
                word = []
        elif _is_cjk(ch):
            if word:
                tokens.append("".join(word))
                word = []
            tokens.append(ch)
        else:
            word.append(ch)
    if word:
        tokens.append("".join(word))
    return tokens


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0xF900 <= cp <= 0xFAFF or 0x3040 <= cp <= 0x30FF
            or 0xAC00 <= cp <= 0xD7AF)


def edit_distance(ref: List[str], hyp: List[str]):
    """(errors, substitutions, deletions, insertions) via Levenshtein DP."""
    import numpy as np

    n, m = len(ref), len(hyp)
    dp = np.zeros((n + 1, m + 1), np.int32)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dp[i, j] = min(sub, dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    # Backtrack for the S/D/I split (compute-wer style reporting)
    i, j = n, m
    subs = dels = ins = 0
    while i > 0 or j > 0:
        if (i > 0 and j > 0
                and dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])):
            subs += int(ref[i - 1] != hyp[j - 1])
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return int(dp[n, m]), subs, dels, ins


def token_errors(ref: List[str], hyp: List[str]) -> int:
    """Levenshtein error count; native C++ DP when the library is built
    (the S/D/I split of `edit_distance` is only needed for reporting)."""
    from catears_tpu_torch.utils import native

    if native.available():
        vocab: dict = {}
        ids = [[vocab.setdefault(t, len(vocab)) for t in seq]
               for seq in (ref, hyp)]
        n = native.edit_distance(ids[0], ids[1])
        if n is not None:
            return n
    return edit_distance(ref, hyp)[0]


@dataclass
class ScoreResult:
    errors: int = 0
    ref_tokens: int = 0
    utterances: int = 0
    missing: int = 0
    per_utt: Dict[str, float] = field(default_factory=dict)

    @property
    def wer(self) -> float:
        return self.errors / max(self.ref_tokens, 1)


def read_transcripts(path: str, char_tok: bool) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as fd:
        for raw in fd:
            line = raw.strip()
            if not line:
                continue
            fields = line.split(None, 1)
            name = fields[0]
            text = fields[1] if len(fields) > 1 else ""
            out[name] = (char_tokenize(text) if char_tok else text.split())
    return out


def score(ref_path: str, hyp_path: str, char_tok: bool = False) -> ScoreResult:
    refs = read_transcripts(ref_path, char_tok)
    hyps = read_transcripts(hyp_path, char_tok)
    result = ScoreResult()
    for name, ref in refs.items():
        result.utterances += 1
        result.ref_tokens += len(ref)
        if name not in hyps:
            result.missing += 1
            result.errors += len(ref)
            continue
        err = token_errors(ref, hyps[name])
        result.errors += err
        result.per_utt[name] = err / max(len(ref), 1)
    return result


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    char_tok = "--cer" in argv
    argv = [a for a in argv if a != "--cer"]
    if len(argv) != 2:
        print("Usage: python -m catears_tpu_torch.tools.score [--cer] "
              "<ref> <hyp>")
        return 1
    r = score(argv[0], argv[1], char_tok)
    kind = "%CER" if char_tok else "%WER"
    print(f"{kind} {100.0 * r.wer:.2f} [ {r.errors} / {r.ref_tokens}, "
          f"{r.utterances} utts, {r.missing} missing ]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
