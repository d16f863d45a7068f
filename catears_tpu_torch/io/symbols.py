"""Word symbol table (text `word id` file).

Parity with reference src/symbol_table.cc:16-51: two whitespace-separated
columns, id->word and word->id maps, `<s>`/`</s>` required.
"""

from __future__ import annotations

from typing import Dict, List

from catears_tpu_torch.utils.errors import CorruptionError, IOError_

BOS_SYMBOL = "<s>"
EOS_SYMBOL = "</s>"
NOT_EXIST = -1


class SymbolTable:
    def __init__(self):
        self._words: List[str] = []
        self._ids: Dict[str, int] = {}
        self.bos_id = 0
        self.eos_id = 0

    @classmethod
    def read(cls, filename: str, require_bos_eos: bool = True) -> "SymbolTable":
        self = cls()
        try:
            with open(filename, "r", encoding="utf-8") as fd:
                lines = fd.readlines()
        except OSError as e:
            raise IOError_(f"failed to open {filename}: {e}")
        for raw in lines:
            line = raw.strip()
            if not line:
                continue
            fields = line.split()
            if len(fields) != 2:
                raise CorruptionError(
                    f"2 columns expected but {len(fields)} found: {line}")
            word, word_id = fields[0], int(fields[1])
            self._ids[word] = word_id
            if word_id >= len(self._words):
                self._words.extend([""] * (word_id + 1 - len(self._words)))
            self._words[word_id] = word
        if require_bos_eos:
            if BOS_SYMBOL not in self._ids or EOS_SYMBOL not in self._ids:
                raise CorruptionError(
                    "symbol_table: unable to find BOS/EOS symbol")
            self.bos_id = self._ids[BOS_SYMBOL]
            self.eos_id = self._ids[EOS_SYMBOL]
        return self

    def get(self, symbol_id: int) -> str:
        return self._words[symbol_id]

    def get_id(self, word: str) -> int:
        return self._ids.get(word, NOT_EXIST)

    def __len__(self) -> int:
        return len(self._words)
