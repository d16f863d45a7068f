"""`key = value` configuration files.

Behavioral parity with the reference parser (reference
src/configuration.cc:14-71): `#` comment lines, keys lowercased, values
trimmed, empty values rejected, and relative paths resolved against the
directory of the config file itself.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from catears_tpu_torch.utils.errors import CorruptionError, IOError_


class Configuration:
    def __init__(self, table: Optional[Dict[str, str]] = None, filename: str = ""):
        self._table: Dict[str, str] = dict(table or {})
        self._filename = filename

    @classmethod
    def read(cls, filename: str) -> "Configuration":
        table: Dict[str, str] = {}
        try:
            with open(filename, "r", encoding="utf-8") as fd:
                lines = fd.readlines()
        except OSError as e:
            raise IOError_(f"failed to open {filename}: {e}")
        for raw in lines:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.split("=")
            if len(fields) != 2:
                raise CorruptionError(f"unexpected line in {filename}: {line}")
            key = fields[0].strip().lower()
            value = fields[1].strip()
            if not value:
                raise CorruptionError(f"value could not be empty: {filename}: {line}")
            table[key] = value
        return cls(table, filename)

    @property
    def filename(self) -> str:
        return self._filename

    def get_string(self, key: str, default: Optional[str] = None) -> str:
        val = self._table.get(key.lower())
        if val is None:
            if default is None:
                raise CorruptionError(
                    f"unable to find key '{key}' in {self._filename}")
            return default
        return val

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        val = self._table.get(key.lower())
        if val is None:
            if default is None:
                raise CorruptionError(
                    f"unable to find key '{key}' in {self._filename}")
            return default
        try:
            return int(val)
        except ValueError as e:
            raise CorruptionError(
                f"key '{key}' in {self._filename} is not an integer: "
                f"'{val}'") from e

    def get_float(self, key: str, default: Optional[float] = None) -> float:
        val = self._table.get(key.lower())
        if val is None:
            if default is None:
                raise CorruptionError(
                    f"unable to find key '{key}' in {self._filename}")
            return default
        try:
            return float(val)
        except ValueError as e:
            raise CorruptionError(
                f"key '{key}' in {self._filename} is not a number: "
                f"'{val}'") from e

    def get_path(self, key: str, default: Optional[str] = None) -> str:
        """Like get_string, but relative values resolve against the config dir."""
        val = self._table.get(key.lower())
        if val is None:
            if default is None:
                raise CorruptionError(
                    f"unable to find key '{key}' in {self._filename}")
            return default
        if os.path.isabs(val):
            return val
        directory = os.path.dirname(self._filename)
        if not directory:
            return val
        return os.path.join(directory, val)

    def has(self, key: str) -> bool:
        return key.lower() in self._table
