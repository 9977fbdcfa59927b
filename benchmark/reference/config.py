"""Nested attribute-access view over a configuration dict: a frozen copy
of ``ndjir_torch.config.Config`` for the benchmark's reference, which
reads its configuration from the benchmark's JSON file.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, Tuple


class Config:
    """Nested attribute-access view over a dict tree (OmegaConf-lite).

    Nested access returns a VIEW over the same underlying dicts, so
    ``conf.a.b.c = v`` mutates the tree.  Hashable and comparable by content.
    """

    __slots__ = ("_data",)

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, "_data", data)

    def __getattr__(self, key: str) -> Any:
        try:
            v = self._data[key]
        except KeyError as e:
            raise AttributeError(f"Config has no key {key!r}") from e
        if isinstance(v, dict):
            return Config(v)
        return v

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __getitem__(self, key: str) -> Any:
        return self.__getattr__(key)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        v = self._data.get(key, default)
        if isinstance(v, dict):
            return Config(v)
        return v

    def keys(self):
        return self._data.keys()

    def items(self) -> Iterator[Tuple[str, Any]]:
        for k, v in self._data.items():
            yield k, (Config(v) if isinstance(v, dict) else v)

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def _freeze(self, v=None) -> Any:
        v = self._data if v is None else v
        if isinstance(v, dict):
            return tuple(sorted((k, self._freeze(x)) for k, x in v.items()))
        if isinstance(v, list):
            return tuple(self._freeze(x) for x in v)
        return v

    def __hash__(self) -> int:
        return hash(self._freeze())

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Config) and self._freeze() == other._freeze()
