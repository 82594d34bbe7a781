"""Tiny name->factory registry (the reference's
`repro/utils/registry.py`)."""
from __future__ import annotations

from typing import Callable, Dict, Iterable


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Callable] = {}

    def register(self, name: str):
        def deco(fn):
            if name in self._items:
                raise KeyError(f"duplicate {self.kind} registration: {name}")
            self._items[name] = fn
            return fn
        return deco

    def get(self, name: str):
        if name not in self._items:
            raise KeyError(
                f"unknown {self.kind} '{name}'; available: "
                f"{sorted(self._items)}")
        return self._items[name]

    def names(self) -> Iterable[str]:
        return sorted(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items
