"""Dataset and metadata catalogs (the detectron2 DatasetCatalog and
MetadataCatalog as the reference's data/datasets/builtin.py uses them)."""
from __future__ import annotations

from typing import Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, fn: Callable[[], List[dict]],
                 allow_overwrite: bool = False) -> None:
        if name in self._registry and not allow_overwrite:
            raise KeyError(f"dataset {name} already registered")
        self._registry[name] = fn

    def get(self, name: str) -> List[dict]:
        if name not in self._registry:
            raise KeyError(f"dataset {name} not registered; have {list(self._registry)}")
        return self._registry[name]()

    def __contains__(self, name: str) -> bool:
        return name in self._registry


class _MetadataCatalog:
    def __init__(self):
        self._data: Dict[str, dict] = {}

    def get(self, name: str) -> dict:
        return self._data.setdefault(name, {"name": name})

    def set(self, name: str, **kwargs) -> dict:
        meta = self.get(name)
        meta.update(kwargs)
        return meta


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
