"""Component registries — the pluggable seams of the toolkit (port of
``repro.toolkit.registry``, whole).

The paper's modular-design claim (§3.1: tokenizer, embedding, encoder,
target layers are decoupled) becomes concrete here: downstream **target
heads** and **latency backends** are looked up by name from registries, so
a new task type or a new latency source is one ``register`` call away — no
edits to the Pipeline or the SAMP facade.

Built-in registrations (import side effects of the toolkit package):

* targets — ``cls``, ``pair_matching``, ``seq_labeling``, ``lm``
  (:mod:`repro_torch.toolkit.targets`)
* latency backends — ``roofline``, ``wallclock``
  (:mod:`repro_torch.toolkit.latency`)
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional


class Registry:
    """Name -> component mapping with decorator registration and
    fail-loud resolution (unknown names list what *is* available)."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: dict[str, Any] = {}

    def register(self, name: str, obj: Any = None,
                 *, overwrite: bool = False):
        """``reg.register("name", obj)`` or ``@reg.register("name")``."""
        if obj is None:
            return lambda o: self.register(name, o, overwrite=overwrite)
        if not overwrite and name in self._items:
            raise KeyError(f"{self.kind} {name!r} already registered; "
                           f"pass overwrite=True to replace it")
        self._items[name] = obj
        return obj

    def get(self, name: str) -> Any:
        if name not in self._items:
            raise KeyError(f"unknown {self.kind} {name!r}; "
                           f"available: {sorted(self._items)}")
        return self._items[name]

    def names(self) -> list[str]:
        return sorted(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    def __repr__(self) -> str:
        return f"Registry({self.kind}: {self.names()})"


TARGETS = Registry("target head")
LATENCY_BACKENDS = Registry("latency backend")


def register_target(name: str, spec: Any = None, **kw):
    return TARGETS.register(name, spec, **kw)


def get_target(name: str):
    return TARGETS.get(name)


def register_latency_backend(name: str, backend: Any = None, **kw):
    return LATENCY_BACKENDS.register(name, backend, **kw)


def get_latency_backend(name: str):
    return LATENCY_BACKENDS.get(name)
