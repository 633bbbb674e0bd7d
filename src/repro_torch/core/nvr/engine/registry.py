"""Prefetcher registry: ``@register_prefetcher("name")`` replaces the seed's
hardcoded ``PREFETCHERS`` dict so new prefetchers (including out-of-tree
experiments) plug in without touching the engine."""

from __future__ import annotations

_REGISTRY: dict[str, type] = {}


def register_prefetcher(name: str):
    """Class decorator: register a :class:`Prefetcher` subclass under
    ``name`` and stamp it as ``cls.name``."""

    def deco(cls):
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"prefetcher {name!r} already registered "
                             f"by {_REGISTRY[name].__name__}")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def _ensure_builtins() -> None:
    # importing the module runs the @register_prefetcher decorators
    from .. import prefetchers  # noqa: F401


def get_prefetcher(name: str) -> type:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown prefetcher {name!r}; available: "
                       f"{sorted(_REGISTRY)}") from None


def available_prefetchers() -> list[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)
