"""Registry of named components, built from config dicts.

Mirrors the capability surface of mmcv's ``Registry`` +
``build_from_cfg`` pattern used throughout the reference
(mmdet3d/models/builder.py), re-implemented from scratch:
configs are plain dicts with a ``type`` key naming a registered class; the
rest of the dict becomes constructor kwargs.  This keeps the reference's
published configs mappable 1:1 onto the port's modules.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class mapping with decorator-based registration."""

    def __init__(self, name: str, parent: Optional["Registry"] = None):
        self._name = name
        self._module_dict: Dict[str, Any] = {}
        self._parent = parent
        self._children: Dict[str, "Registry"] = {}
        if parent is not None:
            parent._children[name] = self

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return dict(self._module_dict)

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __repr__(self) -> str:
        return (f"Registry(name={self._name}, "
                f"items={list(self._module_dict)})")

    def get(self, key: str) -> Optional[Any]:
        """Look up ``key`` here, then in parent/sibling registries."""
        if key in self._module_dict:
            return self._module_dict[key]
        if self._parent is not None:
            return self._parent.get(key)
        for child in self._children.values():
            if key in child._module_dict:
                return child._module_dict[key]
        return None

    def register_module(self,
                        name: Optional[str] = None,
                        force: bool = False,
                        module: Optional[Any] = None) -> Callable:
        """Register a class/function, usable as decorator (with or without
        arguments) or as a plain call with ``module=``."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator

    def _register(self, module: Any, name: Optional[str], force: bool):
        keys = [module.__name__] if name is None else (
            [name] if isinstance(name, str) else list(name))
        for key in keys:
            if not force and key in self._module_dict:
                raise KeyError(
                    f"{key} is already registered in {self._name}")
            self._module_dict[key] = module

    def build(self, cfg: Dict[str, Any], **default_args) -> Any:
        return build_from_cfg(cfg, self, default_args or None)


def build_from_cfg(cfg: Dict[str, Any],
                   registry: Registry,
                   default_args: Optional[Dict[str, Any]] = None) -> Any:
    """Instantiate ``registry[cfg['type']](**cfg_minus_type, **defaults)``.

    ``type`` may also be a class itself (already imported) for convenience.
    """
    if not isinstance(cfg, dict):
        raise TypeError(f"cfg must be a dict, got {type(cfg)}")
    if "type" not in cfg:
        if default_args is None or "type" not in default_args:
            raise KeyError(f'cfg must contain the key "type": {cfg}')
    args = dict(cfg)
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(
                f"{obj_type} is not in the {registry.name} registry. "
                f"Available: {sorted(registry._module_dict)}")
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(
            f"type must be a str or class, got {type(obj_type)}")
    try:
        return obj_cls(**args)
    except Exception as e:  # re-raise with context: which class failed
        raise type(e)(f"{obj_cls.__name__}: {e}") from e
