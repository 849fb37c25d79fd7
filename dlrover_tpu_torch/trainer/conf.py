"""Class-based training configuration (port of
``dlrover_tpu/trainer/conf.py``: ``Configuration`` and
``build_configuration``). Class attributes merge down the inheritance
chain (subclass wins), and the result behaves as both attribute- and
dict-style config.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def _is_config_attr(name: str) -> bool:
    return not name.startswith("_")


def _class_attrs(cls: type) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    # reversed MRO: base values first, subclasses override
    for klass in reversed(cls.__mro__):
        for name, value in vars(klass).items():
            if _is_config_attr(name) and not callable(value) and not isinstance(
                value, (classmethod, staticmethod, property)
            ):
                out[name] = value
    return out


class Configuration:
    """Attribute/dict hybrid with recursive merge."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data: Dict[str, Any] = {}
        if data:
            self.merge_dict(data)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_class(cls, conf_cls: type) -> "Configuration":
        return cls(_class_attrs(conf_cls))

    @classmethod
    def from_module(cls, module) -> "Configuration":
        data = {
            k: v for k, v in vars(module).items()
            if _is_config_attr(k) and not callable(v)
            and not isinstance(v, type(module))
        }
        return cls(data)

    # -- access --------------------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            value = data[name]
            if isinstance(value, dict):
                return Configuration(value)
            return value
        raise AttributeError(name)

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def set(self, name: str, value: Any):
        self._data[name] = value

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    # -- merge ---------------------------------------------------------------

    def merge_dict(self, other: Dict[str, Any]):
        _deep_merge(self._data, other)
        return self

    def merge(self, other: "Configuration"):
        return self.merge_dict(other.to_dict())

    def __repr__(self):
        return f"Configuration({self._data!r})"


def _deep_merge(base: Dict, other: Dict):
    for key, value in other.items():
        if (
            key in base
            and isinstance(base[key], dict)
            and isinstance(value, dict)
        ):
            _deep_merge(base[key], value)
        else:
            base[key] = value


def build_configuration(
    *sources: Any, overrides: Optional[Dict[str, Any]] = None
) -> Configuration:
    """Fold modules / classes / dicts / Configurations, left to right."""
    conf = Configuration()
    for source in sources:
        if isinstance(source, Configuration):
            conf.merge(source)
        elif isinstance(source, dict):
            conf.merge_dict(source)
        elif isinstance(source, type):
            conf.merge(Configuration.from_class(source))
        else:
            conf.merge(Configuration.from_module(source))
    if overrides:
        conf.merge_dict(overrides)
    return conf
