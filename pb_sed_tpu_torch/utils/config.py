"""Dogmatic configuration system.

Reimplements the *behavior* of the reference's config machinery
(padertorch ``Configurable`` / ``_DogmaticConfig``, consumed throughout the
reference, e.g. ``pb_sed/models/weak_label/crnn.py:304-340`` and
``pb_sed/data_preparation/provider.py:302-378``):

- ``Class.get_config(updates)`` builds a nested config dict
  ``{'factory': Class, **kwargs}``. User-provided ``updates`` are *dogmatic*:
  defaults injected later (from ``finalize_dogmatic_config`` or from the
  factory's signature) never overwrite them.
- ``Class.finalize_dogmatic_config(config)`` lets classes inject/complete
  defaults top-down, including into nested sub-configs; reading a missing key
  of a nested factory config triggers on-demand default filling of that
  sub-config, so cross-references like
  ``config['feature_extractor']['number_of_filters']`` work.
- ``Class.from_config(config)`` recursively instantiates factories.
- Configs serialize to plain JSON (factories as ``"module.QualName"`` strings)
  and can be re-instantiated from the persisted form.

The port's own copy of ``pb_sed_tpu/utils/config.py``: the port imports
nothing of the JAX package. Keep the two in step.
"""
import dataclasses
import importlib
import inspect
from collections.abc import Mapping, MutableMapping


def import_class(path):
    """Resolve ``"module.ClassName"`` to the class object."""
    if not isinstance(path, str):
        return path
    module_name, _, qualname = path.rpartition('.')
    module = importlib.import_module(module_name)
    obj = module
    for part in qualname.split('.'):
        obj = getattr(obj, part)
    return obj


def class_to_str(cls):
    if isinstance(cls, str):
        return cls
    return f'{cls.__module__}.{cls.__qualname__}'


def _resolve_factory(factory):
    if isinstance(factory, str):
        return import_class(factory)
    return factory


def _signature_defaults(factory):
    """Default kwargs from a factory's signature (dataclass aware)."""
    factory = _resolve_factory(factory)
    defaults = {}
    try:
        if dataclasses.is_dataclass(factory):
            for field in dataclasses.fields(factory):
                if not field.init:
                    continue
                if field.name in ('parent', 'name', 'rngs'):
                    continue  # flax module plumbing fields
                if field.default is not dataclasses.MISSING:
                    if type(field.default).__name__ == '_Sentinel':
                        continue
                    defaults[field.name] = field.default
                elif field.default_factory is not dataclasses.MISSING:
                    defaults[field.name] = field.default_factory()
            return defaults
        sig = inspect.signature(factory)
    except (ValueError, TypeError):
        return defaults
    for name, param in sig.parameters.items():
        if name == 'self':
            continue
        if param.kind in (param.VAR_POSITIONAL, param.VAR_KEYWORD):
            continue
        if param.default is not inspect.Parameter.empty:
            defaults[name] = param.default
    return defaults


class DogmaticConfig(MutableMapping):
    """A nested mapping where user-set ("dogmatic") values beat defaults.

    ``cfg[key] = value`` from default-injection code only takes effect if
    ``key`` was not dogmatically set; assigning a dict onto an existing
    sub-config merges it as defaults instead of replacing it.
    """

    def __init__(self):
        self._data = {}
        self._dogmatic = set()
        # priority per key: dogmatic (user) > 'strong' (explicit update(),
        # e.g. mirrored configs) > plain defaults (signature/finalize)
        self._strong = set()
        self._finalized_factories = []

    # -- construction -----------------------------------------------------
    @classmethod
    def from_updates(cls, updates):
        cfg = cls()
        if updates:
            cfg._set_dogmatic_tree(updates)
        return cfg

    def _set_dogmatic_tree(self, mapping):
        for key, value in mapping.items():
            if isinstance(value, (Mapping, DogmaticConfig)):
                sub = self._data.get(key)
                if not isinstance(sub, DogmaticConfig):
                    sub = DogmaticConfig()
                    self._data[key] = sub
                sub._set_dogmatic_tree(value)
                # the key itself stays overridable as a mapping (merge),
                # only its dogmatic leaves are protected
            else:
                self._data[key] = value
                self._dogmatic.add(key)

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key):
        if key not in self._data and 'factory' in self._data:
            # on-demand default fill so cross-references into nested
            # sub-configs resolve (reference behavior)
            self.fill_defaults()
        value = self._data[key]
        return value

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key, value):
        self._write(key, value, overwrite=True, strong=False)

    def _write(self, key, value, overwrite, strong):
        if key in self._dogmatic:
            # dogma wins; dict-valued assignment still merges defaults into
            # any protected sub-config
            existing = self._data.get(key)
            if isinstance(existing, DogmaticConfig) and isinstance(
                    value, (Mapping, DogmaticConfig)):
                existing._merge_defaults(value, overwrite=overwrite,
                                         strong=strong)
            return
        existing = self._data.get(key)
        if isinstance(existing, DogmaticConfig) and isinstance(
                value, (Mapping, DogmaticConfig)):
            existing._merge_defaults(value, overwrite=overwrite,
                                     strong=strong)
            return
        if not strong and key in self._strong:
            return  # plain defaults never displace strong values
        if not overwrite and key in self._data:
            return
        if isinstance(value, (Mapping, DogmaticConfig)) and not isinstance(
                value, DogmaticConfig):
            sub = DogmaticConfig()
            sub._merge_defaults(value, overwrite=True, strong=strong)
            value = sub
        self._data[key] = value
        if strong:
            self._strong.add(key)

    def _merge_defaults(self, mapping, overwrite=False, strong=False):
        for key, value in mapping.items():
            self._write(key, value, overwrite=overwrite, strong=strong)

    def __delitem__(self, key):
        del self._data[key]
        self._dogmatic.discard(key)

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __contains__(self, key):
        if key in self._data:
            return True
        if 'factory' in self._data:
            self.fill_defaults()
        return key in self._data

    def __repr__(self):
        return f'DogmaticConfig({self.to_dict()!r})'

    # -- dogmatic helpers -------------------------------------------------
    def update(self, other=(), reverse=False, **kwargs):
        """Explicit updates are 'strong': they beat sub-factory defaults but
        lose to user-dogmatic values. ``reverse=True`` keeps existing strong
        values in place (mirror-as-defaults semantics,
        reference ``weak_label/crnn.py:340``)."""
        items = dict(other, **kwargs)
        self._merge_defaults(items, overwrite=not reverse, strong=True)

    def fill_defaults(self):
        """Fill signature defaults + run ``finalize_dogmatic_config``."""
        factory = self._data.get('factory')
        if factory is None:
            return
        factory = _resolve_factory(factory)
        if factory in self._finalized_factories:
            return
        self._finalized_factories.append(factory)
        for key, value in _signature_defaults(factory).items():
            if key not in self._data:
                self[key] = value
        finalize = getattr(factory, 'finalize_dogmatic_config', None)
        if finalize is not None:
            finalize(self)

    def resolve(self, max_passes=20):
        """Iterate default filling over the whole tree to a fixed point."""
        for _ in range(max_passes):
            before = self.to_dict(serialize_factories=True)
            self._resolve_once()
            if self.to_dict(serialize_factories=True) == before:
                break

    def _resolve_once(self):
        self._finalized_factories = []
        self.fill_defaults()
        for value in list(self._data.values()):
            if isinstance(value, DogmaticConfig):
                value._resolve_once()

    def to_dict(self, serialize_factories=False):
        out = {}
        for key, value in self._data.items():
            if isinstance(value, DogmaticConfig):
                out[key] = value.to_dict(serialize_factories)
            elif key == 'factory' and serialize_factories:
                out[key] = class_to_str(value)
            else:
                out[key] = value
        return out


def _jsonify(value):
    """Make a resolved config JSON-serializable."""
    import numpy as np
    if isinstance(value, Mapping):
        return {
            k: (class_to_str(v) if k == 'factory' else _jsonify(v))
            for k, v in value.items()
        }
    if isinstance(value, (list, tuple)):
        return [_jsonify(v) for v in value]
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, type) or callable(value) and inspect.isclass(value):
        return class_to_str(value)
    return value


class Configurable:
    """Base class providing get_config / from_config / finalize hooks."""

    @classmethod
    def get_config(cls, updates=None):
        cfg = updates if isinstance(updates, DogmaticConfig) else (
            DogmaticConfig.from_updates(updates))
        if 'factory' not in cfg._data:
            cfg._data['factory'] = cls
        cfg.resolve()
        resolved = cfg.to_dict()
        if isinstance(updates, MutableMapping) and not isinstance(
                updates, DogmaticConfig):
            # mirror resolution back into the caller's dict (reference
            # pattern: ``DESEDProvider.get_config(data_provider)`` mutates)
            updates.clear()
            updates.update(resolved)
        return resolved

    @classmethod
    def finalize_dogmatic_config(cls, config):
        pass

    @classmethod
    def from_config(cls, config):
        return instantiate(config)


def instantiate(config):
    """Recursively instantiate a resolved config tree."""
    if isinstance(config, (Mapping, DogmaticConfig)) and 'factory' in config:
        factory = _resolve_factory(config['factory'])
        kwargs = {
            key: instantiate(value)
            for key, value in config.items() if key != 'factory'
        }
        return factory(**kwargs)
    if isinstance(config, (Mapping, DogmaticConfig)):
        return {key: instantiate(value) for key, value in config.items()}
    if isinstance(config, (list, tuple)):
        return type(config)(instantiate(v) for v in config)
    return config


def config_to_json(config):
    return _jsonify(config)
