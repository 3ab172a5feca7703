"""A minimal OmegaConf-like configuration tree.

Implements exactly the subset the pipeline uses from OmegaConf in the
reference (load YAML, merge user config over defaults, dotted ``key=value``
updates, attribute access, ``.get`` with default, ``.update`` with a mapping —
reference run_handheld.py:94-116 and super_resolution.py:239-289).
"""

import copy


class ConfigNode(dict):
    """Nested dict with attribute access. Leaves are plain Python values."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = _wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def update(self, other=None, **kwargs):
        """Shallow update with node wrapping (like OmegaConf .update on a mapping)."""
        if other:
            for k, v in dict(other).items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def copy(self):
        return copy.deepcopy(self)

    def to_dict(self):
        return _unwrap(self)

    def to_yaml(self):
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _wrap(value):
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, dict):
        node = ConfigNode()
        for k, v in value.items():
            node[k] = v
        return node
    return value


def _unwrap(value):
    if isinstance(value, dict):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_unwrap(v) for v in value]
    return value


def load_yaml(path):
    """Load a YAML file into a ConfigNode (needs PyYAML)."""
    import yaml
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return _wrap(data or {})


def merge(base, override):
    """Deep-merge ``override`` into a copy of ``base`` (override wins)."""
    out = copy.deepcopy(_wrap(base))

    def _merge(dst, src):
        for k, v in src.items():
            if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
                _merge(dst[k], v)
            else:
                dst[k] = copy.deepcopy(v)

    _merge(out, _wrap(override))
    return out


def update(config, dotted_key, value):
    """Set ``config.a.b.c = value`` from the dotted string ``"a.b.c"``.

    Intermediate nodes are created on demand (OmegaConf.update semantics used
    by the CLI overrides, reference run_handheld.py:104-116).
    """
    keys = dotted_key.split(".")
    node = config
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = ConfigNode()
        node = node[k]
    node[keys[-1]] = value
    return config


def default_config():
    """The framework's default configuration tree (a fresh copy)."""
    from .defaults import DEFAULTS
    return _wrap(copy.deepcopy(DEFAULTS))
