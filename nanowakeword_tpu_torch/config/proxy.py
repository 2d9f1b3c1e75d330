"""ConfigProxy: mapping wrapper with leaf-access tracking.

A copy of `nanowakeword_tpu/config/proxy.py`.

Parity target: the upstream `nanowakeword/_config/ConfigProxy.py` — every
leaf key ever read (including defaulted `get()`s) is recorded so the live
config table (utils/dynamic_table.py) and the training journal can show
exactly the parameters a run actually used. Nested dicts proxy recursively
with dotted prefixes; a proxy wrapping a scalar coerces like one.
"""

from __future__ import annotations

import collections.abc


class ConfigProxy(collections.abc.Mapping):
    def __init__(self, data, root_proxy=None, prefix: str = ""):
        self._tree = data
        self._tracker_root = root_proxy if root_proxy is not None else self
        self._dotted_prefix = prefix
        if self._tracker_root is self:
            self._seen_leaves = {}
            self._seen_keys = set()

    def _track_access(self, key, value):
        full_key = self._dotted_prefix + key
        if not isinstance(value, dict):
            root = self._tracker_root
            if full_key not in root._seen_keys:
                root._seen_leaves[full_key] = value
                root._seen_keys.add(full_key)

    def __getitem__(self, key):
        if key not in self._tree:
            raise KeyError(f"Key '{self._dotted_prefix}{key}' not found "
                           "in configuration.")
        value = self._tree[key]
        self._track_access(key, value)
        if isinstance(value, dict):
            return ConfigProxy(value, root_proxy=self._tracker_root,
                               prefix=f"{self._dotted_prefix}{key}.")
        return value

    def __iter__(self):
        return iter(self._tree)

    def __len__(self):
        return len(self._tree)

    def get(self, key: str, default=None):
        if key in self._tree:
            return self[key]
        self._track_access(key, default)
        if isinstance(default, dict):
            return ConfigProxy(default, root_proxy=self._tracker_root,
                               prefix=f"{self._dotted_prefix}{key}.")
        return default

    def __setitem__(self, key, value):
        self._tree[key] = value
        self._track_access(key, value)

    def report(self) -> dict:
        """All parameters accessed so far (leaf keys, dotted paths)."""
        return self._tracker_root._seen_leaves

    def to_dict(self) -> dict:
        out = {}
        for key, value in self.items():
            out[key] = value.to_dict() if isinstance(value, ConfigProxy) else value
        return out

    def __repr__(self):
        return (f"ConfigProxy(prefix='{self._dotted_prefix}', "
                f"data={self._tree})")

    def _leaf(self):
        if isinstance(self._tree, dict):
            raise TypeError(
                "This ConfigProxy wraps a dictionary and cannot be treated "
                f"as a single value. Path: '{self._dotted_prefix}'")
        return self._tree

    def __int__(self):
        return int(self._leaf())

    def __float__(self):
        return float(self._leaf())

    def __str__(self):
        if isinstance(self._tree, dict):
            return str(self._tree)
        return str(self._leaf())

    def __add__(self, other):
        return self._leaf() + other

    def __radd__(self, other):
        return other + self._leaf()


def deep_merge(d1: dict, d2: dict) -> dict:
    """Recursively merge d2 into d1 (trainer.py:81-92)."""
    for k, v in d2.items():
        if (k in d1 and isinstance(d1[k], dict)
                and isinstance(v, collections.abc.Mapping)):
            d1[k] = deep_merge(d1[k], v)
        else:
            d1[k] = v
    return d1
