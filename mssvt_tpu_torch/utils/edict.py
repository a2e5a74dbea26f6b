"""A minimal attribute-access dict (easydict equivalent, no external dep).

The reference framework builds its whole config system on ``easydict.EasyDict``
(ref: pcdet/config.py:1-5). We provide a self-contained equivalent.
"""

from __future__ import annotations


class EasyDict(dict):
    """dict with attribute access; nested dicts/lists are converted recursively."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d is None:
            d = {}
        d = dict(d)
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _convert(value):
        if isinstance(value, EasyDict):
            return value
        if isinstance(value, dict):
            return EasyDict(value)
        if isinstance(value, (list, tuple)):
            converted = [EasyDict._convert(v) for v in value]
            return type(value)(converted) if isinstance(value, tuple) else converted
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, EasyDict._convert(value))

    def __setattr__(self, name, value):
        self[name] = value

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def update(self, other=None, **kwargs):  # keep conversion on update
        if other is None:
            other = {}
        for k, v in dict(other, **kwargs).items():
            self[k] = v

    def copy(self):
        return EasyDict(self)
