"""The configuration as the reference reads it: the configuration file's
sections as attribute namespaces (lists as tuples), independent of the
program's configuration classes."""

from __future__ import annotations

import types

SECTIONS = ("sensor", "preprocess", "keypoints", "descriptor", "match", "map",
            "backend", "runtime")


def from_json(config: dict) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{
        name: types.SimpleNamespace(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in config[name].items()})
        for name in SECTIONS})
