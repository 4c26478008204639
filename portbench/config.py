"""A configuration file, ``configs/<name>.json``: the keys it may hold,
and the patterns its recipe makes.

Every key is read: the matcher's keys go to the port's constructor, the
call's to every call, the record's into the result.  A key the harness
does not know is refused, so that no key can be ignored unseen.  This
module imports neither torch nor the port.
"""

from __future__ import annotations

import importlib
import json
import re
from types import ModuleType
from typing import Any

#: passed to the matcher's constructor (``matcher`` names its class)
MATCHER_KEYS = ("matcher", "patterns", "matchkind", "implementation",
                "store_patterns", "backend", "mesh")
#: passed to every call of the window
CALL_KEYS = ("overlapping",)
#: what the deployment is, for the record and the driver
RECORD_KEYS = ("source", "assumed", "reduced", "binding", "guarantees",
               "chips")
REQUIRED = ("source", "assumed", "reduced", "binding", "guarantees",
            "chips", "matcher", "patterns", "matchkind", "backend")
#: the meshes a configuration may ask for
MESHES = (None, "local")
_MODULE = re.compile(r"^[a-z_][a-z0-9_]*$")


def plugin(package: str, name: str) -> ModuleType:
    """Module ``name`` of ``portbench.<package>``, found by its name."""
    if not _MODULE.match(str(name)):
        raise ValueError(f"{package} name {name!r} is not a module name")
    return importlib.import_module(f"portbench.{package}.{name}")


def check(cfg: dict[str, Any]) -> dict[str, Any]:
    """``cfg`` if every key is known and the required ones are there."""
    unknown = sorted(set(cfg) - set(MATCHER_KEYS + CALL_KEYS + RECORD_KEYS))
    if unknown:
        raise ValueError(f"unknown configuration keys {unknown}")
    missing = [k for k in REQUIRED if k not in cfg]
    if missing:
        raise ValueError(f"configuration lacks {missing}")
    if cfg.get("mesh") not in MESHES:
        raise ValueError(f"unknown mesh {cfg['mesh']!r}")
    if "recipe" not in cfg["patterns"]:
        raise ValueError("patterns has no recipe")
    return cfg


def load(path: str) -> dict[str, Any]:
    with open(path) as f:
        return check(json.load(f))


def patterns(cfg: dict[str, Any], seed: int) -> list:
    """The configuration's patterns from ``seed``, by its recipe."""
    params = dict(cfg["patterns"])
    return plugin("recipes", params.pop("recipe")).make(seed, **params)
