"""INI recipe configuration system (a copy of the JAX package's
config.py: ``Conf`` sections, ``ConfigFile``, ``Recipe`` and the sweep
helpers ``parse_sweep_file`` / ``apply_sweep_overrides``).

Capability parity with the reference's config layer (SURVEY.md §1 L10):
a recipe directory holds INI files read with ConfigParser —
``database.conf``, ``model.cfg``, ``trainer.cfg``,
``validation_evaluator.cfg``, ``test_evaluator.cfg``, ``recognizer.cfg`` —
and every component is instantiated from a config section via a registry.
This module keeps the INI surface (cheap parity for the five baseline
recipes) but exposes sections as typed ``Conf`` objects.
"""

from __future__ import annotations

import ast
import configparser
import copy
import os
from typing import Any, Dict, Iterator, List, Optional

RECIPE_FILES = {
    "database": "database.conf",
    "model": "model.cfg",
    "trainer": "trainer.cfg",
    "validation_evaluator": "validation_evaluator.cfg",
    "test_evaluator": "test_evaluator.cfg",
    "recognizer": "recognizer.cfg",
}


class Conf:
    """One config section with typed accessors (ConfigParser-style)."""

    def __init__(self, values: Optional[Dict[str, str]] = None, name: str = ""):
        self.name = name
        self._values: Dict[str, str] = dict(values or {})

    # -- dict-like --------------------------------------------------------
    def __contains__(self, key: str) -> bool:
        return key in self._values

    def __iter__(self) -> Iterator[str]:
        return iter(self._values)

    def keys(self):
        return self._values.keys()

    def items(self):
        return self._values.items()

    def as_dict(self) -> Dict[str, str]:
        return dict(self._values)

    def set(self, key: str, value: Any) -> None:
        self._values[key] = str(value)

    def copy(self) -> "Conf":
        return Conf(copy.deepcopy(self._values), self.name)

    # -- typed getters ----------------------------------------------------
    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._values.get(key, default)

    def __getitem__(self, key: str) -> str:
        try:
            return self._values[key]
        except KeyError:
            raise KeyError(f"missing key {key!r} in section [{self.name}]")

    def getint(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self._values.get(key)
        return int(v) if v is not None else default

    def getfloat(self, key: str, default: Optional[float] = None):
        v = self._values.get(key)
        return float(v) if v is not None else default

    def getbool(self, key: str, default: Optional[bool] = None):
        v = self._values.get(key)
        if v is None:
            return default
        lv = v.strip().lower()
        if lv in ("true", "yes", "1", "on"):
            return True
        if lv in ("false", "no", "0", "off"):
            return False
        raise ValueError(f"not a boolean: {key}={v!r}")

    def getlist(self, key: str, default: Optional[List[str]] = None):
        v = self._values.get(key)
        if v is None:
            return default if default is not None else []
        return [s for s in v.replace(",", " ").split() if s]

    def getintlist(self, key: str, default=None):
        lst = self.getlist(key, None)
        if lst is None:
            return default
        return [int(x) for x in lst]

    def getliteral(self, key: str, default: Any = None) -> Any:
        v = self._values.get(key)
        return ast.literal_eval(v) if v is not None else default

    def __repr__(self) -> str:
        return f"Conf([{self.name}], {self._values})"


class ConfigFile:
    """All sections of one INI file."""

    def __init__(self, sections: Dict[str, Conf], path: str = ""):
        self.path = path
        self._sections = sections

    @classmethod
    def read(cls, path: str) -> "ConfigFile":
        parser = configparser.ConfigParser(
            interpolation=None, inline_comment_prefixes=("#", ";")
        )
        parser.optionxform = str  # keep case
        with open(path) as f:
            parser.read_file(f)
        sections = {
            name: Conf(dict(parser.items(name)), name)
            for name in parser.sections()
        }
        return cls(sections, path)

    def section(self, name: str) -> Conf:
        if name not in self._sections:
            raise KeyError(
                f"missing section [{name}] in {self.path}; "
                f"available: {sorted(self._sections)}"
            )
        return self._sections[name]

    def get_section(self, name: str, default: Optional[Conf] = None):
        return self._sections.get(name, default)

    def sections(self) -> List[str]:
        return list(self._sections)

    def __contains__(self, name: str) -> bool:
        return name in self._sections

    def write(self, path: str) -> None:
        parser = configparser.ConfigParser(interpolation=None)
        parser.optionxform = str
        for name, conf in self._sections.items():
            parser[name] = conf.as_dict()
        with open(path, "w") as f:
            parser.write(f)


class Recipe:
    """A recipe directory: the set of config files driving an experiment."""

    def __init__(self, path: str):
        self.path = path
        self._files: Dict[str, ConfigFile] = {}

    def file(self, kind: str) -> ConfigFile:
        if kind not in self._files:
            fname = RECIPE_FILES.get(kind, kind)
            fpath = os.path.join(self.path, fname)
            if not os.path.exists(fpath):
                raise FileNotFoundError(
                    f"recipe {self.path} has no {fname} "
                    f"(needed for {kind!r})"
                )
            self._files[kind] = ConfigFile.read(fpath)
        return self._files[kind]

    def has(self, kind: str) -> bool:
        fname = RECIPE_FILES.get(kind, kind)
        return os.path.exists(os.path.join(self.path, fname))

    # convenience accessors matching the reference file layout
    @property
    def database(self) -> ConfigFile:
        return self.file("database")

    @property
    def model(self) -> ConfigFile:
        return self.file("model")

    @property
    def trainer(self) -> ConfigFile:
        return self.file("trainer")

    @property
    def validation_evaluator(self) -> ConfigFile:
        return self.file("validation_evaluator")

    @property
    def test_evaluator(self) -> ConfigFile:
        return self.file("test_evaluator")

    @property
    def recognizer(self) -> ConfigFile:
        return self.file("recognizer")


def apply_sweep_overrides(recipe: Recipe, overrides: Dict[str, str]) -> None:
    """Apply sweep-style overrides ``file/section/key -> value`` in place.

    Mirrors the reference's sweep capability (nabu/scripts/sweep.py):
    a sweep file patches recipe parameters to train model variants.
    """
    for spec, value in overrides.items():
        parts = spec.split("/")
        if len(parts) != 3:
            raise ValueError(
                f"override key must be file/section/key, got {spec!r}"
            )
        fkind, section, key = parts
        recipe.file(fkind).section(section).set(key, value)


def parse_sweep_file(path: str) -> List[Dict[str, str]]:
    """Parse a sweep file into a list of override dicts.

    Format: blocks separated by blank lines; each line is
    ``file/section/key value``.
    """
    blocks: List[Dict[str, str]] = []
    cur: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                if cur:
                    blocks.append(cur)
                    cur = {}
                continue
            spec, _, value = line.partition(" ")
            cur[spec] = value.strip()
    if cur:
        blocks.append(cur)
    return blocks
