"""Modules that a data file names: a configuration's build
(``builds/<name>.py``) and a traffic mix's centre kind
(``centers/<name>.py``), as ``data/<generator>.py`` is named by its
configuration."""
from __future__ import annotations

import importlib
import pathlib
import re

PKG = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9][A-Za-z0-9_]*\Z")


def find(package: str, name, source):
    """``portbench.<package>.<name>``; a ``ValueError`` that names
    ``source``, the file that asked for it, where there is no such
    module."""
    if not (isinstance(name, str) and NAME.match(name)
            and (PKG / package / f"{name}.py").is_file()):
        known = sorted(p.stem for p in (PKG / package).glob("[!_]*.py"))
        raise ValueError(f"{source}: no {package} module {name!r} (there are {known})")
    return importlib.import_module(f"portbench.{package}.{name}")
