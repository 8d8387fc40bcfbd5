"""A model family of the benchmark, found by its name.

A configuration's file names its family (``"family"`` at its top level,
``bench/configs/<config>.json``).  The family is two modules of that
name, and nothing else:

- ``bench/reference/families/<family>.py``: the plain reference of the
  family's layers and the laws of their weights;
- ``bench/counts/families/<family>.py``: its model FLOPs and the bytes
  and operations of the kernel calls its layers make.

Adding a family is adding those two files; no file that is already
there changes.  A module registered in ``sys.modules`` under either name
counts as the file.
"""
from __future__ import annotations

import importlib
from types import ModuleType

#: where each half of a family lives, as a package and as a folder
PLACES = {"reference": "bench.reference.families",
          "counts": "bench.counts.families"}


def files(name: str) -> list[str]:
    """The two files that make up family ``name``."""
    return [p.replace(".", "/") + f"/{name}.py" for p in PLACES.values()]


def _module(where: str, name: str) -> ModuleType:
    full = f"{PLACES[where]}.{name}"
    why = f"no family {name!r}: looked for {' and '.join(files(name))}"
    if not name.isidentifier():
        raise LookupError(f"{why}, but {name!r} is no module name")
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise LookupError(f"{why}; {full.replace('.', '/')}.py is not there"
                          ) from None


def reference(name: str) -> ModuleType:
    """The reference half of family ``name``."""
    return _module("reference", name)


def counts(name: str) -> ModuleType:
    """The counts half of family ``name``."""
    return _module("counts", name)
