"""Files found by name: a per-layer metric's reader, a traffic kind, a
graph generator. Each is a file of its own, so a later cell, metric or
generator is a new file and never an edit."""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(folder: str, name: str, attr: str):
    """``attr`` of the module in ``portbench/<folder>/<name>.py``."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {path.relative_to(HERE.parent)}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, attr)
