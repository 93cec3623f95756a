"""The system under test, found by name: a configuration's ``"system"``
names ``systems/<system>.py``, whose contract ``systems/__init__.py``
gives. ``build`` hands a configuration to its system's ``build``.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Optional

DIR = Path(__file__).resolve().parent / "systems"


@dataclass
class System:
    params: object                        # handed back as the callables' first argument
    pipeline: Optional[Callable] = None   # batch: (params, frames) -> answer
    init: Optional[Callable] = None       # tick: frames -> state
    step: Optional[Callable] = None       # tick: (params, state, frame) -> (state, answer)


def names() -> List[str]:
    """The systems there are."""
    return sorted(p.stem for p in DIR.glob("*.py") if not p.stem.startswith("_"))


def module(cfg: dict) -> ModuleType:
    """The system module that configuration ``cfg`` names."""
    name = cfg["system"]
    path = DIR / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"configuration {cfg.get('name')!r} names system {name!r}, "
                         f"which is not in {DIR}; systems: {names()}")
    spec = importlib.util.spec_from_file_location(f"nowcast_bench.systems.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(cfg: dict, kind: str, weights: dict, device,
          wrap: Optional[Callable[[str, Callable], Callable]] = None,
          control: bool = False) -> System:
    """The program for a ``kind`` ("batch" or "tick") mix, or with
    ``control`` the system's control."""
    return module(cfg).build(cfg, kind, weights, device, wrap=wrap, control=control)
