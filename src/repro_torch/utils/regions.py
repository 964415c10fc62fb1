"""Named spans of the port's code, read by ``repro_torch.analysis``.

``region(label)`` marks a span (``"screen-pass"``: one pass of AFA's
screening loop, ``"round-body"``: the fused engine's round body,
``"twin"``: a kernel wrapper's plain twin on CPU operands, ``"attention"``
and ``"ssd"``: a layer's attention and SSD scan in a model's forward); it
costs a list append and pop.  Each span gets its own serial, ``"screen-pass#12"``,
so two passes in a row stay apart (``region_label`` strips it).  The
engines, the meshes and the wrappers open spans here; the analysis package
reads them, and nothing here imports it.
"""

from __future__ import annotations

import contextlib
import itertools

SCREEN_PASS = "screen-pass"
ROUND_BODY = "round-body"
TWIN = "twin"               # a kernel wrapper's plain twin (CPU operands)
ATTENTION = "attention"     # a forward's attention of one layer (models/blocks.py)
SSD = "ssd"                 # a Mamba-2 layer's chunked SSD scan (models/ssm.py)

_REGIONS: list = []
_SERIAL = itertools.count()


@contextlib.contextmanager
def region(label: str):
    """Label the operations, wrapper calls and collectives made inside."""
    _REGIONS.append(f"{label}#{next(_SERIAL)}")
    try:
        yield
    finally:
        _REGIONS.pop()


def current_regions() -> tuple:
    """The spans open here, outermost first, each ``label#serial``."""
    return tuple(_REGIONS)


def region_label(span: str) -> str:
    return span.split("#", 1)[0]
