"""Spans of the port's serving path, recorded in memory.

``span(name, **attrs)`` marks a region of host code: a serving step, one
layer kind's call inside it, a dispatch or an observation of the HeMT
batcher. With no recording open it returns one shared no-op context, so
the serving path pays a function call and nothing more. Inside
``recording(clock)`` each span appends a :class:`Span`: its name, start
and end on the recording's clock, the index of the span that encloses it
(``parent``; a span's self time is its duration less its children's),
the batch it serves and its attributes. The model's full pass
(``forward``, ``loss_fn``, training) runs the serving steps' layer body,
so it opens the same per-layer spans, outside any step; with no
recording open they cost it the same function call each.

The clock is the opener's: this module reads none of its own. Only the
code that opens a device trace knows that trace's clock (``torch.profiler``
stamps device events on the wall clock, ``time.time_ns``), so that code
passes it in and the spans land on the trace's time line; simulation code
never gets a clock, and the package's rule against wall-clock reads
(hemt-lint HL003) holds unchanged.

A batch id ties a prefill to the decode steps that continue its state:
``new_batch`` draws one, ``bind`` attaches it to the state's cache list
(which decode updates in place and hands back), ``batch_step`` reads it
and counts the step. Only the identity of the cache list is kept, never
the list, so a recording holds no device memory.

One recording is open per process at a time (the spans sit inside model
functions that no recorder object is passed to); ``recording`` closes it
on exit, whatever happens inside.

Spans mark host code, so they fire only where the step's Python runs. On
the card a batch's decode step is captured once as a CUDA graph and then
replayed (``runtime.serve_loop.make_serve_step``): the per-kind spans
(``embed``, ``norm``, ``attn``, ``ssm``, ``ffn``, ``head``) fire on the
capturing step alone, and a replayed ``decode_step`` span has no
children. Every ``decode_step`` span says which it was in its ``graph``
attribute: "capture", "replay" or "eager".
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple


class Span(NamedTuple):
    name: str
    start: int
    end: int
    parent: Optional[int]         # index of the enclosing span in ``Recording.spans``
    batch: Optional[int]
    attrs: Dict[str, Any]


class Recording:
    """The spans of one recording, in the order they opened; an open
    span's slot holds None until it closes."""

    def __init__(self, clock: Callable[[], int]):
        self.clock = clock
        self.spans: List[Optional[Span]] = []
        self._open: List["_Open"] = []
        self._batches = 0
        self._bound: Dict[int, List[int]] = {}     # id(cache list) -> [batch, steps]


class _Noop:
    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        """Attributes known only inside the span; dropped here."""


class _Open:
    __slots__ = ("rec", "name", "batch", "attrs", "parent", "index", "start")

    def __init__(self, rec: Recording, name: str, batch: Optional[int],
                 attrs: Dict[str, Any]):
        self.rec, self.name, self.batch, self.attrs = rec, name, batch, attrs

    def __enter__(self) -> "_Open":
        rec = self.rec
        if rec._open:
            top = rec._open[-1]
            self.parent = top.index
            if self.batch is None:
                self.batch = top.batch
        else:
            self.parent = None
        self.index = len(rec.spans)
        rec.spans.append(None)
        rec._open.append(self)
        self.start = rec.clock()
        return self

    def __exit__(self, *exc) -> None:
        rec = self.rec
        end = rec.clock()
        rec._open.pop()
        rec.spans[self.index] = Span(self.name, self.start, end, self.parent, self.batch,
                                     self.attrs)

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (a dispatch's shares)."""
        self.attrs.update(attrs)


_NOOP = _Noop()
_active: Optional[Recording] = None


def span(name: str, *, batch: Optional[int] = None, **attrs):
    """Context over one region of host code; ``batch`` defaults to the
    enclosing span's. ``with span(...) as sp: sp.set(k=v)`` adds
    attributes known only inside it."""
    rec = _active
    if rec is None:
        return _NOOP
    return _Open(rec, name, batch, attrs)


@contextlib.contextmanager
def recording(clock: Callable[[], int]) -> Iterator[Recording]:
    """Open the process's one recording, reading ``clock`` (an int-valued
    clock, such as the device trace's). Raises if one is open already."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already open")
    rec = _active = Recording(clock)
    try:
        yield rec
    finally:
        _active = None


def new_batch() -> Optional[int]:
    """A fresh batch id, or None with no recording open."""
    rec = _active
    if rec is None:
        return None
    rec._batches += 1
    return rec._batches - 1


def bind(cache: Any, batch: Optional[int]) -> None:
    """Attach ``batch`` to the decode state's cache list."""
    rec = _active
    if rec is not None and batch is not None:
        rec._bound[id(cache)] = [batch, 0]


def batch_step(cache: Any) -> Tuple[Optional[int], Optional[int]]:
    """(batch id, index of this decode step within the batch) of the
    state whose cache list is ``cache``, counting the step; (None, None)
    with no recording open or a cache no prefill bound."""
    rec = _active
    bound = None if rec is None else rec._bound.get(id(cache))
    if bound is None:
        return None, None
    bound[1] += 1
    return bound[0], bound[1] - 1
