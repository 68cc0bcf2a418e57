"""The port's span recorder: where the host's time goes inside the program,
always on.

``span(name, unit=None, **attrs)`` is a context manager that records one
:class:`Record` when it closes: its name, start and end on
``time.time_ns()`` (the Unix epoch in ns, the clock ``torch.profiler``
stamps its events on, so a span sits beside a device trace as it is), the
id of the span open around it on the same thread (``parent``), a unit id
and the attributes.  The unit id names the unit of work a span belongs to
(a train step's number, a prefetcher get's ordinal, a ``synthesize``
call's number); a span without one takes its parent's, so the spans of one
call or step share it.

The records stay in memory, the newest :data:`CAPACITY` of them; older
ones are dropped and counted (``dropped``).  Nothing is written to disk.
A span costs two clock reads and an append, with no lock.  No span goes to
``torch.profiler``: the profiler draws a ``record_function`` range as a
device-side annotation, which a device trace would count as busy time.

The module's functions act on the process's recorder (:data:`RECORDER`),
which the program's layers write and the benchmark's readers read in the
same process; a test that wants a recorder of its own puts a fresh
:class:`Recorder` in its place.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, Iterable, List, NamedTuple, Optional

#: records kept; older ones are dropped
CAPACITY = 65536


class Record(NamedTuple):
    """One closed span."""

    name: str
    id: int
    parent: Optional[int]
    unit: Optional[int]
    start_ns: int
    end_ns: int
    thread: int
    attrs: Dict[str, Any]

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_new_record = tuple.__new__   # a Record without its __new__'s call


class _Thread:
    """One thread's open spans and the count of spans it closed; only that
    thread writes them."""

    __slots__ = ("ident", "stack", "closed")

    def __init__(self, ident: int):
        self.ident = ident
        self.stack: List["Span"] = []
        self.closed = 0


class Span:
    """An open span (what ``with span(...) as s`` binds): ``attrs`` may be
    added to until it closes; ``start_ns`` and, once closed, ``end_ns``
    are its bounds."""

    __slots__ = ("_recorder", "_thread", "name", "id", "parent", "unit",
                 "attrs", "start_ns", "end_ns")

    def __init__(self, recorder: "Recorder", name: str, unit: Optional[int],
                 attrs: Dict[str, Any]):
        self._recorder = recorder
        self.name = name
        self.unit = unit
        self.attrs = attrs
        self.end_ns = 0

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self) -> "Span":
        rec = self._recorder
        ident = threading.get_ident()
        self._thread = thread = (rec._threads.get(ident)
                                 or rec._threads.setdefault(ident,
                                                            _Thread(ident)))
        stack = thread.stack
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.unit is None:
                self.unit = top.unit
        else:
            self.parent = None
        self.id = next(rec._ids)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = end = time.time_ns()
        thread = self._thread
        thread.stack.pop()
        thread.closed += 1
        # a bounded deque's append, one C call: no lock
        self._recorder._buf.append(_new_record(Record, (
            self.name, self.id, self.parent, self.unit, self.start_ns, end,
            thread.ident, self.attrs)))


class Recorder:
    """The spans of one process (see the module docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        # thread id -> _Thread; a finished thread's entry, its stack empty,
        # serves the next thread the system gives that id
        self._threads: Dict[int, _Thread] = {}
        self._ids = itertools.count()

    @property
    def dropped(self) -> int:
        """The records dropped for room: the spans closed less those kept
        (exact while no span closes during the read)."""
        closed = sum(t.closed for t in list(self._threads.values()))
        return max(0, closed - len(self._buf))

    def span(self, name: str, unit: Optional[int] = None, **attrs) -> Span:
        return Span(self, name, unit, attrs)

    def records(self, name: Optional[str] = None) -> List[Record]:
        """The kept records (of ``name``, if given), in the order they
        closed."""
        out = list(self._buf)   # one C call: no append interleaves
        return out if name is None else [r for r in out if r.name == name]


def self_ns(record: Record, records: Iterable[Record]) -> int:
    """``record``'s self time: its duration less the part of it that its
    child spans (among ``records``) cover."""
    kids = sorted((max(r.start_ns, record.start_ns),
                   min(r.end_ns, record.end_ns))
                  for r in records if r.parent == record.id)
    covered, end = 0, record.start_ns
    for s, e in kids:
        s = max(s, end)
        if e > s:
            covered += e - s
            end = e
    return record.end_ns - record.start_ns - covered


#: the process's recorder
RECORDER = Recorder()


def span(name: str, unit: Optional[int] = None, **attrs) -> Span:
    return RECORDER.span(name, unit, **attrs)


def records(name: Optional[str] = None) -> List[Record]:
    return RECORDER.records(name)


__all__ = ["CAPACITY", "RECORDER", "Record", "Recorder", "Span", "records",
           "self_ns", "span"]
