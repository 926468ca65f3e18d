"""Device seconds and bytes of spans inside the port's steps.

    with wall.span("attention") as sp:
        h = sp.input(h)             # marks where the span's backward ends
        ...
        out = sp.output(out)        # marks where the span's backward begins

A span records if and only if a ``torch.profiler`` is active and no
backward is running (a forward recomputed inside a backward, as under
``remat``, is that backward's work): there is no other switch.  Off,
:func:`span` returns one shared no-op object whose ``input``/``output``
hand their tensor back, and does nothing else: no event, no allocator
read, no hook, no view.  On, a span

  * on a card, records a pair of CUDA timing events on the current
    stream (resolved when the spans are read, never synchronised inside
    the step) and reads the allocator's allocated bytes at entry and at
    exit; on the CPU it records its place in the tree alone;
  * keeps ``id``, ``parent`` (the enclosing span's id, or None) and
    ``req``: a span opened with no span open starts a request, its
    children share its id, and a ``.bwd`` span takes the id of the span
    it is the backward of;
  * lands, once closed, in a process-global ring of ``MAX_SPANS``.

It opens no ``record_function``: a profile that records host ops copies
such a range onto the device's timeline as a user annotation, which a
reading of device activity would count as work.  The profiler's own
trace holds the host's ops.

**Backward brackets.**  While recording, ``sp.input(x)`` hooks ``x`` and
``sp.output(y)`` hooks ``y`` and hands back a view of it.  The output's
hook opens ``<name>.bwd`` when its gradient arrives and the input's hook
closes it when the gradient is whole, so the span's backward is a span of
its own.  The view keeps the two hooks off one tensor where one span's
output is the next one's input: the next span's input hook sits on the
view, so its backward closes before this one's opens; and the input keeps
the order in which its gradient's parts are summed.  Within one block of a
sequential stack each region is single-entry and single-exit: no other
layer's backward node runs between its two hooks.  A ``.bwd`` span whose
input hook never runs (a backward that stops above the region) is dropped
when its enclosing span ends.

Spans nest on one stack for the process: a step's forward runs in the
caller's thread and its backward in the autograd engine's, never at the
same time.  Read with :func:`recorded` and :func:`summary`.
"""
from __future__ import annotations

from collections import defaultdict, deque

import torch

MAX_SPANS = 200_000          # the ring's bound
_enabled = torch._C._autograd._profiler_enabled
_graph_task = torch._C._current_graph_task_id


class _Off:
    """The shared no-op span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def input(self, t):
        return t

    def output(self, t):
        return t


_OFF = _Off()


class Span:
    """One span: its name, ``id``, ``parent`` and ``req``; on a card its
    ``device_s`` (once read) and ``bytes_in``/``bytes_out`` (forward spans)."""
    __slots__ = ("name", "id", "parent", "req", "bytes_in", "bytes_out", "device_s",
                 "events", "dropped")

    def __init__(self, name: str, req: int, with_bytes: bool):
        st = _state
        self.name, self.req, self.id = name, req, st.next_id
        self.parent = st.stack[-1].id if st.stack else None
        st.next_id += 1
        self.bytes_in = self.bytes_out = self.device_s = self.events = None
        self.dropped = False
        if torch.cuda.is_initialized():
            if with_bytes:
                self.bytes_in = _allocated()
            stream = torch.cuda.current_stream()
            self.events = (_event(stream), stream)
        st.stack.append(self)

    def close(self) -> None:
        if self.dropped:
            return
        st = _state
        if self in st.stack:
            i = st.stack.index(self)
            for dangling in st.stack[i + 1:]:
                dangling.dropped = True
            del st.stack[i:]
        if self.events is not None:
            e0, stream = self.events
            self.events = (e0, _event(stream))
            if self.bytes_in is not None:
                self.bytes_out = _allocated()
        st.ring.append(self)


class _State:
    def __init__(self):
        self.ring: deque = deque(maxlen=MAX_SPANS)
        self.stack: list = []        # open spans, innermost last
        self.next_id = 0
        self.next_req = 0


_state = _State()


def reset() -> None:
    """Forget every recorded span."""
    global _state
    _state = _State()


def _event(stream) -> "torch.cuda.Event":
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _allocated() -> int:
    return torch.cuda.memory_stats_as_nested_dict()["allocated_bytes"]["all"]["current"]


class _Region:
    """The backward of one span: its output's gradient hook opens it, its
    input's closes it."""
    __slots__ = ("name", "req", "open")

    def __init__(self, name: str, req: int):
        self.name, self.req, self.open = name + ".bwd", req, None

    def begin(self, grad) -> None:
        if _enabled():
            self.open = Span(self.name, self.req, with_bytes=False)

    def end(self, grad) -> None:
        sp, self.open = self.open, None
        if sp is not None:
            sp.close()


class _Recording:
    __slots__ = ("name", "open", "region")

    def __init__(self, name: str):
        self.name, self.open, self.region = name, None, None

    def __enter__(self):
        st = _state
        if st.stack:
            req = st.stack[-1].req
        else:
            req, st.next_req = st.next_req, st.next_req + 1
        self.open = Span(self.name, req, with_bytes=True)
        return self

    def __exit__(self, *exc):
        self.open.close()
        return False

    def input(self, t: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and t.requires_grad:
            self.region = _Region(self.name, self.open.req)
            t.register_hook(self.region.end)
        return t

    def output(self, t: torch.Tensor) -> torch.Tensor:
        if self.region is None or not t.requires_grad:
            return t
        t.register_hook(self.region.begin)
        return t.view_as(t)


def span(name: str):
    """A context manager recording ``name`` while a profiler is active
    outside a backward, and the shared no-op otherwise."""
    if not _enabled() or _graph_task() != -1:
        return _OFF
    return _Recording(name)


def recorded() -> list:
    """The recorded spans in the order they closed, each with its
    ``device_s`` once the device has reached its end event (this waits
    for those events)."""
    spans = list(_state.ring)
    for s in spans:
        if s.events is not None:
            e0, e1 = s.events
            e1.synchronize()
            s.device_s, s.events = e0.elapsed_time(e1) / 1e3, None
    return spans


def summary(spans=None) -> dict:
    """Per span name, over ``spans`` (every recorded span by default):
    ``count``; ``device_s`` and ``device_self_s`` (less the direct
    children's; None where no span of the name had device events);
    ``bytes_held`` (allocated bytes at exit less at entry, summed; forward
    spans on a card, else None) and ``bytes_at_entry`` (summed)."""
    spans = recorded() if spans is None else spans
    child_dev: dict = defaultdict(float)
    for s in spans:
        if s.parent is not None and s.device_s is not None:
            child_dev[s.parent] += s.device_s
    out: dict = {}
    for s in spans:
        row = out.setdefault(s.name, {"count": 0, "device_s": None, "device_self_s": None,
                                      "bytes_held": None, "bytes_at_entry": None})
        row["count"] += 1
        if s.device_s is not None:
            row["device_s"] = (row["device_s"] or 0.0) + s.device_s
            row["device_self_s"] = (row["device_self_s"] or 0.0) + s.device_s - child_dev[s.id]
        if s.bytes_out is not None:
            row["bytes_held"] = (row["bytes_held"] or 0) + s.bytes_out - s.bytes_in
            row["bytes_at_entry"] = (row["bytes_at_entry"] or 0) + s.bytes_in
    return out
