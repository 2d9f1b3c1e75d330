"""Counters and spans of the program: what an operator reads to see where a
streaming chunk's or a bulk call's time goes.

`counters` is one registry of integers, always on. The kernels' wrappers,
the graph helpers, the kernel builder and the interpreter add to it:

- `mel.launches`, `mel.captured`: mel kernel launches, and calls recorded
  while a stream was being captured into a CUDA graph (those launch nothing
  themselves; each replay of the graph counts its launches);
- `mix.launches`: mix kernel launches;
- `graph.captures`, `graph.replays`: CUDA graphs captured and replayed
  (utils/cuda_graph.py);
- `kernels.built`: native libraries compiled by nvcc or g++ (ops/_build.py);
- `interpreter.chunks`: 80 ms chunks `NanoInterpreter.predict` scored;
- `interpreter.verifier_runs`, `interpreter.verifier_served`: chunks on
  which a cascade's verifier really ran, and those on which its own score
  reached the result (neither the gate nor the window's warm-up guard
  zeroed it);
- `interpreter.verifier_skipped`: chunks on which the one-call step, split
  at the gate, did not run the cascade's verifier (for such a step
  `verifier_runs` + `verifier_skipped` = `chunks`);
- `ssm.scans`, `ssm.frames`: the Granite hybrid's Mamba-2 scans run
  outside a CUDA-graph capture, and the frames (batch x length) they
  scanned (a replay of a captured step adds to neither).
- `features.downloads`, `features.downloads_pinned`: batches whose
  embeddings `AudioFeatures.embed_clips` copied to the host, and those
  among them that landed in page-locked memory (the call's pinned output,
  or its pinned staging block where the output is too large to pin); on
  the CPU the second stays put.

`span(name, device=False, **attrs)` marks a stage of the program. Off (the
default) it returns one shared no-op context. It is on inside
`recording()` and while a `torch.profiler` records. Then a span keeps its
name, its host interval (`time.perf_counter_ns`), its parent and the request
it belongs to (the root span's `request` attribute, or a serial of root
spans) in a bounded store. With `device` a CUDA torch.device, it records a
pair of timing events on that device's current stream, whose interval is
the span's device time: the idle gaps inside the span, where the device
waits on the host (a launch from an idle stream, the launches of an eager
model), count in it. The events are read by `snapshot()`, after the
synchronisation the program makes anyway (a score or an embedding copied
to the host); the tracer never synchronises. Spans entered while a stream
is being captured into a CUDA graph are no-ops: they would time the
capture, not the replays.

Under a profiler a span also opens a range of its name in the trace, a
host operation on the clock of the device's activity, so the trace shows
the program's stages. The range is opened through torch's private
`torch._C._profiler._RecordFunctionFast`, not `torch.profiler.
record_function`, whose user-scope range the profiler also copies onto the
device timeline, where a trace's busy time would count it as work.

A session starts at the first span entered while the tracer is on after a
span was entered with it off, or after `recording()` was entered or left.
`snapshot()` gives the spans, their device times and the counters' changes
of the last session.

The span names, from the entry points down:

    nww.predict            NanoInterpreter.predict (request: the chunk serial)
      nww.predict.upload     the chunker; then, per chunk, its copy to the
                             device (two spans of this name a chunk)
      nww.step.replay        the captured step's launch           (device)
      nww.predict.readback   the scores' copy to the host (waits for the step)
      nww.step.verifier      a split cascade's verifier, its launch and its
                             score's copy to the host            (device)
      nww.predict.rules      the VAD gate, patience / debounce, the score
                             buffers (after the warm-up guard and the
                             cascade gate, which zero a model unscored)
      nww.predict.features   (general path) the feature step
      nww.session.run        (general path) one model's score; attrs model
    nww.embed_clips        AudioFeatures.embed_clips, per batch:
      nww.features.upload    the clips' copy to the device        (device)
      nww.features.mel       the log-mel (the kernel's launch)    (device)
      nww.features.encoder   the speech encoder                   (device)
      nww.features.download  the embeddings' copy to the host, pinned and
                             asynchronous on a card               (device)
    nww.run_batch          _LocalSession.run_batch:
      nww.session.upload     the features' copy to the device     (device)
      nww.session.forward    the classifier and its sigmoid       (device)
        nww.ssm.scan           a Mamba-2 mixer's SSD scan, from its inputs
                               to y before the gate; attrs batch, length,
                               heads, head_dim, state, groups, chunk (device)
        nww.attention.core     Q K^T, the mask, the softmax and A V of a
                               Granite hybrid's attention layer   (device)
      nww.session.download   the scores' copy to the host         (device)
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import torch

COUNTERS = ("mel.launches", "mel.captured", "mix.launches",
            "graph.captures", "graph.replays", "kernels.built",
            "interpreter.chunks", "interpreter.verifier_runs",
            "interpreter.verifier_served", "interpreter.verifier_skipped",
            "ssm.scans", "ssm.frames", "features.downloads",
            "features.downloads_pinned")
counters = dict.fromkeys(COUNTERS, 0)

MAX_SPANS = 1 << 16          # the store keeps the newest spans of a session

_profiler_enabled = torch._C._autograd._profiler_enabled
_HostRange = torch._C._profiler._RecordFunctionFast


@dataclass(slots=True)
class SpanRecord:
    """One span: host interval in perf_counter nanoseconds, device time in
    milliseconds (None if not timed or not yet resolved)."""
    id: int
    name: str
    parent: Optional[int]
    request: int
    attrs: dict
    start_ns: Optional[int] = None
    end_ns: Optional[int] = None
    device_ms: Optional[float] = None
    events: Optional[tuple] = field(default=None, repr=False)

    @property
    def host_ms(self) -> Optional[float]:
        if self.start_ns is None or self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e6


@dataclass
class Snapshot:
    """The spans of a session, oldest first, and the counters' changes."""
    spans: list
    counters: dict

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]


class _Session:
    def __init__(self):
        self.spans = deque(maxlen=MAX_SPANS)
        self.ids = itertools.count()
        self.counters_start = dict(counters)
        self.counters_end = self.counters_start


class _State:
    recording = 0               # depth of recording() contexts
    live = False                # the current session is still open
    session: Optional[_Session] = None


_state = _State()
_local = threading.local()      # each thread's stack of open spans
_requests = itertools.count()


class _NoSpan:
    """The span while tracing is off: enters and exits, records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def capturing() -> bool:
    """A stream is being captured into a CUDA graph."""
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def _stream_of(device):
    if isinstance(device, torch.device) and device.type == "cuda":
        return torch.cuda.current_stream(device)
    return None


class _Span:
    __slots__ = ("record", "_stream", "_start", "_mirror", "_session",
                 "_stack")

    def __init__(self, session: _Session, name: str, device, attrs: dict):
        self._stack = stack = _stack()
        parent = stack[-1] if stack else None
        if parent is not None:
            request = parent.request
        else:
            request = attrs.pop("request", None)
            if request is None:
                request = next(_requests)
        self.record = SpanRecord(next(session.ids), name,
                                 None if parent is None else parent.id,
                                 request, attrs)
        self._session = session
        self._stream = _stream_of(device) if device else None
        self._mirror = None

    def __enter__(self):
        self._stack.append(self.record)
        self._session.spans.append(self.record)
        if _profiler_enabled():
            # a range the profiler keeps as a host operation: a user-scope
            # `record_function` range would also be copied onto the device
            # timeline, as an annotation spanning the device work launched
            # inside it, which a trace's busy time would count as work
            self._mirror = _HostRange(self.record.name)
            self._mirror.__enter__()
        if self._stream is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self._stream)
        self.record.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        record = self.record
        record.end_ns = time.perf_counter_ns()
        if self._stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            record.events = (self._start, end)
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
        stack = self._stack
        stack.pop()
        if not stack:
            self._session.counters_end = dict(counters)
        return False


def span(name: str, device=False, **attrs):
    """A context for one stage of the program; see the module's docstring.
    `device`: the torch.device whose current stream the span's device time
    is taken on (a CUDA device; any other times nothing)."""
    if not (_state.recording or _profiler_enabled()):
        _state.live = False
        return NO_SPAN
    if capturing():
        return NO_SPAN
    if not _state.live:
        _state.session = _Session()
        _state.live = True
    return _Span(_state.session, name, device, attrs)


@contextmanager
def recording():
    """Turn spans on for the block (no profiler needed); a new session
    starts at its first span and ends with the block."""
    if not _state.recording:
        _state.live = False
    _state.recording += 1
    try:
        yield
    finally:
        _state.recording -= 1
        if not _state.recording:
            _state.live = False


def snapshot() -> Snapshot:
    """The spans and the counters' changes of the last session (empty
    before any). Device times whose events have completed are resolved; a
    span whose work the device has not finished keeps `device_ms` None."""
    session = _state.session
    if session is None:
        return Snapshot([], dict.fromkeys(COUNTERS, 0))
    spans = list(session.spans)
    for record in spans:
        if record.events is not None and record.events[1].query():
            start, end = record.events
            record.device_ms = start.elapsed_time(end)
            record.events = None
    return Snapshot(spans, {k: session.counters_end[k]
                            - session.counters_start[k] for k in COUNTERS})
