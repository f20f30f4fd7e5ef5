"""Device time by the program's own spans: the ``gwen.*`` ranges that
``gwen_tpu_torch.profiling.annotate`` opens while a profiler runs, read
from a traced window's events (:class:`Linked`) on the profiler's one
clock.

Attribution of a device event (kernel, copy or fill; the device-side
annotation ranges are left out):

* It is linked to its host launch by correlation id: the launching
  operator is the host event whose correlation id is the device event's
  linked one (the profiler links a launch to the innermost operator, not
  to a span), the launch is the runtime call that shares the device
  event's own correlation id (else the operator's start). Its path is the
  ``gwen.*`` spans open on the operator's thread at the launch, outermost
  first.
* Where that path does not begin with an entry span (``gwen.train_step``
  or ``gwen.ensemble``), as on autograd's device thread, the spans open at
  that moment on the thread that opened the entry span are put in front.
* Where the path holds ``gwen.backward`` and the launch ran inside a
  backward node, the model and operator spans (``gwen.encoder``,
  ``gwen.process``, ``gwen.decoder``, ``gwen.perturb``, ``gwen.op.*``) open
  at the start of the forward operator with the node's sequence number on
  its forward thread go right below ``gwen.backward``.
* An event with no launch, or launched outside every program span, is
  ``unattributed``.

Device time is the sum of the events' durations inside the ``window``
range, as ``Trace.seconds`` sums them. An operator or a span is a host
event that links to nothing, is not a CUDA runtime or driver call, and
ran on a thread of the program's (one that opened an annotation or an
autograd operator): the profiler's own records, such as "Command Buffer
Full", carry correlation ids of the runtime's kind, which may equal an
operator's. Of operators that share a linked id, the one whose interval
holds the launch is taken.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

from portbench.trace import WINDOW_RANGE, _from_function_event, _from_kineto, _open_range

PREFIX = "gwen."
OP = "gwen.op."
ENTRY = ("gwen.train_step", "gwen.ensemble")
MODEL = ("gwen.encoder", "gwen.process", "gwen.decoder", "gwen.perturb")
BACKWARD = "gwen.backward"
UNATTRIBUTED = "unattributed"
# Above this share of the window's device time unattributed, the glue and
# idle readers read nothing.
MAX_UNATTRIBUTED = 0.02


class Linked(NamedTuple):
    """One profiler event with its links: ``trace.Event``'s five fields
    (name, on the device, an annotation range, interval in ns), then the
    host thread that ran it, its correlation id, the correlation id of the
    host event it links to (a device event's launching operator; 0 for
    none), its autograd sequence number (-1 for none) and, for a backward
    operator, the thread of its forward (0 otherwise)."""

    name: str
    device: bool
    annotation: bool
    start_ns: int
    end_ns: int
    tid: int = 0
    corr: int = 0
    linked: int = 0
    seq: int = -1
    fwd_tid: int = 0


def from_kineto(ev) -> Linked:
    return Linked(*_from_kineto(ev), ev.start_thread_id(), ev.correlation_id(),
                  ev.linked_correlation_id(), ev.sequence_nr(), ev.fwd_thread_id())


def from_function_event(ev) -> Linked:
    return Linked(*_from_function_event(ev), ev.thread, ev.id, 0, ev.sequence_nr,
                  ev.fwd_thread or 0)


@dataclass
class SpanTrace:
    """A traced window by program span: device seconds by span path, the
    spans opened in the window by name, each request's idle seconds and the
    idle gaps by the innermost span open on the entry thread."""

    device_s: float = 0.0
    unattributed_s: float = 0.0
    by_path: dict[tuple, float] = field(default_factory=dict)
    opened: dict[str, int] = field(default_factory=dict)
    request_idle_s: list[float] = field(default_factory=list)
    idle_by_span: dict[str, float] = field(default_factory=dict)
    # unattributed device seconds by the launching host event's name
    unattributed_by: dict[str, float] = field(default_factory=dict)
    # device events, and those whose launch time a runtime call gave
    launched: int = 0
    runtime_timed: int = 0

    def unattributed_share(self) -> float:
        return self.unattributed_s / self.device_s if self.device_s > 0 else 1.0

    def under(self, names) -> float:
        """Device seconds whose path holds any of ``names``."""
        return sum(s for p, s in self.by_path.items() if any(n in p for n in names))

    def glue(self, names) -> float:
        """Device seconds under ``names`` whose path has no ``gwen.op.*``
        span."""
        return sum(s for p, s in self.by_path.items()
                   if any(n in p for n in names) and not any(n.startswith(OP) for n in p))

    def layers(self, k: int = 10) -> list[list]:
        """The ``k`` span names with the largest self device time (the
        innermost span of a path): ``[name, spans opened, ms]``."""
        own: dict[str, float] = {}
        for p, s in self.by_path.items():
            own[p[-1]] = own.get(p[-1], 0.0) + s
        if self.unattributed_s:
            own[UNATTRIBUTED] = self.unattributed_s
        top = sorted(own.items(), key=lambda kv: -kv[1])[:k]
        return [[name, self.opened.get(name, 0), 1e3 * s] for name, s in top]

    def top_idle(self, k: int = 10) -> list[list]:
        top = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:k]
        return [[name, s] for name, s in top]


class _Nest:
    """Properly nested intervals of one thread, ``(start, end, payload)``:
    the chain open at a time, outermost first."""

    def __init__(self, items: list):
        items.sort(key=lambda s: (s[0], -s[1]))
        self.items, self.starts, self.parent = items, [s[0] for s in items], []
        stack: list[int] = []
        for i, (lo, _, _) in enumerate(items):
            while stack and items[stack[-1]][1] <= lo:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: int) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.parent[i]
        return i

    def chain(self, t: int) -> list:
        out, i = [], self.innermost(t)
        while i >= 0:
            out.append(self.items[i][2])
            i = self.parent[i]
        return out[::-1]


def _runtime_call(name: str) -> bool:
    """A CUDA runtime (``cuda*``) or driver (``cuXxx``) API call."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def _merged(intervals: list[tuple[int, int]]) -> list[list[int]]:
    out: list[list[int]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _busy(merged: list[list[int]], starts: list[int], prefix: list[int],
          lo: int, hi: int) -> int:
    """Busy ns of the merged intervals inside ``[lo, hi]`` (``prefix``:
    their lengths' running sum)."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    if i < len(merged) and merged[i][1] <= lo:
        i += 1
    j = bisect.bisect_left(starts, hi)
    if j <= i:
        return 0
    return (prefix[j] - prefix[i] - max(0, lo - merged[i][0])
            - max(0, merged[j - 1][1] - hi))


def _launching_op(candidates, t: Optional[int]) -> Optional[Linked]:
    """Of the host events that carry a device event's linked id, the one
    whose interval holds the launch at ``t``, else the last."""
    for c in candidates:
        if t is not None and c.start_ns <= t <= c.end_ns:
            return c
    return candidates[-1] if candidates else None


def attribute(events: list[Linked], range_names) -> SpanTrace:
    """Reduce a traced window's events to a :class:`SpanTrace`; gaps under
    no program span are named by the harness's host ranges
    (``range_names``), as ``trace.reduce`` names them."""
    out = SpanTrace()
    window = next((e for e in events if not e.device and e.name == WINDOW_RANGE), None)
    if window is None:
        return out
    w_lo, w_hi = window.start_ns, window.end_ns
    spans: dict[int, list] = {}
    nodes: dict[int, list] = {}
    forward: dict[tuple[int, int], list[int]] = {}
    ops: dict[int, list[Linked]] = {}
    launches: dict[int, int] = {}
    ranges, dev = [], []
    threads = {e.tid for e in events if not e.device and (e.annotation or e.seq >= 0)}
    for e in events:
        if e.device:
            if not e.annotation:
                dev.append(e)
            continue
        if e.annotation and e.name.startswith(PREFIX):
            spans.setdefault(e.tid, []).append((e.start_ns, e.end_ns, e.name))
            if w_lo <= e.start_ns <= w_hi:
                out.opened[e.name] = out.opened.get(e.name, 0) + 1
        elif e.name in range_names and e.name != WINDOW_RANGE:
            ranges.append((e.start_ns, e.end_ns, e.name))
        if e.linked:
            launches[e.corr] = e.start_ns
        elif e.tid in threads and not _runtime_call(e.name):
            ops.setdefault(e.corr, []).append(e)
            if e.seq >= 0 and not e.annotation:
                if e.fwd_tid > 0:
                    nodes.setdefault(e.tid, []).append((e.start_ns, e.end_ns, e))
                else:
                    forward.setdefault((e.tid, e.seq), []).append(e.start_ns)
    nest = {tid: _Nest(v) for tid, v in spans.items()}
    node_nest = {tid: _Nest(v) for tid, v in nodes.items()}
    for starts in forward.values():
        starts.sort()
    entries = sorted((lo, hi, name, tid) for tid, v in spans.items()
                     for lo, hi, name in v if name in ENTRY)
    entry_starts = [e[0] for e in entries]

    def entry_at(t: int) -> int:
        i = bisect.bisect_right(entry_starts, t) - 1
        return i if i >= 0 and entries[i][1] >= t else -1

    def chain(tid: int, t: int) -> list[str]:
        n = nest.get(tid)
        return n.chain(t) if n is not None else []

    def forward_spans(tid: int, t: int) -> list[str]:
        n = node_nest.get(tid)
        i = n.innermost(t) if n is not None else -1
        if i < 0:
            return []
        node = n.items[i][2]
        starts = forward.get((node.fwd_tid, node.seq), [])
        j = bisect.bisect_right(starts, t) - 1
        if j < 0:
            return []
        return [s for s in chain(node.fwd_tid, starts[j])
                if s in MODEL or s.startswith(OP)]

    last_end: dict[int, int] = {}
    for k in dev:
        lo, hi = max(k.start_ns, w_lo), min(k.end_ns, w_hi)
        if hi <= lo:
            continue
        dur = (hi - lo) / 1e9
        out.device_s += dur
        t = launches.get(k.corr)
        op = _launching_op(ops.get(k.linked, ()), t) if k.linked else None
        path: list[str] = []
        out.launched += 1
        if op is not None:
            if t is not None and op.start_ns < t <= op.end_ns:
                out.runtime_timed += 1
            else:
                t = op.start_ns
            path = chain(op.tid, t)
            ei = entry_at(t)
            if ei >= 0:
                last_end[ei] = max(last_end.get(ei, 0), k.end_ns)
                if (not path or path[0] not in ENTRY) and entries[ei][3] != op.tid:
                    path = chain(entries[ei][3], t) + path
            if BACKWARD in path:
                below = path.index(BACKWARD) + 1
                path[below:below] = forward_spans(op.tid, t)
        if path:
            key = tuple(path)
            out.by_path[key] = out.by_path.get(key, 0.0) + dur
        else:
            out.unattributed_s += dur
            who = op.name if op is not None else "no launch"
            out.unattributed_by[who] = out.unattributed_by.get(who, 0.0) + dur

    merged = _merged([(e.start_ns, e.end_ns) for e in dev])
    m_starts = [m[0] for m in merged]
    prefix = [0]
    for a, b in merged:
        prefix.append(prefix[-1] + b - a)
    for ei, end in sorted(last_end.items()):
        lo, _, name, _ = entries[ei]
        if name == "gwen.ensemble" and w_lo <= lo <= w_hi and end > lo:
            idle = (end - lo) - _busy(merged, m_starts, prefix, lo, end)
            out.request_idle_s.append(idle / 1e9)

    ranges.sort()
    r_starts = [r[0] for r in ranges]
    entry_tid = entries[0][3] if entries else None
    cur = w_lo
    for a, b in merged + [[w_hi, w_hi]]:
        a, b = min(max(a, w_lo), w_hi), min(b, w_hi)
        if a > cur:
            mid = (cur + a) // 2
            inner = chain(entry_tid, mid) if entry_tid is not None else []
            name = inner[-1] if inner else _open_range(ranges, r_starts, mid)
            out.idle_by_span[name] = out.idle_by_span.get(name, 0.0) + (a - cur) / 1e9
        cur = max(cur, b)
    return out


# ------------------------------------------------------- the metrics' readers


def per_step_ms(sp: Optional[SpanTrace], name: str) -> Optional[float]:
    """Device ms a train step under the span ``name``: the window's total
    over the ``gwen.train_step`` spans begun in it."""
    if sp is None or not sp.opened.get("gwen.train_step") or not sp.opened.get(name):
        return None
    return 1e3 * sp.under((name,)) / sp.opened["gwen.train_step"]


def glue_pct(sp: Optional[SpanTrace], names) -> Optional[float]:
    """The share of the device time under ``names`` whose path has no
    operator span, in %."""
    if sp is None or sp.unattributed_share() > MAX_UNATTRIBUTED:
        return None
    under = sp.under(names)
    return 100.0 * sp.glue(names) / under if under > 0 else None


def request_idle_ms(sp: Optional[SpanTrace]) -> Optional[float]:
    """The median request's device idle ms from its ``gwen.ensemble``
    span's host start to the end of the last device event launched under
    it."""
    if sp is None or not sp.request_idle_s or sp.unattributed_share() > MAX_UNATTRIBUTED:
        return None
    v = sorted(sp.request_idle_s)
    mid = len(v) // 2
    return 1e3 * (v[mid] if len(v) % 2 else 0.5 * (v[mid - 1] + v[mid]))


def kernel_load_s(loads: Optional[dict]) -> Optional[float]:
    """The program's kernel-load seconds (``{name: {"count", "seconds"}}``):
    nvcc's builds, the CUDA libraries' loads and Triton's first calls."""
    if not loads:
        return None
    return sum(v["seconds"] for v in loads.values())
