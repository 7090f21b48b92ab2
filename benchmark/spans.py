"""The profiled sub-window's device events put down to the program's spans
(``pea_diffusion_tpu_torch/utils/trace.py``: host ranges named ``pea/...``,
on the same clock as the kernels).

1. Launching host call: a device event (kernel, memcpy, memset; not a
   GPU-side annotation) joins the CUDA runtime or driver call that launched
   it, the host event with the same correlation id whose name is a runtime
   or driver function (``cudaLaunchKernel``, ``cuLaunchKernel``,
   ``cudaMemcpyAsync``, ...): torch ops and ranges carry ids of their own,
   which can equal a launch's.
2. Phase: the ``pea/`` spans other than components open at the launch on
   the launching thread, outermost first; the innermost is the event's
   phase. On a thread with none open (the autograd engine's), those open
   at the launch time on the main thread, the one whose outermost spans
   cover the most time (the thread that started the profiler).
3. Component (``groupnorm``): the event was launched under a
   ``pea/groupnorm`` span on its own thread (a forward, or a recompute in
   the backward), or by an autograd node whose forward op ran under one:
   the innermost op with a sequence number around the launch is a backward
   node (its ``fwd_thread`` set), and an op of that thread with that
   sequence number lies inside a ``pea/groupnorm`` span there.
4. A device event that joins no launch, or whose launch lies in no span,
   is unattributed.

A run of a program without spans finds none: every reader then returns
None.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

PREFIX = "pea/"
COMPONENTS = frozenset({"groupnorm"})
ANNOTATIONS = (PREFIX, "bench/")  # GPU-side ranges, never device work
RUNTIME = re.compile(r"cu(da)?[A-Z]")


class Span(NamedTuple):
    name: str  # without the prefix
    thread: int
    start: float  # us, the trace's clock
    end: float


class Device(NamedTuple):
    name: str
    start: float
    end: float
    under: Tuple[str, ...]  # phase spans open at the launch, outermost first
    component: Optional[str]

    @property
    def phase(self) -> Optional[str]:
        return self.under[-1] if self.under else None


class Attribution(NamedTuple):
    spans: List[Span]
    device: List[Device]
    host_start: float  # the sub-window's first and last host activity
    host_end: float

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s.name == name)

    def device_us(self, keep) -> float:
        return sum(d.end - d.start for d in self.device if keep(d))

    def idle_us(self, lo: float, hi: float) -> float:
        """Time in [lo, hi] with no device event running."""
        busy, cur = 0.0, None
        for d in sorted(self.device, key=lambda d: d.start):
            s, t = max(d.start, lo), min(d.end, hi)
            if t <= s:
                continue
            if cur is None or s > cur[1]:
                busy += 0.0 if cur is None else cur[1] - cur[0]
                cur = [s, t]
            else:
                cur[1] = max(cur[1], t)
        busy += 0.0 if cur is None else cur[1] - cur[0]
        return max(0.0, hi - lo - busy)


def of(ctx) -> Optional[Attribution]:
    """The attribution of the run's profiled sub-window, made once a run;
    None without a closed sub-window or without a span in it."""
    if "spans" not in ctx:
        sub = ctx.get("subwindow")
        ctx["spans"] = attribute(sub.prof.events()) if sub is not None and sub.done else None
    found = ctx["spans"]
    return found if found is not None and found.spans else None


def _is_cuda(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def _open_at(items: Sequence[Tuple[float, float, object]],
             times: Sequence[float]) -> List[Tuple[object, ...]]:
    """The payloads of the (start, end, payload) `items` of one thread
    (nested, as context managers and ops leave them) open at each of
    `times`, outermost first."""
    items = sorted(items, key=lambda s: (s[0], -s[1]))
    out: List[Tuple[object, ...]] = [()] * len(times)
    stack: List[Tuple[float, float, object]] = []
    k = 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while k < len(items) and items[k][0] <= t:
            while stack and stack[-1][1] <= items[k][0]:
                stack.pop()
            stack.append(items[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(s[2] for s in stack if s[1] >= t)
    return out


def _by_thread(items) -> Dict[int, List]:
    out: Dict[int, List] = {}
    for it in items:
        out.setdefault(it.thread, []).append(it)
    return out


def _ranges(items) -> List[Tuple[float, float, object]]:
    return [(it.start, it.end, it) if isinstance(it, Span)
            else (it.time_range.start, it.time_range.end, it) for it in items]


def _covered(spans: Sequence[Span]) -> float:
    """Time the outermost of one thread's spans cover."""
    total, end = 0.0, float("-inf")
    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        if s.start > end:
            total += s.end - s.start
            end = s.end
    return total


def attribute(events) -> Attribution:
    """Puts each device event of `events` (``prof.events()``) down to its
    phase and component (see the module's docstring)."""
    host, device, launch = [], [], {}
    for e in events:
        if _is_cuda(e):
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(ANNOTATIONS)):
                device.append(e)
        else:
            host.append(e)
            if RUNTIME.match(e.name):
                launch[e.id] = e
    if not host:
        return Attribution([], [], 0.0, 0.0)
    spans = [Span(e.name[len(PREFIX):], e.thread, e.time_range.start, e.time_range.end)
             for e in host if e.name.startswith(PREFIX)]
    spans_of = {th: _ranges(ss) for th, ss in _by_thread(spans).items()}
    phases_of = {th: [s for s in ss if s.name not in COMPONENTS]
                 for th, ss in _by_thread(spans).items()}
    main = max(phases_of, key=lambda th: _covered(phases_of[th]), default=None)

    # (thread, sequence number) of the forward ops (no fwd_thread) that ran
    # under a component span, by component
    seq_ops = _by_thread(e for e in host
                         if e.sequence_nr >= 0 and not e.name.startswith(PREFIX))
    component_of: Dict[Tuple[int, int], str] = {}
    for th, ops in seq_ops.items():
        fwd = [e for e in ops if not e.fwd_thread]
        for e, o in zip(fwd, _open_at(spans_of.get(th, []), [e.time_range.start for e in fwd])):
            comps = [s.name for s in o if s.name in COMPONENTS]
            if comps:
                component_of[(th, e.sequence_nr)] = comps[-1]

    runs = [launch.get(d.id) for d in device]
    at: Dict[int, Tuple[Tuple[str, ...], Optional[str]]] = {}  # id(launch) -> under, component
    for th, rs in _by_thread(r for r in runs if r is not None).items():
        times = [r.time_range.start for r in rs]
        fallback = (_open_at(_ranges(phases_of[main]), times) if main is not None and th != main
                    else [()] * len(rs))
        ops = _open_at(_ranges(seq_ops.get(th, [])), times)
        for r, own, alt, op in zip(rs, _open_at(spans_of.get(th, []), times), fallback, ops):
            under = tuple(s.name for s in own if s.name not in COMPONENTS) or tuple(
                s.name for s in alt)
            comps = [s.name for s in own if s.name in COMPONENTS]
            node = op[-1] if op else None  # a backward node has its forward's thread
            if not comps and node is not None and node.fwd_thread:
                comps = [component_of.get((node.fwd_thread, node.sequence_nr))]
            at[id(r)] = (under, comps[-1] if comps else None)
    return Attribution(
        spans, [Device(d.name, d.time_range.start, d.time_range.end,
                       *(at[id(r)] if r is not None else ((), None)))
                for d, r in zip(device, runs)],
        min(e.time_range.start for e in host), max(e.time_range.end for e in host))


def report(found: Attribution) -> Dict:
    """Where the sub-window's device time and idle went, by span: device
    seconds by phase (None: unattributed) and by component, and the idle
    stretches between device events (and before the first and after the
    last) by the innermost span open on the main thread at their middle."""
    by_phase: Dict[str, float] = {}
    by_component: Dict[str, float] = {}
    for d in found.device:
        key = d.phase or "unattributed"
        by_phase[key] = by_phase.get(key, 0.0) + (d.end - d.start) / 1e6
        if d.component:
            by_component[d.component] = by_component.get(d.component, 0.0) + (
                d.end - d.start) / 1e6
    main = _by_thread(s for s in found.spans if s.name not in COMPONENTS)
    main = max(main.values(), key=_covered, default=[])
    gaps, end = [], found.host_start
    for d in sorted(found.device, key=lambda d: d.start):
        if d.start > end:
            gaps.append((end, d.start))
        end = max(end, d.end)
    if found.host_end > end:
        gaps.append((end, found.host_end))
    mids = [(s + t) / 2 for s, t in gaps]
    idle: Dict[str, float] = {}
    for (s, t), o in zip(gaps, _open_at(_ranges(main), mids)):
        key = o[-1].name if o else "no span"
        idle[key] = idle.get(key, 0.0) + (t - s) / 1e6
    return {"device_s": by_phase, "component_s": by_component, "idle_s": idle}
