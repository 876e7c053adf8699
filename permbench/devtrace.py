"""The device's side of a traced window, from torch.profiler's events.

Device events are every kernel, copy and set the profiler saw on the card
(CUPTI records the program's ctypes-launched kernels as it records
PyTorch's own).  Host events are the harness's marks of the window and
of each call, and the program's spans, which the harness puts on the
timeline while it traces (harness.span_marks).  Only this summary is
kept, never the trace.
"""

from __future__ import annotations

import dataclasses

#: the harness's marks of the window and of each call
WINDOW, CALL = "permbench.window", "permbench.call"
#: the prefix of the program's spans on the timeline, and the span that
#: holds the others (inside a call's mark, so it labels nothing itself)
SPAN, OUTER_SPAN = "span:", "span:permanent["
#: idle labels of device gaps that fall in no leaf span of the program
DISPATCH, BETWEEN = "dispatch", "between_calls"


@dataclasses.dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    #: device seconds by short name
    device_s: dict = dataclasses.field(default_factory=dict)
    #: [[name, seconds]], most time first
    device_ops: list = dataclasses.field(default_factory=list)
    #: [[what the host was doing, idle seconds]], most time first
    idle_gaps: list = dataclasses.field(default_factory=list)

    def kernel_s(self, kernel: str) -> float:
        """Device seconds of every instance of the kernel function."""
        return sum(s for k, s in self.device_s.items()
                   if base_name(k) == kernel)


#: the longest device operation name kept whole; longer ones lose their
#: template arguments (PyTorch's own kernels)
NAME_MAX = 64


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and argument
    list: "void (anonymous namespace)::f<32, 0>(int*, ...)" ->
    "f<32, 0>"; template arguments too where that is long."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name if len(name) <= NAME_MAX else name.split("<", 1)[0]


def base_name(name: str) -> str:
    """The function's own name: "ns::f<32, 0>" -> "f"."""
    return name.split("<", 1)[0].rsplit("::", 1)[-1].strip()


def _start(ev) -> int:
    """An event's start in ns (torch releases name it start_ns or
    start_us)."""
    return ev.start_ns() if hasattr(ev, "start_ns") else \
        int(ev.start_us() * 1000)


def _dur(ev) -> int:
    return ev.duration_ns() if hasattr(ev, "duration_ns") else \
        int(ev.duration_us() * 1000)


def _on_host(ev) -> bool:
    return str(ev.device_type()).endswith("CPU")


def _device_event(ev) -> bool:
    """A kernel, copy or set on the card: not a range the host marked,
    which the profiler repeats on the card's timeline."""
    name = ev.name()
    return (str(ev.device_type()).endswith("CUDA")
            and not name.startswith((SPAN, WINDOW, CALL)))


def summarize(prof, on_card: bool) -> Trace:
    events = prof.profiler.kineto_results.events()
    host = [ev for ev in events if _on_host(ev)]
    win = [ev for ev in host if ev.name() == WINDOW]
    out = Trace()
    if not win:
        return out
    w0 = _start(win[0])
    w1 = w0 + _dur(win[0])
    out.window_s = (w1 - w0) * 1e-9
    dev = [ev for ev in events if _device_event(ev)] if on_card else []
    iv = []
    for ev in dev:
        s, d = _start(ev), _dur(ev)
        if s + d <= w0 or s >= w1:
            continue
        name = short_name(ev.name())
        out.device_s[name] = out.device_s.get(name, 0.0) + d * 1e-9
        iv.append((max(s, w0), min(s + d, w1)))
    out.device_ops = sorted(([k, v] for k, v in out.device_s.items()),
                            key=lambda kv: -kv[1])
    # busy: the union of the device intervals; idle: the rest of the window
    iv.sort()
    busy, gaps, cur = 0, [], w0
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if cur < w1:
        gaps.append((cur, w1))
    out.busy_s = busy * 1e-9
    out.idle_gaps = _label_gaps(gaps, host, w0, w1)
    return out


def _segments(host, w0: int, w1: int):
    """The window cut into labelled host segments, sorted and disjoint:
    the program's leaf spans by name, the rest of each call DISPATCH, the
    rest of the window BETWEEN."""
    calls, leaves = [], []
    for ev in host:
        nm, s = ev.name(), _start(ev)
        e = s + _dur(ev)
        if s >= w1 or e <= w0:
            continue
        if nm == CALL:
            calls.append((s, e))
        elif nm.startswith(SPAN) and not nm.startswith(OUTER_SPAN):
            leaves.append((s, e, nm[len(SPAN):]))
    calls.sort()
    leaves.sort()
    segs, cur, li = [], w0, 0
    for cs, ce in calls:
        if cs > cur:
            segs.append((cur, cs, BETWEEN))
        cur = max(cur, cs)
        while li < len(leaves) and leaves[li][0] < ce:
            ls, le, nm = leaves[li]
            li += 1
            if ls > cur:
                segs.append((cur, ls, DISPATCH))
            if le > max(cur, ls):
                segs.append((max(cur, ls), le, nm))
                cur = le
        if ce > cur:
            segs.append((cur, ce, DISPATCH))
            cur = ce
    if w1 > cur:
        segs.append((cur, w1, BETWEEN))
    return segs


def _label_gaps(gaps, host, w0, w1) -> list:
    """Idle seconds by what the host was doing while the card idled: each
    gap's overlap with each labelled segment (_segments)."""
    segs = _segments(host, w0, w1)
    tot, si = {}, 0
    for gs, ge in gaps:
        while si < len(segs) and segs[si][1] <= gs:
            si += 1
        j = si
        while j < len(segs) and segs[j][0] < ge:
            s, e, label = segs[j]
            ov = min(e, ge) - max(s, gs)
            if ov > 0:
                tot[label] = tot.get(label, 0.0) + ov * 1e-9
            j += 1
    return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])
