"""Reduction of a profiler window to the device's busy time, the time of
each kernel, and the longest idle gaps by what the host was doing.

The profiler's events are read in memory (`torch.profiler.profile.events()`);
no trace file is written. Intervals are (start, end) pairs in microseconds
on the profiler's clock. Busy time is the union of the intervals of every
operation on the card (kernels, copies, sets), not their sum: two
operations on two streams that overlap count once.
"""

from __future__ import annotations

import dataclasses
import heapq

HARNESS_PREFIX = "bench."     # the harness's own `record_function` spans


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted, disjoint intervals."""
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """Each interval cut to [lo, hi]; those outside are dropped."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def covered(intervals) -> float:
    """Total length of the union of the intervals."""
    return sum(b - a for a, b in union(intervals))


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no busy interval covers."""
    out, t = [], lo
    for a, b in union(clip(busy, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


@dataclasses.dataclass
class HostEvent:
    name: str
    start: float
    end: float


def _label(holding: list[HostEvent]) -> str:
    """The innermost harness span and the outermost other operation among
    the host events that hold one instant, joined by '/'."""
    spans = [e for e in holding if e.name.startswith(HARNESS_PREFIX)]
    ops = [e for e in holding if not e.name.startswith(HARNESS_PREFIX)]
    span = min(spans, key=lambda e: e.end - e.start).name if spans else "outside"
    op = max(ops, key=lambda e: e.end - e.start).name if ops else "python"
    return f"{span}/{op}"


def host_labels(host: list[HostEvent], times: list[float]) -> list[str]:
    """What the host was doing at each of `times` (`_label`), in one sweep
    over the events sorted by start."""
    events = sorted(host, key=lambda e: e.start)
    order = sorted(range(len(times)), key=times.__getitem__)
    labels = [""] * len(times)
    active: list[tuple[float, int]] = []     # heap of (end, index into events)
    i = 0
    for k in order:
        t = times[k]
        while i < len(events) and events[i].start <= t:
            heapq.heappush(active, (events[i].end, i))
            i += 1
        while active and active[0][0] <= t:
            heapq.heappop(active)
        labels[k] = _label([events[j] for _, j in active])
    return labels


@dataclasses.dataclass
class Window:
    """One traced window: its bounds, the card's operations and the host's."""
    start: float
    end: float
    device: list[tuple[str, float, float]]   # (name, start, end) on the card
    host: list[HostEvent]
    steps: int                               # units of work the window holds

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_s(self) -> float:
        return covered(clip([(a, b) for _, a, b in self.device], self.start, self.end)) * 1e-6

    def kernel_s(self, symbol: str) -> float:
        """Seconds the card spent in operations whose name holds `symbol`,
        inside the window."""
        spans = [(a, b) for name, a, b in self.device if symbol in name]
        return covered(clip(spans, self.start, self.end)) * 1e-6

    def top_ops(self, n: int = 10) -> list[list]:
        """The n device operations (by name) that took most time."""
        total: dict[str, float] = {}
        for name, a, b in self.device:
            for lo, hi in clip([(a, b)], self.start, self.end):
                total[name] = total.get(name, 0.0) + (hi - lo) * 1e-6
        return [[name[:120], s] for name, s in sorted(total.items(), key=lambda x: -x[1])[:n]]

    def idle_by_host(self, n: int = 10) -> list[list]:
        """The card's idle time, summed by what the host was doing at the
        middle of each gap; the n largest."""
        idle = gaps([(x, y) for _, x, y in self.device], self.start, self.end)
        labels = host_labels(self.host, [0.5 * (a + b) for a, b in idle])
        total: dict[str, float] = {}
        for (a, b), label in zip(idle, labels):
            total[label] = total.get(label, 0.0) + (b - a) * 1e-6
        return [[name[:120], s] for name, s in sorted(total.items(), key=lambda x: -x[1])[:n]]


def from_profiler(prof, window_span: str, steps: int) -> Window:
    """The `Window` of a finished `torch.profiler.profile`, bounded by the
    host span named `window_span` that the harness recorded around it."""
    from torch.autograd import DeviceType

    device, host, bounds = [], [], None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a host span's shadow on the card's timeline is no operation
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(HARNESS_PREFIX)):
                device.append((e.name, start, end))
        elif e.name == window_span:
            bounds = (start, end)
        else:
            host.append(HostEvent(e.name, start, end))
    if bounds is None:
        raise RuntimeError(f"the profiler recorded no span {window_span!r}")
    if not device:
        raise RuntimeError("the profiler recorded no operation on the card")
    return Window(bounds[0], bounds[1], device, host, steps)
