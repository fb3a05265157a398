"""What the program's own spans say in a traced window.

The port marks pieces of host work at its layer boundaries with
`torch.profiler.record_function` ranges named `ud.*`
(unsupervised_detection_tpu_torch/utils/profiling.py::span). They are host
events of the `trace.Window` on the clock of the card's operations, so a
reader can take, over the window, the host's time inside them, the card's
idle time that falls inside them, and the kernel launches made from them.
A name in a group matches itself, or every span it prefixes where it ends
with a dot. Each function returns None where the window holds no such
span: a program without the spans reports nothing, not 0.
"""

from __future__ import annotations

import bisect

from . import trace

# the spans that the per-layer metrics read, by group
FEEDER = ("ud.data.device_batch",)                 # Evaluator.device_batch
DISPATCH = ("ud.model.", "ud.eval.metrics")        # the nets, crop, resize, metrics
RESULT_COPY = ("ud.eval.result_copy",)             # IoU and MAE to the host
ADAM = ("ud.train.adam",)                          # adam_apply, OptaxAdam.step
NOISE_TEST = ("ud.train.noise_test",)              # the generator's host sync
SCENE = ("ud.pretrain.scene",)                     # synthetic_flow_batch
# the host's records of a kernel launch, by the name's start
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")


def matches(name: str, names) -> bool:
    return any(name == n or (n.endswith(".") and name.startswith(n)) for n in names)


def intervals(window: trace.Window, names) -> list[tuple[float, float]]:
    """The union of the named spans' intervals, cut to the window."""
    spans = [(e.start, e.end) for e in window.host if matches(e.name, names)]
    return trace.union(trace.clip(spans, window.start, window.end))


def overlap(a, b) -> float:
    """Total length shared by two lists of sorted, disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_ms(window: trace.Window, names):
    """Milliseconds a step that the host spent inside the named spans."""
    spans = intervals(window, names)
    if not spans or window.steps <= 0:
        return None
    return sum(b - a for a, b in spans) * 1e-3 / window.steps


def idle_share(window: trace.Window, names):
    """The share of the window (%) in which the card was idle while the host
    was inside the named spans: each idle gap's overlap with them, so a gap
    that crosses a span's edge counts only inside it, and once."""
    spans = intervals(window, names)
    if not spans or window.window_s <= 0:
        return None
    idle = trace.gaps([(a, b) for _, a, b in window.device], window.start, window.end)
    return 100.0 * overlap(idle, spans) * 1e-6 / window.window_s


def launches(window: trace.Window, names):
    """Kernel launches a step recorded on the host inside the named spans
    (by the start of each runtime launch record); None where the window
    holds no span or no launch record at all."""
    spans = intervals(window, names)
    starts = sorted(e.start for e in window.host if e.name.startswith(LAUNCH_PREFIXES))
    if not spans or not starts or window.steps <= 0:
        return None
    count = sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a) for a, b in spans)
    return count / window.steps
