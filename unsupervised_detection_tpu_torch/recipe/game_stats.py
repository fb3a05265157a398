"""Summarise a game log, counterpart of the JAX repo's
tools/exp_game_stats.py:

    python -m unsupervised_detection_tpu_torch.recipe.game_stats <log> [lock_iou=0.4] [cover=0.12]

It reads the 25-cycle validation lines of `recipe.game`, `recipe.synth`
or the JAX tools (a trailing elapsed "(Ns)" is ignored) and prints, as the
tool does line for line: the number of validations, the best IoU and its
cycle, the mean of the last 8; the lock lever's "LOCK detected" line if
the log has one; then either "no lock" or the transition (the first
validation with IoU > lock_iou and cover < cover), the locked window (up
to the first later validation with cover > 0.5 or < 0.005), the
destabilisation and any re-lock.

The lock test is the tool's, on the mask's cover alone: it sees neither a
lock onto the square's complement (cover near 1) nor one onto a square
larger than `cover` of the frame. numpy only; it touches no tensor.
"""

from __future__ import annotations

import re
import sys

import numpy as np

VAL_LINE = re.compile(r"cycle\s+(\d+)\s+IoU (\d+\.\d+)\s+mask-cover (\d+\.\d+)")


def parse_lines(lines):
    """([(cycle, IoU, cover)], the last "LOCK detected" line or None)."""
    rows = []
    lock_event = None
    for line in lines:
        m = VAL_LINE.search(line)
        if m:
            rows.append((int(m.group(1)), float(m.group(2)), float(m.group(3))))
        if "LOCK detected" in line:
            lock_event = line.strip()
    return rows, lock_event


def parse(path: str):
    """`parse_lines` of a log file."""
    with open(path) as fh:
        return parse_lines(fh)


def summarize(rows, lock_event=None, lock_iou: float = 0.4, lock_cover: float = 0.12) -> list:
    """The tool's printed lines for `parse`'s output."""
    cycles = np.array([r[0] for r in rows])
    ious = np.array([r[1] for r in rows])
    covers = np.array([r[2] for r in rows])
    locked = (ious > lock_iou) & (covers < lock_cover)
    out = [f"vals: {len(rows)} (cycles {cycles[0]}..{cycles[-1]}); "
           f"best IoU {ious.max():.3f} at cycle {cycles[ious.argmax()]}; "
           f"last-8 mean {ious[-8:].mean():.3f}"]
    if lock_event:
        out.append(lock_event)
    if not locked.any():
        out.append(f"no lock (no val with IoU > {lock_iou} and cover < {lock_cover})")
        return out
    t0 = locked.argmax()
    out.append(f"transition: cycle {cycles[t0]} (IoU {ious[t0]:.3f}, cover {covers[t0]:.2f})")
    # destabilisation: the first later validation with the cover far outside
    # the locked band (collapse to empty or full); IoU dips alone do not count
    destab = next((i for i in range(t0 + 1, len(rows))
                   if covers[i] > 0.5 or covers[i] < 0.005), None)
    end = destab if destab is not None else len(rows)
    w = slice(t0, end)
    frac = float((ious[w] > 0.5).mean())
    out.append(f"locked window: cycles {cycles[t0]}..{cycles[end - 1]} "
               f"({end - t0} vals) — IoU mean {ious[w].mean():.3f} / max "
               f"{ious[w].max():.3f}, {100 * frac:.0f}% of vals > 0.5, "
               f"cover mean {covers[w].mean():.3f}")
    if destab is None:
        out.append("destabilization: NONE — lock held to the end of the run")
        return out
    out.append(f"destabilization: cycle {cycles[destab]} (cover "
               f"{covers[destab]:.2f}); post-destab IoU mean "
               f"{ious[destab:].mean():.3f} max {ious[destab:].max():.3f}")
    relock = [i for i in range(destab, len(rows)) if locked[i]]
    if relock:
        out.append(f"re-lock: cycle {cycles[relock[0]]} "
                   f"({len(relock)} locked vals after destabilization)")
    else:
        out.append("re-lock: none")
    return out


def main(argv=None, log=None) -> list:
    """The tool's command line: `<log> [lock_iou] [cover]`; prints the
    summary through `log` and returns its lines."""
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0]
    lock_iou = float(argv[1]) if len(argv) > 1 else 0.4
    lock_cover = float(argv[2]) if len(argv) > 2 else 0.12
    rows, lock_event = parse(path)
    if not rows:
        raise SystemExit("no val lines found in " + path)
    lines = summarize(rows, lock_event, lock_iou, lock_cover)
    for line in lines:
        (log or print)(line)
    return lines


if __name__ == "__main__":
    main()
