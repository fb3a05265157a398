#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`unsupervised_detection_tpu_torch`).

    python3 chip_smoke.py          # needs one CUDA card; takes no arguments

Phases, in order, each printed with its wall seconds:

* card    -- the card's name and power limit from nvidia-smi;
* build   -- the CUDA kernels of csrc/ built by one nvcc call (seconds, and
             ptxas' registers / shared memory per kernel);
* kernels -- each kernel against its plain PyTorch version on the card at the
             five PWC level shapes of a 384x640 frame (cost volume at r=4 and
             r=2, warp at L5..L2 with flows that drive taps past every clamp),
             in float32 and bfloat16, with the stated tolerance; then each
             kernel's time at batch 8 (CUDA events) beside its bound, its
             plain version's time and a yardstick PyTorch call where one
             exists;
* path    -- the flagship forward (`benchlib.build_forward`) and
             `Evaluator.infer_metrics` at full width (reader 384x640, working
             192x384, PWC 6 levels r=4, generator cnum 32) with seeded random
             weights, batch 8, float32 (TF32 off) and bfloat16: launch counts
             per forward (5 cost volume, 4 warp), the float32 card mask
             against the same forward on the CPU for one frame pair, and
             frames/s from CUDA events;
* profile -- device time by kernel over three of the path's forwards in
             each dtype (torch.profiler), and the device's busy share.

Any failed check raises, and the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available. The line
before the last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from unsupervised_detection_tpu_torch import Config
from unsupervised_detection_tpu_torch.benchlib import build_forward, random_images, time_cuda
from unsupervised_detection_tpu_torch.eval import Evaluator
from unsupervised_detection_tpu_torch.ops import _build
from unsupervised_detection_tpu_torch.ops.cost_volume import cost_volume, cost_volume_plain
from unsupervised_detection_tpu_torch.ops.warp import dense_image_warp, warp_plain

PHASES = ("card", "build", "kernels", "path", "profile")
BATCH = 8
# PWC pyramid level -> (H, W, C) at the 384x640 reader resolution
LEVELS = {6: (6, 10, 196), 5: (12, 20, 128), 4: (24, 40, 96), 3: (48, 80, 64), 2: (96, 160, 32)}
# H100 SXM peaks (NVIDIA data sheet, dense): memory 3.35 TB/s; float32 outside
# the tensor cores 67 TFLOP/s; bfloat16 989 TFLOP/s.
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
DTYPES = (torch.float32, torch.bfloat16)
# Tolerances, kernel vs plain version on the same card and inputs:
# * float32: both sum in float32 in other orders -> 1e-5 absolute on costs
#   of magnitude ~0.1; the warp repeats the plain arithmetic op for op and
#   is expected bit-equal (reported), held to 1e-6 relative.
# * bfloat16: both compute in float32 from the same bfloat16 inputs and round
#   once (cost volume) or per op (warp) -> at most one bfloat16 ulp of the
#   largest output, 2**-7 relative.
COST_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
WARP_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7}
# Full forward, float32 card (TF32 off) vs CPU: conv sums in other orders;
# the mask is a softmax probability in [0, 1].
MASK_TOL = 1e-3
METRIC_TOL = 1e-3
KERNEL_SOURCES = {
    "cost_volume": ("unsupervised_detection_tpu_torch/csrc/cost_volume.cu",
                    "unsupervised_detection_tpu/ops/pallas/cost_volume_kernel.py:57"),
    "warp": ("unsupervised_detection_tpu_torch/csrc/warp.cu",
             "unsupervised_detection_tpu/ops/pallas/warp_kernel.py:219"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """Least time for the work: the larger of bytes over the memory rate and
    operations over the dtype's peak; and which of the two it is."""
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cost_bound(b, h, w, c, r, dtype):
    k = (2 * r + 1) ** 2
    item = torch.empty((), dtype=dtype).element_size()
    return bound_ms((2 * b * h * w * c + b * h * w * k) * item, 2.0 * b * h * w * c * k, dtype)


def warp_bound(b, h, w, c, dtype):
    # 3 lerps of 3 operations per output element, ~10 per pixel for coordinates
    item = torch.empty((), dtype=dtype).element_size()
    return bound_ms(2 * b * h * w * c * item + b * h * w * 2 * item,
                    9.0 * b * h * w * c + 10.0 * b * h * w, dtype)


def clamp_flow(gen, b, h, w, dtype):
    """Flow whose sources span [-H, 2H) x [-W, 2W): taps fall inside, past
    every edge (floor and weight clamps) and at fractional positions."""
    scale = torch.tensor([h, w], dtype=torch.float32, device="cuda")
    u = torch.rand((b, h, w, 2), generator=gen, device="cuda") * 2.0 - 1.0
    return (u * scale).to(dtype)


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def check(name: str, got: torch.Tensor, want: torch.Tensor, limit: float) -> float:
    """Hold a kernel's output against its plain version; returns max abs err."""
    abs_err, rel_err = errors(got, want)
    ok = bool(torch.isfinite(got.float()).all()) and abs_err <= limit
    log("kernels: " + json.dumps({
        "check": name, "max_abs_err": abs_err, "max_rel_err": rel_err, "tol_abs": limit,
        "bit_equal": bool(torch.equal(got, want)), "ok": ok}))
    if not ok:
        raise AssertionError(f"{name}: max abs err {abs_err} > {limit}")
    return abs_err


def tolerance(kind: str, dtype, want: torch.Tensor) -> float:
    """Absolute limit for `kind` in `dtype` (see COST_TOL / WARP_TOL)."""
    top = want.float().abs().max().item()
    if kind == "cost_volume" and dtype == torch.float32:
        return COST_TOL[dtype]
    return (COST_TOL if kind == "cost_volume" else WARP_TOL)[dtype] * top


def phase_kernels(report: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cv_err = wp_err = 0.0
    for dtype in DTYPES:
        dn = str(dtype).replace("torch.", "")
        for lvl, (h, w, c) in LEVELS.items():
            c1 = torch.randn((BATCH, h, w, c), generator=gen, device="cuda").to(dtype)
            wp = torch.randn((BATCH, h, w, c), generator=gen, device="cuda").to(dtype)
            for r in (4, 2):
                want = cost_volume_plain(c1, wp, r)
                cv_err = max(cv_err, check(
                    f"cost_volume L{lvl} r={r} {dn} {(BATCH, h, w, c)}",
                    cost_volume(c1, wp, r), want, tolerance("cost_volume", dtype, want)))
            if lvl == 6:
                continue
            flow = clamp_flow(gen, BATCH, h, w, dtype)
            want = warp_plain(c1, flow)
            wp_err = max(wp_err, check(f"warp L{lvl} {dn} {(BATCH, h, w, c)}",
                                       dense_image_warp(c1, flow), want,
                                       tolerance("warp", dtype, want)))
    torch.cuda.synchronize()

    # time at batch 8, per level and summed over one forward (r=4)
    totals = {}
    for dtype in DTYPES:
        dn = str(dtype).replace("torch.", "")
        # per kernel: [ms, plain_ms, bound_ms, library_ms, bound_ms by bytes, by operations]
        t = {k: [0.0] * 6 for k in ("cost_volume", "warp")}
        for lvl, (h, w, c) in LEVELS.items():
            c1 = torch.randn((BATCH, h, w, c), generator=gen, device="cuda").to(dtype)
            wp = torch.randn((BATCH, h, w, c), generator=gen, device="cuda").to(dtype)
            ms = time_cuda(cost_volume, c1, wp, 4, iters=20, repeats=5)
            plain = time_cuda(cost_volume_plain, c1, wp, 4, iters=3, warmup=1, repeats=1)
            bnd, by = cost_bound(BATCH, h, w, c, 4, dtype)
            log("kernels: " + json.dumps({"time": f"cost_volume L{lvl} r=4 {dn} batch {BATCH}",
                                          "ms": ms, "plain_ms": plain, "bound_ms": bnd,
                                          "bound_by": by}))
            for i, v in enumerate((ms, plain, bnd)):
                t["cost_volume"][i] += v
            t["cost_volume"][4 if by == "bytes" else 5] += bnd
            if lvl == 6:
                continue
            flow = (torch.randn((BATCH, h, w, 2), generator=gen, device="cuda") * 2.0).to(dtype)
            ms = time_cuda(dense_image_warp, c1, flow, iters=20, repeats=5)
            plain = time_cuda(warp_plain, c1, flow, iters=3, warmup=1, repeats=1)
            bnd, by = warp_bound(BATCH, h, w, c, dtype)
            # yardstick: one grid_sample on the same image and an equivalent grid
            img = c1.permute(0, 3, 1, 2)
            ys = torch.arange(h, device="cuda", dtype=torch.float32).view(1, h, 1)
            xs = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, w)
            f = flow.float()
            grid = torch.stack([(xs - f[..., 1]) * (2.0 / (w - 1)) - 1.0,
                                (ys - f[..., 0]) * (2.0 / (h - 1)) - 1.0], dim=-1).to(dtype)
            lib = time_cuda(F.grid_sample, img, grid, "bilinear", "border", True, iters=20,
                            repeats=5)
            # same function up to rounding (border padding = the TF clamps); reported
            lib_err = (F.grid_sample(img, grid, "bilinear", "border", True).permute(0, 2, 3, 1)
                       .float() - warp_plain(c1, flow).float()).abs().max().item()
            log("kernels: " + json.dumps({"time": f"warp L{lvl} {dn} batch {BATCH}", "ms": ms,
                                          "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                                          "library_ms": lib, "library_max_abs_diff": lib_err}))
            for i, v in enumerate((ms, plain, bnd, lib)):
                t["warp"][i] += v
            t["warp"][4 if by == "bytes" else 5] += bnd
        totals[dn] = t
        log("kernels: " + json.dumps({"per_forward": dn, "batch": BATCH, **t}))
    # the JSON line: float32, summed over one forward's launches at batch 8
    for name, err, has_lib in (("cost_volume", cv_err, False), ("warp", wp_err, True)):
        ms, plain, bnd, lib, by_bytes, by_ops = totals["float32"][name]
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
                        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                        "library_ms": lib if has_lib else None}


def reset_counts() -> None:
    cost_volume.launches = 0
    dense_image_warp.launches = 0


def expect_counts(what: str, forwards: int = 1) -> tuple[int, int]:
    counts = (cost_volume.launches, dense_image_warp.launches)
    log(f"path: {what}: launches cost_volume={counts[0]} warp={counts[1]}")
    if counts != (5 * forwards, 4 * forwards):
        raise AssertionError(f"{what}: expected {5 * forwards} cost-volume and "
                             f"{4 * forwards} warp launches, got {counts}")
    return counts


def check_mask(what: str, mask: torch.Tensor, cfg: Config) -> None:
    shape = (cfg.batch_size, cfg.img_height, cfg.img_width, 1)
    if tuple(mask.shape) != shape:
        raise AssertionError(f"{what}: mask shape {tuple(mask.shape)} != {shape}")
    if not bool(torch.isfinite(mask).all()) or mask.min() < 0 or mask.max() > 1:
        raise AssertionError(f"{what}: mask not finite in [0, 1]")


def forward_with_sharp_head(cfg: Config, device: str):
    """build_forward with its seeded random weights, and the generator's last
    conv scaled by 100 so the mask spans [0, 1] instead of staying near 0.5:
    the thresholded metrics then see both classes."""
    fwd, obj = build_forward(cfg, device=device, seed=0)
    with torch.no_grad():
        obj.generator.conv17.weight.mul_(100.0)
    return fwd, obj


def phase_path(report: dict):
    """Returns the float32 and bfloat16 forwards and their input frames."""
    cfg = Config(batch_size=BATCH, reader_height=384, reader_width=640, img_height=192,
                 img_width=384, pwc_pyr_lvls=6, pwc_search_range=4)
    img1, img2 = random_images(cfg, seed=1, device="cuda")
    gt = torch.zeros((BATCH, cfg.reader_height, cfg.reader_width, 1), device="cuda")
    gt[:, 120:260, 200:440] = 1.0

    # the main path: Evaluator.infer_metrics, float32, counts from 0
    fwd32, obj = forward_with_sharp_head(cfg, "cuda")
    states = (obj.generator.state_dict(), obj.pwc.state_dict())
    ev = Evaluator(cfg, device="cuda")
    ev.load_state_dicts(*states)
    reset_counts()
    metrics = ev.infer_metrics(img1, img2, gt)
    torch.cuda.synchronize()
    report["launches"] = dict(zip(("cost_volume", "warp"), expect_counts("infer_metrics float32")))
    for k, v in metrics.items():
        if tuple(v.shape) != (BATCH,) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"infer_metrics {k}: {v}")
    log(f"path: infer_metrics float32 iou={metrics['iou'].tolist()} mae={metrics['mae'].tolist()}")

    reset_counts()
    mask32 = fwd32(img1, img2)
    torch.cuda.synchronize()
    expect_counts("forward float32")
    check_mask("forward float32", mask32, cfg)

    # float32 card vs CPU, one frame pair
    cpu_cfg = cfg.replace(batch_size=1)
    fwd_cpu, _ = forward_with_sharp_head(cpu_cfg, "cpu")
    mask_cpu = fwd_cpu(img1[:1].cpu(), img2[:1].cpu())
    err = (mask32[:1].cpu() - mask_cpu).abs().max().item()
    log(f"path: float32 card vs CPU mask max abs err {err} (tol {MASK_TOL})")
    if not err <= MASK_TOL:
        raise AssertionError(f"float32 card mask differs from CPU by {err} > {MASK_TOL}")
    ev_cpu = Evaluator(cpu_cfg, device="cpu")
    ev_cpu.load_state_dicts(*states)
    m_cpu = ev_cpu.infer_metrics(img1[:1].cpu(), img2[:1].cpu(), gt[:1].cpu())
    for k in ("iou", "mae"):
        d = abs(metrics[k][0].item() - m_cpu[k][0].item())
        log(f"path: float32 card vs CPU {k} abs diff {d} (tol {METRIC_TOL})")
        if not d <= METRIC_TOL:
            raise AssertionError(f"{k} card vs CPU differs by {d}")
    report["mask_err_vs_cpu"] = err

    iters, repeats = 3, 3
    timed = iters * repeats + 1     # + one warm-up forward
    reset_counts()
    ms32 = time_cuda(fwd32, img1, img2, iters=iters, warmup=1, repeats=repeats)
    expect_counts("timed forwards float32", forwards=timed)

    bcfg = cfg.replace(compute_dtype="bfloat16")
    fwd16, _ = forward_with_sharp_head(bcfg, "cuda")
    reset_counts()
    mask16 = fwd16(img1, img2)
    torch.cuda.synchronize()
    expect_counts("forward bfloat16")
    check_mask("forward bfloat16", mask16, bcfg)
    log(f"path: bfloat16 vs float32 card mask max abs diff "
        f"{(mask16 - mask32).abs().max().item()} (reported, not held)")
    reset_counts()
    ms16 = time_cuda(fwd16, img1, img2, iters=iters, warmup=1, repeats=repeats)
    expect_counts("timed forwards bfloat16", forwards=timed)
    for dn, ms in (("float32", ms32), ("bfloat16", ms16)):
        log(f"path: forward {dn} batch {BATCH}: {ms:.3f} ms, {BATCH * 1e3 / ms:.2f} frames/s "
            f"(CUDA events, median of {repeats} windows of {iters})")
    report["fps"] = {"float32": BATCH * 1e3 / ms32, "bfloat16": BATCH * 1e3 / ms16}
    return {"float32": fwd32, "bfloat16": fwd16}, (img1, img2)


def phase_profile(forwards: dict, images, iters: int = 3, top: int = 12) -> None:
    """Device time by kernel over `iters` of the path's forwards at batch 8
    (torch.profiler), and the device's busy share of the profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    img1, img2 = images
    for dtype, fwd in forwards.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fwd(img1, img2)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        per_kernel: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:    # kernels and copies on the card
                acc = per_kernel.setdefault(e.name, [0.0, 0])
                acc[0] += e.time_range.elapsed_us()
                acc[1] += 1
        rows = sorted(((us, n, name) for name, (us, n) in per_kernel.items()), reverse=True)
        busy = sum(r[0] for r in rows)
        log(f"profile: {dtype} batch {BATCH}: {iters} forwards, wall {wall_us / 1e3:.3f} ms, "
            f"device busy {busy / 1e3:.3f} ms ({100.0 * busy / wall_us:.1f}% of the window)")
        for us, count, name in rows[:top]:
            log(f"profile: {dtype} {100.0 * us / busy:5.1f}% {us / 1e3 / iters:8.3f} ms/fwd "
                f"{count // iters:4d}/fwd {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    t_run = time.perf_counter()
    report: dict = {}
    for phase in PHASES:
        t0 = time.perf_counter()
        if phase == "card":
            log(f"card: {card_line()}")
        elif phase == "build":
            lib = _build.library()
            log(f"build: nvcc {lib.build_seconds:.2f} s -> {lib.path}")
            for line in lib.log.splitlines():
                if "registers" in line or "Compiling entry" in line:
                    log("build: " + line.strip())
        elif phase == "kernels":
            phase_kernels(report)
        elif phase == "path":
            forwards, images = phase_path(report)
        else:
            phase_profile(forwards, images)
        log(f"phase {phase}: {time.perf_counter() - t0:.2f} s")
    log(f"total: {time.perf_counter() - t_run:.2f} s")

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        k = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": report["launches"][name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
