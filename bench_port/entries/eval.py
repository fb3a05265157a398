"""Entry `eval`: the window drives the port's `evaluate_dataset` (metrics
path) over a `TestPipeline` fed with seeded raw 480p frames held in host
memory: the pipeline's threads, the `DeviceFeeder`'s pinned copies and
resize on the card, the central crop, PWC-Net through the cost-volume and
warp kernels, the working resize and standardisation, the generator, and
the per-batch IoU and MAE the loop copies to the host. Only the JPEG
decode is left out.

Spans: `feed` around each request to the pipeline's iterator, and the
host time from one request to the next (`batch_s`). A sample of the
batches that the window runs, drawn from the seed as they come (a
reservoir of `check_batches`), keeps what the timed path produced (the
working flow, the mask, the loop's IoU and MAE); after the window the
plain reference recomputes each from the raw frames.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_port.lib import bounds, common, frames, stats, trace, weights
from bench_port.reference import model as ref
from bench_port.reference.quant import BELOW

RAW_KEYS = ("img1_raw", "img2_raw", "gt_raw")


class Runner:
    def __init__(self, cell, seed: int, device: str, traced: bool, log):
        self.cell, self.seed, self.device, self.traced_run, self.log = cell, seed, device, traced, log
        self.cfg, self.spec, self.traffic = cell.config, cell.spec, cell.spec["traffic"]
        self.dtype = cell.spec["compute_dtype"]
        self.batch = self.cfg["batch_size"]
        self.seed_weights, self.seed_frames, self.seed_sample = common.seeds(seed, 3)
        self.capturing, self.cur, self.captured = False, None, []
        self.sampler = np.random.RandomState(self.seed_sample)
        self.feed_s: list = []
        self.batch_s: list = []
        self.flops = None
        self.ref_nets: dict = {}

    # --- set-up --------------------------------------------------------------------
    def setup(self) -> None:
        from unsupervised_detection_tpu_torch.data import SequenceDataset, TestPipeline
        from unsupervised_detection_tpu_torch.eval import Evaluator, evaluate_dataset

        t, log = self.traffic, self.log
        self.config = common.program_config(self.cell, self.seed_frames,
                                            num_threads=t["pipeline_threads"])
        with common.phase(log, "weights on the device"):
            self.weights = weights.make(self.cfg, self.seed_weights, self.device,
                                        which=("generator", "pwc"))
        with common.phase(log, "the program's Evaluator and its nets"):
            self.evaluator = Evaluator(self.config, self.device)
            self.evaluator.load_state_dicts(self.weights["generator"], self.weights["pwc"])
        self._hook()
        with common.phase(log, "raw frames in host memory"):
            rs = np.random.RandomState(self.seed_frames)
            self.arrays, cats, names = frames.eval_frames(
                rs, t["categories"], t["frames_per_category"], t["stored_frames"],
                t["raw_hw"], t["square"])
        ds = SequenceDataset("DAVIS2016", cats, names, [[n + ".mask" for n in s] for s in names])
        pipeline = TestPipeline(
            ds, self.batch, self.config.test_temporal_shift,
            reader_hw=(self.config.reader_height, self.config.reader_width),
            raw_hw=tuple(t["raw_hw"]), num_threads=self.config.num_threads,
            read_rgb=self.arrays.__getitem__, read_gray=self.arrays.__getitem__)
        self.it = iter(pipeline)
        self.evaluate = evaluate_dataset

        def warm():
            self._run(n=t["warm_batches"])

        if self.traced_run:
            with common.phase(log, "warm-up, FLOPs counted"):
                counted = common.count_flops(warm) / t["warm_batches"]
            self.flops = counted + self._kernel_flops()
            self.log(f"flops: {counted:.6e} counted per batch of {self.batch} "
                     f"({counted / self.batch:.6e} per frame) + {self._kernel_flops():.6e} "
                     f"the kernels' formula per batch; XLA's count of the JAX program "
                     f"{common.XLA_GFLOP_PER_FRAME} GFLOP/frame, for reference")
        else:
            with common.phase(log, "warm-up"):
                warm()

    def _hook(self) -> None:
        """Keep, for the sampled batches, what the timed path produced."""
        obj, ev = self.evaluator.objective, self.evaluator
        resize, mask_fn, metrics_fn = obj.resize_to_working, obj.generate_mask, ev.infer_metrics

        def resize_to_working(img1, flow):
            image, flow = resize(img1, flow)
            if self.capturing:
                self.cur["flow"] = flow.clone()
            return image, flow

        def generate_mask(image, flow):
            mask = mask_fn(image, flow)
            if self.capturing:
                self.cur["mask"] = mask.clone()
            return mask

        def infer_metrics(*args):
            out = metrics_fn(*args)
            if self.capturing:
                self.cur["iou"], self.cur["mae"] = out["iou"].clone(), out["mae"].clone()
            return out

        obj.resize_to_working, obj.generate_mask = resize_to_working, generate_mask
        ev.infer_metrics = infer_metrics

    def _kernel_flops(self) -> float:
        c = self.cfg
        work = bounds.pwc_forward_work(self.batch, c["reader_height"], c["reader_width"],
                                       c["pwc_pyr_lvls"], c["pwc_flow_pred_lvl"],
                                       c["pwc_search_range"], self.dtype)
        return sum(w[2] for w in work.values())

    def _slot(self, count: int):
        """Where the window's batch `count` (from 0) goes in the sample: a
        reservoir, so that each batch the window runs is kept with the same
        chance whatever their number; None where it is not kept."""
        keep = self.traffic["check_batches"]
        if count < keep:
            return count
        j = int(self.sampler.randint(count + 1))
        return j if j < keep else None

    def _batches(self, n=None, deadline=None, sample=False):
        """Batches from the one pipeline pass, n of them or until
        `deadline`; records the wait for each and the time from one request
        to the next."""
        t_ask = time.perf_counter()
        count = 0
        while True:
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.feed"):
                batch = next(self.it, None)
            if batch is None:
                raise RuntimeError("the pipeline ran out before the window closed; "
                                   "give the traffic more frames")
            self.feed_s.append(time.perf_counter() - t0)
            slot = self._slot(count) if sample else None
            self.capturing = slot is not None
            if self.capturing:
                self.cur = {k: batch[k] for k in RAW_KEYS}
            yield batch
            now = time.perf_counter()
            self.batch_s.append(now - t_ask)
            t_ask = now
            if self.capturing:
                if slot == len(self.captured):
                    self.captured.append(self.cur)
                else:
                    self.captured[slot] = self.cur
            self.capturing = False
            count += 1
            if (n is not None and count >= n) or (deadline is not None and now >= deadline):
                return

    def _run(self, **kw) -> dict:
        self.feed_s, self.batch_s = [], []
        with torch.profiler.record_function("bench.evaluate_dataset"):
            return self.evaluate(self.config, self.evaluator, verbose=False,
                                 batches=self._batches(**kw))

    # --- the window ----------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        before = common.launches()
        results = self._run(deadline=time.perf_counter() + seconds, sample=True)
        after = common.launches()
        batches = len(self.batch_s)
        frames = batches * self.batch
        self.window_launches = (after[0] - before[0], after[1] - before[1], batches)
        self.window_feed_s = list(self.feed_s)
        quarter = max(1, batches // 4)
        parts = [self.batch_s[i:i + quarter] for i in range(0, quarter * 4, quarter)]
        self.log("window: frames/s by quarter " + " ".join(
            f"{self.batch * len(p) / sum(p):.2f}" for p in parts if p)
            + f"; batch ms median {1e3 * sorted(self.batch_s)[batches // 2]:.3f}, "
            f"p95 {1e3 * stats.percentile(self.batch_s, 95):.3f}, "
            f"feed wait ms mean {1e3 * sum(self.feed_s) / batches:.3f}")
        return {"metrics": {"frames_per_s": frames / sum(self.batch_s)},
                "attempted": frames, "failed": frames - results["frames"]}

    def traced(self) -> trace.Window:
        from torch.profiler import ProfilerActivity, profile

        n = self.traffic["trace_batches"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("bench.window"):
                self._run(n=n)
                torch.cuda.synchronize()
        return trace.from_profiler(prof, "bench.window", n)

    def layer_context(self, window: trace.Window) -> dict:
        c = self.cfg
        work = bounds.pwc_forward_work(self.batch, c["reader_height"], c["reader_width"],
                                       c["pwc_pyr_lvls"], c["pwc_flow_pred_lvl"],
                                       c["pwc_search_range"], self.dtype)
        return {"window": window, "dtype": self.dtype, "flops_per_step": self.flops,
                "least_s_per_step": {"cost_volume": work["cost_volume"][3]},
                "spans_s": {"feed": self.window_feed_s}}

    # --- the check -----------------------------------------------------------------
    def release(self) -> None:
        self.it.close()
        del self.evaluator, self.it
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def reference_outputs(self, cap: dict, quant=None, half: bool = False) -> dict:
        """The reference's (flow, gt, mask, IoU, MAE) of a sampled
        batch from its raw frames; with `quant` every convolution rounds its
        operands to that precision; with `half` only the first half of the
        batch is computed."""
        n = self.ref_nets.get(quant)
        if n is None:
            n = self.ref_nets[quant] = ref.nets(self.cfg, self.device, quant)
            n["generator"].load_state_dict(self.weights["generator"])
            n["pwc"].load_state_dict(self.weights["pwc"])
        rows = self.batch // 2 if half else self.batch
        raw = [torch.from_numpy(np.ascontiguousarray(cap[k][:rows])).to(self.device)
               for k in RAW_KEYS]
        with torch.no_grad(), common.float32_scope():
            _, flow, gt, mask = ref.eval_forward(self.cfg, n, *raw)
            iou, mae = ref.iou_mae(mask, gt)
        return {"flow": flow, "gt": gt, "mask": mask, "iou": iou, "mae": mae}

    def compare(self, got: list, want: list) -> dict:
        """The numbers, over the sampled batches: the rows that came back;
        the working flow (the feeder, the crop, PWC-Net and its kernels, the
        working resize) against the reference's, its largest gap over its
        largest value; the mask (the standardisation and the generator)
        against the reference's, its largest gap and its mean gap; the mean
        gaps over the reference's mean |flow| (`flow_mean_err`) and over the
        mean slope m(1 - m) of the reference's mask (`mask_slope_err`: the
        softmax's saturation, which swings with the weights, hides a logit
        gap from the plain mean gap but not from this one); and the loop's
        IoU and MAE against the reference's metrics, in float64, of the
        program's own masks (an exact comparison of the metric stage). Each
        is the largest over the sampled batches; the cell's limits say
        which of them it compares. A sampled batch that never came back
        counts all its rows as missing."""
        out = {"rows_missing": 0.0, "flow_err": 0.0, "flow_mean_err": 0.0, "mask_err": 0.0,
               "mask_mean_err": 0.0, "mask_slope_err": 0.0, "iou_err": 0.0, "mae_err": 0.0}
        short = max(0, self.traffic["check_batches"] - len(got))
        out["rows_missing"] = float(short * self.batch)
        for g, w in zip(got, want):
            rows = min(len(g[k]) for k in ("flow", "mask", "iou", "mae"))
            out["rows_missing"] += float(self.batch - rows)
            if rows == 0:
                continue
            out["flow_err"] = max(out["flow_err"], common.rel_max(g["flow"][:rows], w["flow"][:rows]))
            out["mask_err"] = max(out["mask_err"], common.abs_max(g["mask"][:rows], w["mask"][:rows]))
            out["flow_mean_err"] = max(out["flow_mean_err"],
                                       common.rel_mean(g["flow"][:rows], w["flow"][:rows]))
            mask_gap = common.abs_mean(g["mask"][:rows], w["mask"][:rows])
            out["mask_mean_err"] = max(out["mask_mean_err"], mask_gap)
            slope = float((w["mask"][:rows].double() * (1.0 - w["mask"][:rows].double())).mean())
            out["mask_slope_err"] = max(out["mask_slope_err"], mask_gap / max(slope, 1e-30))
            iou, mae = ref.iou_mae(g["mask"][:rows], w["gt"][:rows])
            out["iou_err"] = max(out["iou_err"], common.abs_max(g["iou"][:rows], iou))
            out["mae_err"] = max(out["mae_err"], common.abs_max(g["mae"][:rows], mae))
        return out

    def check(self) -> dict:
        want = [self.reference_outputs(cap) for cap in self.captured]
        numbers = self.compare(self.captured, want)
        # the kernels' path on the card: one cost volume per level, one warp per
        # level below the top; none on the CPU, where the plain versions run
        cv, wp, batches = self.window_launches
        n = batches if self.device.startswith("cuda") else 0
        levels = self.cfg["pwc_pyr_lvls"] - self.cfg["pwc_flow_pred_lvl"] + 1
        numbers["launch_gap"] = float(abs(cv - levels * n) + abs(wp - (levels - 1) * n))
        return numbers

    def control(self, variant: str) -> dict:
        """The numbers when the reference in the precision below the cell's
        (`variant` "control") or on half of each batch ("half_batch") stands
        in the program's place, over the batches the window would sample."""
        caps = [{k: b[k] for k in RAW_KEYS} for b in
                (next(self.it) for _ in range(self.traffic["check_batches"]))]
        self.it.close()
        del self.evaluator
        quant = BELOW[self.dtype] if variant == "control" else None
        got = [self.reference_outputs(c, quant, half=variant == "half_batch") for c in caps]
        return self.compare(got, [self.reference_outputs(c) for c in caps])
