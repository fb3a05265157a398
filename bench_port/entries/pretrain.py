"""Entry `pretrain`: the window drives the port's `PWCPretrainer.step`
over scenes that the port's `synthetic_flow_batch` makes from the seed, as
`pretrain_pwc` does: the scene (textures, a smooth flow field, one warp),
PWC-Net forward and backward through the cost-volume and warp kernels and
their backward kernels, the multi-scale EPE loss, and optax's Adam.

Set-up builds one trainer and drives it through its first steps on the
first scenes; the window goes on with that same trainer and scene stream.
The plain reference makes the first scenes again from the seed and
follows those steps from the same weights; the check compares the scenes,
each step's loss, the first gradient (worked out from Adam's moment after
one update) and the parameters' change after the steps, leaf by leaf.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_port.lib import bounds, common, trace, weights
from bench_port.reference import model as ref
from bench_port.reference.quant import BELOW


class Runner:
    def __init__(self, cell, seed: int, device: str, traced: bool, log):
        self.cell, self.seed, self.device, self.traced_run, self.log = cell, seed, device, traced, log
        self.cfg, self.spec, self.traffic = cell.config, cell.spec, cell.spec["traffic"]
        self.dtype = cell.spec["compute_dtype"]
        self.batch = self.cfg["batch_size"]
        self.seed_weights, self.seed_scenes, self.seed_init = common.seeds(seed, 3)
        self.flops = None

    # --- set-up --------------------------------------------------------------------
    def setup(self) -> None:
        from unsupervised_detection_tpu_torch.train.pretrain_pwc import (PWCPretrainer,
                                                                         synthetic_flow_batch)

        log = self.log
        config = common.program_config(self.cell, self.seed_init)
        with common.phase(log, "weights on the device"):
            self.weights = weights.make(self.cfg, self.seed_weights, self.device,
                                        which=("pwc",))
        with common.phase(log, "the program's PWCPretrainer, its net and Adam"):
            self.trainer = PWCPretrainer(config, self.traffic["schedule_steps"],
                                         params=self.weights["pwc"], device=self.device)
        self.make_scene = synthetic_flow_batch
        self.rng = np.random.RandomState(self.seed_scenes)
        if self.traced_run:
            steps = self.traffic["first_steps"]
            with common.phase(log, "the first steps, FLOPs counted"):
                counted = common.count_flops(self._first_steps) / steps
            self.flops = counted + self._kernel_flops()
            self.log(f"flops: {counted:.6e} counted per step of {self.batch} samples + "
                     f"{self._kernel_flops():.6e} the kernels' formula per step; XLA's count "
                     f"of the JAX program's forward {common.XLA_GFLOP_PER_FRAME} GFLOP/frame, "
                     f"for reference")
        else:
            with common.phase(log, "the first steps"):
                self._first_steps()

    def _work(self) -> dict:
        c = self.cfg
        args = (self.batch, c["reader_height"], c["reader_width"], c["pwc_pyr_lvls"],
                c["pwc_flow_pred_lvl"], c["pwc_search_range"], self.dtype)
        return {**bounds.pwc_forward_work(*args), **bounds.pwc_backward_work(*args)}

    def _kernel_flops(self) -> float:
        # the scene's own warp at C=3 besides PWC-Net's kernels
        c = self.cfg
        scene = bounds.warp(self.batch, c["reader_height"], c["reader_width"], 3, 4)[1]
        return sum(w[2] for w in self._work().values()) + scene

    def _scene(self):
        c = self.cfg
        with torch.profiler.record_function("bench.scene"):
            return self.make_scene(self.rng, self.batch, c["reader_height"], c["reader_width"],
                                   max_mag=self.traffic["max_mag"], device=self.device)

    def _one(self):
        img1, img2, flow = self._scene()
        with torch.profiler.record_function("bench.step"):
            loss, _, _ = self.trainer.step(img1, img2, flow)
        return (img1, img2, flow), loss

    def _first_steps(self) -> None:
        b1 = self.cfg["beta1"]
        self.first = {"scenes": [], "losses": [], "grad": {}, "delta": {}}
        names = [k for k, _ in self.trainer.net.named_parameters()]
        for i in range(self.traffic["first_steps"]):
            scene, loss = self._one()
            self.first["scenes"].append(scene)
            self.first["losses"].append(float(loss))
            if i == 0:
                self.first["grad"]["pwc"] = common.leaf_norms(
                    {k: m / (1.0 - b1) for k, m in zip(names, self.trainer.opt.m)})
        self.first["delta"]["pwc"] = common.leaf_norms(
            {k: p - self.weights["pwc"][k] for k, p in self.trainer.net.named_parameters()})

    # --- the window ----------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        before = common.launches()
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            self._one()
            n += 1
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.window_launches = [a - b for a, b in zip(common.launches(), before)] + [n]
        samples = n * self.batch
        return {"metrics": {"samples_per_s": samples / wall}, "attempted": samples, "failed": 0}

    def traced(self) -> trace.Window:
        from torch.profiler import ProfilerActivity, profile

        steps = self.traffic["trace_steps"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("bench.window"):
                for _ in range(steps):
                    self._one()
                torch.cuda.synchronize()
        return trace.from_profiler(prof, "bench.window", steps)

    def layer_context(self, window: trace.Window) -> dict:
        work = self._work()
        return {"window": window, "dtype": self.dtype, "flops_per_step": self.flops,
                "least_s_per_step": {k: w[3] for k, w in work.items()}}

    # --- the check -----------------------------------------------------------------
    def release(self) -> None:
        del self.trainer
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def reference_steps(self, quant=None, half: bool = False) -> dict:
        """The reference's first steps: its own scenes from the seed, PWC-Net
        from the same weights, optax's Adam; with `quant` every convolution
        rounds its operands, with `half` each step sees half of its scene."""
        c, b1 = self.cfg, self.cfg["beta1"]
        pwc = ref.nets(c, self.device, quant)["pwc"]
        pwc.load_state_dict(self.weights["pwc"])
        params = list(pwc.parameters())
        names = [k for k, _ in pwc.named_parameters()]
        adam = ref.adam_state(params)
        rng = np.random.RandomState(self.seed_scenes)
        rows = self.batch // 2 if half else self.batch
        out = {"scenes": [], "losses": [], "grad": {}, "delta": {}}
        with common.float32_scope():
            for i in range(self.traffic["first_steps"]):
                scene = ref.scene(rng, self.batch, c["reader_height"], c["reader_width"],
                                  self.traffic["max_mag"], self.device)
                out["scenes"].append(scene)
                out["losses"].append(ref.pretrain_step(c, pwc, adam, *(t[:rows] for t in scene)))
                if i == 0:
                    out["grad"]["pwc"] = common.leaf_norms(
                        {k: m / (1.0 - b1) for k, m in zip(names, adam.m)})
        out["delta"]["pwc"] = common.leaf_norms(
            {k: p - self.weights["pwc"][k] for k, p in pwc.named_parameters()})
        return out

    def compare(self, got: dict, want: dict) -> dict:
        """Each step's loss, the first gradient and the parameters' change by
        the worst leaf (as in the `train` entry), and the whole net's
        change. The program's scenes are judged through the loss, which the
        reference takes on its own scenes; their gap is logged."""
        scene_gap = max(common.rel_max(g, w) for gs, ws in zip(got["scenes"], want["scenes"])
                        for g, w in zip(gs, ws))
        self.log(f"scenes: largest gap to the reference's {scene_gap:.6e} of the largest value")
        loss_gap = max(ref.gap(g, w) for g, w in zip(got["losses"], want["losses"]))
        self.log(f"losses: program {got['losses']}; reference {want['losses']}")
        grad = want["grad"]["pwc"]
        keep = common.moved_leaves(grad)
        common.describe_worst(self.log, "first gradient", got["grad"]["pwc"], grad)
        common.describe_worst(self.log, "change", got["delta"]["pwc"], want["delta"]["pwc"], keep)
        return {"loss_gap": loss_gap,
                "grad_gap": common.worst_leaf(got["grad"]["pwc"], grad),
                "delta_gap": common.worst_leaf(got["delta"]["pwc"], want["delta"]["pwc"], keep),
                "delta_net_gap": common.net_gap(got["delta"]["pwc"], want["delta"]["pwc"], keep)}

    def check(self) -> dict:
        numbers = self.compare(self.first, self.reference_steps())
        # on the card, per step: PWC-Net's kernels forward and backward, and the
        # scene's warp besides one per level below the top; none on the CPU
        cv, wp, cvb, wpb, n = self.window_launches
        n = n if self.device.startswith("cuda") else 0
        levels = self.cfg["pwc_pyr_lvls"] - self.cfg["pwc_flow_pred_lvl"] + 1
        numbers["launch_gap"] = float(abs(cv - levels * n) + abs(wp - levels * n)
                                      + abs(cvb - levels * n) + abs(wpb - (levels - 1) * n))
        return numbers

    def control(self, variant: str) -> dict:
        """The numbers when the reference in the precision below the cell's
        (`variant` "control") or on half of each scene ("half_batch") stands
        in the program's place for the first steps."""
        self.release()
        quant = BELOW[self.dtype] if variant == "control" else None
        return self.compare(self.reference_steps(quant, half=variant == "half_batch"),
                            self.reference_steps())
