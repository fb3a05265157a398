"""Entry `train`: the window drives the port's `AdversarialLearner`,
alternating `generator_step` and `recover_step` through `select_step`
(iters_gen : iters_rec) over a pool of seeded frame pairs held on the card:
the augmentation on the card, the frozen PWC-Net through the cost-volume
and warp kernels, the mask, the recover net's three calls, the 8 losses,
each player's gradients, the clip (or the generator's noise) and TF1 Adam
at the shared step. No pipeline, summaries or saves.

Set-up builds the learner and its state once and drives it through its
first cycle (one batch of the pool per sub-step, every row different);
the window goes on with that same state, in whole cycles. The plain
reference follows that first cycle from the same weights, frames and seed,
and the check compares each sub-step's loss, each net's first gradient
(worked out from its Adam moment after its first update) and the change of
its parameters after the cycle, leaf by leaf.
"""

from __future__ import annotations

import time

import torch

from bench_port.lib import bounds, common, frames, trace, weights
from bench_port.reference import model as ref
from bench_port.reference.quant import BELOW


class Runner:
    def __init__(self, cell, seed: int, device: str, traced: bool, log):
        self.cell, self.seed, self.device, self.traced_run, self.log = cell, seed, device, traced, log
        self.cfg, self.spec, self.traffic = cell.config, cell.spec, cell.spec["traffic"]
        self.dtype = cell.spec["compute_dtype"]
        self.batch = self.cfg["batch_size"]
        self.cycle = self.cfg["iters_gen"] + self.cfg["iters_rec"]
        self.seed_weights, self.seed_pool, self.seed_draws = common.seeds(seed, 3)
        self.sub_step = 0
        self.events: list = []
        self.flops = None

    # --- set-up --------------------------------------------------------------------
    def setup(self) -> None:
        from unsupervised_detection_tpu_torch.train.learner import AdversarialLearner

        t, log = self.traffic, self.log
        config = common.program_config(self.cell, self.seed_draws)
        with common.phase(log, "weights on the device"):
            self.weights = weights.make(self.cfg, self.seed_weights, self.device)
        with common.phase(log, "the program's learner, its nets and state"):
            self.learner = AdversarialLearner(config, device=self.device)
            self.learner.objective.load_state_dicts(self.weights["generator"],
                                                    self.weights["pwc"])
            self.learner.objective.recover.load_state_dict(self.weights["recover"])
            self.state = self.learner.init_state()
        with common.phase(log, "frame pairs on the device"):
            gen = torch.Generator(device=self.device).manual_seed(self.seed_pool)
            self.img1, self.img2 = frames.pair_pool(
                gen, t["pool_batches"] * self.batch, (self.cfg["reader_height"],
                                                      self.cfg["reader_width"]),
                t["square"], t["max_shift"], self.device)
        if self.traced_run:
            with common.phase(log, "the first cycle, FLOPs counted"):
                counted = common.count_flops(self._first_cycle) / self.cycle
            self.flops = counted + self._kernel_flops()
            self.log(f"flops: {counted:.6e} counted per sub-step of {self.batch} samples "
                     f"(a cycle of {self.cycle}) + {self._kernel_flops():.6e} the kernels' "
                     f"formula per sub-step; XLA's count of the JAX program's forward "
                     f"{common.XLA_GFLOP_PER_FRAME} GFLOP/frame, for reference")
        else:
            with common.phase(log, "the first cycle"):
                self._first_cycle()

    def _kernel_flops(self) -> float:
        c = self.cfg
        work = bounds.pwc_forward_work(self.batch, c["reader_height"], c["reader_width"],
                                       c["pwc_pyr_lvls"], c["pwc_flow_pred_lvl"],
                                       c["pwc_search_range"], self.dtype)
        return sum(w[2] for w in work.values())

    def _one(self, timed: bool = False):
        """One sub-step on the pool's next batch; returns (player, losses)."""
        self.sub_step += 1
        k = (self.sub_step - 1) % self.traffic["pool_batches"]
        rows = slice(k * self.batch, (k + 1) * self.batch)
        fn = self.learner.select_step(self.sub_step)
        player = "recover" if fn == self.learner.recover_step else "generator"
        if timed:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        with torch.profiler.record_function("bench." + player + "_step"):
            self.state, losses, _ = fn(self.state, self.img1[rows], self.img2[rows])
        if timed:
            end.record()
            self.events.append((player, start, end))
        if self.sub_step % self.cycle == 0:
            self.state = self.learner.incr_step(self.state)
        return player, losses

    def _first_cycle(self) -> None:
        """The first cycle, kept for the check: each sub-step's losses, each
        net's first gradient as its Adam gets it, the cycle's parameter change."""
        b1 = self.cfg["beta1"]
        self.first = {"losses": [], "grad": {}, "delta": {}}
        for _ in range(self.cycle):
            player, losses = self._one()
            self.first["losses"].append((player, {k: float(v) for k, v in losses.items()}))
            if player not in self.first["grad"]:
                opt = self.state.gen_opt if player == "generator" else self.state.rec_opt
                self.first["grad"][player] = common.leaf_norms(
                    {k: m / (1.0 - b1) for k, m in opt.m.items()})
        for player in ("generator", "recover"):
            net = self.state.generator if player == "generator" else self.state.recover
            self.first["delta"][player] = common.leaf_norms(
                {k: p - self.weights[player][k] for k, p in net.named_parameters()})

    # --- the window ----------------------------------------------------------------
    def _cycles(self, seconds=None, cycles=None, timed=False) -> int:
        """Whole cycles until `seconds` have passed or `cycles` are done;
        returns the sub-steps run."""
        t0, n = time.perf_counter(), 0
        while True:
            for _ in range(self.cycle):
                self._one(timed)
            n += self.cycle
            if cycles is not None and n >= cycles * self.cycle:
                return n
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                return n

    def window(self, seconds: float) -> dict:
        before = common.launches()
        self.events = []
        t0 = time.perf_counter()
        n = self._cycles(seconds=seconds, timed=self.traced_run)
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.window_launches = [a - b for a, b in zip(common.launches(), before)] + [n]
        samples = n * self.batch
        return {"metrics": {"samples_per_s": samples / wall}, "attempted": samples, "failed": 0}

    def traced(self) -> trace.Window:
        from torch.profiler import ProfilerActivity, profile

        cycles = self.traffic["trace_cycles"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("bench.window"):
                self._cycles(cycles=cycles)
                torch.cuda.synchronize()
        return trace.from_profiler(prof, "bench.window", cycles * self.cycle)

    def layer_context(self, window: trace.Window) -> dict:
        c = self.cfg
        work = bounds.pwc_forward_work(self.batch, c["reader_height"], c["reader_width"],
                                       c["pwc_pyr_lvls"], c["pwc_flow_pred_lvl"],
                                       c["pwc_search_range"], self.dtype)
        step_ms: dict = {}
        for player, start, end in self.events:
            step_ms.setdefault(player, []).append(start.elapsed_time(end))
        return {"window": window, "dtype": self.dtype, "flops_per_step": self.flops,
                "least_s_per_step": {"cost_volume": work["cost_volume"][3]},
                "step_ms": step_ms}

    # --- the check -----------------------------------------------------------------
    def release(self) -> None:
        del self.learner, self.state
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def reference_cycle(self, quant=None, half: bool = False) -> dict:
        """The reference's first cycle on the same weights, pool batches and
        draws' seed; with `quant` every convolution rounds its operands to
        that precision, with `half` each step sees the first half of its
        batch (the draws are still made for the whole batch)."""
        n = ref.nets(self.cfg, self.device, quant)
        for name, net in n.items():
            net.load_state_dict(self.weights[name])
        game = ref.Game(self.cfg, n, self.seed_draws)
        rows = self.batch // 2 if half else self.batch
        out = {"losses": [], "grad": {}, "delta": {}}
        b1 = self.cfg["beta1"]
        with common.float32_scope():
            for k in range(self.cycle):
                b = slice(k * self.batch, k * self.batch + rows)
                player, losses = game.step(self.img1[b], self.img2[b], self.batch)
                out["losses"].append((player, losses))
                if player not in out["grad"]:
                    names = [k for k, _ in n[player].named_parameters()]
                    out["grad"][player] = common.leaf_norms(
                        {k: m / (1.0 - b1) for k, m in zip(names, game.adam[player].m)})
        for player in ("generator", "recover"):
            out["delta"][player] = common.leaf_norms(
                {k: p - self.weights[player][k] for k, p in n[player].named_parameters()})
        return out

    def compare(self, got: dict, want: dict) -> dict:
        """Each sub-step's stepped loss: the generator's is two reduction
        rates, 1 - rec/den, differences of terms near 1, so its gap is
        taken over the larger of |loss| and 1; the recover loss, a sum of
        positive terms, relative. The first gradient and the cycle's
        parameter change by the worst leaf (the change over the leaves that
        move by more than round-off), and the change of each whole net."""
        loss_gap = 0.0
        for (p_got, l_got), (p_want, l_want) in zip(got["losses"], want["losses"]):
            floor = 1.0 if p_want == "generator" else 0.0
            loss_gap = max(loss_gap, ref.gap(l_got[p_got], l_want[p_want], floor)
                           if p_got == p_want else 1.0)
        self.log("losses: program " + " ".join(f"{p}={l[p]:.9g}" for p, l in got["losses"])
                 + "; reference " + " ".join(f"{p}={l[p]:.9g}" for p, l in want["losses"]))
        keep = {p: common.moved_leaves(want["grad"][p]) for p in want["delta"]}
        for p in want["grad"]:
            common.describe_worst(self.log, f"first gradient, {p}", got["grad"].get(p, {}),
                                  want["grad"][p])
            common.describe_worst(self.log, f"change, {p}", got["delta"][p], want["delta"][p],
                                  keep[p])
        return {"loss_gap": loss_gap,
                "grad_gap": max(common.worst_leaf(got["grad"].get(p, {}), want["grad"][p])
                                for p in want["grad"]),
                "delta_gap": max(common.worst_leaf(got["delta"][p], want["delta"][p], keep[p])
                                 for p in want["delta"]),
                "delta_net_gap": max(common.net_gap(got["delta"][p], want["delta"][p], keep[p])
                                     for p in want["delta"])}

    def check(self) -> dict:
        numbers = self.compare(self.first, self.reference_cycle())
        # the frozen PWC-Net's kernels on the card, no backward kernel; none on the CPU
        cv, wp, cvb, wpb, n = self.window_launches
        n = n if self.device.startswith("cuda") else 0
        levels = self.cfg["pwc_pyr_lvls"] - self.cfg["pwc_flow_pred_lvl"] + 1
        numbers["launch_gap"] = float(abs(cv - levels * n) + abs(wp - (levels - 1) * n)
                                      + cvb + wpb)
        return numbers

    def control(self, variant: str) -> dict:
        """The numbers when the reference in the precision below the cell's
        (`variant` "control") or on half of each batch ("half_batch") stands
        in the program's place for the first cycle."""
        self.release()
        quant = BELOW[self.dtype] if variant == "control" else None
        got = self.reference_cycle(quant, half=variant == "half_batch")
        return self.compare(got, self.reference_cycle())
