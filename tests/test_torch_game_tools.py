"""The port's game instruments (recipe/synth.py, game_stats.py,
inspect_mask.py) against the JAX repo's tools, on the CPU.

* Scenes: `synth.make_batch` bit-equal to exp_convergence_synth.make_batch
  for a few seeds and batch sizes, two calls from one stream each.
* The synthetic game: 3 warm-start steps and 2 cycles (8 sub-steps) at
  batch 2 from JAX's initial weights (through `convert`) and JAX's box
  draws, against the same steps composed from the JAX package's functions
  as exp_convergence_synth.py composes them (:143-185): every step's
  losses within 1e-4 relative. Its loop feeds one RandomState(0) stream to
  the warm start and then to the cycles, in the tool's order.
* The game-log summary: the port's stdout byte-equal to
  exp_game_stats.py's (a subprocess: the tool imports no JAX) on every
  committed game log, at the default thresholds and at (0.45, 0.2).
* The mask inspector: the port on weights_torch/flagship_v2lr_r2.npz fed
  the tool's key-999 draws against exp_inspect_game_mask.py's own `main`
  on the same weights' JAX saves, at 64x128, batch 2 (the file's one JAX
  PWC forward): per sample IoU, area and in-gt within INSPECT_TOL, the
  centroid within INSPECT_CENTROID_TOL px, the components equal. The
  tool prints IoU to 3 digits and the rest to 1 decimal of a percent or
  a pixel: the limits hold the port's exact values to those printed ones,
  the print's rounding (half a unit of the last digit) inside the limit.
* Both CLIs' arguments and `--device`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from torch_parity import (REPO, game_loss_scale, jax_box_draws, jax_game_draws, jax_game_steps,
                          jax_initial_game_weights, torch_threads)
from unsupervised_detection_tpu_torch import convert
from unsupervised_detection_tpu_torch.models import GeneratorNet
from unsupervised_detection_tpu_torch.recipe import game, game_stats, inspect_mask, synth

sys.path.insert(0, os.path.join(REPO, "tools"))
import exp_convergence_synth as jax_synth  # noqa: E402

_threads = torch_threads(2)

FLAGSHIP = os.path.join(REPO, "weights_torch", "flagship_v2lr_r2.npz")
GAME_BEST_GEN = os.path.join(REPO, "weights_torch", "game_card_fp32_best_gen.npz")
JAX_GAME = os.path.join(REPO, "experiments", "game_state_v2lr", "model.best")
JAX_PWC = os.path.join(REPO, "experiments", "pwc_ckpt_v2", "pwc-final")
# every committed game log: the port's card runs, then the JAX arms'
LOGS = ["weights_torch/game_card_fp32.log", "weights_torch/game_card_fp32_own_pwc.log",
        "weights_torch/synth_game_card_fp32.log", "weights_torch/synth_game_jax_cpu.log",
        "experiments/game_state_sq96/log.txt", "experiments/game_state_v2/log.txt",
        "experiments/game_state_v2lr/log.txt", "experiments/game_state_v4/log.txt"]
SYNTH_LOSS_RTOL = 1e-4
INSPECT_TOL = 1e-3            # IoU, area and in-gt, as fractions
INSPECT_CENTROID_TOL = 0.1    # px
INSPECT_HW_BATCH = (64, 128, 2)


# --- scenes ------------------------------------------------------------------
@pytest.mark.parametrize("seed,batch", [(0, 8), (999, 16), (3, 1), (7, 2)])
def test_make_batch_is_the_tools(seed, batch):
    ours, theirs = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):
        got, want = synth.make_batch(ours, batch), jax_synth.make_batch(theirs, batch)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert ours.randint(1 << 30) == theirs.randint(1 << 30)


# --- the synthetic game against JAX -------------------------------------------
def test_synth_steps_match_jax():
    from unsupervised_detection_tpu.config import Config as JaxConfig
    from unsupervised_detection_tpu.train.objective import AdversarialObjective as JaxObjective

    b, pre_steps, cycles = 2, 3, 2
    # the tool's config and objective (:80-81), its initial weights
    cfg = JaxConfig(img_height=synth.H, img_width=synth.W, batch_size=b,
                    compute_dtype="float32", allow_random_flow=True)
    obj = JaxObjective(cfg)
    gen_vars, rec_params = jax_initial_game_weights(obj)
    # the tool's scene stream and box keys
    rs = np.random.RandomState(0)
    batches = [jax_synth.make_batch(rs, b)[:2] for _ in range(pre_steps + 4 * cycles)]
    prng, box_keys = jax.random.PRNGKey(7), []
    for _ in range(pre_steps):
        prng, r = jax.random.split(prng)
        box_keys.append(r)
    want = jax_game_steps(obj, cfg, gen_vars, rec_params, batches, box_keys)

    g = synth.make_game(synth.SynthArgs(cycles, b, pre_steps, "cpu"))
    g.state.generator.load_state_dict(
        convert.generator_state_dict(gen_vars["params"], gen_vars["batch_stats"]))
    g.state.recover.load_state_dict(convert.recover_state_dict(rec_params))
    inputs = [synth.to_device(x, "cpu") for x in batches]
    for i, ((image, flow), key) in enumerate(zip(inputs, box_keys)):
        loss = float(g.pre_step(image, flow, jax_box_draws(key, b)))
        assert abs(loss - want["pre"][i]) <= SYNTH_LOSS_RTOL * abs(want["pre"][i]), (i, loss)
    g.end_warm_start()
    for sub, (image, flow) in enumerate(inputs[pre_steps:]):
        player = "recover" if sub % 4 < g.config.iters_rec else "generator"
        losses = g.sub_step(player, image, flow)
        assert set(losses) == set(want["steps"][sub])
        for k, v in want["steps"][sub].items():
            assert abs(float(losses[k]) - v) <= SYNTH_LOSS_RTOL * game_loss_scale(k, v), \
                (sub, k, float(losses[k]), v)
    assert (g.state.gen_opt.count, g.state.rec_opt.count) == (3 * cycles, cycles)


def test_synth_loop_feeds_the_tools_stream(monkeypatch):
    """The warm start takes the stream's first batches, the cycles the
    next ones, 1 recover then 3 generator sub-steps; the console lines are
    the tool's and `game_stats` reads them."""
    seen = []
    orig_pre, orig_sub = game.Game.pre_step, game.Game.sub_step

    def pre_step(self, image, flow, box_draws=None):
        seen.append(("pre", image.clone(), flow.clone()))
        return orig_pre(self, image, flow, box_draws)

    def sub_step(self, player, image, flow, lr_scale=1.0):
        seen.append((player, image.clone(), flow.clone()))
        return orig_sub(self, player, image, flow, lr_scale)

    monkeypatch.setattr(game.Game, "pre_step", pre_step)
    monkeypatch.setattr(game.Game, "sub_step", sub_step)
    lines = []
    rec = synth.main(["2", "2", "2", "--device=cpu"], log=lines.append)
    assert [s[0] for s in seen] == ["pre"] * 2 + ["recover"] + ["generator"] * 3 + \
        ["recover"] + ["generator"] * 3
    rs = np.random.RandomState(0)
    for _, image, flow in seen:
        img, fl, _ = jax_synth.make_batch(rs, 2)
        assert np.array_equal(image.numpy(), img) and np.array_equal(flow.numpy(), fl)
    assert lines[0].startswith("cycle    1  IoU ") and lines[-1].startswith("final IoU ")
    rows, lock = game_stats.parse_lines(lines)
    assert [r[0] for r in rows] == [1] and lock is None
    (cycle, iou, cover), final = rec["hist"]
    assert cycle == 1 and final[0] == 2
    assert abs(iou - rows[0][1]) <= 5e-4 and abs(cover - rows[0][2]) <= 5e-3


# --- the game-log summary ------------------------------------------------------
@pytest.mark.parametrize("thresholds", [(), ("0.45", "0.2")], ids=["default", "0.45-0.2"])
@pytest.mark.parametrize("log", LOGS)
def test_game_stats_prints_the_tools_lines(log, thresholds, capsys):
    path = os.path.join(REPO, log)
    want = subprocess.run([sys.executable, os.path.join(REPO, "tools", "exp_game_stats.py"),
                           path, *thresholds], capture_output=True, text=True, check=True,
                          timeout=60).stdout
    capsys.readouterr()
    game_stats.main([path, *thresholds])
    assert capsys.readouterr().out == want


def test_game_stats_refuses_a_log_without_validations(tmp_path):
    path = tmp_path / "empty.log"
    path.write_text("pretrain   50  inpaint loss 0.1051\n")
    with pytest.raises(SystemExit, match="no val lines found in"):
        game_stats.main([str(path)])


# --- the mask inspector --------------------------------------------------------
def _parse_table(out):
    rows = []
    for line in out.splitlines():
        f = line.split()
        if len(f) == 6 and f[0].isdigit():
            rows.append({"iou": float(f[1]), "area": float(f[2]) / 100,
                         "in_gt": float(f[3]) / 100, "dist": float(f[4]), "ncomp": int(f[5])})
        elif line.startswith("mean IoU"):
            mean = float(f[2])
    return rows, mean


def test_inspector_matches_the_tool(monkeypatch, capsys):
    import exp_inspect_game_mask

    h, w, b = INSPECT_HW_BATCH
    monkeypatch.setattr(sys, "argv", ["exp_inspect_game_mask.py", JAX_GAME, JAX_PWC,
                                      str(h), str(w), str(b)])
    exp_inspect_game_mask.main()
    want, want_mean = _parse_table(capsys.readouterr().out)
    lines = []
    draws = jax_game_draws(jax.random.PRNGKey(game.VAL_SEED), b, h, w, max(16, h // 4))
    got = inspect_mask.inspect(FLAGSHIP, FLAGSHIP, h, w, b, "cpu", draws=draws, log=lines.append)
    assert len(want) == len(got["rows"]) == b
    assert lines[1] == inspect_mask.HEADER and lines[-1].startswith("mean IoU ")
    for i, (g, t) in enumerate(zip(got["rows"], want)):
        for k in ("iou", "area", "in_gt"):
            assert abs(g[k] - t[k]) <= INSPECT_TOL, (i, k, g[k], t[k])
        assert abs(g["dist"] - t["dist"]) <= INSPECT_CENTROID_TOL, (i, g["dist"], t["dist"])
        assert g["ncomp"] == t["ncomp"], (i, g["ncomp"], t["ncomp"])
    assert abs(got["mean_iou"] - want_mean) <= INSPECT_TOL


def test_inspector_reads_every_generator_save(tmp_path):
    """A generator-only save with its counters, an evaluation checkpoint
    and a `recipe.game` resume point load into the generator."""
    net = GeneratorNet()
    assert inspect_mask.load_generator(GAME_BEST_GEN, net) == \
        {"cycle": 1850, "best": pytest.approx(0.5736, abs=1e-4)}
    assert inspect_mask.load_generator(FLAGSHIP, net) == {}
    g = game.Game(game.GameArgs(batch=1, height=32, width=64, state_dir=str(tmp_path),
                                device="cpu"))
    path = g.save("model-3", 3, 0.25, 1.0)
    assert inspect_mask.load_generator(path, net) == {"cycle": 3, "best": 0.25}
    want = g.state.generator.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in net.state_dict().items())


def test_inspector_geometry_of_known_masks():
    gt = np.zeros((3, 8, 8), bool)
    gt[:, 2:6, 2:6] = True
    mask = np.zeros_like(gt)
    mask[0] = gt[0]                         # the square itself
    mask[1] = ~gt[1]                        # its complement
    mask[2, 0, 0] = mask[2, 7, 7] = True    # two specks
    rows = inspect_mask.mask_geometry(mask, gt)
    assert rows[0] == {"iou": 1.0, "area": 0.25, "in_gt": 1.0, "dist": 0.0, "ncomp": 1}
    assert (rows[1]["iou"], rows[1]["area"], rows[1]["in_gt"], rows[1]["ncomp"]) == \
        (0.0, 0.75, 0.0, 1)
    assert rows[2]["ncomp"] == 2 and rows[2]["in_gt"] == 0.0
    assert inspect_mask.table(rows)[1] == "  0  1.000   25.0  100.0        0.0      1"


# --- the CLIs' arguments -------------------------------------------------------
def test_cli_arguments():
    a = synth.parse_args([])
    assert (a.cycles, a.batch, a.pretrain, a.device) == (400, 8, 200, None)
    a = synth.parse_args(["25", "4", "50", "--device=cpu"])
    assert (a.cycles, a.batch, a.pretrain, a.device) == (25, 4, 50, "cpu")
    a = inspect_mask.parse_args(["g.npz", "p.npz"])
    assert (a.game_ckpt, a.pwc_ckpt, a.height, a.width, a.batch, a.device) == \
        ("g.npz", "p.npz", 192, 384, 16, None)
    a = inspect_mask.parse_args(["g", "p", "64", "128", "2", "--device=cpu"])
    assert (a.height, a.width, a.batch, a.device) == (64, 128, 2, "cpu")
