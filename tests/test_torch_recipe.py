"""The port's recipe (unsupervised_detection_tpu_torch/recipe/) against the
JAX repo's experiment tools, on the CPU.

* Scenes: the port's render of the draws that the tools' `jax.random` key
  splits make (replayed by torch_parity's `jax_game_draws` and here by
  `jax_v2_draws`) against
  `exp_convergence_v2.make_batch_fn` and `exp_scenes.make_scenes_v2` on
  the same key, at 64x128, batch 2: images and flows within 1e-5, masks
  equal.
* The diagnostic's region masks and report line against
  `exp_flow_diag.region_masks` / `report` on the same inputs.
* The flagship anchor: the tool's own validation batch (key 999, batch 16,
  192x384, square 48) through the port with the committed flagship export
  reproduces the JAX log's frozen-PWC EPE 1.90 px
  (experiments/game_state_v2lr/log.txt:9), the best IoU 0.675 (:244) and
  the diagnostic's fullres region EPE (experiments/README.md:46).
* The game: 3 warm-start steps and 2 cycles (8 sub-steps) at 64x128, batch
  2, on the scenes' own flow, from JAX's initial weights, against the same
  sub-steps composed from the JAX package's functions as the tool composes
  them (exp_convergence_v2.py:192-245); a resumed run against an
  uninterrupted one, bit for bit.
* Both CLIs' arguments and environment knobs.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (REPO, game_loss_scale, jax_box_draws, jax_game_draws,
                          jax_game_steps, jax_initial_game_weights, torch_threads)
from unsupervised_detection_tpu_torch import convert
from unsupervised_detection_tpu_torch.recipe import flow_diag, game, pretrain_pwc, scenes
from unsupervised_detection_tpu_torch.train.checkpoint import load_eval_checkpoint

sys.path.insert(0, os.path.join(REPO, "tools"))
from exp_convergence_v2 import make_batch_fn  # noqa: E402
from exp_flow_diag import region_masks as jax_region_masks  # noqa: E402
from exp_flow_diag import report as jax_report  # noqa: E402
from exp_scenes import make_scenes_v2  # noqa: E402

_threads = torch_threads(2)

B, H, W, SQUARE = 2, 64, 128, 16
SCENE_TOL = 1e-5
FLAGSHIP = os.path.join(REPO, "weights_torch", "flagship_v2lr_r2.npz")
GAME_BEST_SHA256 = "b0b027844de8e3f00fcaee8c9f7efb4e2dec95e550dc0db4245e97bd8db88165"
# experiments/game_state_v2lr/log.txt:9 and :244, printed to 2 and 3 digits
LOG_EPE, LOG_EPE_TOL = 1.90, 0.005
LOG_IOU, LOG_IOU_TOL = 0.675, 0.002
# the same PWC's fullres region EPE on that batch (experiments/README.md:46)
README_FULLRES = {"overall": 1.90, "inside": 3.38, "boundary": 7.78, "background": 1.74}
# the game against JAX: losses relative, parameters of the net's largest.
# The reduction rates are 1 - a ratio near 1 (the generator's loss the sum
# of two): they are held to GAME_LOSS_RTOL of the ratios, k - value.
GAME_LOSS_RTOL, GAME_PARAM_REL = 1e-5, 1e-5
# ... but for elements whose gradient sits at float32 noise: an Adam step
# moves such an element by ~lr whatever the noise's sign, so two
# implementations may move it apart by up to 2 lr per update (the learner's
# gate and chip_smoke's mesh phase allow the same). At most this share of a
# net's elements, each within 2 lr x the net's updates.
GAME_FLOOR_SHARE = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_v2_draws(key, b, h, w, max_objects=3, bright=0.05, deform_amp=0.0):
    """`scenes.v2_draws` as exp_scenes.make_scenes_v2 draws them from
    `key`."""
    u = jax.random.uniform
    ks = jax.random.split(key, 5 + max_objects)
    out = {"bg8": _t(u(ks[0], (b, h // 8, w // 8, 3))),
           "bg2": _t(u(ks[1], (b, h // 2, w // 2, 3))),
           "co_bg": _t(u(ks[2], (b, 2, 3), minval=-1.0, maxval=1.0))}
    objs = {}
    for i in range(max_objects):
        kk = jax.random.split(ks[3 + i], 9 if deform_amp else 8)
        o = {"side_y": jax.random.randint(kk[0], (b, 1, 1), h // 8, h // 2 + 1),
             "side_x": jax.random.randint(kk[1], (b, 1, 1), h // 8, h // 2 + 1),
             "y0": jax.random.randint(kk[2], (b, 1, 1), 0, h - h // 8),
             "x0": jax.random.randint(kk[3], (b, 1, 1), 0, w - h // 8),
             "active": (jnp.ones((b, 1, 1), bool) if i == 0
                        else jax.random.bernoulli(kk[4], 0.5, (b, 1, 1))),
             "tex": u(kk[5], (b, h // 4, w // 4, 3)),
             "offset": u(kk[6], (b, 1, 1, 1), minval=-0.2, maxval=0.2),
             "co": u(kk[7], (b, 2, 3), minval=-1.0, maxval=1.0)}
        if deform_amp:
            ka, kf, kp = jax.random.split(kk[8], 3)
            o.update(amp=u(ka, (b, 1, 1, 2), minval=0.3, maxval=1.0),
                     freq=u(kf, (b, 1, 1, 2, 2), minval=1.0, maxval=3.0),
                     phase=u(kp, (b, 1, 1, 2, 2), maxval=2 * jnp.pi))
        for k, v in o.items():
            objs.setdefault(k, []).append(_t(v))
    for k, v in objs.items():
        t = torch.stack(v)
        out["obj_" + k] = t.long() if t.dtype == torch.int32 else t
    out["bright"] = _t(u(ks[3 + max_objects], (b, 1, 1, 1), minval=-bright, maxval=bright))
    out["noise"] = _t(jax.random.normal(ks[4 + max_objects], (b, h, w, 3)))
    return out


def assert_scene(got, want):
    *fields, mask = zip(got, want)
    for g, w in fields:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=SCENE_TOL)
    np.testing.assert_array_equal(mask[0].numpy(), np.asarray(mask[1]))


# --- scenes ------------------------------------------------------------------
@pytest.mark.parametrize("with_pairs", [False, True])
def test_game_scenes_match_the_tool(with_pairs):
    key = jax.random.PRNGKey(3)
    want = make_batch_fn(B, H, W, SQUARE, with_pairs=with_pairs)(key)
    got = scenes.render_game(jax_game_draws(key, B, H, W, SQUARE), H, W, SQUARE,
                             with_pairs=with_pairs, device="cpu")
    assert len(got) == len(want)
    assert_scene(got, want)
    assert 0 < float(got[-1].mean()) < 1


@pytest.mark.parametrize("deform_amp", [0.0, 6.0])
def test_v2_scenes_match_the_tool(deform_amp):
    key = jax.random.PRNGKey(4)
    want = make_scenes_v2(B, H, W, deform_amp=deform_amp)(key)
    got = scenes.render_v2(jax_v2_draws(key, B, H, W, deform_amp=deform_amp), H, W,
                           deform_amp=deform_amp, device="cpu")
    assert_scene(got, want)


def test_port_draws_have_the_tools_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    draws = scenes.v2_draws(gen, 16, H, W, deform_amp=6.0)
    ref = jax_v2_draws(jax.random.PRNGKey(0), 2, H, W, deform_amp=6.0)
    assert {k: (v.shape[:1] + v.shape[2:] if k.startswith("obj_") else v.shape[1:], v.dtype)
            for k, v in draws.items()} == \
        {k: (v.shape[:1] + v.shape[2:] if k.startswith("obj_") else v.shape[1:], v.dtype)
         for k, v in ref.items()}
    assert bool(draws["obj_active"][0].all())
    assert int(draws["obj_side_y"].min()) >= H // 8 and int(draws["obj_side_y"].max()) <= H // 2
    assert int(draws["obj_y0"].max()) < H - H // 8 and int(draws["obj_x0"].max()) < W - H // 8
    g = scenes.game_draws(gen, 256, H, W, SQUARE)
    assert int(g["y0"].max()) < H - SQUARE and int(g["x0"].max()) < W - SQUARE
    # one seed, one batch
    again = scenes.game_draws(torch.Generator().manual_seed(0), 2, H, W, SQUARE)
    first = scenes.game_draws(torch.Generator().manual_seed(0), 2, H, W, SQUARE)
    assert all(torch.equal(again[k], first[k]) for k in first)


# --- the diagnostic ---------------------------------------------------------
def test_region_masks_and_report_match_the_tool(capsys):
    rs = np.random.RandomState(0)
    gt = np.zeros((B, H, W, 1), np.float32)
    gt[0, 10:30, 20:60] = 1.0
    gt[1, 0:12, 100:128] = 1.0          # at the frame's edge: the SAME padding
    for got, want in zip(flow_diag.region_masks(torch.from_numpy(gt)),
                         jax_region_masks(jnp.asarray(gt))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    est = rs.randn(B, H, W, 2).astype(np.float32) * 3
    flow = rs.randn(B, H, W, 2).astype(np.float32) * 3
    capsys.readouterr()
    jax_report("fullres", jnp.asarray(est), jnp.asarray(flow), jnp.asarray(gt))
    want = capsys.readouterr().out.strip()
    r = flow_diag.region_epe(torch.from_numpy(est), torch.from_numpy(flow), torch.from_numpy(gt))
    assert flow_diag.line("fullres", r) == want


def test_diagnostic_runs_every_path():
    pwc = flow_diag.load_pwc(FLAGSHIP, "cpu")
    lines = []
    out = flow_diag.diagnose(pwc, batch=1, seed=5, device="cpu", log=lines.append)
    assert list(out) == ["native", "fullres", "divisor"] and len(lines) == 4
    for r in out.values():
        assert all(np.isfinite(v) for v in r.values()) and 0.0 <= r["seen"] <= 1.0


# --- the flagship anchor -----------------------------------------------------
def test_flagship_anchor_reproduces_the_jax_log():
    """The JAX game's validation batch through the port's game path on the
    CPU with the flagship's weights: its frozen-PWC EPE line and its best
    validation IoU."""
    key = jax.random.PRNGKey(999)
    want = make_batch_fn(16, 192, 384, 48, with_pairs=True)(key)
    g = game.Game(game.GameArgs(batch=16, pwc_ckpt=FLAGSHIP, device="cpu"))
    gen_sd, _ = load_eval_checkpoint(FLAGSHIP, 2)
    g.state.generator.load_state_dict(gen_sd)
    image, flow, gt, flow80 = g.inputs(jax_game_draws(key, 16, 192, 384, 48))
    np.testing.assert_allclose(flow80.numpy(), np.asarray(want[2]), rtol=0, atol=SCENE_TOL)
    epe = float(torch.linalg.vector_norm((flow - flow80) * 80.0, dim=-1).mean())
    iou, cover = g.validate(image, flow, gt)
    assert abs(epe - LOG_EPE) <= LOG_EPE_TOL, epe
    assert abs(iou - LOG_IOU) <= LOG_IOU_TOL, iou
    assert 0.0 < cover < 0.12
    regions = flow_diag.region_epe(flow * 80.0, flow80 * 80.0, gt)
    for k, v in README_FULLRES.items():
        assert abs(regions[k] - v) <= LOG_EPE_TOL, (k, regions[k])


def test_committed_game_detector_makes_its_evaluation_checkpoint(tmp_path):
    """weights_torch/game_card_fp32_best_gen.npz (the card's from-scratch
    game's model.best without its PWC) with the flagship's PWC is the
    evaluation checkpoint weights_torch/README.md names, byte for byte."""
    import hashlib

    from unsupervised_detection_tpu_torch.train.checkpoint import load_trees, save_eval_checkpoint

    g = load_trees(os.path.join(REPO, "weights_torch", "game_card_fp32_best_gen.npz"))
    assert (int(g["cycle"]), round(float(g["best"]), 4)) == (1850, 0.5736)
    path = save_eval_checkpoint(str(tmp_path / "best.npz"), g["gen_params"], g["gen_stats"],
                                load_trees(FLAGSHIP)["pwc_params"])
    with open(path, "rb") as fh:
        assert hashlib.sha256(fh.read()).hexdigest() == GAME_BEST_SHA256
    gen_sd, pwc_sd = load_eval_checkpoint(path, 2)
    assert gen_sd and pwc_sd


# --- the game against JAX ----------------------------------------------------
def _jax_objective():
    """The tool's objective at this test's sizes (ground-truth flow)."""
    from unsupervised_detection_tpu.config import Config as JaxConfig
    from unsupervised_detection_tpu.models import RecoverNet as JaxRecover
    from unsupervised_detection_tpu.train.objective import AdversarialObjective as JaxObjective

    cfg = JaxConfig(img_height=H, img_width=W, batch_size=B, reader_height=H, reader_width=W,
                    compute_dtype="float32", allow_random_flow=True, pwc_search_range=4)
    obj = JaxObjective(cfg)
    obj.recover = JaxRecover(f=0.25, dtype=obj.dtype)
    return obj, cfg


def test_game_steps_match_jax():
    pre_steps, cycles = 3, 2
    # JAX's initial weights as the tool makes them
    obj, cfg = _jax_objective()
    gen_vars, rec_params = jax_initial_game_weights(obj)
    # the tool's scene keys and box keys
    data_key, keys = jax.random.PRNGKey(1234), []
    for _ in range(pre_steps + 4 * cycles):
        data_key, k = jax.random.split(data_key)
        keys.append(k)
    prng, box_keys = jax.random.PRNGKey(7), []
    for _ in range(pre_steps):
        prng, r = jax.random.split(prng)
        box_keys.append(r)
    make = make_batch_fn(B, H, W, SQUARE)
    jax_batches = [make(k)[:2] for k in keys]
    want = jax_game_steps(obj, cfg, gen_vars, rec_params, jax_batches, box_keys)

    g = game.Game(game.GameArgs(batch=B, height=H, width=W, device="cpu"))
    g.state.generator.load_state_dict(
        convert.generator_state_dict(gen_vars["params"], gen_vars["batch_stats"]))
    g.state.recover.load_state_dict(convert.recover_state_dict(rec_params))
    batches = [g.inputs(jax_game_draws(k, B, H, W, SQUARE))[:2] for k in keys]
    for i, ((image, flow), key) in enumerate(zip(batches, box_keys)):
        loss = float(g.pre_step(image, flow, jax_box_draws(key, B)))
        np.testing.assert_allclose(loss, want["pre"][i], rtol=GAME_LOSS_RTOL)
    g.end_warm_start()
    for sub, (image, flow) in enumerate(batches[pre_steps:]):
        player = "recover" if sub % 4 < g.config.iters_rec else "generator"
        losses = g.sub_step(player, image, flow)
        for k, v in want["steps"][sub].items():
            assert abs(float(losses[k]) - v) <= GAME_LOSS_RTOL * game_loss_scale(k, v), \
                (sub, k, float(losses[k]), v)
    assert (g.state.gen_opt.count, g.state.rec_opt.count) == (3 * cycles, cycles)
    for net, tree, to_sd, updates in (
            (g.state.generator, want["gen_params"],
             lambda t: convert.generator_state_dict(t, gen_vars["batch_stats"]), 3 * cycles),
            (g.state.recover, want["rec_params"], convert.recover_state_dict,
             pre_steps + cycles)):
        ref = to_sd(tree)
        top = max(float(v.abs().max()) for v in ref.values())
        diff = torch.cat([(net.state_dict()[k] - v).abs().flatten() for k, v in ref.items()])
        off = int((diff > GAME_PARAM_REL * top).sum())
        assert off <= GAME_FLOOR_SHARE * diff.numel(), (type(net).__name__, off, diff.numel())
        assert float(diff.max()) <= 2 * g.config.learning_rate * updates, \
            (type(net).__name__, float(diff.max()))


def test_resume_replays_the_run_bit_for_bit(tmp_path):
    env = {"EXP_SAVE_EVERY": "1", "EXP_POSTLOCK_LR": "0.3"}
    quiet = [].append

    def run(cycles, state_dir, log=quiet):
        return game.main([str(cycles), "2", "1", "0.25", "32", "64", "", str(state_dir),
                          "--device=cpu"], environ=env, log=log)

    whole = run(2, tmp_path / "a")
    run(1, tmp_path / "b")
    lines = []
    resumed = run(2, tmp_path / "b", lines.append)
    assert lines[1].startswith("resumed from") and "at cycle 2" in lines[1]
    a, b = whole["game"].state, resumed["game"].state
    for name in ("generator", "recover"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name
    for opt in ("gen_opt", "rec_opt"):
        oa, ob = getattr(a, opt), getattr(b, opt)
        assert oa.count == ob.count and all(torch.equal(oa.v[k], ob.v[k]) for k in oa.v)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())
    assert whole["hist"][-1] == resumed["hist"][-1]
    # model.best is an evaluation checkpoint
    gen_sd, pwc_sd = load_eval_checkpoint(str(tmp_path / "a" / "model.best"), 4)
    assert set(gen_sd) == set(a.generator.state_dict()) and pwc_sd


# --- the CLIs' arguments -----------------------------------------------------
def test_game_arguments_and_knobs():
    a = game.parse_args([], environ={})
    assert (a.cycles, a.batch, a.pretrain, a.f, a.height, a.width, a.pwc_ckpt, a.state_dir,
            a.side, a.save_every, a.postlock_lr, a.lock_iou, a.lock_cover, a.device,
            a.dtype) == (2000, 16, 500, 0.25, 192, 384, "", "", 48, 250, 1.0, 0.45, 0.12,
                         None, "float32")
    env = {"EXP_SQUARE": "96", "EXP_SAVE_EVERY": "100", "EXP_POSTLOCK_LR": "0.3",
           "EXP_LOCK_IOU": "0.5", "EXP_LOCK_COVER": "0.1"}
    a = game.parse_args(["7000", "8", "50", "1.0", "96", "192", "p.npz", "st", "--device=cpu",
                         "--dtype=bfloat16"], environ=env)
    assert (a.cycles, a.batch, a.pretrain, a.f, a.height, a.width, a.pwc_ckpt, a.state_dir,
            a.side, a.save_every, a.postlock_lr, a.lock_iou, a.lock_cover, a.device,
            a.dtype) == (7000, 8, 50, 1.0, 96, 192, "p.npz", "st", 96, 100, 0.3, 0.5, 0.1,
                         "cpu", "bfloat16")
    assert game.parse_args(["1", "1", "1", "0.25", "32", "64"], environ={}).side == 16


@pytest.mark.parametrize("version", [1, 2, 3])
def test_pretrain_arguments_and_knobs(version):
    a = pretrain_pwc.parse_args(["16000", "8", "128", "192", "d", "", str(version)], environ={})
    assert (a.steps, a.batch, a.height, a.width, a.ckpt_dir, a.resume, a.scenes) == \
        (16000, 8, 128, 192, "d", "", version)
    assert a.object_weight == (0.0 if version == 1 else 4.0)
    assert (a.deform_amp, a.boundary_weight) == ((6.0, 8.0) if version == 3 else (0.0, 0.0))
    assert (a.boundary_mode, a.lr_schedule) == ("final", "constant")
    env = {"PWC_OBJECT_WEIGHT": "2", "PWC_DEFORM_AMP": "3", "PWC_BOUNDARY_WEIGHT": "4",
           "PWC_BOUNDARY_MODE": "all", "PWC_LR_SCHEDULE": "cosine"}
    a = pretrain_pwc.parse_args(["5", "2", "64", "128", "d", "r", str(version), "--device=cpu"],
                                environ=env)
    assert a.object_weight == (0.0 if version == 1 else 2.0)
    assert (a.deform_amp, a.boundary_weight) == ((3.0, 4.0) if version == 3 else (0.0, 0.0))
    assert (a.boundary_mode, a.lr_schedule, a.resume, a.device) == ("all", "cosine", "r", "cpu")
    fn = pretrain_pwc.scene_batches(a, "cpu")
    batch = fn(None, 2, 64, 128)
    assert len(batch) == (3 if version == 1 else 4)
    assert batch[2].shape == (2, 64, 128, 2) and float(batch[2].abs().max()) > 1.0


def test_recipe_pretraining_resumes_and_saves(tmp_path):
    net, epe = pretrain_pwc.main(["2", "2", "64", "128", str(tmp_path), "", "2", "--device=cpu"],
                                 environ={}, log=[].append)
    assert np.isfinite(epe) and (tmp_path / "pwc-final").is_file()
    net2, _ = pretrain_pwc.main(["1", "2", "64", "128", "", str(tmp_path / "pwc-final"), "3",
                                 "--device=cpu"], environ={}, log=[].append)
    assert net2.search_range == 2
