"""The port's pretraining stages against the JAX package, on the CPU:

* one PWC gradient: the multiscale EPE (object mask and boundary band)
  through the port's PWC against `jax.value_and_grad` of the same loss
  built from the JAX package's own functions, 64x64, batch 2, r=2, float32;
* the port's version of JAX's `test_pretrain_pwc_reduces_epe`;
* the chain pretrain_flow -> pretrain_recover -> train -> test_generator
  through the CLIs' `main(argv, device="cpu")` on a synthetic DAVIS tree,
  and `pretrain_recover` from a TF1 bundle of the flow net, with its
  refusals without flow weights or with another search range.

Tolerances, fixed before the first run: loss and EPE within 1e-5
relative (float32 sums over ~8k pixels in other orders); every gradient
element within 1e-4 of its tensor's largest |gradient| (the backward of
~40 float32 convolutions, oneDNN against XLA).
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synthetic import make_moving_square_davis
from torch_parity import torch_threads
from unsupervised_detection_tpu.models import PWCNet as JaxPWCNet
from unsupervised_detection_tpu.train import pretrain_pwc as jax_pwc
from unsupervised_detection_tpu_torch import Config, convert
from unsupervised_detection_tpu_torch import pretrain_flow as flow_cli
from unsupervised_detection_tpu_torch import pretrain_recover as recover_cli
from unsupervised_detection_tpu_torch import test_generator as eval_cli
from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet
from unsupervised_detection_tpu_torch.train import checkpoint as ckpt
from unsupervised_detection_tpu_torch.train import tf1_bundle, tf1_export
from unsupervised_detection_tpu_torch.train.pretrain_pwc import (PWCPretrainer, pretrain_pwc,
                                                                 pwc_loss, synthetic_flow_batch)

train_cli = importlib.import_module("unsupervised_detection_tpu_torch.train.__main__")

LOSS_RTOL = 1e-5
GRAD_OF_LARGEST = 1e-4


_threads = torch_threads(1)


def _grad_gaps(got: dict, want: dict) -> dict:
    """{name: max |got - want| over the largest |want|} of two dicts of
    tensors by state-dict name."""
    assert set(got) == set(want)
    return {k: float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30)
            for k in want}


# --- one PWC gradient ---------------------------------------------------------
PWC_B, PWC_HW, OBJECT_WEIGHT, BOUNDARY_WEIGHT = 2, 64, 2.0, 3.0


@pytest.fixture(scope="module")
def pwc_case():
    """Seeded weights (flax layout), a synthetic batch with an object mask,
    and JAX's (loss, epe, gradients) of pretrain_pwc's loss_fn with
    boundary_mode "final", compiled once."""
    _, _, params = convert.random_jax_params(GeneratorNet(), PWCNet(search_range=2), seed=3)
    img1, img2, flow = jax_pwc.synthetic_flow_batch(np.random.RandomState(0), PWC_B, PWC_HW,
                                                    PWC_HW, max_mag=5.0)
    mask = np.zeros((PWC_B, PWC_HW, PWC_HW, 1), np.float32)
    mask[:, 20:40, 16:44] = 1.0
    net = JaxPWCNet(search_range=2)

    def loss_fn(p):          # train/pretrain_pwc.py:204-232, boundary_mode="final"
        flow_pred, flow_pyr = net.apply({"params": p}, img1, img2, return_pyramid=True)
        weight = 1.0 + OBJECT_WEIGHT * mask
        band = jax_pwc.boundary_band(jnp.asarray(mask))
        return jax_pwc.multiscale_epe(flow_pred, flow_pyr, flow, net.flow_pred_lvl,
                                      weight=weight + BOUNDARY_WEIGHT * band, weight_aux=weight)

    (loss, epe), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return {"params": params, "batch": (img1, img2, flow, mask), "loss": float(loss),
            "epe": float(epe), "grads": convert.pwc_state_dict(jax.device_get(grads))}


@pytest.fixture(scope="module")
def pwc_port(pwc_case):
    cfg = Config(batch_size=PWC_B, reader_height=PWC_HW, reader_width=PWC_HW,
                 pwc_search_range=2)
    trainer = PWCPretrainer(cfg, steps=1, params=convert.pwc_state_dict(pwc_case["params"]),
                            object_weight=OBJECT_WEIGHT, boundary_weight=BOUNDARY_WEIGHT,
                            device="cpu")
    batch = [torch.from_numpy(np.array(a)) for a in pwc_case["batch"]]
    loss, epe, regions, grads = trainer.loss_and_grads(*batch)
    names = [k for k, _ in trainer.net.named_parameters()]
    return {"loss": float(loss), "epe": float(epe), "regions": regions,
            "grads": dict(zip(names, grads))}


def test_pwc_loss_and_epe_match_jax(pwc_case, pwc_port):
    assert pwc_port["loss"] == pytest.approx(pwc_case["loss"], rel=LOSS_RTOL)
    assert pwc_port["epe"] == pytest.approx(pwc_case["epe"], rel=LOSS_RTOL)
    assert len(pwc_port["regions"]) == 3                 # inside, background, band
    assert all(np.isfinite(float(r)) for r in pwc_port["regions"])


def test_pwc_gradients_match_jax(pwc_case, pwc_port):
    gaps = _grad_gaps(pwc_port["grads"], pwc_case["grads"])
    print("largest gradient gaps over their tensor's largest:",
          sorted(gaps.items(), key=lambda kv: -kv[1])[:5])
    assert max(gaps.values()) <= GRAD_OF_LARGEST


def test_pwc_loss_is_the_trainers(pwc_case):
    # pwc_loss with the band on every level ("all") differs from "final"
    # only on the pyramid levels' weights
    net = PWCNet(search_range=2)
    net.load_state_dict(convert.pwc_state_dict(pwc_case["params"]))
    batch = [torch.from_numpy(np.array(a)) for a in pwc_case["batch"]]
    with torch.no_grad():
        final = pwc_loss(net, *batch, OBJECT_WEIGHT, BOUNDARY_WEIGHT, "final")
        every = pwc_loss(net, *batch, OBJECT_WEIGHT, BOUNDARY_WEIGHT, "all")
    assert float(final[0]) == pytest.approx(pwc_case["loss"], rel=LOSS_RTOL)
    assert float(final[1]) == float(every[1]) and float(final[0]) != float(every[0])


# --- training runs --------------------------------------------------------------
def test_pretrain_pwc_reduces_epe(tmp_path):
    # JAX's test_pretrain_pwc_reduces_epe: constant small translations, 40
    # steps; the EPE must fall below 0.7 of the first step's, and pwc-final
    # restores into a fresh net
    cfg = Config(batch_size=4, reader_height=64, reader_width=64, img_height=32, img_width=32,
                 seed=0, checkpoint_dir=str(tmp_path / "pwc"))

    def easy_batches(rng, batch, h, w):
        return synthetic_flow_batch(rng, batch, h, w, max_mag=3.0, device="cpu")

    os.makedirs(cfg.checkpoint_dir)
    _, epe0 = pretrain_pwc(cfg, steps=1, verbose=False, batch_fn=easy_batches, device="cpu")
    net, epe = pretrain_pwc(cfg, steps=40, verbose=False, batch_fn=easy_batches,
                            save_every=40, device="cpu")
    assert np.isfinite(epe)
    assert epe < 0.7 * epe0, (epe0, epe)
    assert sorted(os.listdir(cfg.checkpoint_dir)) == ["pwc-40", "pwc-final"]
    fresh = PWCNet(search_range=cfg.pwc_search_range)
    ckpt.restore_params_scope(os.path.join(cfg.checkpoint_dir, "pwc-final"), fresh, "pwc_params")
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in net.state_dict().items())


def test_pretrain_pwc_options():
    cfg = Config(batch_size=2, reader_height=64, reader_width=64, seed=1)

    def masked_batches(rng, batch, h, w):
        img1, img2, flow = synthetic_flow_batch(rng, batch, h, w, max_mag=3.0, device="cpu")
        mask = torch.zeros((batch, h, w, 1))
        mask[:, 16:40, 20:44] = 1.0
        return img1, img2, flow, mask

    _, epe = pretrain_pwc(cfg, steps=3, verbose=False, batch_fn=masked_batches,
                          lr_schedule="cosine", object_weight=1.0, boundary_weight=2.0,
                          boundary_mode="all", device="cpu")
    assert np.isfinite(epe)
    for bad in (dict(lr_schedule="bogus"), dict(boundary_mode="bogus")):
        with pytest.raises(ValueError):
            pretrain_pwc(cfg, steps=1, verbose=False, batch_fn=masked_batches, device="cpu",
                         **bad)
    with pytest.raises(ValueError):                  # too few steps for the warmup
        pretrain_pwc(cfg, steps=1, verbose=False, lr_schedule="cosine", device="cpu")


@pytest.fixture(scope="module")
def davis_root(tmp_path_factory):
    return make_moving_square_davis(str(tmp_path_factory.mktemp("davis")), frames=10,
                                    hw=(128, 192))


SIZES = ["--batch_size=8", "--pwc_search_range=2", "--img_height=32", "--img_width=64",
         "--reader_height=64", "--reader_width=128"]


def test_cli_chain_into_train_and_test_generator(davis_root, tmp_path, capsys):
    pwc_dir, rec_dir, game_dir = (str(tmp_path / d) for d in ("pwc", "rec", "game"))
    net, epe = flow_cli.main([f"--checkpoint_dir={pwc_dir}", "--pretrain_steps=1"] + SIZES,
                             device="cpu")
    assert np.isfinite(epe) and "pwc-pretrain      1  loss " in capsys.readouterr().out
    assert sorted(os.listdir(pwc_dir)) == ["pwc-final"]
    flow_ckpt = os.path.join(pwc_dir, "pwc-final")

    recover = recover_cli.main([f"--root_dir={davis_root}", f"--flow_ckpt={flow_ckpt}",
                                f"--checkpoint_dir={rec_dir}", "--pretrain_steps=2",
                                "--num_threads=2"] + SIZES, device="cpu")
    assert sorted(os.listdir(rec_dir)) == ["recover-final"]
    recover_ckpt = os.path.join(rec_dir, "recover-final")

    state = train_cli.main([f"--root_dir={davis_root}", f"--checkpoint_dir={game_dir}",
                            f"--flow_ckpt={flow_ckpt}", f"--recover_ckpt={recover_ckpt}",
                            "--num_samples_train=16", "--max_epochs=1", "--summary_freq=1",
                            "--save_freq=1", "--num_threads=2"] + SIZES, device="cpu")
    out = capsys.readouterr().out
    assert "Flow net loaded from" in out and "Recover net loaded from previous ckpt" in out
    assert "Training completed successfully" in out
    # the game started from both pretrained nets (PWC stays frozen)
    assert all(torch.equal(state.pwc.state_dict()[k], v) for k, v in net.state_dict().items())
    fresh = PWCNet(search_range=2)
    ckpt.restore_params_scope(os.path.join(game_dir, "model.best"), fresh, "pwc_params")
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in net.state_dict().items())
    # an epoch of 2 sub-steps trains the generator only (1:3 alternation)
    assert (state.gen_opt.count, state.rec_opt.count) == (2, 0)
    assert all(torch.equal(state.recover.state_dict()[k], v)
               for k, v in recover.state_dict().items())

    results = eval_cli.main([f"--root_dir={davis_root}",
                             f"--ckpt_file={os.path.join(game_dir, 'model.best')}"] + SIZES,
                            device="cpu")
    assert "The Average over the dataset: IoU is" in capsys.readouterr().out
    assert results["frames"] == 16


def test_pretrain_recover_refuses_without_flow_weights(davis_root, tmp_path):
    flags = [f"--root_dir={davis_root}", "--pretrain_steps=1"] + SIZES
    with pytest.raises(SystemExit, match="needs --flow_ckpt"):
        recover_cli.main(flags, device="cpu")
    # a TF1 bundle of the flow net restores bit for bit and the stage runs
    # on it; one of another search range is refused, naming both
    torch.manual_seed(4)
    pwc = PWCNet(search_range=2)
    tf1 = tf1_bundle.write_bundle(str(tmp_path / "tf1" / "model.ckpt-100"),
                                  tf1_export.tf1_tensors(pwc))
    restored = PWCNet(search_range=2)
    ckpt.restore_params_scope(tf1, restored, "pwc_params")
    assert all(torch.equal(restored.state_dict()[k], v) for k, v in pwc.state_dict().items())
    recover = recover_cli.main(flags + [f"--flow_ckpt={tf1}", "--num_threads=2"], device="cpu")
    assert all(bool(torch.isfinite(p).all()) for p in recover.parameters())
    with pytest.raises(ValueError, match="search range 2, but --pwc_search_range=4"):
        recover_cli.main([f for f in flags if "search_range" not in f]
                         + ["--pwc_search_range=4", f"--flow_ckpt={tf1}"], device="cpu")
    # a flow save of another search range is refused, not silently misread
    other = str(tmp_path / "pwc-r4")
    ckpt.save_scope(str(tmp_path), "pwc-r4", PWCNet(search_range=4), "pwc_params")
    with pytest.raises(ValueError, match="search range 4"):
        recover_cli.main(flags + [f"--flow_ckpt={other}"], device="cpu")
