"""The port's learner against the JAX learner, on the CPU.

* The gate: 8 alternation cycles (32 sub-steps: gen, gen, gen, rec) from
  identical weights with PWC and the augmentation bypassed and the flow fed
  directly, as tests/test_golden_train_dynamics.py drives the JAX learner
  against the TF1 reference; every sub-step's 8 losses and the final
  parameter deltas of both nets are compared, and JAX's noise branch must
  not fire on these inputs.
* One full `generator_step` and one full `recover_step` (PWC r=2 and the
  augmentation) against the jitted JAX steps, the augmentation draws taken
  from the JAX state's key as learner.py:136 and augment.py:81 split it.
* `val_step` against JAX's.

Reader 64x128, working 32x64, batch 4, float32, one JAX device.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import jax_augment_draws, moving_square_frames, torch_threads
from unsupervised_detection_tpu.config import Config as JaxConfig
from unsupervised_detection_tpu.train import learner as jax_learner_mod
from unsupervised_detection_tpu.train.learner import AdversarialLearner as JaxLearner
from unsupervised_detection_tpu.train.learner import TrainState as JaxTrainState
from unsupervised_detection_tpu.train.optim import adam_init as jax_adam_init
from unsupervised_detection_tpu_torch import Config, convert
from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet, RecoverNet
from unsupervised_detection_tpu_torch.train import learner as learner_mod
from unsupervised_detection_tpu_torch.train.checkpoint import load_train_state
from unsupervised_detection_tpu_torch.train.learner import AdversarialLearner


_threads = torch_threads(1)


B = 4
SIZES = dict(batch_size=B, reader_height=64, reader_width=128, img_height=32, img_width=64,
             pwc_search_range=2)
LOSS_KEYS = ("generator", "recover", "red_rate", "red_rate_compl", "reconstruction_loss",
             "reconstruction_compl_loss", "denominator_red_rate",
             "denominator_red_rate_compl")
N_STEPS = 32
# The gate's limits, those of the JAX learner's own gate against the TF1
# reference (tests/test_golden_train_dynamics.py): losses within
# rtol 2e-3 and atol 2e-4, growing linearly past cycle 2 (every step feeds
# the next through both nets, so float32 rounding compounds); parameter
# deltas: fewer than 2% of a tensor's elements may differ by more than 5%
# of its largest |delta| (Adam makes a delta ~lr * sign(g), which flips
# for gradients at the noise level).
GATE_RTOL, GATE_ATOL = 2e-3, 2e-4
DELTA_REL, DELTA_FRAC = 0.05, 0.02
# One full step: losses of a float32 forward (PWC included) within 1e-4
# relative; deltas as above with at most 1% of the elements off.
STEP_RTOL, STEP_ATOL, STEP_FRAC = 1e-4, 1e-6, 0.01
# val_step: the summed IoU of B masks; a pixel within float32 noise of the
# 0.1 threshold may flip.
VAL_ATOL = 1e-3


@pytest.fixture(scope="module")
def trees():
    gen_p, gen_s, pwc_p = convert.random_jax_params(GeneratorNet(), PWCNet(search_range=2),
                                                    seed=21)
    # the generator's head x 30: the mask spans [0, 1] (the validation IoU
    # then sees both classes) and stays off saturation (gradients flow)
    gen_p["conv17"]["conv"]["kernel"] = gen_p["conv17"]["conv"]["kernel"] * 30.0
    return gen_p, gen_s, convert.random_recover_params(RecoverNet(), seed=22), pwc_p


def _jax_state(trees, seed=42):
    gen_p, gen_s, rec_p, pwc_p = jax.tree.map(jnp.asarray, trees)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(seed),
                         gen_params=gen_p, gen_stats=gen_s, rec_params=rec_p,
                         pwc_params=pwc_p, gen_opt=jax_adam_init(gen_p),
                         rec_opt=jax_adam_init(rec_p))


def _fields(jstate) -> dict:
    """A JAX TrainState's fields as nested dicts of numpy arrays."""
    s = jax.device_get(jstate)
    opt = lambda o: {"count": o.count, "m": o.m, "v": o.v}  # noqa: E731
    return {"step": s.step, "gen_params": s.gen_params, "gen_stats": s.gen_stats,
            "rec_params": s.rec_params, "pwc_params": s.pwc_params,
            "gen_opt": opt(s.gen_opt), "rec_opt": opt(s.rec_opt)}


def _port(cfg, jstate):
    learner = AdversarialLearner(cfg, device="cpu")
    state = load_train_state(learner.init_state(), _fields(jstate))
    return learner, state


def _params(state):
    return {"gen": {k: v.detach().clone() for k, v in state.generator.named_parameters()},
            "rec": {k: v.detach().clone() for k, v in state.recover.named_parameters()}}


def _jax_params(jstate):
    f = _fields(jstate)
    return {"gen": convert.generator_state_dict(f["gen_params"]),
            "rec": convert.recover_state_dict(f["rec_params"])}


def _assert_deltas_close(got, got_init, want, want_init, frac_limit, what):
    """Each net's parameter deltas, port (got - got_init) against JAX
    (want - want_init); a net that did not step is bit-unchanged on both
    sides."""
    for net in ("gen", "rec"):
        for name, w in want[net].items():
            d_jax = (w - want_init[net][name]).numpy()
            d_port = (got[net][name] - got_init[net][name]).numpy()
            scale = np.abs(d_jax).max()
            if scale == 0.0:       # the net did not step
                assert torch.equal(got[net][name], got_init[net][name]), (what, net, name)
                continue
            bad = float(np.mean(np.abs(d_port - d_jax) > DELTA_REL * scale))
            assert bad < frac_limit, (
                f"{what} {net}.{name}: {bad:.2%} of the deltas differ by more than "
                f"{DELTA_REL:.0%} of max |delta| {scale:.3e}")


def _assert_losses_close(got, want, rtol, atol, what):
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=atol,
                                   err_msg=f"loss {k!r}, {what}")


def _noise_fired(grads) -> bool:
    # the noise is |U(-clip, clip)| >= 0 everywhere; a clipped gradient has
    # negative elements
    return all(float(jnp.min(g)) >= 0.0 for g in jax.tree.leaves(grads))


def test_eight_cycles_match_jax_learner(trees, monkeypatch):
    cfg = dict(img_height=32, img_width=64, batch_size=B, train_crop=1.0, pwc_search_range=2)
    rs = np.random.RandomState(77)
    image = rs.uniform(-0.5, 0.5, (B, 32, 64, 3)).astype(np.float32)
    base = rs.randn(B, 4, 8, 2).astype(np.float32) * 4.0
    flow = np.asarray(jax.image.resize(jnp.asarray(base), (B, 32, 64, 2), "linear")) / 80.0

    # JAX learner, PWC and augmentation bypassed (the flow fed directly)
    monkeypatch.setattr(jax_learner_mod, "augment_pair", lambda rng, a, b, crop: (a, b))
    jl = JaxLearner(JaxConfig(mesh_data=1, **cfg))
    jobj = jl.objective
    monkeypatch.setattr(jobj, "forward", lambda gp, gs, rp, pp, img, fl:
                        jobj.losses_from_flow(gp, gs, rp, img, fl))
    jl._build_steps()
    jstate = _jax_state(trees)

    # the port's learner, bypassed the same way
    monkeypatch.setattr(learner_mod, "augment_pair", lambda draws, a, b: (a, b))
    learner, state = _port(Config(**cfg), jstate)
    obj = learner.objective
    monkeypatch.setattr(obj, "forward", obj.losses_from_flow)
    init, j_init = _params(state), _jax_params(jstate)

    jimage, jflow = jnp.asarray(image), jnp.asarray(flow)
    timage, tflow = torch.from_numpy(image), torch.from_numpy(flow)
    for sub_step in range(1, N_STEPS + 1):
        is_rec = (sub_step % 4) < 1
        assert (learner.select_step(sub_step) == learner.recover_step) == is_rec
        jstate, j_losses, j_grads = jl.select_step(sub_step)(jstate, jimage, jflow)
        state, losses, _ = learner.select_step(sub_step)(state, timage, tflow)
        if not is_rec:
            assert not _noise_fired(j_grads), f"JAX's noise branch fired at sub-step {sub_step}"
        growth = max(1.0, sub_step / 8.0)
        _assert_losses_close(losses, j_losses, GATE_RTOL * growth, GATE_ATOL * growth,
                             f"sub-step {sub_step}")
    assert (state.gen_opt.count, state.rec_opt.count) == (24, 8) == (
        int(jstate.gen_opt.count), int(jstate.rec_opt.count))
    _assert_deltas_close(_params(state), init, _jax_params(jstate), j_init, DELTA_FRAC,
                         "8 cycles")


def _jax_draws(rng, b, h, w, crop):
    """What the JAX step draws from state.rng (learner.py:136, augment.py:81)."""
    _, r_aug, _ = jax.random.split(rng, 3)
    return jax_augment_draws(r_aug, b, h, w, crop)


@pytest.fixture(scope="module")
def full(trees):
    jl = JaxLearner(JaxConfig(mesh_data=1, **SIZES))
    img1, img2, gt = moving_square_frames(B, 64, 128, seed=23, shift=(2, 3))
    return jl, (img1, img2, gt)


def test_full_steps_match_jax(trees, full):
    jl, (img1, img2, _) = full
    jstate = _jax_state(trees, seed=7)
    learner, state = _port(Config(**SIZES), jstate)
    init, j_init = _params(state), _jax_params(jstate)
    t1, t2 = torch.from_numpy(img1), torch.from_numpy(img2)
    for name in ("generator_step", "recover_step"):
        draws = _jax_draws(jstate.rng, B, 64, 128, 0.9)
        assert not torch.equal(draws["p"], torch.ones(B))
        before, j_before = _params(state), _jax_params(jstate)
        jstate, j_losses, j_grads = getattr(jl, name)(jstate, jnp.asarray(img1),
                                                     jnp.asarray(img2))
        state, losses, _ = getattr(learner, name)(state, t1, t2, draws=draws)
        if name == "generator_step":
            assert not _noise_fired(j_grads)
        _assert_losses_close(losses, j_losses, STEP_RTOL, STEP_ATOL, name)
        _assert_deltas_close(_params(state), before, _jax_params(jstate), j_before, STEP_FRAC,
                             name)
    assert state.shared_adam_t == 3 and int(jstate.gen_opt.count + jstate.rec_opt.count) == 2
    _assert_deltas_close(_params(state), init, _jax_params(jstate), j_init, STEP_FRAC,
                         "both steps")


def test_val_step_matches_jax(trees, full):
    jl, (img1, img2, gt) = full
    jstate = _jax_state(trees)
    want = float(jl.val_step(jstate, jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(gt)))
    learner, state = _port(Config(**SIZES), jstate)
    got = float(learner.val_step(state, *(torch.from_numpy(a) for a in (img1, img2, gt))))
    assert 0.05 < want < B - 0.05
    assert abs(got - want) <= VAL_ATOL, (got, want)
