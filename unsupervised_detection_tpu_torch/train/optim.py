"""TF1-compatible Adam with the reference's shared bias-correction step,
counterpart of unsupervised_detection_tpu/train/optim.py.

The reference builds ONE `tf.train.AdamOptimizer` and applies it to both
players (adversarial_learner.py:216-233); TF1 decays its beta1^t / beta2^t
accumulators on every apply, so the generator's and the recover's updates
share one step count t (`TrainState.shared_adam_t`). Per tensor:

    m <- b1*m + (1-b1)*g
    v <- b2*v + (1-b2)*g^2
    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    p <- p - lr_t * m / (sqrt(v) + eps)

eps sits OUTSIDE the bias correction, which `torch.optim.Adam` folds into
m_hat / v_hat, so the port has its own. b1^t and b2^t are float32 powers,
as in the JAX package (a float64 power gives another lr_t).

The pretraining stages use `optax.adam` instead (train/pretrain.py:12-17
there), eps added to sqrt(v_hat): `OptaxAdam`; `warmup_cosine_lr` is
pretrain_pwc's optional schedule.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Iterable, Mapping

import numpy as np
import torch

from ..utils.profiling import span


@dataclasses.dataclass
class AdamState:
    count: int                      # applies of THIS net's update so far
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


def adam_init(params: Mapping[str, torch.Tensor]) -> AdamState:
    """Zero moments shaped, typed and placed like `params`."""
    return AdamState(count=0, m={k: torch.zeros_like(p) for k, p in params.items()},
                     v={k: torch.zeros_like(p) for k, p in params.items()})


def _bias_correction(b: float, t: int) -> torch.Tensor:
    """1 - b^t in float32, a 0-d tensor."""
    f32 = torch.float32
    return torch.tensor(1.0, dtype=f32) - torch.tensor(b, dtype=f32) ** torch.tensor(float(t), dtype=f32)


def lr_at(t: int, lr: float, b1: float, b2: float) -> float:
    """lr * sqrt(1 - b2^t) / (1 - b1^t) in float32 (exact as a Python float)."""
    return float(torch.tensor(lr, dtype=torch.float32) * torch.sqrt(_bias_correction(b2, t))
                 / _bias_correction(b1, t))


@torch.no_grad()
def adam_apply(grads: Mapping[str, torch.Tensor], opt: AdamState,
               params: Mapping[str, torch.Tensor], t: int, lr: float, b1: float,
               b2: float, eps: float) -> AdamState:
    """One Adam step with bias-correction step `t` (>= 1): updates `params`
    in place and returns the new state (this net's count + 1)."""
    with span("ud.train.adam"):
        lr_t = lr_at(t, lr, b1, b2)
        m, v = {}, {}
        for k, p in params.items():
            g = grads[k]
            m[k] = b1 * opt.m[k] + (1.0 - b1) * g
            v[k] = b2 * opt.v[k] + (1.0 - b2) * g * g
            p.sub_(lr_t * m[k] / (torch.sqrt(v[k]) + eps))
        return AdamState(count=opt.count + 1, m=m, v=v)


# --- the pretraining stages' optimizer (optax.adam) --------------------------
class OptaxAdam:
    """`optax.adam(lr, b1=b1, b2=b2, eps=eps)` over a list of tensors:

        m <- (1-b1)*g + b1*m,   v <- (1-b2)*g^2 + b2*v,   t <- t + 1
        p <- p - lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

    with optax's float32 bias corrections, where `torch.optim.Adam` takes
    them in float64 (1 - 0.999 is 0.0009999871 in float32: a first update
    moves by 6.4e-6 relative less). Updates in place with PyTorch's
    multi-tensor ops."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, b1: float, eps: float,
                 b2: float = 0.999):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0   # updates applied

    @torch.no_grad()
    def step(self, grads, lr: float | None = None) -> None:
        """Apply one update from `grads` (one per parameter) at rate `lr`
        (default: the constructor's)."""
        lr = self.lr if lr is None else lr
        self.count += 1
        with span("ud.train.adam"):
            bc1 = float(_bias_correction(self.b1, self.count))
            bc2 = float(_bias_correction(self.b2, self.count))
            grads = list(grads)
            torch._foreach_mul_(self.m, self.b1)
            torch._foreach_add_(self.m, torch._foreach_mul(grads, 1.0 - self.b1))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - self.b2)
            torch._foreach_mul_(self.v, self.b2)
            torch._foreach_add_(self.v, sq)
            denom = torch._foreach_div(self.v, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(self.m, bc1)
            torch._foreach_div_(update, denom)
            torch._foreach_mul_(update, -lr)
            torch._foreach_add_(self.params, update)


def warmup_cosine_lr(count: int, lr: float, steps: int) -> float:
    """The rate of update `count + 1` (optax evaluates a schedule at the
    count BEFORE its increment, so the first update takes lr/10) under
    optax.warmup_cosine_decay_schedule(init_value=lr/10, peak_value=lr,
    warmup_steps=min(200, max(1, steps//10)), decay_steps=steps,
    end_value=lr*0.05) (train/pretrain_pwc.py:182-186 there), with optax's
    float32 arithmetic (its schedules run on an int32 count)."""
    f32 = np.float32
    warmup = min(200, max(1, steps // 10))
    decay = steps - warmup
    if decay <= 0:
        # as optax's cosine_decay_schedule refuses decay_steps <= 0
        raise ValueError(f"lr_schedule='cosine' needs more than {warmup} steps, got {steps}")
    init, alpha = lr / 10, (lr * 0.05) / lr
    if count < warmup:
        frac = f32(1.0) - f32(max(count, 0)) / f32(warmup)
        return float(f32(init - lr) * frac + f32(lr))
    t = f32(min(count - warmup, decay))
    cosine = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * t / f32(decay)))
    return float(f32(lr) * (f32(1.0 - alpha) * cosine + f32(alpha)))
