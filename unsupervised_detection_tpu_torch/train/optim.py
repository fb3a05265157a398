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
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch


@dataclasses.dataclass
class AdamState:
    count: int                      # applies of THIS net's update so far
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


def adam_init(params: Mapping[str, torch.Tensor]) -> AdamState:
    """Zero moments shaped, typed and placed like `params`."""
    return AdamState(count=0, m={k: torch.zeros_like(p) for k, p in params.items()},
                     v={k: torch.zeros_like(p) for k, p in params.items()})


def lr_at(t: int, lr: float, b1: float, b2: float) -> float:
    """lr * sqrt(1 - b2^t) / (1 - b1^t) in float32 (exact as a Python float)."""
    t32 = torch.tensor(float(t), dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    b1_t = torch.tensor(b1, dtype=torch.float32) ** t32
    b2_t = torch.tensor(b2, dtype=torch.float32) ** t32
    return float(torch.tensor(lr, dtype=torch.float32) * torch.sqrt(one - b2_t) / (one - b1_t))


@torch.no_grad()
def adam_apply(grads: Mapping[str, torch.Tensor], opt: AdamState,
               params: Mapping[str, torch.Tensor], t: int, lr: float, b1: float,
               b2: float, eps: float) -> AdamState:
    """One Adam step with bias-correction step `t` (>= 1): updates `params`
    in place and returns the new state (this net's count + 1)."""
    lr_t = lr_at(t, lr, b1, b2)
    m, v = {}, {}
    for k, p in params.items():
        g = grads[k]
        m[k] = b1 * opt.m[k] + (1.0 - b1) * g
        v[k] = b2 * opt.v[k] + (1.0 - b2) * g * g
        p.sub_(lr_t * m[k] / (torch.sqrt(v[k]) + eps))
    return AdamState(count=opt.count + 1, m=m, v=v)
