"""Learning-rate schedules and the optimizer chain, written to optax's
semantics (``tacotron_tpu/train/optim.py:20-63``).

- mode 0: Noam warmup ``lr * ws**0.5 * min((t+1) * ws**-1.5, (t+1)**-0.5)``
  with ``ws`` = ``warmup_steps_fresh`` (4000) for a randomly initialized
  run and ``warmup_steps_finetune`` (40000) for a warm start;
- mode 1: exponential decay ``lr * 0.95**((t+1)/3000)``;
- the chain ``clip_by_global_norm -> scale_by_adam -> scale_by_learning_rate``:

  * clip: ``g`` if ``|g| < max`` else ``g / |g| * max``, with the global
    norm over every parameter (``clip_grad_norm_`` divides by ``|g| + 1e-6``
    and clamps, which is another function);
  * Adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, the bias
    corrections at ``count + 1``, ``u = mu_hat / (sqrt(nu_hat) + 1e-8)``;
  * the learning rate at the optimizer's own ``count`` (so a warm start
    with fresh optimizer state restarts the warmup), applied as
    ``p - lr * u``.

Everything stays on the device: the count is a device tensor and the
schedules are tensor functions, so a step needs no host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def noam_schedule(initial_lr: float, warmup_steps: float) -> Schedule:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        t = (step + 1).to(torch.float32)
        return (initial_lr * warmup_steps ** 0.5
                * torch.minimum(t * warmup_steps ** -1.5, t ** -0.5))
    return schedule


def exponential_schedule(initial_lr: float, decay_steps: int = 3000,
                         decay_rate: float = 0.95) -> Schedule:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        t = (step + 1).to(torch.float32)
        return initial_lr * decay_rate ** (t / decay_steps)
    return schedule


def learning_rate_schedule(config, randomly_initialized: bool = True
                           ) -> Schedule:
    """``config`` is a ``TrainConfig``."""
    if config.decay_learning_rate_mode == 0:
        warmup = (config.warmup_steps_fresh if randomly_initialized
                  else config.warmup_steps_finetune)
        return noam_schedule(config.initial_learning_rate, warmup)
    if config.decay_learning_rate_mode == 1:
        return exponential_schedule(config.initial_learning_rate)
    raise ValueError(
        f"unknown decay_learning_rate_mode {config.decay_learning_rate_mode}")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of every tensor."""
    norms = torch._foreach_norm(tensors)
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclass
class AdamState:
    """First and second moments (one per parameter, in parameter order) and
    the update count, an int32 device tensor."""

    m: List[torch.Tensor]
    v: List[torch.Tensor]
    count: torch.Tensor

    @classmethod
    def zeros(cls, params: List[torch.Tensor]) -> "AdamState":
        return cls(m=[torch.zeros_like(p) for p in params],
                   v=[torch.zeros_like(p) for p in params],
                   count=torch.zeros((), dtype=torch.int32,
                                     device=params[0].device))


class Optimizer:
    """clip-by-global-norm -> Adam -> the schedule, applied in place."""

    def __init__(self, config, randomly_initialized: bool = True):
        self.max_norm = float(config.grad_clip_norm)
        self.b1 = float(config.adam_beta1)
        self.b2 = float(config.adam_beta2)
        self.eps = 1e-8
        self.schedule = learning_rate_schedule(config, randomly_initialized)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState) -> torch.Tensor:
        """One update of ``params`` and ``state`` in place from ``grads``
        (left as they are); returns the global norm of ``grads``."""
        g_norm = global_norm(grads)
        scale = torch.where(g_norm < self.max_norm,
                            torch.ones_like(g_norm), self.max_norm / g_norm)
        g = torch._foreach_mul(grads, scale)

        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.m, b1)
        torch._foreach_add_(state.m, g, alpha=1.0 - b1)
        torch._foreach_mul_(state.v, b2)
        torch._foreach_addcmul_(state.v, g, g, value=1.0 - b2)
        count_inc = (state.count + 1).to(torch.float32)
        bc1 = 1.0 - b1 ** count_inc
        bc2 = 1.0 - b2 ** count_inc
        m_hat = torch._foreach_div(state.m, bc1)
        denom = torch._foreach_sqrt(torch._foreach_div(state.v, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(m_hat, denom)
        torch._foreach_mul_(updates, -self.schedule(state.count))
        torch._foreach_add_(params, updates)
        state.count.add_(1)
        return g_norm
