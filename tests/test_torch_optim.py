"""The port's schedules and optimizer chain against optax.

Both schedules at steps 0, 1, 4000 and 1e5 for the fresh and the fine-tune
warmup; five updates of the clip -> Adam -> schedule chain on the same
gradients, below and above the clip norm: the global norm rel 1e-6, the
updates and moments within 1e-6 of each tensor's largest magnitude (a
moment that nearly cancels over steps amplifies an ulp of either side's
rounding order).  The chain does not read the parameters, so the port's
are zeroed before each update and hold exactly that update after it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import TrainConfig
from tacotron_tpu.train.optim import (learning_rate_schedule,
                                      make_optimizer)
from tacotron_tpu_torch.config import TrainConfig as TorchTrainConfig
from tacotron_tpu_torch.train import optim as port


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("step", [0, 1, 4000, 100000])
def test_schedule_matches_jax(mode, fresh, step):
    kw = dict(decay_learning_rate_mode=mode)
    want = learning_rate_schedule(TrainConfig(**kw), fresh)(
        jnp.asarray(step, jnp.int32))
    got = port.learning_rate_schedule(TorchTrainConfig(**kw), fresh)(
        torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


SHAPES = [(7, 5), (5,), (3, 4, 2), ()]


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["below-clip", "above-clip"])
@pytest.mark.parametrize("mode", [0, 1])
def test_chain_matches_optax(grad_scale, mode):
    kw = dict(decay_learning_rate_mode=mode, grad_clip_norm=1.0)
    rng = np.random.default_rng(5)
    params = [np.asarray(rng.standard_normal(s), np.float32)
              for s in SHAPES]
    opt = make_optimizer(TrainConfig(**kw), True)
    j_params = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    j_state = opt.init(j_params)
    port_opt = port.Optimizer(TorchTrainConfig(**kw), True)
    t_params = [torch.from_numpy(p.copy()) for p in params]
    t_state = port.AdamState.zeros(t_params)
    for _ in range(5):
        grads = [np.asarray(grad_scale * rng.standard_normal(s), np.float32)
                 for s in SHAPES]
        for p in t_params:
            p.zero_()
        norm = port_opt.update(t_params, [torch.from_numpy(g) for g in grads],
                               t_state)
        updates, j_state = opt.update(
            {str(i): jnp.asarray(g) for i, g in enumerate(grads)}, j_state,
            j_params)
        j_params = {k: j_params[k] + updates[k] for k in j_params}
        want_norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                                for g in grads))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        for i, p in enumerate(t_params):
            _close(p, updates[str(i)], f"update of {i}")
    adam = j_state[1]
    assert int(t_state.count) == int(adam.count) == 5
    for i in range(len(SHAPES)):
        _close(t_state.m[i], adam.mu[str(i)], f"m of {i}")
        _close(t_state.v[i], adam.nu[str(i)], f"v of {i}")


def _close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * scale, err_msg=what)
