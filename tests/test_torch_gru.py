"""The fused GRU (K4) of the PyTorch port against the JAX package on the
CPU: forward against JAX's Pallas kernel in interpret mode, gradients of all
six inputs against ``jax.grad`` through JAX's kernel (whose ``custom_vjp``
differentiates the scan), and the BiGRU adapter on weights carried over from
flax by the weight bridge, against JAX's adapter and the port's ``BiGRU``.

Everything is float32 on both sides; only summation order differs:
1e-5 for the forward, 1e-4 for the gradients (as the JAX kernel's own
tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.ops.pallas import gru as jgru
from tacotron_tpu.ops.rnn import BiGRU as JaxBiGRU
from tacotron_tpu_torch import params as P
from tacotron_tpu_torch.ops.kernels import gru as tgru
from tacotron_tpu_torch.ops.rnn import BiGRU


def _weights(rng, D, H):
    wg = (rng.standard_normal((D + H, 2 * H)) * 0.3).astype(np.float32)
    bg = (1.0 + 0.1 * rng.standard_normal(2 * H)).astype(np.float32)
    wc = (rng.standard_normal((D + H, H)) * 0.3).astype(np.float32)
    bc = (0.1 * rng.standard_normal(H)).astype(np.float32)
    return wg, bg, wc, bc


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("lengths", [[12, 7, 0, 12], None])
def test_gru_sequence_ntd_matches_jax_kernel(lengths):
    rng = np.random.default_rng(0)
    N, T, D, H = 4, 12, 16, 8
    x = rng.standard_normal((N, T, D)).astype(np.float32)
    h0 = rng.standard_normal((N, H)).astype(np.float32)
    w = _weights(rng, D, H)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want = np.asarray(jgru.gru_sequence_ntd(
        jnp.asarray(x), jnp.asarray(h0), *map(jnp.asarray, w),
        None if lens is None else jnp.asarray(lens), interpret=True))
    before = tgru.gru_sequence.launches
    got = tgru.gru_sequence_ntd(
        *_t(x, h0, *w), None if lens is None else torch.from_numpy(lens))
    assert tgru.gru_sequence.launches == before   # CPU: the plain scan
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if lens is not None:   # rows are exactly zero past their length
        for n, length in enumerate(lengths):
            assert np.all(got.numpy()[n, length:] == 0.0)


@pytest.mark.parametrize("lengths", [[6, 4], None])
def test_gru_gradients_match_jax(lengths):
    """Gradients of a sum of squares with respect to x, h0, wg, bg, wc and
    bc: the port's backward recomputes through the plain scan under
    autograd, as JAX's custom_vjp does through its scan."""
    rng = np.random.default_rng(1)
    N, T, D, H = 2, 6, 8, 8
    x = rng.standard_normal((N, T, D)).astype(np.float32)
    h0 = rng.standard_normal((N, H)).astype(np.float32)
    w = _weights(rng, D, H)
    lens = None if lengths is None else np.asarray(lengths, np.int32)

    def loss(*args):
        return jnp.sum(jgru.gru_sequence_ntd(
            *args, None if lens is None else jnp.asarray(lens),
            interpret=True) ** 2)

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (x, h0, *w)))
    inputs = [t.requires_grad_() for t in _t(x, h0, *w)]
    out = tgru.gru_sequence_ntd(
        *inputs, None if lens is None else torch.from_numpy(lens))
    got = torch.autograd.grad((out ** 2).sum(), inputs)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("with_lengths,with_state", [
    (True, False), (False, False), (True, True), (False, True)])
def test_bigru_from_params_matches_jax_and_module(with_lengths, with_state):
    """Weights initialized in flax, carried over by ``params.from_flax``:
    the port's adapter equals JAX's adapter (kernel in interpret mode) and
    the port's ``BiGRU`` module, with and without lengths and with a split
    initial state."""
    rng = np.random.default_rng(2)
    N, T, D, H = 3, 10, 12, 8
    x = rng.standard_normal((N, T, D)).astype(np.float32)
    lens = np.asarray([10, 6, 9], np.int32) if with_lengths else None
    state = (rng.standard_normal((N, 2 * H)).astype(np.float32)
             if with_state else None)
    jl = None if lens is None else jnp.asarray(lens)
    js = None if state is None else jnp.asarray(state)
    variables = JaxBiGRU(H).init(jax.random.PRNGKey(0), jnp.asarray(x), jl)
    want = np.asarray(jgru.bigru_from_params(variables["params"],
                                             jnp.asarray(x), jl, js,
                                             interpret=True))
    module = BiGRU(D, H)
    module.load_state_dict(P.from_flax(
        {"params": jax.tree.map(np.asarray, variables["params"])}))
    tl = None if lens is None else torch.from_numpy(lens)
    ts = None if state is None else torch.from_numpy(state)
    got = tgru.bigru_from_params(module, torch.from_numpy(x), tl, ts)
    via_state = tgru.bigru_from_params(module.state_dict(),
                                       torch.from_numpy(x), tl, ts)
    with torch.no_grad():
        plain = module(torch.from_numpy(x), tl, ts)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), plain.numpy(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(via_state, got, rtol=0, atol=0)


def test_bigru_gradients_through_module_weights():
    """Gradients reach the ``BiGRU`` module's own parameters through the
    adapter's transposes and equal autograd through the module."""
    rng = np.random.default_rng(3)
    N, T, D, H = 2, 7, 6, 5
    module = BiGRU(D, H)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(
                0.3 * rng.standard_normal(p.shape).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((N, T, D)).astype(np.float32))
    lens = torch.tensor([7, 3])
    names = [n for n, _ in module.named_parameters()]
    (tgru.bigru_from_params(module, x, lens) ** 2).sum().backward()
    got = {n: p.grad.clone() for n, p in module.named_parameters()}
    module.zero_grad()
    (module(x, lens) ** 2).sum().backward()
    for n, p in module.named_parameters():
        torch.testing.assert_close(got[n], p.grad, rtol=1e-4, atol=1e-4,
                                   msg=n)
    assert len(names) == 8


def test_gru_edge_shapes_and_devices():
    """T = 1, N = 1, a zero length and H not a multiple of 32 on the plain
    path; a tensor on neither the CPU nor CUDA is refused."""
    rng = np.random.default_rng(4)
    for N, T, D, H, lengths in ((1, 1, 3, 5, [1]), (3, 4, 7, 37, [0, 4, 2])):
        x = rng.standard_normal((N, T, D)).astype(np.float32)
        h0 = rng.standard_normal((N, H)).astype(np.float32)
        w = _weights(rng, D, H)
        lens = np.asarray(lengths, np.int32)
        want = np.asarray(jgru.gru_sequence_ntd(
            jnp.asarray(x), jnp.asarray(h0), *map(jnp.asarray, w),
            jnp.asarray(lens), interpret=True))
        got = tgru.gru_sequence_ntd(*_t(x, h0, *w), torch.from_numpy(lens))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    meta = torch.empty((2, 3, 4), device="meta")
    with pytest.raises(ValueError):
        tgru.gru_sequence(meta, torch.empty((3, 5), device="meta"),
                          torch.empty((9, 10), device="meta"),
                          torch.empty((10,), device="meta"),
                          torch.empty((9, 5), device="meta"),
                          torch.empty((5,), device="meta"),
                          torch.empty((2, 3), device="meta"))
