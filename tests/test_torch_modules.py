"""Module-level parity of the PyTorch port against the flax modules.

Each flax module is initialized, its parameters (and batch statistics) are
replaced by seeded random values, and the same tree is carried into the
port's module through ``params.from_flax``; both see the same numpy inputs.
Tolerance: 1e-5 absolute and relative, float32 on both sides (only the
summation order of the products differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.models import modules as jm
from tacotron_tpu.ops import attention as ja
from tacotron_tpu.ops import rnn as jr
from tacotron_tpu_torch import params as P
from tacotron_tpu_torch.models import modules as tm
from tacotron_tpu_torch.ops import attention as ta
from tacotron_tpu_torch.ops import rnn as tr

TOL = dict(rtol=1e-5, atol=1e-5)


def _random_tree(variables, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for path, arr in P.flatten_variables(
            jax.tree.map(np.asarray, dict(variables))).items():
        if path.endswith("/var"):
            val = rng.uniform(0.5, 1.5, arr.shape)
        else:
            val = 0.3 * rng.standard_normal(arr.shape)
        out[path] = np.asarray(val, np.float32)
    return P.unflatten_variables(out)


def carry(flax_module, torch_module, *args, seed=0, **kwargs):
    """Init ``flax_module`` on ``args``, randomize its variables, load them
    into ``torch_module``.  Returns (flax variables, eval torch module)."""
    key = jax.random.PRNGKey(0)
    variables = _random_tree(
        flax_module.init({"params": key, "dropout": key}, *args, **kwargs),
        seed)
    torch_module.load_state_dict(P.from_flax(variables))
    return variables, torch_module.eval()


def t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_gru_cell():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 8)).astype(np.float32)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    v, cell = carry(jr.GRUCell(8), tr.GRUCell(5, 8), h, x, seed=1)
    want, _ = jr.GRUCell(8).apply(v, h, x)
    close(cell(t(h), t(x)), want)
    # the sequence path (input projections hoisted) is the same cell
    gx, cx = cell.input_projections(t(x)[:, None])
    close(cell.step_projected(t(h), gx[:, 0], cx[:, 0]), want)


@pytest.mark.parametrize("lengths,init_state", [
    (None, False), ([9, 4, 1], False), ([9, 6, 9], True), (None, True)],
    ids=["full", "lengths", "lengths+init", "full+init"])
def test_bigru(lengths, init_state):
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((3, 9, 6)).astype(np.float32)
    init = (rng.standard_normal((3, 14)).astype(np.float32)
            if init_state else None)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    v, mod = carry(jr.BiGRU(7), tr.BiGRU(6, 7), xs, lens, init, seed=2)
    want = jr.BiGRU(7).apply(v, xs, lens, init)
    close(mod(t(xs), None if lens is None else t(lens).long(), t(init)), want)


@pytest.mark.parametrize("kind", ["bah_mon", "bah", "bah_norm", "luong",
                                  "luong_scaled"])
def test_attention_mechanisms(kind):
    rng = np.random.default_rng(2)
    N, T, U = 2, 11, 12
    query = rng.standard_normal((N, U)).astype(np.float32)
    keys = rng.standard_normal((N, T, U)).astype(np.float32)
    prev = rng.dirichlet(np.ones(T), N).astype(np.float32)
    v, mod = carry(ja.make_attention(kind, U), ta.make_attention(kind, U, U),
                   query, keys, prev, seed=3)
    want = ja.make_attention(kind, U).apply(v, query, keys, prev)
    close(mod(t(query), t(keys), t(prev)), want)
    close(ta.initial_alignments(kind, N, T),
          ja.initial_alignments(kind, N, T))


def test_prenet_eval():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 9)).astype(np.float32)
    v, mod = carry(jm.Prenet((16, 8), 0.5), tm.Prenet(9, (16, 8), 0.5), x,
                   False, seed=4)
    close(mod(t(x)), jm.Prenet((16, 8), 0.5).apply(v, x, False))


def test_highway():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 10)).astype(np.float32)
    v, mod = carry(jm.HighwayNet(), tm.HighwayNet(10), x, seed=5)
    close(mod(t(x)), jm.HighwayNet().apply(v, x))


@pytest.mark.parametrize("bank_size", [3, 4], ids=["odd", "even"])
def test_conv_bank(bank_size):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 13, 6)).astype(np.float32)
    v, mod = carry(jm.ConvBank(bank_size, 5), tm.ConvBank(6, bank_size, 5),
                   x, seed=6)
    close(mod(t(x)), jm.ConvBank(bank_size, 5).apply(v, x))


@pytest.mark.parametrize("width", [3, 4])
def test_conv1d(width):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 13, 6)).astype(np.float32)
    v, mod = carry(jm.Conv1d(width, 7), tm.Conv1d(6, 7, width), x, seed=7)
    close(mod(t(x)), jm.Conv1d(width, 7).apply(v, x))


@pytest.mark.parametrize("width", [2, 3])
def test_max_pool_same(width):
    x = np.random.default_rng(7).standard_normal((2, 9, 4)).astype(
        np.float32)
    close(tm.max_pool_same(t(x), width), jm.max_pool_same(jnp.asarray(x),
                                                         width))


@pytest.mark.parametrize("rnn_size,lengths,speaker", [
    (10, [11, 6], False), (8, [11, 11], True), (10, None, False)],
    ids=["encoder", "dim_fix+speaker", "postnet"])
def test_cbhg(rnn_size, lengths, speaker):
    """CBHG in inference (running statistics), with the highway dim fix,
    the speaker bias and the BiGRU initial state."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 11, 10)).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    bh = rng.standard_normal((2, 10)).astype(np.float32) if speaker else None
    init = (rng.standard_normal((2, 2 * rnn_size)).astype(np.float32)
            if speaker else None)
    args = (4, 6, 2, 2, rnn_size, (12, 10), 3)
    flax_mod = jm.CBHG(*args)
    v, mod = carry(flax_mod, tm.CBHG(10, *args), x, lens, True, bh, init,
                   seed=9)
    want = flax_mod.apply(v, x, lens, False, bh, init)
    got = mod(t(x), None if lens is None else t(lens).long(), t(bh),
              t(init))
    close(got, want)
