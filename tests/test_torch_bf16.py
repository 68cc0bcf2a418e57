"""bfloat16 compute (``ModelConfig.compute_dtype="bfloat16"``): the port
against the JAX package's bf16 program under ``jax.jit``, on the CPU at
small widths, with the weights carried over by ``params.from_flax``.

XLA keeps or drops bf16 roundings inside a fusion as it sees fit, so the
port (which rounds after every op, as JAX's source reads) can only be held
to the compiled program within a few roundings.  A bf16 ulp here is
``ulp(p) = 2 ** (floor(log2 p) - 7)`` at the peak ``p`` of the reference.

- Modules (Prenet, HighwayNet, ConvBank, Conv1d, BatchNorm in both modes,
  CBHG, GRUCell, BiGRU, the five attention mechanisms): the output's dtype
  equals JAX's, and the values lie within ``MODULE_ULPS`` (4) ulps of the
  output's peak (measured: at most 2).  The BiGRU's split products
  (float32 partial sums, rounded once a step) are held to the same bound
  as the rest.
- The dtype audit: forward hooks on every port module that has a flax
  counterpart of the same path (``capture_intermediates``) see the dtype
  JAX's module returns; the model's outputs are float32.
- The whole model over ``tests/test_torch_model.py``'s ``CASES``,
  teacher-forced and greedy at 4 steps: mel and linear within 3 % of
  JAX's float32 peak of the bf16 program, alignments within 1e-2; and the
  port's distance from JAX's float32 output at most twice JAX's own bf16
  distance from it plus one ulp of the peak.  ``bah_norm`` has no bf16
  program in JAX (its float32 score changes the decode scan's carry dtype
  and the scan refuses to trace); the port refuses it at construction.
- The train step against JAX's bf16 step, guided attention off and on:
  loss rel 1e-2, gradient global norm rel 2e-2, parameters and Adam state
  float32.  Per leaf, the gradient's cosine with JAX's, over every leaf
  that carries at least 1e-3 of the global gradient norm (the two conv
  biases ahead of a training-mode BatchNorm carry ~5e-5: their exact
  gradient is 0, so what remains is rounding), is held to
  ``LEAF_COSINE`` = 0.934 and each leaf's difference to ``LEAF_DIFF`` =
  0.0217 of the global norm: twice JAX's own spread, its jitted step
  against the same step under ``jax.disable_jit`` (``python
  tests/bf16_spread.py``, both cases), which reaches a cosine of 0.9671
  (``post_cbhg/proj_1/bias``) and a leaf difference of 0.01086 of the
  norm.  A cosine of 0.99 does not hold against that spread.  The
  encoder's front (conv bank, ``bank_bn``, ``proj_1``) is held tighter,
  to ``FRONT_COSINE`` = 0.9933, twice JAX's spread there (0.99669;
  measured 0.9972-0.9998).  It lay at 0.976-0.99 while the port's
  ``linear`` and ``conv1d`` added the bias inside the bf16 product
  (rounded once): JAX rounds the product, then adds the bias, in its
  jitted and eager programs alike, and the one-ulp difference entered at
  the encoder prenet and moved the front's max pool and BatchNorm.
- The encoder's front stage by stage (conv bank, ReLU, ``bank_bn``, max
  pool, ``proj_1``), each fed JAX's bf16 input and JAX's cotangent at its
  output from the jitted front: outputs bit-equal (``STAGE_ULPS`` = 0),
  gradients within ``STAGE_COSINE`` = 0.9999 (measured >= 0.99997).
- ``Config.tpu_recommended`` equals JAX's field by field; ``--preset tpu``
  applies it before ``--batch_size``; ``--scan_unroll`` stays refused.
- ``Synthesizer.load`` of a bf16 run directory synthesizes on the CPU, with
  manual attention, equal to the port's model called directly and within
  the model bound of JAX's bf16 model given the same alignments.
- ``utils.parallel_run`` and ``str2bool`` against the JAX functions.
"""

import dataclasses
import json
import os
import subprocess
import sys

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
from test_torch_modules import carry

BF16 = jnp.bfloat16
MODULE_ULPS = 4
LEAF_COSINE = 0.934
LEAF_DIFF = 0.0217
#: the gradient leaves of the encoder CBHG's front, held to FRONT_COSINE:
#: twice JAX's own jit-vs-eager spread there (0.99669 at
#: ``encoder_cbhg/conv_bank/kernel_4``, ``python tests/bf16_spread.py``)
FRONT = ("params/encoder_cbhg/conv_bank/", "params/encoder_cbhg/bank_bn/",
         "params/encoder_cbhg/proj_1/")
FRONT_COSINE = 0.9933


def ulp(peak: float) -> float:
    """One bf16 ulp at ``peak``."""
    return 2.0 ** (np.floor(np.log2(peak)) - 7)


def jb(x):
    """A float32 numpy array as a JAX bf16 array (None passes)."""
    return None if x is None else jnp.asarray(x).astype(BF16)


def tb(x):
    """A float32 numpy array as a torch bf16 tensor (None passes)."""
    return None if x is None else torch.from_numpy(np.asarray(x)).bfloat16()


def held(got: torch.Tensor, want, what: str, ulps: int = MODULE_ULPS):
    """``got`` (port) against ``want`` (JAX): the same dtype, and within
    ``ulps`` bf16 ulps of the peak of ``want``.  Returns the deviation in
    ulps."""
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), \
        (what, got.dtype, want.dtype)
    w = want.astype(np.float32)
    err = float(np.abs(got.detach().float().numpy() - w).max())
    peak = float(np.abs(w).max())
    n = err / ulp(peak) if peak > 0 else err
    assert n <= ulps, f"{what}: {err} = {n:.2f} ulps of the peak {peak}"
    print(f"{what}: {n:.2f} ulps")
    return n


def jit_apply(module, variables, *args, mutable=False):
    """``module.apply`` under ``jax.jit``; array arguments are traced,
    the others (flags, None) are static."""
    dynamic = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]

    def fn(v, *arrays):
        full = list(args)
        for i, a in zip(dynamic, arrays):
            full[i] = a
        if mutable:
            return module.apply(v, *full, mutable=["batch_stats"])
        return module.apply(v, *full)

    return jax.jit(fn)(variables, *(args[i] for i in dynamic))


# ------------------------------------------------- encoder front, staged

#: the encoder CBHG's front, stage by stage (``encoder_cbhg``'s conv bank,
#: ReLU, ``bank_bn`` in training mode, the max pool and ``proj_1``) at the
#: SMALL encoder's widths
FRONT_STAGES = ("conv_bank", "relu", "bank_bn", "max_pool", "proj_1")
#: a stage's output within this many bf16 ulps of its peak, given JAX's
#: input to that stage: bit-equal (with the bias added inside the product,
#: rounded once, the conv bank and ``proj_1`` were 1 ulp off)
STAGE_ULPS = 0
#: a stage's gradients (its input's, its parameters') against the jitted
#: JAX front's, given JAX's cotangent at its output (measured: >= 0.99999)
STAGE_COSINE = 0.9999


def _front_jax(cbhg_vars, x, cot):
    """The jitted JAX front: each stage's input and output and, from one
    vjp with ``cot`` at ``proj_1``'s output, the cotangent at each stage's
    output (read as the gradient of a zero added there) and the parameter
    gradients."""
    params, stats = cbhg_vars["params"], cbhg_vars["batch_stats"]

    def front(p, x, zeros):
        acts = [x]
        y = jm.ConvBank(4, 16).apply({"params": p["conv_bank"]}, x)
        acts.append(y + zeros[0])
        acts.append(jax.nn.relu(acts[-1]) + zeros[1])
        y, _ = jm.BatchNorm().apply(
            {"params": p["bank_bn"], "batch_stats": stats["bank_bn"]},
            acts[-1], True, mutable=["batch_stats"])
        acts.append(y + zeros[2])
        acts.append(jm.max_pool_same(acts[-1], 2) + zeros[3])
        acts.append(jm.Conv1d(3, 16).apply({"params": p["proj_1"]},
                                           acts[-1]) + zeros[4])
        return acts

    def run(p, x, cot):
        acts = front(p, x, [jnp.zeros((), BF16)] * 5)
        zeros = [jnp.zeros_like(a) for a in acts[1:]]

        def out(p, x, zeros):
            return front(p, x, zeros)[-1]

        _, vjp = jax.vjp(out, p, x, zeros)
        gp, gx, gz = vjp(cot)
        return acts, gp, [gx] + list(gz)

    return jax.jit(run)(params, x, cot)


def test_encoder_front_stage_by_stage():
    """Each stage of the encoder's front fed JAX's bf16 activation at its
    input and JAX's cotangent at its output, against the jitted JAX front:
    the port rounds where XLA rounds (each product rounded before its bias
    is added, ``ops/cast.py``), so the outputs lie within STAGE_ULPS and the
    gradients within STAGE_COSINE."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((3, 12, 16)).astype(np.float32)
    cot = rng.standard_normal((3, 12, 16)).astype(np.float32)
    flax_mod = jm.CBHG(4, 16, 2, 2, 16, (16, 16), 3)
    v, mod = carry(flax_mod, tm.CBHG(16, 4, 16, 2, 2, 16, (16, 16), 3), x,
                   None, True, seed=32)
    mod.train()
    acts, gp, gacts = _front_jax(v, jb(x), jb(cot))
    stages = {"conv_bank": mod.conv_bank, "relu": torch.relu,
              "bank_bn": mod.bank_bn,
              "max_pool": lambda y: tm.max_pool_same(y, 2),
              "proj_1": mod.proj_1}
    flat_gp = P.flatten_variables({"params": gp})
    for i, name in enumerate(FRONT_STAGES):
        a = torch.from_numpy(np.asarray(acts[i], np.float32)).bfloat16()
        a.requires_grad_(True)
        mod.zero_grad()
        out = stages[name](a)
        held(out, acts[i + 1], f"front {name}", ulps=STAGE_ULPS)
        out.backward(torch.from_numpy(np.asarray(gacts[i + 1], np.float32))
                     .bfloat16())
        got = {"input": a.grad}
        if name in ("conv_bank", "bank_bn", "proj_1"):
            # the stage's state dict with its parameters' gradients, in
            # flax's names
            sd = {f"{name}.{k}": t for k, t in
                  getattr(mod, name).state_dict().items()}
            sd.update({f"{name}.{k}": p.grad for k, p in
                       getattr(mod, name).named_parameters()})
            got.update({k: g for k, g in P.flatten_variables(
                P.to_flax(sd)).items() if k.startswith("params/")})
        want = {"input": gacts[i]}
        want.update({k: w for k, w in flat_gp.items()
                     if k.startswith(f"params/{name}/")})
        assert set(got) == set(want), (name, sorted(got), sorted(want))
        for key, w in want.items():
            a64 = np.asarray(w, np.float64).ravel()
            g = got[key]
            if isinstance(g, torch.Tensor):
                g = g.detach().double().numpy()
            b64 = np.asarray(g, np.float64).ravel()
            cos = float(a64 @ b64 / (np.linalg.norm(a64)
                                     * np.linalg.norm(b64)))
            assert cos >= STAGE_COSINE, (name, key, cos)
            print(f"front {name} gradient {key}: cosine {cos:.6f}")


# ------------------------------------------------------------------ modules

def test_prenet_and_highway():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 9)).astype(np.float32)
    v, mod = carry(jm.Prenet((16, 8), 0.5), tm.Prenet(9, (16, 8), 0.5), x,
                   False, seed=4)
    held(mod(tb(x)), jit_apply(jm.Prenet((16, 8), 0.5), v, jb(x), False),
         "prenet")
    x = rng.standard_normal((2, 5, 10)).astype(np.float32)
    v, mod = carry(jm.HighwayNet(), tm.HighwayNet(10), x, seed=5)
    held(mod(tb(x)), jit_apply(jm.HighwayNet(), v, jb(x)), "highway")


@pytest.mark.parametrize("bank_size", [3, 4], ids=["odd", "even"])
def test_conv_bank_and_conv1d(bank_size):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 13, 6)).astype(np.float32)
    v, mod = carry(jm.ConvBank(bank_size, 5), tm.ConvBank(6, bank_size, 5),
                   x, seed=6)
    held(mod(tb(x)), jit_apply(jm.ConvBank(bank_size, 5), v, jb(x)),
         "conv bank")
    v, mod = carry(jm.Conv1d(bank_size, 7), tm.Conv1d(6, 7, bank_size), x,
                   seed=7)
    held(mod(tb(x)), jit_apply(jm.Conv1d(bank_size, 7), v, jb(x)), "conv1d")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm(train):
    """Statistics in float32 from the bf16 input, normalization in float32,
    the output in bf16; in training mode the moved running statistics
    stay float32 and equal flax's (1e-6)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 12)) * 2.0 + 0.5).astype(np.float32)
    v, bn = carry(jm.BatchNorm(), tm.BatchNorm(12), x, False, seed=8)
    bn.train(train)
    if train:
        want, mutated = jit_apply(jm.BatchNorm(), v, jb(x), True,
                                  mutable=True)
    else:
        want = jit_apply(jm.BatchNorm(), v, jb(x), False)
    held(bn(tb(x)), want, f"batchnorm train={train}")
    if train:
        stats = mutated["batch_stats"]["BatchNorm_0"]
        assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=1e-6)


@pytest.mark.parametrize("rnn_size,lengths,speaker,train", [
    (10, [11, 6], False, False), (8, [11, 11], True, False),
    (10, None, False, True)],
    ids=["encoder", "dim_fix+speaker", "postnet-train"])
def test_cbhg(rnn_size, lengths, speaker, train):
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
    mod.train(train)
    want = jit_apply(flax_mod, v, jb(x), None if lens is None
                     else jnp.asarray(lens), train, jb(bh), jb(init),
                     mutable=train)
    if train:
        want = want[0]
    got = mod(tb(x), None if lens is None else torch.from_numpy(lens),
              tb(bh), tb(init))
    held(got, want, "cbhg")


def test_gru_cell():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 8)).astype(np.float32)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    v, cell = carry(jr.GRUCell(8), tr.GRUCell(5, 8), h, x, seed=1)
    want, _ = jit_apply(jr.GRUCell(8), v, jb(h), jb(x))
    held(cell(tb(h), tb(x)), want, "gru cell")
    # the split form (input projections hoisted, float32 partial sums)
    gx, cx = cell.input_projections(tb(x)[:, None])
    assert gx.dtype == cx.dtype == torch.float32
    held(cell.step_projected(tb(h), gx[:, 0], cx[:, 0]), want,
         "gru cell, split products")


@pytest.mark.parametrize("lengths,init_state", [
    (None, False), ([9, 4, 1], False), ([9, 6, 9], True)],
    ids=["full", "lengths", "lengths+init"])
def test_bigru(lengths, init_state):
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((3, 9, 6)).astype(np.float32)
    init = (rng.standard_normal((3, 14)).astype(np.float32)
            if init_state else None)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    v, mod = carry(jr.BiGRU(7), tr.BiGRU(6, 7), xs, lens, init, seed=2)
    want = jit_apply(jr.BiGRU(7), v, jb(xs),
                     None if lens is None else jnp.asarray(lens), jb(init))
    got = mod(tb(xs), None if lens is None else torch.from_numpy(lens),
              tb(init))
    held(got, want, "bigru")


@pytest.mark.parametrize("kind", ["bah_mon", "bah", "bah_norm", "luong",
                                  "luong_scaled"])
def test_attention_mechanisms(kind):
    """In bf16 (``bah_norm``: its float32 score and alignments, as JAX's),
    and the initial alignments in the memory's dtype."""
    rng = np.random.default_rng(2)
    N, T, U = 2, 11, 12
    query = rng.standard_normal((N, U)).astype(np.float32)
    keys = rng.standard_normal((N, T, U)).astype(np.float32)
    prev = rng.dirichlet(np.ones(T), N).astype(np.float32)
    v, mod = carry(ja.make_attention(kind, U), ta.make_attention(kind, U, U),
                   query, keys, prev, seed=3)
    want = jit_apply(ja.make_attention(kind, U), v, jb(query), jb(keys),
                     jb(prev))
    held(mod(tb(query), tb(keys), tb(prev)), want, kind)
    got0 = ta.initial_alignments(kind, N, T, dtype=torch.bfloat16)
    held(got0, ja.initial_alignments(kind, N, T, BF16), "initial", ulps=0)


def test_exclusive_cumprod_matches_jit():
    """The monotonic recurrence's log-space cumulative product in bf16."""
    x = np.random.default_rng(4).uniform(0.05, 1.0, (3, 40)).astype(
        np.float32)
    want = jax.jit(ja._safe_exclusive_cumprod)(jb(x))
    held(ta.safe_exclusive_cumprod(tb(x)), want, "exclusive cumprod")


# --------------------------------------------------------------- dtype audit

def _dtypes(out) -> set:
    """The dtype names of the array leaves of a module's output."""
    leaves = (jax.tree.leaves(out) if not isinstance(out, torch.Tensor)
              else [out])
    if isinstance(out, (tuple, list, dict)) and any(
            isinstance(x, torch.Tensor) for x in jax.tree.leaves(out)):
        leaves = [x for x in jax.tree.leaves(out)
                  if isinstance(x, torch.Tensor)]
    return {str(x.dtype).split(".")[-1] for x in leaves
            if hasattr(x, "dtype")}


def test_dtype_audit_against_flax():
    """Every port module whose path has a flax counterpart returns what
    JAX's module returns: bf16 activations, float32 embeddings and speaker
    layers, float32 model outputs.  The decoder's modules, which flax does
    not capture inside its scan, are held to one ``DecoderStep`` applied on
    a bf16 carry."""
    from tacotron_tpu.config import ModelConfig
    from tacotron_tpu.models.tacotron import (DecoderCarry, DecoderStep,
                                              Tacotron)
    from tacotron_tpu_torch.config import ModelConfig as TorchModelConfig
    from tacotron_tpu_torch.models.tacotron import Tacotron as TorchTacotron
    from test_torch_params import model_config, random_variables

    kw = model_config("deepvoice", 16)
    variables = random_variables(ModelConfig(**kw), 1)
    cfg = ModelConfig(**kw, compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    N, T_in = 2, 12
    inputs = rng.integers(0, 80, (N, T_in)).astype(np.int32)
    lengths = np.asarray([12, 9], np.int32)
    mels = rng.uniform(0, 1, (N, 8, cfg.num_mels)).astype(np.float32)
    spk = np.asarray([0, 2], np.int32)
    _, state = Tacotron(cfg).apply(
        variables, inputs, lengths, speaker_id=spk, mel_targets=mels,
        capture_intermediates=True, mutable=["intermediates"])
    want = {}

    def collect(tree, prefix):
        for name, node in tree.items():
            if name == "__call__":
                want[prefix] = _dtypes(node[0])
            else:
                collect(node, f"{prefix}/{name}" if prefix else name)

    collect(state["intermediates"], "")
    memory_dim = 2 * cfg.enc_rnn_size
    bf = jnp.bfloat16
    carry = DecoderCarry(
        attn_state=jnp.zeros((N, cfg.attention_state_size), bf),
        context=jnp.zeros((N, memory_dim), bf),
        alignments=ja.initial_alignments(cfg.attention_type, N, T_in, bf),
        dec_states=tuple(jnp.zeros((N, cfg.dec_rnn_size), bf)
                         for _ in range(cfg.dec_layer_num)),
        prev_frame=jnp.zeros((N, cfg.num_mels), bf),
        keys=jb(rng.standard_normal((N, T_in, cfg.attention_size))),
        values=jb(rng.standard_normal((N, T_in, memory_dim))),
        speaker=(), is_manual=None)
    _, dec_state = DecoderStep(cfg, greedy=False, train=False).apply(
        {"params": variables["params"]["decoder"]}, carry,
        (jb(mels[:, 0]), None), capture_intermediates=True,
        mutable=["intermediates"])
    collect(dec_state["intermediates"], "decoder")

    port = TorchTacotron(TorchModelConfig(**kw, compute_dtype="bfloat16"))
    port.load_state_dict(P.from_flax(variables))
    port.eval()
    seen = {}

    def hook(name):
        def record(module, args, out):
            seen.setdefault(name.replace(".", "/"), _dtypes(out))
        return record

    for name, module in port.named_modules():
        module.register_forward_hook(hook(name))
    with torch.no_grad():
        port(torch.from_numpy(inputs).long(), torch.from_numpy(lengths),
             torch.from_numpy(spk).long(),
             mel_targets=torch.from_numpy(mels))
    common = sorted(set(seen) & set(want))
    assert {"", "char_embedding", "speaker_embedding", "encoder_prenet",
            "encoder_cbhg/bank_bn", "encoder_cbhg/bigru",
            "attention_memory_layer", "decoder", "decoder/prenet/dense_1",
            "decoder/attention_rnn", "decoder/attention",
            "decoder/decoder_rnn_1", "decoder/frame_projection",
            "post_cbhg/highway_dim_fix", "linear_projection"} <= set(common)
    assert len(common) >= 50, common
    wrong = {k: (seen[k], want[k]) for k in common if seen[k] != want[k]}
    assert not wrong, wrong
    assert want[""] == {"float32"}
    assert want["encoder_cbhg"] == want["decoder"] == {"bfloat16"}


# --------------------------------------------------------------- train step

def _leaf_stats(got: dict, want: dict):
    """(min cosine over leaves carrying >= 1e-3 of the global norm, max
    leaf difference over the global norm) of two flat gradient trees."""
    norm = np.sqrt(sum(float(np.sum(np.asarray(w, np.float64) ** 2))
                       for w in want.values()))
    cosines, diffs = {}, {}
    for k, w in want.items():
        a = np.asarray(w, np.float64).ravel()
        b = np.asarray(got[k], np.float64).ravel()
        diffs[k] = float(np.linalg.norm(a - b)) / norm
        if np.linalg.norm(a) >= 1e-3 * norm:
            cosines[k] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return cosines, diffs


def bf16_step_pair(guided: bool, jit: bool = True):
    """The JAX and the port's bf16 train step from the same weights and
    batch (``tests/test_torch_train_step.py``'s): (JAX metrics, JAX Adam
    first moments, port metrics, port first moments, port state).  With
    ``jit=False`` the JAX step runs under ``jax.disable_jit``."""
    from tacotron_tpu.train.optim import make_optimizer
    from tacotron_tpu.train.state import TrainState
    from tacotron_tpu.train.step import Batch, make_train_step
    from tacotron_tpu_torch.config import Config as TorchConfig
    from tacotron_tpu_torch.train import step as port_step
    from tacotron_tpu_torch.train.optim import AdamState
    from tacotron_tpu_torch.train.state import TrainState as PortState
    from tacotron_tpu_torch.train.state import create_model
    from test_torch_params import random_variables
    from test_torch_train_step import _batch, _configs

    cfg, _ = _configs(guided)
    variables = random_variables(cfg.model, 21)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bfloat16"))
    tcfg = TorchConfig.from_json(cfg.to_json())
    batch = _batch(cfg, 22)
    opt = make_optimizer(cfg.train, True)
    j_state = TrainState(
        step=jnp.asarray(3, jnp.int32),
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=opt.init(variables["params"]))
    j_batch = Batch(*(None if x is None else jnp.asarray(x) for x in batch))
    step = make_train_step(cfg)
    if jit:
        j_new, j_metrics = step(j_state, j_batch, jax.random.PRNGKey(0))
    else:
        with jax.disable_jit():
            j_new, j_metrics = step(j_state, j_batch, jax.random.PRNGKey(0))
    j_m = P.flatten_variables({"params": j_new.opt_state[1].mu})

    model = create_model(tcfg)
    model.load_state_dict(P.from_flax(variables))
    state = PortState(step=3, model=model.train(),
                      opt=AdamState.zeros(list(model.parameters())))
    state, metrics = port_step.make_train_step(tcfg)(
        state, port_step.batch_to_device(port_step.Batch(*batch), "cpu"), 0)
    names = [n for n, _ in state.model.named_parameters()]
    moments = dict(state.model.state_dict())
    moments.update(zip(names, state.opt.m))
    p_m = {k: v for k, v in P.flatten_variables(P.to_flax(moments)).items()
           if k.startswith("params/")}
    return j_metrics, j_m, metrics, p_m, state


@pytest.mark.parametrize("guided", [False, True],
                         ids=["plain", "guided-annealed"])
def test_bf16_train_step_matches_jax(guided):
    j_metrics, j_m, metrics, p_m, state = bf16_step_pair(guided)
    assert set(metrics) == set(j_metrics)
    for key, rel in (("loss", 1e-2), ("grad_norm", 2e-2)):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(j_metrics[key]), rtol=rel,
                                   err_msg=key)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(b.dtype == torch.float32 for b in state.model.buffers())
    assert all(t.dtype == torch.float32 for t in state.opt.m + state.opt.v)
    assert set(p_m) == set(j_m)
    # the first moments are (1 - b1) times the clipped gradients on both
    # sides: their cosines and their differences over the global norm are
    # the gradients'
    cosines, diffs = _leaf_stats(p_m, j_m)
    assert len(cosines) >= len(j_m) - 2, sorted(set(j_m) - set(cosines))
    worst = min(cosines, key=cosines.get)
    assert cosines[worst] >= LEAF_COSINE, (worst, cosines[worst])
    front = {k: c for k, c in cosines.items() if k.startswith(FRONT)}
    assert len(front) == 9, sorted(front)
    low = min(front, key=front.get)
    assert front[low] >= FRONT_COSINE, (low, front[low])
    widest = max(diffs, key=diffs.get)
    assert diffs[widest] <= LEAF_DIFF, (widest, diffs[widest])


# ------------------------------------------------------------ config and CLI

def test_tpu_recommended_matches_jax():
    """Field by field (the JSON) and the debug dump, on the defaults and on
    a base config with another batch, as ``tests/test_config.py`` checks
    the JAX preset."""
    from tacotron_tpu.config import Config
    from tacotron_tpu_torch.config import Config as TorchConfig

    for batch in (32, 64):
        base = Config().replace(data=dataclasses.replace(
            Config().data, cleaners="english_cleaners", min_tokens=5))
        want = Config.tpu_recommended(base, batch_size=batch)
        got = TorchConfig.tpu_recommended(
            TorchConfig.from_json(base.to_json()), batch_size=batch)
        assert json.loads(got.to_json()) == json.loads(want.to_json())
        assert got.debug_string() == want.debug_string()
        assert TorchConfig.from_json(got.to_json()) == got
    assert json.loads(TorchConfig.tpu_recommended().to_json()) == \
        json.loads(Config.tpu_recommended().to_json())


def _cli_args(**kw):
    import argparse
    base = dict(config=None, preset=None, model_type=None, batch_size=None,
                on_device_features=False, device_resident=False,
                guided_attention_weight=None,
                guided_attention_decay_steps=None)
    return argparse.Namespace(**dict(base, **kw))


def test_preset_tpu_before_the_other_flags():
    """``--preset tpu`` applies the preset to the loaded config, then the
    flags (``--batch_size`` wins), in ``train.py``'s order."""
    from tacotron_tpu.config import Config
    from tacotron_tpu_torch.train.__main__ import build_config

    dirs = ["a/data", "b/data"]
    want = Config.tpu_recommended(Config())
    want = want.replace(model=dataclasses.replace(
        want.model, num_speakers=2, model_type="deepvoice"))
    got = build_config(_cli_args(preset="tpu"), dirs)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    got = build_config(_cli_args(preset="tpu", batch_size=8), dirs)
    assert got.train.batch_size == 8
    assert got.model.compute_dtype == "bfloat16"
    assert got.train.on_device_features and got.data.store_waveform


def test_cli_preset_tpu_trains_in_bf16(tmp_path, monkeypatch):
    """The CLI with ``--preset tpu`` on a corpus that stores waveforms: a
    bf16 run whose ``config.json`` reads the preset with the batch flag on
    top; ``--scan_unroll`` and a preset other than ``tpu`` are refused."""
    from tacotron_tpu_torch.config import Config, save_config
    from tacotron_tpu_torch.data import synthetic
    from tacotron_tpu_torch.train.__main__ import main
    from tacotron_tpu_torch.utils import read_metrics
    from test_torch_params import SMALL

    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    base = Config()
    cfg = base.replace(
        audio=dataclasses.replace(base.audio, num_freq=129, num_mels=10,
                                  sample_rate=8000, frame_length_ms=25.0),
        model=base.model.__class__(**dict(
            SMALL, num_mels=10, num_freq=129, reduction_factor=4)),
        train=dataclasses.replace(base.train, test_interval=100,
                                  checkpoint_interval=100))
    monkeypatch.setattr(synthetic, "PER_SPEAKER", 8)
    monkeypatch.setattr(synthetic, "FRAMES", (120, 180))
    dirs = synthetic.write_synthetic_corpus(str(tmp_path / "corpus"), cfg)
    save_config(cfg, str(tmp_path / "cfg.json"))
    args = ["--data_paths", ",".join(dirs), "--config",
            str(tmp_path / "cfg.json"), "--log_dir", str(tmp_path / "logs"),
            "--device", "cpu"]
    for bad in (["--preset", "gpu"], ["--scan_unroll", "8"]):
        with pytest.raises(SystemExit):
            main(args + bad)
    assert not (tmp_path / "logs").exists()
    main(args + ["--preset", "tpu", "--batch_size", "2", "--num_steps", "2",
                 "--sync_every", "1"])
    [run] = os.listdir(tmp_path / "logs")
    run = tmp_path / "logs" / run
    saved = json.loads((run / "config.json").read_text())
    assert saved["model"]["compute_dtype"] == "bfloat16"
    assert saved["model"]["decoder_unroll"] == 8
    assert saved["train"]["batch_size"] == 2
    assert saved["train"]["on_device_features"] is True
    losses = [r["loss"] for r in read_metrics(str(run / "metrics.jsonl"),
                                              "train")]
    assert len(losses) == 2 and np.isfinite(losses).all()


# ------------------------------------------------------------------ serving

def test_synthesizer_load_bf16_run_dir_with_manual_attention(tmp_path):
    from tacotron_tpu.config import Config
    from tacotron_tpu.models.tacotron import Tacotron
    from tacotron_tpu_torch.config import Config as TorchConfig
    from tacotron_tpu_torch.config import save_config
    from tacotron_tpu_torch.synth.synthesizer import Synthesizer
    from tacotron_tpu_torch.text import text_to_sequence
    from test_torch_params import random_variables
    from test_torch_synth import AUDIO, MODEL, TEXTS

    cfg = Config.from_dict({"audio": AUDIO, "model": dict(
        MODEL, compute_dtype="bfloat16")})
    variables = random_variables(Config.from_dict({"model": MODEL}).model, 5)
    run = tmp_path / "run"
    (run / "checkpoints" / "0").mkdir(parents=True)
    save_config(TorchConfig.from_json(cfg.to_json()),
                str(run / "config.json"))
    np.savez(run / "checkpoints" / "0" / "variables.npz",
             **P.flatten_variables(variables))
    synth = Synthesizer(device="cpu").load(str(run))
    assert synth.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in synth.model.parameters())

    steps, speakers = 4, [0, 1, 0]
    seqs = [text_to_sequence(t, list(synth.cleaner_names())) for t in TEXTS]
    rng = np.random.default_rng(3)
    manual = np.stack([rng.dirichlet(np.ones(32), steps).T
                       for _ in TEXTS]).astype(np.float32)  # [N, T_in, T_dec]
    res = synth.synthesize(sequences=seqs, speaker_ids=speakers,
                           max_steps=steps, manual_alignments=manual,
                           attention_trim=False, librosa_trim=False)
    rounded = torch.from_numpy(manual).bfloat16().float().numpy()
    for i, (wav, al) in enumerate(zip(res["wavs"], res["alignments"])):
        assert wav.size > 0 and np.isfinite(wav).all()
        assert np.abs(wav).max() > 0
        np.testing.assert_array_equal(al, rounded[i, :al.shape[0]])

    # the spectrograms: the synthesizer's decode is the model's, and within
    # the model bounds of JAX's bf16 model given the bf16 alignments
    spec = synth.synthesize(sequences=seqs, speaker_ids=speakers,
                            max_steps=steps, manual_alignments=manual,
                            attention_trim=False, vocode="none")["linear"]
    inputs = np.zeros((len(seqs), 32), np.int64)
    for i, s in enumerate(seqs):
        inputs[i, :len(s)] = s
    lengths = np.asarray([len(s) for s in seqs])
    man = np.transpose(manual, (0, 2, 1))
    with torch.no_grad():
        direct = synth.model(torch.from_numpy(inputs),
                             torch.from_numpy(lengths),
                             torch.tensor(speakers), max_steps=steps,
                             manual_alignments=torch.from_numpy(man),
                             is_manual=torch.tensor(True))["linear_outputs"]
    want = jax.jit(lambda v: Tacotron(cfg.model).apply(
        v, inputs.astype(np.int32), lengths.astype(np.int32),
        speaker_id=np.asarray(speakers, np.int32), max_steps=steps,
        manual_alignments=jnp.asarray(man).astype(BF16),
        is_manual=jnp.asarray(True)))(variables)["linear_outputs"]
    for i, s in enumerate(spec):
        np.testing.assert_array_equal(s, direct[i, :s.shape[0]].numpy())
        w = np.asarray(want[i, :s.shape[0]])
        assert float(np.abs(s - w).max()) <= 0.03 * float(np.abs(w).max())


# -------------------------------------------------------------------- utils

def test_parallel_run_and_str2bool_match_jax():
    from tacotron_tpu.utils import parallel_run as jax_parallel_run
    from tacotron_tpu.utils import str2bool as jax_str2bool
    from tacotron_tpu_torch.utils import parallel_run, str2bool

    items = [-3, 1, -2, 5]
    # the pool forks: from a process of its own, as this one runs JAX's
    # threads
    code = ("from tacotron_tpu_torch.utils import parallel_run; "
            f"print(parallel_run(abs, {items}, workers=2))")
    pooled = subprocess.run([sys.executable, "-c", code], check=True,
                            capture_output=True, text=True, timeout=120,
                            cwd=os.path.dirname(os.path.dirname(
                                os.path.abspath(__file__))))
    assert pooled.stdout.strip() == "[3, 1, 2, 5]"
    assert parallel_run(abs, items, parallel=False) == \
        jax_parallel_run(abs, items, parallel=False) == [3, 1, 2, 5]
    assert parallel_run(abs, [-7]) == jax_parallel_run(abs, [-7]) == [7]
    # tests/test_utils.py's cases, and each against the JAX function
    assert str2bool("true") and str2bool("1") and str2bool("Yes")
    assert not str2bool("false") and not str2bool("0")
    for v in ("true", "1", "Yes", "t", "false", "0", "No", "F", True, False):
        assert str2bool(v) == jax_str2bool(v), v
    with pytest.raises(ValueError):
        str2bool("maybe")
