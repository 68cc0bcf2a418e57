"""The port's multi-process layer on the CPU (gloo), at small widths.

- The rank grid: ``rank_grid`` / ``make_mesh`` lay the ranks out as JAX's
  ``make_mesh`` lays out devices, with its error text, and cut the same
  ranks.
- Two processes of data parallelism on ``tests/dp_worker.py``'s tiny
  config (with the guided-attention prior on), 3 steps over a global batch
  of 8 whose rank halves differ in ``max(target_lengths)`` (so in
  ``ref_len``), in decode-step counts and in BatchNorm moments (asserted):
  dropout on, against the port's one-process run over the concatenated
  batch (losses rtol 1e-5, parameters rtol 1e-4 / atol 1e-6, both ranks'
  parameters bit-equal, the eval step's losses rtol 1e-5); dropout 0,
  against the JAX sharded step on the 8 virtual CPU devices
  (``tests/conftest.py``) from the same weights through ``params.py``:
  losses rtol 1e-5, parameters rtol 1e-3 / atol 1e-5, the JAX test's own
  tolerances (``tests/test_multiprocess_dp.py``).  The same launch checks
  that a batch-shape mismatch raises on both ranks and that prewarm on a
  gloo group is refused.
- Sharded synthesis: 2 ranks of ``make_sharded_synthesis`` against the
  port's unsharded computation (rtol 1e-4 / atol 1e-5, the JAX test's
  tolerance) and against JAX's ``make_sharded_synthesis`` on 8 devices
  (alignments 5e-4, waveforms correlated above 0.999 with a std ratio in
  [0.95, 1.05]: the tolerances of ``tests/test_torch_synth.py``, as both
  vocode through bf16 products); the ``"fused"`` refusal.
- A 2 x 2 (data, model) grid of 4 processes: the head split over columns
  by ``shard_params`` against the replicated forward, outputs and
  gradients (2e-5, as ``tests/test_model.py``'s model-axis test), and a
  column count the model axis does not divide raises.
- ``python -m tacotron_tpu_torch.train --distributed`` in two processes with
  the torchrun environment: one run directory, written by rank 0.

The workers are this file run as a script (``python
tests/test_torch_parallel.py JOB OUT``), which imports no JAX; every
subprocess has its own timeout of at most 120 s.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
TIMEOUT = 120
STEPS = 3
N_GLOBAL = 8
T_IN, T_OUT = 12, 24
# rank 0's rows, then rank 1's: the halves differ in max length (ref_len
# 24 against 16) and in decode steps
TARGET_LENGTHS = [20, 15, 11, 9, 13, 10, 8, 6]
INPUT_LENGTHS = [12, 10, 9, 7, 11, 8, 6, 5]


# ------------------------------------------------------------------ workers

def _worker_setup():
    sys.path.insert(0, str(ROOT))
    from tacotron_tpu_torch.parallel import distributed_initialize
    distributed_initialize(device="cpu")
    torch.manual_seed(0)


def _load_model(config, weights):
    from tacotron_tpu_torch import params as P
    from tacotron_tpu_torch.train.state import create_model
    model = create_model(config)
    model.load_state_dict(P.from_flax(P.load_npz(weights)))
    return model


def _state(config, weights):
    from tacotron_tpu_torch.train.optim import AdamState
    from tacotron_tpu_torch.train.state import TrainState
    model = _load_model(config, weights).train()
    return TrainState(step=0, model=model,
                      opt=AdamState.zeros(list(model.parameters())))


def _flat_params(state):
    from tacotron_tpu_torch import params as P
    return P.flatten_variables(P.to_flax(state.model.state_dict()))


def _job_dp(out: Path) -> None:
    import torch.distributed as dist

    from tacotron_tpu_torch.config import load_config
    from tacotron_tpu_torch.parallel import (make_mesh, shard_batch,
                                             shard_params)
    from tacotron_tpu_torch.synth.synthesizer import make_sharded_synthesis
    from tacotron_tpu_torch.train.step import (Batch, make_eval_step,
                                               make_train_step)

    rank = dist.get_rank()
    data = np.load(out / "batches.npz")
    saved = {}
    for variant in ("dropout", "nodropout"):
        cfg = load_config(str(out / f"{variant}.json"))
        plan = make_mesh(cfg.mesh)
        assert plan.data_size == 2 and plan.data_index == rank
        state = _state(cfg, out / "weights.npz")
        shard_params(plan, state.model)
        step = make_train_step(cfg, plan)
        if variant == "dropout":
            seen = []
            bn = state.model.encoder_cbhg.bank_bn
            hook = bn.register_forward_pre_hook(
                lambda m, args: seen.append(
                    args[0].detach().mean(dim=(0, 1)).numpy().copy()))
        losses = []
        for t in range(STEPS):
            batch = Batch(*(None if f"{t}/{k}" not in data else
                            plan.shard.rows(torch.from_numpy(
                                data[f"{t}/{k}"])).numpy()
                            for k in Batch._fields))
            state, metrics = step(state, shard_batch(plan, batch, "cpu"), 0)
            losses.append(float(metrics["loss"]))
        if variant == "dropout":
            hook.remove()
            saved["bn_local_mean"] = seen[0]
            ev = make_eval_step(cfg, plan)(
                state, shard_batch(plan, batch, "cpu"))
            saved["eval"] = np.asarray([float(ev[k]) for k in sorted(ev)])
            # one rank's batch of another shape must raise, not hang
            bad = batch if rank == 0 else batch._replace(
                inputs=np.pad(batch.inputs, ((0, 0), (0, 4))))
            try:
                step(state, shard_batch(plan, bad, "cpu"), 0)
            except ValueError as e:
                saved["mismatch_raised"] = np.asarray("differ in shape"
                                                      in str(e))
            try:
                step.prewarm(state, [])
            except ValueError as e:
                saved["prewarm_refused"] = np.asarray("NCCL" in str(e))
        saved[f"{variant}/losses"] = np.asarray(losses, np.float64)
        for k, v in _flat_params(state).items():
            saved[f"{variant}/{k}"] = v

    # sharded synthesis: the global batch on every rank, rows split
    cfg = load_config(str(out / "synth.json"))
    plan = make_mesh(cfg.mesh)
    model = shard_params(plan, _load_model(cfg, out / "synth_weights.npz"))
    model.eval()
    syn = np.load(out / "synth_inputs.npz")
    wavs, aligns = make_sharded_synthesis(cfg, plan, int(syn["steps"]))(
        model, syn["inputs"], syn["lengths"], syn["speakers"])
    saved["synth/wavs"], saved["synth/aligns"] = wavs.numpy(), \
        aligns.numpy()
    np.savez(out / f"rank{rank}.npz", **saved)


def _job_grid(out: Path) -> None:
    import copy
    import dataclasses

    import torch.distributed as dist

    from tacotron_tpu_torch.config import MeshConfig, load_config
    from tacotron_tpu_torch.parallel import make_mesh, shard_params
    from tacotron_tpu_torch.train.state import create_model

    rank = dist.get_rank()
    cfg = load_config(str(out / "grid.json"))
    plan = make_mesh(MeshConfig(model_parallelism=2))
    assert plan.grid == ((0, 1), (2, 3)), plan.grid
    assert (plan.data_index, plan.model_index) == divmod(rank, 2)
    ref = _load_model(cfg, out / "grid_weights.npz").eval()
    model = shard_params(plan, copy.deepcopy(ref))
    head = model.linear_projection
    assert tuple(head.weight.shape) == (cfg.model.num_freq // 2,
                                        ref.linear_projection.in_features)
    data = np.load(out / "grid_inputs.npz")
    rows = slice(2 * plan.data_index, 2 * plan.data_index + 2)
    args = [torch.from_numpy(data[k][rows])
            for k in ("inputs", "lengths", "mels")]
    results = {}
    for name, m in (("sharded", model), ("replicated", ref)):
        out_lin = m(args[0], args[1], mel_targets=args[2])["linear_outputs"]
        (out_lin ** 2).sum().backward()
        results[name] = out_lin.detach().numpy()
    # the column block's gradient is its slice of the replicated head's;
    # a layer below the head sees every block's contribution
    width = cfg.model.num_freq // 2
    block = slice(plan.model_index * width, (plan.model_index + 1) * width)
    head_err = float((head.weight.grad
                      - ref.linear_projection.weight.grad[block]).abs().max())
    below = dict(model.named_parameters())
    below_err = max(float((below[n].grad - p.grad).abs().max())
                    for n, p in ref.post_cbhg.named_parameters(
                        prefix="post_cbhg"))
    try:
        odd = cfg.replace(model=dataclasses.replace(
            cfg.model, num_freq=cfg.model.num_freq + 1))
        shard_params(plan, create_model(odd))
        raised = False
    except ValueError as e:
        raised = "do not divide" in str(e)
    np.savez(out / f"grid{rank}.npz", sharded=results["sharded"],
             replicated=results["replicated"], head_err=head_err,
             below_err=below_err, odd_raised=raised)


def worker_main(job: str, out: str) -> None:
    _worker_setup()
    try:
        {"dp": _job_dp, "grid": _job_grid}[job](Path(out))
    finally:
        from tacotron_tpu_torch.parallel.distributed import shutdown
        shutdown()


# ------------------------------------------------------------ test helpers

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(world: int, argv, cwd=ROOT):
    """``world`` processes of ``argv`` with the torchrun environment."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable] + list(argv), cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs):
    """Every process's output, each waited for at most ``TIMEOUT`` s;
    all must exit 0."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-4000:]
    return logs


def _worker(world: int, job: str, out: Path):
    return _start(world, [str(Path(__file__).resolve()), job, str(out)])


# ------------------------------------------------------------------ tests

def test_rank_grid_matches_jax_make_mesh():
    import jax
    from tacotron_tpu.config import MeshConfig as JMesh
    from tacotron_tpu.parallel import make_mesh as jax_make_mesh

    from tacotron_tpu_torch.config import MeshConfig
    from tacotron_tpu_torch.parallel import make_mesh, rank_grid

    devices = jax.devices()[:8]
    index = {d: i for i, d in enumerate(devices)}
    for data, model in ((-1, 1), (-1, 2), (2, 2), (3, 2), (-1, 4), (1, 8)):
        want = jax_make_mesh(JMesh(data_parallelism=data,
                                   model_parallelism=model), devices)
        got = rank_grid(MeshConfig(data_parallelism=data,
                                   model_parallelism=model), range(8))
        grid = np.vectorize(index.get)(want.mesh.devices)
        np.testing.assert_array_equal(got, grid)
    for data, model, n in ((-1, 3, 8), (-1, 2, 5)):
        with pytest.raises(ValueError) as want:
            jax_make_mesh(JMesh(data_parallelism=data,
                                model_parallelism=model), devices[:n])
        with pytest.raises(ValueError) as got:
            rank_grid(MeshConfig(data_parallelism=data,
                                 model_parallelism=model), range(n))
        assert str(got.value) == str(want.value)
    # the JAX package's parallel names all exist in the port
    import tacotron_tpu.parallel as jax_parallel
    import tacotron_tpu_torch.parallel as port_parallel
    assert set(jax_parallel.__all__) <= set(port_parallel.__all__)
    # one process without a process group: a 1 x 1 plan, no groups
    plan = make_mesh()
    assert plan.grid == ((0,),) and plan.shard is None
    assert plan.data_size == plan.model_size == 1
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(world=range(2))


def test_sharded_synthesis_refuses_fused():
    import dataclasses

    from tacotron_tpu_torch.config import Config
    from tacotron_tpu_torch.parallel import make_mesh
    from tacotron_tpu_torch.synth.synthesizer import make_sharded_synthesis

    cfg = Config()
    fused = cfg.replace(audio=dataclasses.replace(
        cfg.audio, griffin_lim_impl="fused"))
    with pytest.raises(ValueError, match="'fused'"):
        make_sharded_synthesis(fused, make_mesh(), 4)


def _dp_configs():
    """dp_worker's tiny config, guided attention on: the JAX config, and
    the port's JSON for dropout on and off."""
    import dataclasses

    from dp_worker import build_config
    cfg = build_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, guided_attention_weight=0.5,
        guided_attention_decay_steps=10))
    nodrop = cfg.replace(model=dataclasses.replace(cfg.model,
                                                   dropout_prob=0.0))
    return cfg, nodrop


def _dp_batches(cfg, seed: int = 7):
    rng = np.random.default_rng(seed)
    m = cfg.model
    out = []
    for t in range(STEPS):
        lengths = np.asarray(INPUT_LENGTHS, np.int32)
        inputs = rng.integers(1, 60, (N_GLOBAL, T_IN)).astype(np.int32)
        inputs[np.arange(T_IN)[None, :] >= lengths[:, None]] = 0
        tl = np.asarray(TARGET_LENGTHS, np.int32) - t
        pad = np.arange(T_OUT)[None, :, None] >= tl[:, None, None]
        scale = np.where(np.arange(N_GLOBAL) < 4, 1.0, 0.4)[:, None, None]
        mel = rng.uniform(0, 1, (N_GLOBAL, T_OUT, m.num_mels)) * scale
        lin = rng.uniform(0, 1, (N_GLOBAL, T_OUT, m.num_freq)) * scale
        out.append(dict(
            inputs=inputs, input_lengths=lengths,
            loss_coeff=np.ones(N_GLOBAL, np.float32),
            mel_targets=np.where(pad, 0, mel).astype(np.float32),
            linear_targets=np.where(pad, 0, lin).astype(np.float32),
            speaker_id=np.zeros(N_GLOBAL, np.int32), target_lengths=tl))
    return out


def _synth_setup(out: Path):
    """Small-width synthesis config, weights and inputs (the shape of
    ``tests/test_synth.py``'s sharded test: 8 rows x 16 tokens x 4
    steps)."""
    from test_torch_synth import AUDIO, MODEL

    from tacotron_tpu.config import Config
    from tacotron_tpu_torch import params as P
    from test_torch_params import random_variables

    cfg = Config.from_dict({"audio": dict(AUDIO, griffin_lim_iters=8),
                            "model": MODEL})
    variables = random_variables(cfg.model, 11)
    np.savez(out / "synth_weights.npz", **P.flatten_variables(variables))
    (out / "synth.json").write_text(cfg.to_json())
    rng = np.random.default_rng(0)
    inputs = rng.integers(2, 60, (N_GLOBAL, 16)).astype(np.int32)
    lengths = np.asarray([16, 14, 12, 16, 9, 16, 11, 13], np.int32)
    speakers = np.asarray([0, 1] * 4, np.int32)
    np.savez(out / "synth_inputs.npz", inputs=inputs, lengths=lengths,
             speakers=speakers, steps=4)
    return cfg, variables, inputs, lengths, speakers


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The JAX weights and batches written; one 2-process launch of the
    ``dp`` job (both train variants and the sharded synthesis) while this
    process computes the references: the port's one-process run, the JAX
    sharded step and JAX's sharded synthesis."""
    import jax

    from tacotron_tpu.train import create_train_state, make_optimizer
    from tacotron_tpu_torch import params as P

    out = tmp_path_factory.mktemp("dp")
    cfg, nodrop = _dp_configs()
    state = create_train_state(cfg, jax.random.PRNGKey(0),
                               make_optimizer(cfg.train))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    np.savez(out / "weights.npz", **P.flatten_variables(
        jax.tree.map(np.asarray, variables)))
    (out / "dropout.json").write_text(cfg.to_json())
    (out / "nodropout.json").write_text(nodrop.to_json())
    batches = _dp_batches(cfg)
    np.savez(out / "batches.npz", **{f"{t}/{k}": v
                                     for t, b in enumerate(batches)
                                     for k, v in b.items()})
    synth = _synth_setup(out)
    procs = _worker(2, "dp", out)
    try:
        refs = dict(
            single=_port_single(out / "dropout.json", out / "weights.npz",
                                batches),
            jax_step=_jax_sharded_step(nodrop, variables, batches),
            jax_synth=_jax_sharded_synthesis(*synth))
    finally:
        _wait(procs)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    return dict(cfg=cfg, ranks=ranks, synth=synth, out=out, **refs)


def _port_single(cfg_json: Path, weights: Path, batches):
    """The port's plain step, one process, over the global batches: the
    losses, the final flat variables and the eval step's losses."""
    from tacotron_tpu_torch.config import load_config
    from tacotron_tpu_torch.train.step import (Batch, batch_to_device,
                                               make_eval_step,
                                               make_train_step)
    cfg = load_config(str(cfg_json))
    state = _state(cfg, weights)
    step = make_train_step(cfg)
    losses = []
    for b in batches:
        batch = batch_to_device(Batch(**b), "cpu")
        state, metrics = step(state, batch, 0)
        losses.append(float(metrics["loss"]))
    ev = make_eval_step(cfg)(state, batch)
    return (np.asarray(losses), _flat_params(state),
            np.asarray([float(ev[k]) for k in sorted(ev)]))


def _jax_sharded_step(cfg, variables, batches):
    """Per-step losses and the final flat variables of the JAX step on the
    8-device mesh over the global batches."""
    import jax
    import jax.numpy as jnp

    from tacotron_tpu.parallel import make_mesh, shard_batch
    from tacotron_tpu.train import TrainState, make_optimizer
    from tacotron_tpu.train import make_train_step as jax_step
    from tacotron_tpu.train.step import Batch
    from tacotron_tpu_torch import params as P

    plan = make_mesh()
    assert plan.data_size == 8
    opt = make_optimizer(cfg.train)
    v = jax.tree.map(jnp.asarray, variables)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=opt.init(v["params"]))
    step = jax_step(cfg, plan)
    losses = []
    for b in batches:
        batch = Batch(*shard_batch(plan, Batch(**b)))
        state, metrics = step(state, batch, jax.random.PRNGKey(1))
        losses.append(float(metrics["loss"]))
    return np.asarray(losses), P.flatten_variables(jax.tree.map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}))


def _jax_sharded_synthesis(cfg, variables, inputs, lengths, speakers):
    import jax
    import jax.numpy as jnp

    from tacotron_tpu.parallel import make_mesh
    from tacotron_tpu.synth import synthesizer as jsynth

    plan = make_mesh()
    fn = jsynth.make_sharded_synthesis(cfg, plan, max_steps=4)
    sh = plan.batch()
    wavs, aligns = fn(jax.tree.map(jnp.asarray, variables),
                      *(jax.device_put(jnp.asarray(x), sh)
                        for x in (inputs, lengths, speakers)))
    return np.asarray(wavs), np.asarray(aligns)


def test_dp_batch_halves_differ(dp_run):
    tl = np.asarray(TARGET_LENGTHS)
    r = dp_run["cfg"].model.reduction_factor

    def ref_len(x):
        return -(-(x.max() + 1) // r) * r

    assert ref_len(tl[:4]) != ref_len(tl[4:])
    assert set(-(-tl[:4] // r)) != set(-(-tl[4:] // r))
    a, b = (rk["bn_local_mean"] for rk in dp_run["ranks"])
    assert float(np.abs(a - b).max()) > 1e-3


def test_two_process_dp_matches_one_process_dropout_on(dp_run):
    losses, params, ev = dp_run["single"]
    r0, r1 = dp_run["ranks"]
    np.testing.assert_allclose(r0["dropout/losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(r0["eval"], ev, rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(r0[f"dropout/{k}"], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        assert np.array_equal(r0[f"dropout/{k}"], r1[f"dropout/{k}"]), k
    assert bool(r0["mismatch_raised"]) and bool(r1["mismatch_raised"])
    assert bool(r0["prewarm_refused"]) and bool(r1["prewarm_refused"])


def test_two_process_dp_matches_jax_sharded_step(dp_run):
    losses, want = dp_run["jax_step"]
    r0 = dp_run["ranks"][0]
    np.testing.assert_allclose(r0["nodropout/losses"], losses, rtol=1e-5)
    assert {k for k in r0 if k.startswith("nodropout/")} == \
        {f"nodropout/{k}" for k in want} | {"nodropout/losses"}
    for k, arr in want.items():
        np.testing.assert_allclose(r0[f"nodropout/{k}"], arr, rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_sharded_synthesis_matches_unsharded_and_jax(dp_run):
    from tacotron_tpu_torch.config import Config as TorchConfig
    from tacotron_tpu_torch.parallel import make_mesh as port_mesh
    from tacotron_tpu_torch.synth.synthesizer import make_sharded_synthesis

    cfg, variables, inputs, lengths, speakers = dp_run["synth"]
    r0, r1 = dp_run["ranks"]
    wavs, aligns = r0["synth/wavs"], r0["synth/aligns"]
    assert np.array_equal(wavs, r1["synth/wavs"])
    assert aligns.shape == (N_GLOBAL, 16, 4) and np.isfinite(wavs).all()

    tcfg = TorchConfig.from_json(cfg.to_json())
    model = _load_model(tcfg, dp_run["out"] / "synth_weights.npz").eval()
    want_w, want_a = make_sharded_synthesis(tcfg, port_mesh(), 4)(
        model, inputs, lengths, speakers)
    np.testing.assert_allclose(wavs, want_w.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(aligns, want_a.numpy(), rtol=1e-4,
                               atol=1e-5)

    j_w, j_a = dp_run["jax_synth"]
    assert j_w.shape == wavs.shape
    np.testing.assert_allclose(aligns, j_a, atol=5e-4)
    for a, b in zip(j_w, wavs):
        assert np.corrcoef(a, b)[0, 1] > 0.999
        assert 0.95 <= b.std() / a.std() <= 1.05


def test_four_process_grid_shards_linear_head(tmp_path):
    from test_torch_params import SMALL, random_variables

    from tacotron_tpu.config import Config
    from tacotron_tpu_torch import params as P

    cfg = Config.from_dict({"model": dict(SMALL, num_mels=8, num_freq=24,
                                          post_proj_sizes=(16, 8))})
    variables = random_variables(cfg.model, 3)
    np.savez(tmp_path / "grid_weights.npz",
             **P.flatten_variables(variables))
    (tmp_path / "grid.json").write_text(cfg.to_json())
    rng = np.random.default_rng(1)
    lengths = np.asarray([12, 7, 10, 12], np.int32)
    inputs = rng.integers(1, 60, (4, 12)).astype(np.int32)
    mels = rng.uniform(0, 1, (4, 8, 8)).astype(np.float32)
    np.savez(tmp_path / "grid_inputs.npz", inputs=inputs, lengths=lengths,
             mels=mels)
    _wait(_worker(4, "grid", tmp_path))
    for rank in range(4):
        got = np.load(tmp_path / f"grid{rank}.npz")
        np.testing.assert_allclose(got["sharded"], got["replicated"],
                                   rtol=2e-5, atol=2e-5)
        assert float(got["head_err"]) <= 2e-5
        assert float(got["below_err"]) <= 2e-5
        assert bool(got["odd_raised"])


def test_train_cli_distributed_two_processes(tmp_path, monkeypatch):
    import dataclasses

    from tacotron_tpu_torch.config import Config, save_config
    from tacotron_tpu_torch.data import synthetic
    from tacotron_tpu_torch.utils import read_metrics
    from test_torch_params import SMALL

    base = Config()
    cfg = base.replace(
        audio=dataclasses.replace(base.audio, num_freq=129, num_mels=10,
                                  sample_rate=8000, frame_length_ms=25.0),
        model=base.model.__class__(**dict(
            SMALL, num_mels=10, num_freq=129, reduction_factor=4)),
        train=dataclasses.replace(base.train, batch_size=2,
                                  test_interval=2, checkpoint_interval=2))
    # 2 speakers x 8 utterances of 120-180 frames: 2 test files a speaker,
    # the rest striped over the two ranks
    monkeypatch.setattr(synthetic, "PER_SPEAKER", 8)
    monkeypatch.setattr(synthetic, "FRAMES", (120, 180))
    dirs = synthetic.write_synthetic_corpus(str(tmp_path / "corpus"), cfg)
    save_config(cfg, str(tmp_path / "cfg.json"))
    logs = _wait(_start(2, ["-m", "tacotron_tpu_torch.train", "--distributed",
                       "--device", "cpu", "--data_paths", ",".join(dirs),
                       "--config", str(tmp_path / "cfg.json"),
                       "--num_steps", "2", "--sync_every", "1",
                       "--log_dir", str(tmp_path / "logs")]))
    assert all("'process_count': 2" in text for text in logs)
    runs = os.listdir(tmp_path / "logs")
    assert len(runs) == 1, runs
    run = tmp_path / "logs" / runs[0]
    records = read_metrics(str(run / "metrics.jsonl"))
    assert [(r["kind"], r["step"]) for r in records] == \
        [("train", 1), ("train", 2), ("eval", 2)]
    assert os.listdir(run / "checkpoints") == ["2"]
    saved = json.loads((run / "config.json").read_text())
    assert saved["data"]["pad_to_corpus_max"] is True
    text = (run / "train.log").read_text()
    assert text.count("Step       2") == 1 and "global batch 4" in text


if __name__ == "__main__":
    worker_main(sys.argv[1], sys.argv[2])
