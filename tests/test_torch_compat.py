"""The port's TF1 checkpoint interchange (``tacotron_tpu_torch/compat``):
the cases of ``tests/test_compat.py`` on the port's copy, and the two
packages against each other.

- The bundle codec round-trips and writes the same bytes as the JAX
  package's; crc32c matches RFC 3720's vectors.
- export -> bundle -> import round-trips every ``model_type`` with zero
  unmatched and zero unfilled variables, leaves and forward bit-identical.
- A JAX ``export_tf1_checkpoint`` imports through the port's CLI into
  exactly ``from_flax`` of the same tree, and the port's export reads back
  through JAX's ``import_tf1_checkpoint`` into the same tree.
- The port's ``import`` writes a run dir that ``Synthesizer.load`` serves
  and ``train`` resumes; a wrong ``--config`` is refused.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tacotron_tpu.compat import bundle as jbundle
from tacotron_tpu.compat import tf1 as jtf1
from tacotron_tpu.config import Config as JaxConfig
from tacotron_tpu_torch import params as P
from tacotron_tpu_torch.compat.__main__ import main as compat_main
from tacotron_tpu_torch.compat.bundle import (crc32c, read_checkpoint,
                                              write_checkpoint)
from tacotron_tpu_torch.compat.names import import_tf1
from tacotron_tpu_torch.compat.tf1 import (export_tf1_checkpoint,
                                           import_report,
                                           import_tf1_checkpoint,
                                           map_tf1_variables,
                                           resolve_checkpoint_prefix)
from tacotron_tpu_torch.config import Config, save_config
from tacotron_tpu_torch.train.state import create_model
from test_torch_params import random_variables


def test_crc32c_vectors():
    # RFC 3720 test vectors for CRC32C (Castagnoli)
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA


def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "model/inference/embedding": rng.standard_normal(
            (80, 256)).astype(np.float32),
        "model/inference/prenet/dense_1/kernel": rng.standard_normal(
            (256, 128)).astype(np.float32),
        "model/inference/prenet/dense_1/bias": np.zeros(128, np.float32),
        "global_step": np.asarray(1234, np.int64).reshape(()),
        "a/very/long/name/" + "x" * 100: rng.standard_normal(
            (3, 5)).astype(np.float64),
    }


def test_bundle_roundtrip(tmp_path):
    tensors = _tensors()
    prefix = str(tmp_path / "model.ckpt-1234")
    write_checkpoint(prefix, tensors)
    back = read_checkpoint(prefix)
    assert set(back) == set(tensors)
    for name in tensors:
        np.testing.assert_array_equal(back[name], tensors[name])
        assert back[name].dtype == tensors[name].dtype


def test_bundle_many_keys(tmp_path):
    """Prefix compression and the restart array with many similar keys."""
    tensors = {f"model/layer_{i:03d}/kernel":
               np.full((4, 4), i, np.float32) for i in range(100)}
    prefix = str(tmp_path / "model.ckpt-7")
    write_checkpoint(prefix, tensors)
    back = read_checkpoint(prefix)
    assert len(back) == 100
    np.testing.assert_array_equal(back["model/layer_042/kernel"],
                                  np.full((4, 4), 42, np.float32))


@pytest.mark.parametrize("many", [False, True], ids=["mixed", "many-keys"])
def test_bundle_bytes_match_jax(tmp_path, many):
    """The port's writer gives the JAX writer's bytes, index and data."""
    tensors = (_tensors(3) if not many else
               {f"model/layer_{i:03d}/kernel":
                np.full((2, 3), i, np.float32) for i in range(40)})
    ours, theirs = str(tmp_path / "a" / "m.ckpt-1"), \
        str(tmp_path / "b" / "m.ckpt-1")
    write_checkpoint(ours, tensors)
    jbundle.write_checkpoint(theirs, tensors)
    for ext in (".index", ".data-00000-of-00001"):
        with open(ours + ext, "rb") as a, open(theirs + ext, "rb") as b:
            assert a.read() == b.read(), ext


def test_map_tf1_variables_core_paths():
    rng = np.random.default_rng(1)
    base = "model/inference/encoder_cbhg/conv_bank/"
    tensors = {
        "model/inference/embedding":
            rng.standard_normal((80, 256)).astype(np.float32),
        "model/inference/prenet/dense_1/kernel":
            rng.standard_normal((256, 256)).astype(np.float32),
        base + "conv1d_1/conv1d/kernel":
            rng.standard_normal((1, 128, 128)).astype(np.float32),
        base + "conv1d_2/conv1d/kernel":
            rng.standard_normal((2, 128, 128)).astype(np.float32),
        base + "conv1d_1/conv1d/bias": np.zeros(128, np.float32),
        base + "conv1d_2/conv1d/bias": np.ones(128, np.float32),
        base + "conv1d_1/batch_normalization/gamma": np.ones(128, np.float32),
        base + "conv1d_2/batch_normalization/gamma":
            2 * np.ones(128, np.float32),
        base + "conv1d_1/batch_normalization/moving_mean":
            np.zeros(128, np.float32),
        base + "conv1d_2/batch_normalization/moving_mean":
            np.ones(128, np.float32),
        "model/inference/encoder_cbhg/bidirectional_rnn/fw/gru_cell/"
        "gates/kernel": rng.standard_normal((256, 256)).astype(np.float32),
        "model/inference/encoder_cbhg/highway_1/H/kernel":
            rng.standard_normal((128, 128)).astype(np.float32),
        "model/inference/memory_layer/kernel":
            rng.standard_normal((256, 256)).astype(np.float32),
        "model/optimizer/whatever/Adam": np.zeros(3, np.float32),
        "model/inference/mystery_variable": np.zeros(3, np.float32),
    }
    params, stats, unmatched = map_tf1_variables(tensors)
    assert params["char_embedding"]["embedding"].shape == (80, 256)
    assert params["encoder_prenet"]["dense_1"]["kernel"].shape == (256, 256)
    # fused bank: per-branch kernels kept, biases/BN concatenated in order
    assert params["encoder_cbhg"]["conv_bank"]["kernel_1"].shape == (
        1, 128, 128)
    np.testing.assert_array_equal(
        params["encoder_cbhg"]["conv_bank"]["bias"][128:],
        np.ones(128, np.float32))
    np.testing.assert_array_equal(
        params["encoder_cbhg"]["bank_bn"]["BatchNorm_0"]["scale"][128:],
        2 * np.ones(128, np.float32))
    np.testing.assert_array_equal(
        stats["encoder_cbhg"]["bank_bn"]["BatchNorm_0"]["mean"][128:],
        np.ones(128, np.float32))
    assert params["encoder_cbhg"]["bigru"]["fw"]["gates"]["kernel"].shape \
        == (256, 256)
    assert params["encoder_cbhg"]["highway_1"]["H"]["kernel"].shape == (
        128, 128)
    assert params["attention_memory_layer"]["kernel"].shape == (256, 256)
    # optimizer slots skipped silently; unknown inference vars reported
    assert unmatched == ["inference/mystery_variable"]
    # the lenient mapper is the JAX package's
    j_params, j_stats, j_unmatched = jtf1.map_tf1_variables(tensors)
    assert j_unmatched == unmatched
    for ours, theirs in ((params, j_params), (stats, j_stats)):
        a, b = P.flatten_variables(ours), P.flatten_variables(theirs)
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


SMALL_MODEL = dict(
    embedding_size=32, enc_prenet_sizes=(32, 16), enc_bank_size=4,
    enc_bank_channel_size=16, enc_highway_depth=2, enc_rnn_size=16,
    enc_proj_sizes=(16, 16), attention_size=16, attention_state_size=16,
    dec_layer_num=2, dec_rnn_size=16, dec_prenet_sizes=(16, 8),
    post_bank_size=2, post_bank_channel_size=16, post_highway_depth=2,
    post_rnn_size=16, post_proj_sizes=(16, 80))


def _small_config(**model):
    cfg = Config()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, **dict(SMALL_MODEL, **model)))


def _variant_config(mt, ns, ses, att="bah_mon"):
    """A small model of each type (the bundle writer's pure-Python crc32c
    takes ~10 s a full-width bundle)."""
    return _small_config(model_type=mt, num_speakers=ns,
                         speaker_embedding_size=ses, attention_type=att)


def _forward(model, variables, ns):
    """Greedy 4-step decode of the port model with ``variables``."""
    model.load_state_dict(P.from_flax(variables))
    model.eval()
    with torch.no_grad():
        out = model(torch.ones((2, 8), dtype=torch.int64),
                    torch.full((2,), 8), max_steps=4,
                    speaker_id=(torch.zeros(2, dtype=torch.int64)
                                if ns > 1 else None))
    return out["linear_outputs"].numpy()


@pytest.mark.parametrize("mt,ns,ses,att", [
    ("single", 1, 16, "bah_mon"),
    ("deepvoice", 4, 16, "bah_mon"),
    ("deepvoice", 4, 1, "bah_mon"),
    ("simple", 4, 16, "bah_mon"),
    ("single", 1, 16, "bah_norm"),
])
def test_tf1_bundle_roundtrip_zero_residue(tmp_path, mt, ns, ses, att):
    """export -> TF1 bundle -> import: zero unmatched, zero unfilled, every
    leaf bit-identical, and so a bit-identical forward."""
    cfg = _variant_config(mt, ns, ses, att)
    model = create_model(cfg)
    P.init_random_(model, seed=3)
    variables0 = P.to_flax(model.state_dict())

    prefix = str(tmp_path / "model.ckpt-777")
    export_tf1_checkpoint(prefix, variables0["params"],
                          variables0["batch_stats"], cfg)
    params, stats, unmatched, unfilled = import_tf1(read_checkpoint(prefix),
                                                    cfg)
    assert unmatched == [], unmatched[:5]
    assert unfilled == [], unfilled[:5]

    flat0 = P.flatten_variables(variables0)
    flat1 = P.flatten_variables({"params": params, "batch_stats": stats})
    assert set(flat0) == set(flat1)
    for key, leaf in flat0.items():
        np.testing.assert_array_equal(leaf, flat1[key], err_msg=key)

    out0 = _forward(create_model(cfg), variables0, ns)
    out1 = _forward(create_model(cfg),
                    {"params": params, "batch_stats": stats}, ns)
    np.testing.assert_array_equal(out0, out1)

    report = import_report(prefix, cfg)
    assert "unmatched source variables: 0" in report
    assert "rule targets not in bundle: 0" in report


def test_tf1_synthetic_reference_bundle(tmp_path):
    """A bundle carrying the complete transcribed reference inventory
    (decoder wrapper-stack scopes included) imports with zero residue and
    drives a forward pass; the inventory is the JAX package's."""
    from tacotron_tpu.compat import tf1_variable_inventory as j_inventory
    from tacotron_tpu_torch.compat import tf1_variable_inventory

    cfg = _variant_config("deepvoice", 2, 16)
    inv = tf1_variable_inventory(cfg)
    assert inv == j_inventory(JaxConfig.from_json(cfg.to_json()))
    dec = ("model/inference/decoder/output_projection_wrapper/multi_rnn_cell"
           "/cell_0/output_projection_wrapper/"
           "concat_output_and_attention_wrapper/attention_wrapper")
    assert f"{dec}/bahdanau_monotonic_attention/attention_score_bias" in inv
    assert f"{dec}/decoder_prenet_wrapper/gru_cell/gates/kernel" in inv
    assert inv[f"{dec}/bahdanau_monotonic_attention/attention_v"] == (
        cfg.model.attention_size,)

    rng = np.random.default_rng(5)
    tensors = {}
    for name, shape in inv.items():
        if name == "model/global_step":
            tensors[name] = np.asarray(1000, np.int64)
        elif name.endswith("moving_variance"):
            tensors[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            tensors[name] = (0.05 * rng.standard_normal(shape)).astype(
                np.float32)
    prefix = str(tmp_path / "model.ckpt-1000")
    write_checkpoint(prefix, tensors)

    params, stats, unmatched = import_tf1_checkpoint(prefix, cfg)
    assert unmatched == []
    out = _forward(create_model(cfg), {"params": params,
                                       "batch_stats": stats}, 2)
    assert np.isfinite(out).all()


def _npz_state(run_dir, step=0):
    path = os.path.join(run_dir, "checkpoints", str(step), "variables.npz")
    return P.from_flax(P.load_npz(path))


def test_compat_cli_roundtrip(tmp_path):
    """The user-facing path: port run dir -> ``export`` -> TF1 bundle ->
    ``import`` -> new run dir, weights bit-identical end to end; a wrong
    ``--config`` is refused."""
    from tacotron_tpu_torch.train.checkpoint import CheckpointManager
    from tacotron_tpu_torch.train.state import create_train_state

    cfg = _small_config()
    run_a = str(tmp_path / "run_a")
    state = create_train_state(cfg, seed=3, device="cpu")
    state.step = 7
    CheckpointManager(run_a, cfg).save(state)

    prefix = str(tmp_path / "tf1" / "model.ckpt-777")
    assert compat_main(["export", run_a, prefix, "--device", "cpu"]) == 0
    assert os.path.exists(prefix + ".index")
    cfg_json = os.path.join(run_a, "config.json")
    assert compat_main(["report", prefix, "--config", cfg_json]) == 0

    run_b = str(tmp_path / "run_b")
    assert compat_main(["import", prefix, "--run_dir", run_b, "--config",
                        cfg_json, "--device", "cpu"]) == 0
    want = state.model.state_dict()
    got = _npz_state(run_b)
    assert set(got) == set(want)
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)
    saved = torch.load(os.path.join(run_b, "checkpoints", "0",
                                    "optimizer.pt"), weights_only=True)
    assert saved["step"] == 0 and saved["count"] == 0

    bad_path = str(tmp_path / "bad.json")
    save_config(_small_config(enc_rnn_size=24), bad_path)
    assert compat_main(["import", prefix, "--run_dir",
                        str(tmp_path / "run_c"), "--config", bad_path,
                        "--device", "cpu"]) == 1
    assert not os.path.exists(str(tmp_path / "run_c" / "checkpoints" / "0"))


def test_cli_refuses_unmatched_without_force(tmp_path, capsys):
    """An inference variable no rule maps stops ``import``; ``--force``
    drops it and imports the rest."""
    cfg = _small_config()
    cfg_json = str(tmp_path / "config.json")
    save_config(cfg, cfg_json)
    model = P.init_random_(create_model(cfg), seed=2)
    variables = P.to_flax(model.state_dict())
    from tacotron_tpu_torch.compat.names import export_tf1
    tensors = export_tf1(variables["params"], variables["batch_stats"], cfg)
    tensors["model/inference/mystery_variable"] = np.zeros(3, np.float32)
    prefix = str(tmp_path / "tf1" / "model.ckpt-5")
    write_checkpoint(prefix, tensors)
    run = str(tmp_path / "run")
    args = ["import", prefix, "--run_dir", run, "--config", cfg_json,
            "--device", "cpu"]
    assert compat_main(args) == 1
    assert "mystery_variable" in capsys.readouterr().err
    assert compat_main(args + ["--force"]) == 0
    for key, value in model.state_dict().items():
        torch.testing.assert_close(_npz_state(run)[key], value, rtol=0,
                                   atol=0)


def test_resolve_checkpoint_prefix(tmp_path):
    """A run directory resolves to its newest model.ckpt-N."""
    d = str(tmp_path)
    for step in (100, 2000, 350):
        write_checkpoint(os.path.join(d, f"model.ckpt-{step}"),
                         {"v": np.zeros((2,), np.float32)})
    p = os.path.join(d, "model.ckpt-100")
    assert resolve_checkpoint_prefix(p) == p
    assert resolve_checkpoint_prefix(d).endswith("model.ckpt-2000")
    empty = tmp_path / "sub"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint_prefix(str(empty))


def _jax_pair():
    """The small Deep Voice 2 model as a (JAX, port) config pair."""
    tcfg = _small_config(model_type="deepvoice", num_speakers=2)
    return JaxConfig.from_json(tcfg.to_json()), tcfg


def test_jax_export_imports_through_port_cli(tmp_path):
    """JAX's ``export_tf1_checkpoint`` of a random tree, imported by the
    port's CLI: the run dir's weights are exactly ``from_flax`` of it."""
    jcfg, tcfg = _jax_pair()
    variables = random_variables(jcfg.model, 21)
    prefix = str(tmp_path / "tf1" / "model.ckpt-3")
    jtf1.export_tf1_checkpoint(prefix, variables["params"],
                               variables["batch_stats"], jcfg)
    cfg_json = str(tmp_path / "config.json")
    save_config(tcfg, cfg_json)
    run = str(tmp_path / "run")
    assert compat_main(["import", prefix, "--run_dir", run, "--config",
                        cfg_json, "--device", "cpu"]) == 0
    want = P.from_flax(variables)
    got = _npz_state(run)
    assert set(got) == set(want)
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)


def test_port_export_reads_back_through_jax(tmp_path):
    """The port's ``export`` of a run dir holding a random tree, read by
    JAX's ``import_tf1_checkpoint``: the same tree, zero unmatched."""
    from tacotron_tpu_torch.synth import Synthesizer
    from tacotron_tpu_torch.train.checkpoint import CheckpointManager
    from tacotron_tpu_torch.train.state import create_train_state

    jcfg, tcfg = _jax_pair()
    variables = random_variables(jcfg.model, 22)
    state = create_train_state(tcfg, device="cpu")
    state.model.load_state_dict(P.from_flax(variables))
    run = str(tmp_path / "run")
    CheckpointManager(run, tcfg).save(state)
    prefix = str(tmp_path / "tf1" / "model.ckpt-1")
    assert compat_main(["export", run, prefix, "--device", "cpu"]) == 0
    params, stats, unmatched = jtf1.import_tf1_checkpoint(prefix, jcfg)
    assert unmatched == []
    want = P.flatten_variables(variables)
    got = P.flatten_variables({"params": params, "batch_stats": stats})
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    # the run dir also serves
    res = Synthesizer(device="cpu").load(run).synthesize(
        texts=["안녕"], speaker_ids=[1], max_steps=2, librosa_trim=False)
    assert np.isfinite(res["wavs"][0]).all()


def test_imported_run_dir_serves_and_trains(tmp_path_factory):
    """The port's ``import`` writes a run dir that ``Synthesizer.load``
    serves and ``train`` resumes from step 0 for one step."""
    from tacotron_tpu.data import build_from_path
    from tacotron_tpu_torch.synth import Synthesizer
    from tacotron_tpu_torch.train.checkpoint import checkpoint_steps
    from tacotron_tpu_torch.train.driver import train
    from test_data import _make_corpus, _tiny_config

    tmp = tmp_path_factory.mktemp("compat_train")
    dirs = []
    for spk in range(2):
        meta = _make_corpus(str(tmp / f"spk{spk}"), seed=spk)
        build_from_path(meta, _tiny_config(), num_workers=1)
        dirs.append(str(tmp / f"spk{spk}" / "data"))
    tiny = Config.from_json(_tiny_config().to_json())
    jcfg, tcfg = _jax_pair()
    tcfg = tcfg.replace(data=tiny.data, train=dataclasses.replace(
        tiny.train, test_interval=100, checkpoint_interval=100))
    variables = random_variables(jcfg.model, 23)
    prefix = str(tmp / "tf1" / "model.ckpt-9")
    jtf1.export_tf1_checkpoint(prefix, variables["params"],
                               variables["batch_stats"], jcfg)
    cfg_json = str(tmp / "config.json")
    save_config(tcfg, cfg_json)
    run = str(tmp / "run")
    assert compat_main(["import", prefix, "--run_dir", run, "--config",
                        cfg_json, "--device", "cpu"]) == 0

    res = Synthesizer(device="cpu").load(run).synthesize(
        texts=["안녕하세요"], speaker_ids=[0], max_steps=3,
        librosa_trim=False)
    assert res["wavs"][0].size > 0 and np.isfinite(res["wavs"][0]).all()

    state = train(run, dirs, tcfg, num_steps=1, device="cpu")
    assert state.step == 1
    assert checkpoint_steps(run) == [0, 1]
