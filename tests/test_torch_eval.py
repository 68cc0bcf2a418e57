"""The port's batch evaluation CLI (``python -m tacotron_tpu_torch.eval``)
and the synth CLI's serving flags, on the CPU on a tiny port run dir:

- eval writes ``eval000_<i>.wav`` per text for each speaker, plain and
  with ``--attention_retry``; retry and manual attention together exit 2;
- without ``--device`` the eval, server and compat CLIs run on the card,
  and raise without one;
- the synth CLI runs with ``--vocode none``/``host``, ``--long``,
  ``--manual_attention_mode`` and ``--checkpoint_step``.
"""

import dataclasses
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from tacotron_tpu_torch.app import main as app_main
from tacotron_tpu_torch.compat.__main__ import main as compat_main
from tacotron_tpu_torch.config import AudioConfig, Config, ModelConfig
from tacotron_tpu_torch.eval import main as eval_main
from tacotron_tpu_torch.synth.__main__ import main as synth_main
from tacotron_tpu_torch.train.checkpoint import CheckpointManager
from tacotron_tpu_torch.train.state import create_train_state
from test_torch_params import SMALL

ROOT = Path(__file__).resolve().parents[1]
TEXTS = ["안녕하세요.", "반갑습니다 여러분"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port run dir of a small two-speaker model, checkpoints 0 and 5
    (different weights)."""
    cfg = Config(
        audio=AudioConfig(num_freq=129, sample_rate=16000, frame_shift_ms=8,
                          frame_length_ms=16, griffin_lim_iters=3),
        model=ModelConfig(**dict(SMALL, num_mels=10, num_freq=129,
                                 reduction_factor=4, model_type="deepvoice",
                                 num_speakers=2, max_iters=30)))
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, min_iters=1))
    run = tmp_path_factory.mktemp("eval") / "run_a"
    mgr = CheckpointManager(str(run), cfg)
    for step, seed in ((0, 1), (5, 2)):
        state = create_train_state(cfg, seed=seed, device="cpu")
        state.step = step
        mgr.save(state)
    return run


def _wav_frames(path) -> int:
    with wave.open(str(path)) as fh:
        assert fh.getframerate() == 16000
        return fh.getnframes()


def test_eval_cli_writes_wavs_per_speaker(run_dir, tmp_path):
    out = tmp_path / "samples"
    proc = subprocess.run(
        [sys.executable, "-m", "tacotron_tpu_torch.eval", "--device", "cpu",
         "--load_path_pattern", str(run_dir.parent / "run_*"),
         "--speakers", "2", "--max_steps", "4", "--batch_size", "8",
         "--sample_path", str(out), "--texts", *TEXTS],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    for speaker in (0, 1):
        d = out / "run_a" / f"speaker{speaker}"
        names = sorted(p.name for p in d.glob("*.wav"))
        assert names == ["eval000_0.wav", "eval000_1.wav"]
        assert all(_wav_frames(d / n) > 0 for n in names)


def test_eval_attention_retry(run_dir, tmp_path, capsys):
    out = tmp_path / "samples"
    eval_main(["--device", "cpu", "--load_path_pattern", str(run_dir),
               "--max_steps", "4", "--sample_path", str(out),
               "--attention_retry", "1", "--texts", *TEXTS])
    d = out / "run_a" / "speaker0"
    assert sorted(p.name for p in d.glob("*.wav")) == ["eval000_0.wav",
                                                       "eval000_1.wav"]
    # random weights fail the health gate: the retries are reported
    assert "[!] attention retry" in capsys.readouterr().out


def test_eval_refuses_retry_with_manual_mode(run_dir, tmp_path):
    with pytest.raises(SystemExit) as exc:
        eval_main(["--device", "cpu", "--load_path_pattern", str(run_dir),
                   "--attention_retry", "1", "--manual_attention_mode", "1"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        eval_main(["--device", "cpu", "--load_path_pattern",
                   str(tmp_path / "nothing_*")])
    assert exc.value.code == 2


@pytest.mark.parametrize("cli", ["eval", "app", "compat_import",
                                 "compat_export"])
def test_clis_default_to_the_card(run_dir, tmp_path, cli):
    """Without ``--device`` the eval, server and compat CLIs run on the
    card, and raise without one instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    prefix = str(tmp_path / "model.ckpt-5")
    if cli == "compat_import":
        assert compat_main(["export", str(run_dir), prefix,
                            "--device", "cpu"]) == 0
    main, argv = {
        "eval": (eval_main, ["--load_path_pattern", str(run_dir)]),
        "app": (app_main, ["--random_init", "--port", "0"]),
        "compat_import": (compat_main, [
            "import", prefix, "--run_dir", str(tmp_path / "imported"),
            "--config", str(run_dir / "config.json")]),
        "compat_export": (compat_main, ["export", str(run_dir), prefix]),
    }[cli]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


@pytest.mark.parametrize("flags,n_wavs", [
    (["--vocode", "none"], 2),
    (["--vocode", "host"], 2),
    (["--manual_attention_mode", "1"], 2),
    (["--long", "--max_steps", "4"], 1),
    (["--checkpoint_step", "0"], 2),
])
def test_synth_cli_flags(run_dir, tmp_path, flags, n_wavs, capsys):
    out = tmp_path / "s"
    text = (["안녕하세요. 반갑습니다 여러분, 음성 합성을 시험합니다."]
            if "--long" in flags else TEXTS)
    steps = [] if "--max_steps" in flags else ["--max_steps", "4"]
    synth_main(["--device", "cpu", "--load_path", str(run_dir),
                "--sample_path", str(out), "--speaker_id", "1", *steps,
                *flags, *text])
    wavs = sorted(out.glob("*.wav"))
    assert len(wavs) == n_wavs
    if "--vocode" in flags and "none" in flags:
        assert all(_wav_frames(p) == 0 for p in wavs)
    else:
        assert all(_wav_frames(p) > 0 for p in wavs)
    if "--long" in flags:
        assert "chunk(s)" in capsys.readouterr().out


def test_synth_cli_checkpoint_step_selects_weights(run_dir, tmp_path):
    """``--checkpoint_step 0`` and the default (the newest, step 5) load
    different weights."""
    frames = {}
    for flags in ([], ["--checkpoint_step", "0"]):
        out = tmp_path / f"s{len(flags)}"
        synth_main(["--device", "cpu", "--load_path", str(run_dir),
                    "--sample_path", str(out), "--max_steps", "4",
                    "--vocode", "none", "--no_attention_trim", *flags,
                    "안녕"])
        frames[len(flags)] = np.load(out / "synth_0_alignment.npy")
    assert not np.array_equal(frames[0], frames[2])
    with pytest.raises(FileNotFoundError):
        synth_main(["--device", "cpu", "--load_path", str(run_dir),
                    "--sample_path", str(tmp_path / "x"),
                    "--checkpoint_step", "3", "안녕"])
