"""bf16 against float32 training on a synthetic corpus: a port of the
repo's ``scripts/bf16_study.py``.

Trains the same model twice, ``compute_dtype`` float32 and then bfloat16,
on a 2-speaker sine corpus (24 utterances a speaker, built here with the
port's corpus builder), with the port's driver, so the run dirs carry
``metrics.jsonl``; then writes the script's side-by-side loss and
step-time summary with its recommendation::

    python -m tacotron_tpu_torch.studies.bf16_study --steps 300 \
        [--work_dir DIR] [--out report.md]

The report goes to ``--out``, by default ``BF16_STUDY.md`` under the work
directory (a new temporary directory unless ``--work_dir`` is given).
``--device cpu`` runs it on the CPU (the default is the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Optional, Sequence

import numpy as np

from ..config import Config

TEXTS = ["안녕하세요 만나서 반갑습니다", "오늘은 날씨가 정말 좋네요",
         "음성 합성 시스템을 시험합니다", "내일 아침 일찍 만나요",
         "어제는 비가 조금 내렸어요", "스물 네 시간 열두 달"]


def study_config(compute_dtype: str = "float32") -> Config:
    """The script's configuration: ``Config()`` with a 2-speaker Deep Voice
    2 model in ``compute_dtype``, every utterance kept (``min_tokens`` and
    ``min_iters`` 1, ``max_iters`` 400), batch 8, exponential decay, an
    evaluation every 50 steps and no checkpoint before the end."""
    cfg = Config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, model_type="deepvoice",
                                  num_speakers=2,
                                  compute_dtype=compute_dtype),
        data=dataclasses.replace(cfg.data, min_tokens=1, min_iters=1,
                                 max_iters=400),
        train=dataclasses.replace(cfg.train, batch_size=8,
                                  decay_learning_rate_mode=1,
                                  test_interval=50,
                                  checkpoint_interval=10 ** 9))


def build_corpus(root: str, n_speakers: int = 2, n_utts: int = 24) -> list:
    """Sine-tone utterances with noise (1.6-2.8 s, a pitch per speaker and
    utterance) from seed 0, their ``metadata.csv`` and the built ``.npz``
    corpus of each speaker; returns the data dirs."""
    from ..data.builder import build_from_path
    from ..dsp import host as dsp

    cfg = study_config()
    dirs = []
    rng = np.random.default_rng(0)
    sr = cfg.audio.sample_rate
    for spk in range(n_speakers):
        spk_dir = os.path.join(root, f"spk{spk}")
        os.makedirs(spk_dir, exist_ok=True)
        lines = []
        for i in range(n_utts):
            dur = 1.6 + 0.4 * (i % 4)
            t = np.arange(int(dur * sr)) / sr
            f0 = 150 + 60 * spk + 10 * (i % 5)
            wav = (0.4 * np.sin(2 * np.pi * f0 * t)
                   + 0.1 * rng.standard_normal(t.shape)).astype(np.float32)
            path = os.path.join(spk_dir, f"utt{i:03d}.wav")
            dsp.save_audio(wav, path, cfg.audio)
            lines.append(f"{path}|{TEXTS[i % len(TEXTS)]}")
        meta = os.path.join(spk_dir, "metadata.csv")
        with open(meta, "w") as fh:
            fh.write("\n".join(lines))
        build_from_path(meta, cfg, num_workers=1)
        dirs.append(os.path.join(spk_dir, "data"))
    return dirs


def run(tag: str, dtype: str, data_dirs, steps: int, out_root: str,
        device=None) -> list:
    """One arm: ``steps`` steps of :func:`study_config` in ``dtype`` under
    ``out_root/tag``; returns its train records."""
    from ..train.driver import train
    from ..utils import read_metrics

    run_dir = os.path.join(out_root, tag)
    train(run_dir, data_dirs, study_config(dtype), num_steps=steps,
          log_every=10, device=device)
    return read_metrics(os.path.join(run_dir, "metrics.jsonl"),
                        kind="train")


def summarize(f32, bf16, steps: int, out_path: str, device: str) -> str:
    """The script's report of two arms' train records, written to
    ``out_path``: final losses and step times (means of the last 5 logged
    intervals), the curves, and the recommendation by its rule (bf16 when
    its final loss is within 5 % of float32's and its step at most 2 %
    slower)."""
    def tail_mean(ms, key, n=5):
        vals = [m[key] for m in ms[-n:]]
        return sum(vals) / len(vals)

    def curve(ms, key):
        return [(m["step"], round(m[key], 4)) for m in ms]

    f32_loss = tail_mean(f32, "loss")
    bf16_loss = tail_mean(bf16, "loss")
    f32_sps = tail_mean(f32, "sec_per_step")
    bf16_sps = tail_mean(bf16, "sec_per_step")

    lines = [
        "# bf16 vs f32 training study",
        "",
        f"Synthetic 2-speaker deepvoice corpus, {steps} steps, batch 8, "
        f"exponential-decay LR; device: {device}.",
        "Loss values are means over the final 5 logged intervals from each "
        "run's `metrics.jsonl` (persisted by the trainer).",
        "",
        "| compute_dtype | final avg loss | sec/step | frames/s rel |",
        "|---|---|---|---|",
        f"| float32  | {f32_loss:.4f} | {f32_sps:.4f} | 1.00x |",
        f"| bfloat16 | {bf16_loss:.4f} | {bf16_sps:.4f} | "
        f"{f32_sps / bf16_sps:.2f}x |",
        "",
        f"Relative final-loss difference: "
        f"{abs(bf16_loss - f32_loss) / max(f32_loss, 1e-9) * 100:.2f}%  "
        f"(params/optimizer state stay f32; only matmul compute is bf16).",
        "",
        "Loss curves (step, loss):",
        "",
        f"- f32:  {curve(f32, 'loss')}",
        f"- bf16: {curve(bf16, 'loss')}",
        "",
    ]
    if abs(bf16_loss - f32_loss) / max(f32_loss, 1e-9) < 0.05 \
            and bf16_sps <= f32_sps * 1.02:
        lines.append("**Recommendation**: bf16 converges equivalently here "
                     "and is never slower — use "
                     "`model.compute_dtype=\"bfloat16\"` for training; keep "
                     "f32 for checkpoint-parity evaluation against the "
                     "reference.")
    else:
        lines.append("**Recommendation**: measurable divergence or no "
                     "speed win on this device — keep float32 as the "
                     "default; revisit with larger models.")
    text = "\n".join(lines) + "\n"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        fh.write(text)
    return text


def main(argv: Optional[Sequence[str]] = None) -> str:
    from ..synth.synthesizer import resolve_device
    from ..utils.misc import device_line

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--out", default=None,
                        help="the report (default: BF16_STUDY.md under the "
                             "work directory)")
    parser.add_argument("--work_dir", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; raises "
                             "without one; cpu for the CPU)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    work = args.work_dir or tempfile.mkdtemp(prefix="bf16_study_")
    print(f"[*] corpus under {work}")
    data_dirs = build_corpus(os.path.join(work, "corpus"))
    f32 = run("f32", "float32", data_dirs, args.steps, work, device)
    bf16 = run("bf16", "bfloat16", data_dirs, args.steps, work, device)
    text = summarize(f32, bf16, args.steps,
                     args.out or os.path.join(work, "BF16_STUDY.md"),
                     device_line(device))
    print(text)
    return text


if __name__ == "__main__":
    main()
