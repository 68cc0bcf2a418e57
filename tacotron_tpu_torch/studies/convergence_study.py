"""Convergence study: train until attention aligns, then prove it on
held-out sentences.  A port of the repo's ``scripts/convergence_study.py``.

1. Build the synthetic melody corpus (:mod:`.make_synthetic_corpus`: the
   audio is a deterministic, monotonic function of the token sequence,
   with disjoint per-speaker tone bands).
2. Train the full-size Deep Voice 2 two-speaker model with the port's
   driver under the ``--preset tpu`` configuration
   (``Config.tpu_recommended``: bf16 compute, on-device features, batch
   32), the resident corpus and the default Noam schedule, with the train
   step prewarmed as CUDA graphs.
3. Evaluate on held-out sentences (never trained on): per-speaker
   attention health (``tools/speaker_eval.py``), each synthesized wav's
   dominant frequency against its speaker's band, and per-token tone
   accuracy (:func:`token_tone_accuracy`).
4. Write the markdown report, ``convergence_report.json`` and the loss
   curve (``loss_curve.json`` always; ``loss_curve.png`` where matplotlib
   is installed) with a few alignment plots of the run.

A second call with the same ``--work`` resumes from the run directory's
newest checkpoint (the driver's own resume), so a run can be spread over
calls of bounded wall time (``--wall_budget_s``)::

    python -m tacotron_tpu_torch.studies.convergence_study \
        --work /tmp/tacotron_convergence --steps 20000 --wall_budget_s 780

``--device cpu`` runs it on the CPU (the default is the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, load_config
from ..text import text_to_sequence
from ..utils import log, read_metrics
from ..utils.misc import card_line
from .make_synthetic_corpus import (ensure_corpus, is_silent_token,
                                    speaker_band_hz, speaker_tones,
                                    token_frequency, token_slot_bounds)


def dominant_hz(wav: np.ndarray, sr: int) -> float:
    """Frequency of the largest bin of the Hann-windowed spectrum."""
    wav = np.asarray(wav, np.float64)
    if wav.size < 256:
        return 0.0
    mag = np.abs(np.fft.rfft(wav * np.hanning(len(wav))))
    freqs = np.fft.rfftfreq(len(wav), 1.0 / sr)
    return float(freqs[mag.argmax()])


def token_tone_accuracy(wav: np.ndarray, text: str, speaker: int,
                        sr: int, variable_rate: bool = False) -> dict:
    """The alignment check on held-out text: the melody corpus maps token k
    to a tone at a known frequency in a known slot, so if the synthesized
    wav reproduces each token's frequency in each token's slot, the decoder
    attended the right token at the right time, however soft the attention
    matrix is.  Measures the dominant frequency of the interior of every
    voiced token slot (zero-padded FFT) and classifies it against the
    speaker's 24-tone table (nearest tone in log-frequency): correct iff
    the nearest tone is the expected token's.

    ``accuracy_tol`` counts a slot within 1.5 FFT bins of the expected
    tone (the model's spectral rendering precision; a misaligned read
    lands many bins away), ``wrong_token_rate`` a slot more than 6 bins
    off (its audio came from the wrong token).  A slot that the wav ends
    before counts as a miss and as a wrong token: a collapsed decode that
    emits a fraction of the utterance scores near 0.

    ``variable_rate`` scores against the ``melody_var`` corpus's
    non-uniform ground truth (token k lasting 1-3 decoder steps), whose
    slot boundaries are the cumulative per-token durations."""
    tokens = text_to_sequence(text, ["korean_cleaners"])
    bounds = token_slot_bounds(tokens, sr, variable_rate)
    pad = int(0.01 * sr)  # skip the 5 ms fades and the Griffin-Lim smear
    tones = speaker_tones(speaker, sr)
    bin_hz = sr / 2048.0
    hits, tol_hits, wrong, total, measured = 0, 0, 0, 0, 0
    details = []
    for (tok, (slot_lo, slot_hi)) in zip(tokens, bounds):
        if is_silent_token(tok):
            continue
        total += 1
        lo, hi = slot_lo + pad, slot_hi - pad
        if hi > len(wav):
            wrong += 1
            details.append((int(tok), None, None, False))
            continue
        measured += 1
        chunk = np.asarray(wav[lo:hi], np.float64)
        chunk = chunk * np.hanning(len(chunk))
        mag = np.abs(np.fft.rfft(chunk, n=1 << 15))
        freqs = np.fft.rfftfreq(1 << 15, 1.0 / sr)
        got = float(freqs[mag.argmax()])
        want = token_frequency(int(tok), speaker, sr)
        nearest = float(tones[np.abs(np.log(tones) - np.log(max(got, 1.0))
                                     ).argmin()])
        ok = abs(nearest - want) < 1e-6
        hits += ok
        err_bins = abs(got - want) / bin_hz
        tol_hits += err_bins <= 1.5
        wrong += err_bins > 6.0
        details.append((int(tok), round(want, 1), round(got, 1), bool(ok)))
    return {"accuracy": hits / max(total, 1),
            "accuracy_tol": tol_hits / max(total, 1),
            "wrong_token_rate": wrong / max(total, 1),
            "n_segments": total,
            "measured_fraction": measured / max(total, 1),
            "details": details}


def plot_loss_curve(metrics_path: str, out_png: str) -> list:
    """The run's training loss against its step: the ``(step, loss)``
    pairs always go to ``loss_curve.json`` beside ``out_png``; the plot is
    drawn where matplotlib is installed, and its skip is logged where not.
    Returns the pairs."""
    recs = read_metrics(metrics_path, kind="train")
    curve = [(r["step"], r["loss"]) for r in recs]
    with open(os.path.join(os.path.dirname(out_png), "loss_curve.json"),
              "w") as fh:
        json.dump(curve, fh)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        log(f"matplotlib is not installed: loss curve PNG {out_png} "
            f"skipped (the pairs are in loss_curve.json)")
        return curve
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot([s for s, _ in curve], [v for _, v in curve], lw=0.8)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.set_title("training loss (melody corpus, --preset tpu)")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return curve


def device_description(device: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``), or the CPU."""
    if device.type != "cuda":
        return str(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    limit = card_line(index).rsplit(",", 1)[-1].strip()
    return f"{name}, {limit}"


def study_config(base: Config, batch_size: int, num_speakers: int,
                 attention: str, dump_every: int, guided_weight: float,
                 guided_decay_steps: int, streaming: bool) -> Config:
    """The corpus's run config under the ``--preset tpu`` configuration,
    with the study's model and train fields."""
    cfg = Config.tpu_recommended(base, batch_size=batch_size)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, model_type="deepvoice",
                                  num_speakers=num_speakers,
                                  attention_type=attention),
        train=dataclasses.replace(
            cfg.train, checkpoint_interval=1000,
            test_interval=dump_every,
            guided_attention_weight=guided_weight,
            guided_attention_decay_steps=guided_decay_steps,
            device_resident_corpus=not streaming))


def evaluate(synth, heldout: Sequence[str], num_speakers: int,
             variable_rate: bool) -> Tuple[Dict, Dict, Dict]:
    """The held-out evaluation of a loaded synthesizer: the speaker-eval
    report (one batched fast-vocoder call), then per speaker one classic
    call of the held-out texts with both trims off (token slots stay
    sample-aligned from t=0, and a collapsed decode is measured in full),
    scored by dominant frequency against the speaker's band and by
    per-token tone accuracy.  Returns (report, dominant_f0,
    token_tone_accuracy)."""
    from ..tools.speaker_eval import evaluate_speakers

    sr = synth.config.audio.sample_rate
    report = evaluate_speakers(synth, texts=heldout, save_dir=None)
    f0_results, tone_results = {}, {}
    for spk in range(num_speakers):
        res = synth.synthesize(texts=heldout,
                               speaker_ids=[spk] * len(heldout),
                               attention_trim=False, librosa_trim=False)
        lo, hi = speaker_band_hz(spk, sr)
        peaks = [dominant_hz(w, sr) for w in res["wavs"]]
        in_band = [lo * 0.9 <= p < hi * 1.1 for p in peaks]
        f0_results[str(spk)] = {
            "band_hz": [lo, hi], "peaks_hz": peaks,
            "in_band_rate": float(np.mean(in_band)),
        }
        accs = [token_tone_accuracy(w, t, spk, sr,
                                    variable_rate=variable_rate)
                for w, t in zip(res["wavs"], heldout)]
        tone_results[str(spk)] = {
            "mean_accuracy": float(np.mean([a["accuracy"] for a in accs])),
            "min_accuracy": float(np.min([a["accuracy"] for a in accs])),
            "mean_accuracy_tol": float(np.mean(
                [a["accuracy_tol"] for a in accs])),
            "wrong_token_rate": float(np.mean(
                [a["wrong_token_rate"] for a in accs])),
            "n_segments": int(sum(a["n_segments"] for a in accs)),
            "measured_fraction": float(np.mean(
                [a["measured_fraction"] for a in accs])),
            "per_utterance": [round(a["accuracy"], 3) for a in accs],
            "per_utterance_tol": [round(a["accuracy_tol"], 3)
                                  for a in accs],
        }
    return report, f0_results, tone_results


def markdown(args, cfg: Config, payload: dict, picked: Sequence[str],
             curve: Sequence) -> str:
    """The report's markdown."""
    variable_rate = args.style == "melody_var"
    report = payload["speaker_eval"]
    cross = report.get("cross_speaker", {})
    steps_done, train_s = payload["steps"], payload["train_seconds"]
    lines = [
        "# Convergence demonstration",
        "",
        f"Full-size deepvoice 2-speaker model, {args.style} corpus "
        + ("(VARIABLE-RATE ground truth: each token lasts 1-3 decoder "
           "steps by token id, so the true alignment has non-uniform "
           "slope — the regime real speech trains in) "
           if variable_rate else "")
        + f"({args.utterances} utts/speaker, held-out eval sentences), "
        f"the --preset tpu configuration (bf16, on-device features, "
        f"B={cfg.train.batch_size}), default Noam schedule; "
        f"device: {payload['device']}.",
        "",
        f"Trained **{steps_done} steps in {train_s:.0f} s** "
        f"({steps_done / max(train_s, 1e-9):.1f} steps/s wall, "
        + ("device-resident corpus — the whole corpus lives in the card's "
           "memory and each batch is an on-device gather, data/resident.py"
           if not args.streaming else "prefetch-to-device pipeline")
        + ").",
        "",
        "## Held-out attention health (greedy decode, unseen sentences)",
        "",
        "| speaker | attention ok | coverage | focus | monotonicity "
        "| path coverage |",
        "|---|---|---|---|---|---|",
    ]
    for spk, rec in report["speakers"].items():
        a = rec["aggregate"]
        lines.append(
            f"| {spk} | {a['attention_ok_rate']:.0%} | "
            f"{a['mean_coverage']:.3f} | {a['mean_focus']:.3f} | "
            f"{a['mean_monotonicity']:.3f} | "
            f"{a.get('mean_path_coverage', 0):.3f} |")
    lines += [
        "",
        f"Worst attention_ok across speakers: "
        f"**{cross.get('worst_attention_ok_rate', 0):.0%}**; worst "
        f"path_coverage: "
        f"**{cross.get('worst_path_coverage', 0):.3f}**.",
        "",
        "Note on `bah_mon` (the reference-default attention): its "
        "soft-monotonic weights diffuse like a random walk even when "
        "perfectly aligned, so the sharpness thresholds behind the "
        "classic `attention ok` gate (focus >= 0.25, per-token max "
        ">= 0.2) under-rate it structurally; `attention ok` above "
        "therefore judges it by path coverage + monotonicity "
        "(attention_health(soft_monotonic=True)).  Both gate families "
        "are always present in the report JSON (`ok_sharpness`, "
        "`ok_soft_monotonic`, and `gate` = the family `ok` used).",
        "",
        "## Per-speaker acoustics (dominant frequency of synthesized audio)",
        "",
        "| speaker | band (Hz) | in-band rate | example peaks (Hz) |",
        "|---|---|---|---|",
    ]
    for spk, rec in payload["dominant_f0"].items():
        lo, hi = rec["band_hz"]
        ex = ", ".join(f"{p:.0f}" for p in rec["peaks_hz"][:4])
        lines.append(f"| {spk} | [{lo:.0f}, {hi:.0f}) | "
                     f"{rec['in_band_rate']:.0%} | {ex} |")
    lines += [
        "",
        "## Per-token tone accuracy (the conclusive alignment proof)",
        "",
        "The melody corpus maps token k to a known frequency in a known "
        "slot, so reproducing each token's tone in each token's slot on "
        "UNSEEN sentences requires attending the right token at the right "
        "time.",
        "",
        "| speaker | strict (nearest tone) | ±1.5-bin tolerance "
        "| wrong-token rate | segments | measured |",
        "|---|---|---|---|---|---|",
    ]
    for spk, rec in payload["token_tone_accuracy"].items():
        lines.append(f"| {spk} | {rec['mean_accuracy']:.1%} | "
                     f"{rec['mean_accuracy_tol']:.1%} | "
                     f"{rec['wrong_token_rate']:.1%} | "
                     f"{rec['n_segments']} | "
                     f"{rec['measured_fraction']:.0%} |")
    lines += [
        "",
        "`±1.5-bin tolerance` scores a slot correct when its dominant "
        "frequency lands within 1.5 FFT bins (17.6 Hz) of the expected "
        "token's tone; `wrong-token rate` (>6 bins off) counts slots whose "
        "audio came from the wrong token.  The strict column also demands "
        "sub-bin pitch rendering.",
    ]
    first = curve[0] if curve else (0, 0.0)
    last = curve[-1] if curve else (0, 0.0)
    lines += [
        "",
        "## Loss",
        "",
        f"step {first[0]}: {first[1]:.4f} -> step {last[0]}: "
        f"{last[1]:.4f} (curve: `loss_curve.json`, `loss_curve.png` where "
        f"matplotlib is installed).",
        "",
        "## Artifacts",
        "",
        "- `loss_curve.json` — the (step, loss) pairs of the run",
        *(f"- `{p}` — teacher-forced alignment at that step"
          for p in picked),
        "- `convergence_report.json` — the full machine-readable report",
        "",
        f"Reproduce: `python -m tacotron_tpu_torch.studies."
        f"convergence_study --steps {args.steps} --batch_size "
        f"{args.batch_size} --utterances {args.utterances} --style "
        f"{args.style}"
        + (f" --guided_weight {args.guided_weight}"
           if args.guided_weight else "")
        + (f" --guided_decay_steps {args.guided_decay_steps}"
           if args.guided_decay_steps else "")
        + (f" --attention {args.attention}"
           if args.attention != "bah_mon" else "") + "`.",
    ]
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--work", default="/tmp/tacotron_convergence")
    parser.add_argument("--steps", type=int, default=8000)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--utterances", type=int, default=96)
    parser.add_argument("--out", default=None,
                        help="write the markdown report here")
    parser.add_argument("--artifacts", default=None,
                        help="directory for the loss curve, alignment "
                             "plots and the report")
    parser.add_argument("--dump_every", type=int, default=500)
    parser.add_argument("--style", choices=["melody", "melody_var"],
                        default="melody",
                        help="melody = uniform one-step-per-token ground "
                             "truth; melody_var = 1-3 decoder steps per "
                             "token (non-uniform alignment slope)")
    parser.add_argument("--attention", default="bah_mon",
                        help="attention_type for the trained model "
                             "(bah_mon = reference default)")
    parser.add_argument("--skip_train", action="store_true",
                        help="reuse an existing run dir; evaluation only")
    parser.add_argument("--guided_weight", type=float, default=0.0,
                        help="TrainConfig.guided_attention_weight, the "
                             "opt-in soft-diagonal prior; 0 = the "
                             "reference's loss (default)")
    parser.add_argument("--guided_decay_steps", type=int, default=0,
                        help="TrainConfig.guided_attention_decay_steps: "
                             "linear anneal of the guided weight to 0 "
                             "over this many steps")
    parser.add_argument("--wall_budget_s", type=float, default=None,
                        help="stop training after this much wall time "
                             "even if --steps is not reached (the final "
                             "state is checkpointed; a second call with "
                             "the same --work resumes from it)")
    parser.add_argument("--streaming", action="store_true",
                        help="use the streaming DataFeeder instead of the "
                             "default device-resident corpus")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; raises "
                             "without one; cpu for the CPU)")
    args = parser.parse_args(argv)

    from ..synth import Synthesizer
    from ..synth.synthesizer import resolve_device
    from ..train.driver import train

    device = resolve_device(args.device)
    os.makedirs(args.work, exist_ok=True)
    data_dirs = ensure_corpus(args.work, args.utterances,
                              args.batch_size, style=args.style)
    variable_rate = args.style == "melody_var"
    corpus = os.path.join(args.work, "corpus")
    with open(os.path.join(corpus, "heldout.json"), encoding="utf-8") as fh:
        heldout = json.load(fh)

    cfg = study_config(load_config(os.path.join(corpus, "config.json")),
                       args.batch_size, len(data_dirs), args.attention,
                       args.dump_every, args.guided_weight,
                       args.guided_decay_steps, args.streaming)
    run_dir = os.path.join(args.work, "run")
    art = args.artifacts or os.path.join(args.work, "artifacts")
    t0 = time.time()
    steps_done = args.steps
    if args.skip_train:
        # evaluation-only rerun: keep the recorded wall time of the run
        # being re-scored, if its report is in the artifacts dir
        train_s = 0.0
        prior = os.path.join(art, "convergence_report.json")
        if os.path.exists(prior):
            with open(prior) as fh:
                train_s = json.load(fh).get("train_seconds", 0.0)
    else:
        state = train(run_dir, data_dirs, cfg, num_steps=args.steps,
                      log_every=25, prewarm=True,
                      test_dump_dir=os.path.join(run_dir, "samples"),
                      max_seconds=args.wall_budget_s, device=device)
        train_s = time.time() - t0
        steps_done = int(state.step)
        print(f"[*] trained {steps_done} steps in {train_s:.0f} s "
              f"({steps_done / max(train_s, 1e-9):.1f} steps/s)")

    # ------------------------------------------------- held-out evaluation
    synth = Synthesizer(device=device).load(run_dir)
    report, f0_results, tone_results = evaluate(synth, heldout,
                                                len(data_dirs),
                                                variable_rate)

    # ------------------------------------------------------------ artifacts
    os.makedirs(art, exist_ok=True)
    curve = plot_loss_curve(os.path.join(run_dir, "metrics.jsonl"),
                            os.path.join(art, "loss_curve.png"))
    pngs = sorted(glob.glob(os.path.join(run_dir, "samples", "*.png")))
    picked = []
    if pngs:
        idx = sorted({0, len(pngs) // 4, len(pngs) // 2, len(pngs) - 1})
        for i in idx:
            dst = os.path.join(art, os.path.basename(pngs[i]))
            shutil.copyfile(pngs[i], dst)
            picked.append(os.path.basename(dst))
    payload = {
        "steps": steps_done, "train_seconds": train_s,
        "attention_type": args.attention,
        "corpus_style": args.style,
        "config": {"batch_size": cfg.train.batch_size,
                   "compute_dtype": cfg.model.compute_dtype,
                   "on_device_features": cfg.train.on_device_features,
                   "guided_attention_weight": args.guided_weight,
                   "guided_attention_decay_steps": args.guided_decay_steps,
                   "device_resident_corpus": not args.streaming,
                   "schedule": "noam-4k" if
                   cfg.train.decay_learning_rate_mode == 0 else "exp-decay"},
        "heldout_texts": heldout,
        "speaker_eval": report,
        "dominant_f0": f0_results,
        "token_tone_accuracy": tone_results,
        "device": device_description(device),
    }
    with open(os.path.join(art, "convergence_report.json"), "w") as fh:
        json.dump(payload, fh, ensure_ascii=False, indent=2)

    out = args.out or os.path.join(art, "CONVERGENCE.md")
    with open(out, "w") as fh:
        fh.write(markdown(args, cfg, payload, picked, curve))
    print(f"[*] report -> {out}\n[*] artifacts -> {art}")
    cross = report.get("cross_speaker", {})
    print(json.dumps({"worst_attention_ok":
                      cross.get("worst_attention_ok_rate", 0.0),
                      "f0_in_band": {k: v["in_band_rate"]
                                     for k, v in f0_results.items()},
                      "tone_accuracy": {k: round(v["mean_accuracy"], 3)
                                        for k, v in tone_results.items()}}))
    return payload


if __name__ == "__main__":
    main()
