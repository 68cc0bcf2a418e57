"""Offline corpus preprocessor: metadata -> per-utterance ``.npz``.  A copy of
the JAX package's ``data/builder.py``.

Same artifact schema as the reference (its ``datasets/generate_data.py:
144-181``) so corpora interchange between the codebases::

    utterance.npz = { linear: [T, num_freq] float32,
                      mel:    [T, num_mels] float32,
                      tokens: [n] int32,
                      loss_coeff: scalar float32,
                      wav:    [samples] int16 (with store_waveform) }

Metadata is either ``alignment.json`` (audio path -> text, a *list* of
candidates when ASR confidence was low) or a ``metadata.csv`` of
``path|text`` rows (``generate_data.py:39-50``).  List-valued texts get
``loss_coeff = recognition_loss_coeff`` depending on
``ignore_recognition_level`` (``generate_data.py:66-82``):

    0 - use everything at full weight
    1 - down-weight utterances whose alignment was uncertain (list len 1);
        skip other list-valued entries
    2 - skip every ASR-derived utterance

Analysis runs on the host (numpy STFT/mel in ``dsp/host.py``), in the JAX
package too: this is data preparation, not the device path.  Several
workers run in a process pool started with ``spawn``, not the platform's
default ``fork``: the builder is called from processes that have
initialised CUDA and started threads (a feeder, torch's intra-op pool), and
a forked child of such a process can deadlock.
"""

from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import AudioConfig, Config, TrainConfig
from ..dsp import host as dsp
from ..text import text_to_sequence


@dataclass
class BuildStats:
    num_built: int
    num_skipped: int
    n_frames: List[int]

    @property
    def hours(self) -> float:
        # frames_to_hours for hop 12.5 ms (reference audio/__init__.py)
        return sum(self.n_frames) * 12.5 / 1000 / 3600


def read_metadata(metadata_path: str) -> Dict[str, object]:
    """alignment.json or metadata.csv (``path|text``) -> {audio_path: text}."""
    if metadata_path.endswith(".json"):
        with open(metadata_path) as fh:
            return json.load(fh)
    if metadata_path.endswith(".csv"):
        info = {}
        with open(metadata_path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                path, text = line.split("|", 1)
                info[path] = text
        return info
    raise ValueError(f"unknown metadata format: {metadata_path}")


def resolve_loss_coeffs(
        info: Dict[str, object], train_config: TrainConfig
) -> Tuple[Dict[str, str], Dict[str, float]]:
    """Apply the ignore_recognition_level policy; returns (texts, coeffs)
    keeping only utterances that should be built."""
    level = train_config.ignore_recognition_level
    texts: Dict[str, str] = {}
    coeffs: Dict[str, float] = {}
    for path, text in info.items():
        coeff = 1.0
        if isinstance(text, list):
            if (level == 1 and len(text) == 1) or level == 2:
                coeff = train_config.recognition_loss_coeff
            text = text[0]
        if level > 0 and coeff != 1.0:
            continue  # generate_data.py:85-86 skips down-weighted utterances
        texts[path] = text
        coeffs[path] = coeff
    return texts, coeffs


def process_utterance(audio_path: str, out_path: str, tokens: Sequence[int],
                      loss_coeff: float,
                      audio_config: AudioConfig,
                      store_waveform: bool = False) -> Optional[int]:
    """Analyze one utterance to .npz; returns its frame count.

    An existing readable ``out_path`` is reused (with ``store_waveform``,
    only if it holds ``wav``); an unreadable one is rebuilt.
    ``store_waveform`` additionally stores the int16 waveform under the
    (schema-compatible) extra key ``wav`` so training can extract
    features on device (TrainConfig.on_device_features).
    """
    if os.path.exists(out_path):
        try:
            with np.load(out_path) as data:
                if not store_waveform or "wav" in data:
                    return int(data["linear"].shape[0])
        except Exception:
            os.remove(out_path)
    wav = dsp.load_audio(audio_path, audio_config)
    linear = dsp.spectrogram(wav, audio_config).astype(np.float32)  # [F, T]
    mel = dsp.melspectrogram(wav, audio_config).astype(np.float32)  # [M, T]
    extra = {}
    if store_waveform:
        extra["wav"] = np.clip(wav * 32767.0, -32768,
                               32767).astype(np.int16)
    np.savez(out_path,
             linear=linear.T, mel=mel.T,
             tokens=np.asarray(tokens, np.int32),
             loss_coeff=np.float32(loss_coeff), **extra)
    return int(linear.shape[1])


def build_from_path(metadata_path: str, config: Config,
                    data_dirname: str = "data",
                    num_workers: Optional[int] = None,
                    cleaner_names: Optional[Sequence[str]] = None) -> BuildStats:
    """Build the .npz corpus next to ``metadata_path``
    (reference ``generate_data.py:27-124``).  ``num_workers`` <= 1 builds
    in this process; otherwise (None: one per CPU) in a spawned pool."""
    base_dir = os.path.dirname(os.path.abspath(metadata_path))
    data_dir = os.path.join(base_dir, data_dirname)
    os.makedirs(data_dir, exist_ok=True)

    info = read_metadata(metadata_path)
    # resolve relative audio paths against the metadata dir
    resolved = {}
    for path, text in info.items():
        full = path if os.path.exists(path) else os.path.join(base_dir, path)
        if os.path.exists(full):
            resolved[full] = text
    texts, coeffs = resolve_loss_coeffs(resolved, config.train)

    cleaners = (list(cleaner_names) if cleaner_names
                else list(config.data.cleaner_names()))

    jobs = []
    skipped = 0
    for audio_path, text in texts.items():
        try:
            tokens = text_to_sequence(text, cleaners,
                                      symbol_set=config.data.symbol_set)
        except Exception:
            skipped += 1
            continue
        name = os.path.basename(audio_path).rsplit(".", 1)[0] + ".npz"
        jobs.append((audio_path, os.path.join(data_dir, name), tokens,
                     coeffs[audio_path]))

    n_frames: List[int] = []
    if num_workers is not None and num_workers <= 1:
        for audio_path, out_path, tokens, coeff in jobs:
            n = process_utterance(audio_path, out_path, tokens, coeff,
                                  config.audio,
                                  config.data.store_waveform)
            if n is not None:
                n_frames.append(n)
    else:
        with ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = [
                pool.submit(process_utterance, audio_path, out_path, tokens,
                            coeff, config.audio,
                            config.data.store_waveform)
                for audio_path, out_path, tokens, coeff in jobs]
            for fut in futures:
                n = fut.result()
                if n is not None:
                    n_frames.append(n)

    return BuildStats(num_built=len(n_frames), num_skipped=skipped,
                      n_frames=n_frames)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: ``python -m tacotron_tpu_torch.data.builder metadata.csv``
    (reference ``datasets/generate_data.py:183-191``)."""
    import argparse

    parser = argparse.ArgumentParser(
        description="build per-utterance .npz spectrogram corpus")
    parser.add_argument("metadata_path")
    parser.add_argument("--data_dirname", default="data")
    parser.add_argument("--num_workers", type=int, default=None)
    parser.add_argument("--config", default=None,
                        help="path to a config.json (defaults to built-ins)")
    parser.add_argument("--store_waveform", action="store_true",
                        help="also store the int16 waveform per utterance "
                             "(enables on-device feature extraction, "
                             "TrainConfig.on_device_features)")
    args = parser.parse_args(argv)

    from ..config import load_config
    config = load_config(args.config) if args.config else Config()
    if args.store_waveform:
        import dataclasses as _dc
        config = config.replace(
            data=_dc.replace(config.data, store_waveform=True))
    stats = build_from_path(args.metadata_path, config,
                            data_dirname=args.data_dirname,
                            num_workers=args.num_workers)
    print(f"[*] built {stats.num_built} utterances "
          f"({stats.hours:.2f} hours), skipped {stats.num_skipped}")
    if stats.n_frames:
        print(f"[*] frames: min {min(stats.n_frames)} "
              f"max {max(stats.n_frames)}")


if __name__ == "__main__":
    main()
