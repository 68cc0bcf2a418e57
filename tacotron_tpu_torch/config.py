"""Typed, immutable configuration for the PyTorch port.

Field names and defaults are identical to the JAX package's configuration, so
a ``config.json`` written by a JAX run loads here unchanged (unknown keys are
ignored in both directions).  Default values reproduce the hyperparameters in
effect in the TensorFlow reference (``hparams.py``): sample rate 24 kHz,
Deep Voice 2 widths, r=4.  ``ModelConfig.architecture`` chooses the model:
``"tacotron"`` (the default; its JSON leaves out the field and the Tacotron
2 fields, so it stays the JAX package's) or ``"tacotron2"``.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Tuple


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """STFT / mel / Griffin-Lim parameters."""

    num_mels: int = 80
    num_freq: int = 1025
    sample_rate: int = 24000
    frame_length_ms: float = 50.0
    frame_shift_ms: float = 12.5
    preemphasis: float = 0.97
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    griffin_lim_iters: int = 60
    power: float = 1.5  # magnitude exponent applied before Griffin-Lim
    # Griffin-Lim engine: "auto" resolves to "fused" (the hand-written
    # iteration kernel, ops/kernels/gl_fused.py) on CUDA, to the
    # spectral-step kernel past its frame cap there (dsp/chip.py), and to
    # "matmul_half" on the CPU.  Explicit engines: "fused", "matmul_half"
    # (u/v half-frame DFT as bf16 matmuls), "matmul_bf16" (the dense DFT
    # pair as bf16 matmuls), "matmul_split" (the two-stage DFT as bf16
    # matmuls), "pallas" (the hand-written spectral-step kernel,
    # ops/kernels/griffin_lim.py; the name is kept so JAX configs load) and
    # "fft" (strict float32 torch.fft, the parity anchor).
    griffin_lim_impl: str = "auto"
    # Overlap-add inside the batched engines: "pallas" (the hand-written
    # kernel, ops/kernels/ola.py; the name is kept so JAX configs load),
    # "xla" (the plain tensor formulation), or "auto" (the kernel on CUDA,
    # plain on the CPU).
    ola_impl: str = "auto"
    # Fast Griffin-Lim momentum (Perraudin et al. 2013); 0.0 = classic.
    griffin_lim_momentum: float = 0.0

    @property
    def n_fft(self) -> int:
        return (self.num_freq - 1) * 2

    @property
    def hop_length(self) -> int:
        return int(self.frame_shift_ms / 1000 * self.sample_rate)

    @property
    def win_length(self) -> int:
        return int(self.frame_length_ms / 1000 * self.sample_rate)


#: ``ModelConfig.architecture`` values: Tacotron (with Deep Voice 2's
#: speakers) and Tacotron 2
ARCHITECTURES = ("tacotron", "tacotron2")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Tacotron + Deep Voice 2 architecture, or Tacotron 2.

    ``architecture="tacotron2"`` (Shen et al. 2018, arXiv:1712.05884 §2;
    ``models/tacotron2.py``) reads ``embedding_size``, ``attention_size``,
    ``dec_prenet_sizes``, ``reduction_factor``, ``max_iters``,
    ``steps_per_token``, ``num_mels`` and ``num_freq`` as Tacotron does,
    and the ``t2_*`` fields for what Tacotron lacks; it runs inference
    only, single-speaker and in float32 (``__post_init__`` refuses the
    rest)."""

    # "tacotron" or "tacotron2" (ARCHITECTURES)
    architecture: str = "tacotron"

    # "single", "deepvoice" or "simple" speaker conditioning
    model_type: str = "single"
    num_speakers: int = 1
    speaker_embedding_size: int = 16

    num_mels: int = 80
    num_freq: int = 1025

    embedding_size: int = 256
    dropout_prob: float = 0.8

    # Encoder
    enc_prenet_sizes: Tuple[int, ...] = (256, 128)
    enc_bank_size: int = 16
    enc_bank_channel_size: int = 128
    enc_maxpool_width: int = 2
    enc_highway_depth: int = 4
    enc_rnn_size: int = 128
    enc_proj_sizes: Tuple[int, ...] = (128, 128)
    enc_proj_width: int = 3

    # Attention: "bah_mon", "bah", "bah_norm", "luong", "luong_scaled"
    attention_type: str = "bah_mon"
    attention_size: int = 256
    attention_state_size: int = 256

    # Decoder
    dec_layer_num: int = 2
    dec_rnn_size: int = 256
    dec_prenet_sizes: Tuple[int, ...] = (256, 128)

    # Post-net CBHG
    post_bank_size: int = 8
    post_bank_channel_size: int = 256
    post_maxpool_width: int = 2
    post_highway_depth: int = 4
    post_rnn_size: int = 256
    post_proj_sizes: Tuple[int, ...] = (256, 80)
    post_proj_width: int = 3

    reduction_factor: int = 4
    max_iters: int = 200
    # decoder steps per input token for the length-adaptive decode budget
    steps_per_token: float = 4.0

    # Activations in float32 (reference parity) or "bfloat16"; parameters,
    # BatchNorm statistics and the optimizer stay float32 either way.
    compute_dtype: str = "float32"

    # Loop-unroll knobs of the JAX scans; kept for config compatibility,
    # eager PyTorch has no use for them.
    decoder_unroll: int = 1
    rnn_unroll: int = 1

    # Tacotron 2 only, at NVIDIA/tacotron2's hparams.py widths: the
    # encoder's convolutions and its BiLSTM (units per direction); the
    # attention and decoder LSTMs; the location features (filters over the
    # previous and the cumulative alignment); the post-net; the stop gate's
    # threshold on the sigmoid of its logit
    t2_enc_conv_num: int = 3
    t2_enc_conv_channels: int = 512
    t2_enc_conv_width: int = 5
    t2_enc_lstm_size: int = 256
    t2_attention_lstm_size: int = 1024
    t2_decoder_lstm_size: int = 1024
    t2_location_filters: int = 32
    t2_location_width: int = 31
    t2_postnet_conv_num: int = 5
    t2_postnet_channels: int = 512
    t2_postnet_width: int = 5
    t2_gate_threshold: float = 0.5

    def __post_init__(self):
        if self.architecture not in ARCHITECTURES:
            raise ValueError(f"architecture {self.architecture!r} is not one "
                             f"of {ARCHITECTURES}")
        if self.architecture != "tacotron2":
            return
        if self.num_speakers > 1:
            raise ValueError(
                "architecture 'tacotron2' is single-speaker: the port has "
                "no speaker conditioning for it (num_speakers must be 1)")
        if self.compute_dtype != "float32":
            raise ValueError(
                "architecture 'tacotron2' computes in float32 only: its "
                "reference and limits hold float32 with TF32 off")

    def scaled(self, factor: int) -> "ModelConfig":
        """Method form of :func:`scale_model_widths`:
        ``ModelConfig().scaled(2)``."""
        return scale_model_widths(self, factor)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization, schedule and training-loop settings
    (``train/``)."""

    batch_size: int = 16
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    initial_learning_rate: float = 0.002
    decay_learning_rate_mode: int = 0
    warmup_steps_fresh: float = 4000.0
    warmup_steps_finetune: float = 40000.0
    grad_clip_norm: float = 1.0
    prioritize_loss: bool = False
    recognition_loss_coeff: float = 0.2
    ignore_recognition_level: int = 1
    guided_attention_weight: float = 0.0
    guided_attention_sigma: float = 0.2
    guided_attention_decay_steps: int = 0
    on_device_features: bool = False
    device_resident_corpus: bool = False
    resident_corpus_max_bytes: int = 4 << 30
    initial_data_greedy: bool = True
    initial_phase_step: int = 8000
    main_data_greedy_factor: float = 0.0
    main_data: Tuple[str, ...] = ("",)
    checkpoint_interval: int = 1000
    summary_interval: int = 100
    test_interval: int = 500
    max_checkpoints_to_keep: int = 5


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Text frontend and corpus settings."""

    cleaners: str = "korean_cleaners"
    symbol_set: str = "korean"
    min_tokens: int = 50
    min_iters: int = 30
    max_iters: int = 200
    skip_inadequate: bool = False
    batches_per_group: int = 32
    bucket_size_tokens: int = 32
    bucket_size_frames: int = 64
    pad_to_corpus_max: bool = False
    store_waveform: bool = False

    def cleaner_names(self) -> Tuple[str, ...]:
        return tuple(c.strip() for c in self.cleaners.split(","))


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The rank grid of ``parallel/mesh.py``: ``data_parallelism`` ranks
    (-1: every rank the model axis leaves) by ``model_parallelism``."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallelism: int = -1
    model_parallelism: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def as_dict(self) -> dict:
        """The sections as nested dicts; a Tacotron model section leaves
        out ``architecture`` and the ``t2_*`` fields, so a Tacotron
        configuration's JSON is the JAX package's, field for field."""
        out = dataclasses.asdict(self)
        if self.model.architecture == "tacotron":
            out["model"] = {k: v for k, v in out["model"].items()
                            if k != "architecture" and not k.startswith("t2_")}
        return out

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.as_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        try:
            raw = json.loads(text)
        except json.JSONDecodeError:
            # tolerate trailing commas outside string literals
            stripped = re.sub(
                r'("(?:[^"\\]|\\.)*")|,(\s*[}\]])',
                lambda m: m.group(1) or m.group(2), text)
            raw = json.loads(stripped)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        def build(dc_cls, d: dict):
            fields = {f.name for f in dataclasses.fields(dc_cls)}
            kwargs: dict[str, Any] = {}
            for key, value in d.items():
                if key not in fields:
                    continue
                kwargs[key] = tuple(value) if isinstance(value, list) \
                    else value
            return dc_cls(**kwargs)

        return cls(
            audio=build(AudioConfig, raw.get("audio", {})),
            model=build(ModelConfig, raw.get("model", {})),
            train=build(TrainConfig, raw.get("train", {})),
            data=build(DataConfig, raw.get("data", {})),
            mesh=build(MeshConfig, raw.get("mesh", {})),
        )

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)

    @classmethod
    def tpu_recommended(cls, base: "Config" = None,
                        batch_size: int = 32) -> "Config":
        """The JAX package's composed training preset (``train --preset
        tpu``), with the same fields and values, on top of ``base`` (the
        defaults if omitted): bfloat16 compute; ``decoder_unroll`` and
        ``rnn_unroll`` 8; features extracted on the device from the stored
        int16 waveforms (``on_device_features``, ``store_waveform``: build
        the corpus with this config); batch 32.  The unroll fields are
        stored so the JSON equals JAX's; the port's eager loops do not read
        them."""
        base = base if base is not None else cls()
        return base.replace(
            model=dataclasses.replace(
                base.model, compute_dtype="bfloat16",
                decoder_unroll=8, rnn_unroll=8),
            train=dataclasses.replace(
                base.train, on_device_features=True,
                batch_size=batch_size),
            data=dataclasses.replace(base.data, store_waveform=True),
        )

    def debug_string(self) -> str:
        """Sorted hyperparameter dump, as the JAX config prints it."""
        flat = {f"{section}.{key}": value
                for section, fields in self.as_dict().items()
                for key, value in fields.items()}
        return "Hyperparameters:\n" + "\n".join(
            f"    {k}: {flat[k]}" for k in sorted(flat))


def save_config(config: Config, path: str) -> None:
    with open(path, "w") as fh:
        fh.write(config.to_json())


def load_config(path: str) -> Config:
    with open(path) as fh:
        return Config.from_json(fh.read())


def scale_model_widths(model: ModelConfig, factor: int) -> ModelConfig:
    """The reference's ``SCALE_FACTOR`` width divider (its ``hparams.py``)
    as a pure function: every hidden width the reference wraps in ``f()``
    is divided by ``factor`` (speaker and character embeddings; prenet,
    bank, projection, RNN and attention sizes); output dimensions
    (``num_mels``, ``num_freq``) and structural counts (bank K, highway
    depth, layers, r) are untouched, as in the reference:

        cfg.replace(model=scale_model_widths(cfg.model, 4))
    """
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")

    def f(n: int) -> int:
        return max(1, n // factor)

    return dataclasses.replace(
        model,
        speaker_embedding_size=f(model.speaker_embedding_size),
        embedding_size=f(model.embedding_size),
        enc_prenet_sizes=tuple(f(n) for n in model.enc_prenet_sizes),
        enc_bank_channel_size=f(model.enc_bank_channel_size),
        enc_rnn_size=f(model.enc_rnn_size),
        enc_proj_sizes=tuple(f(n) for n in model.enc_proj_sizes),
        attention_size=f(model.attention_size),
        attention_state_size=f(model.attention_state_size),
        dec_rnn_size=f(model.dec_rnn_size),
        dec_prenet_sizes=tuple(f(n) for n in model.dec_prenet_sizes),
        post_bank_channel_size=f(model.post_bank_channel_size),
        post_rnn_size=f(model.post_rnn_size),
        # the last post projection stays num_mels for the residual add
        post_proj_sizes=tuple(
            f(n) for n in model.post_proj_sizes[:-1]
        ) + (model.post_proj_sizes[-1],),
    )
