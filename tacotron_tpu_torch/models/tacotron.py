"""Tacotron + Deep Voice 2 multi-speaker model in PyTorch.

Counterpart of the JAX package's ``models/tacotron.py``; the module tree
carries the flax parameter names, so ``params.py`` maps one onto the other
by layout rules alone.  One decoder step:

  1. cell_in   = concat([input frame, prev attention context])
  2. pre       = prenet(cell_in)    [+ speaker embed if 'simple']
  3. attn_rnn  = GRU(attention_state_size)(pre)
  4. align     = attention(attn_rnn, keys, prev_align)  (or the manual override)
  5. context   = align @ values
  6. concat    = [attn_rnn, context] (+ speaker if 'simple')
  7. h         = Dense(dec_rnn_size)(concat)
  8. h         = h + GRU_i(h)   for each decoder layer (residual)
  9. frames    = Dense(num_mels * r)(h)

The decode loop is a Python loop over steps; greedy decoding feeds back the
last of the r frames, teacher forcing feeds every r-th target frame behind a
zero GO frame.

Training mode (``model.train()``) is the teacher-forced train path: the
prenets' dropout draws from the ``dropout_generator`` passed to
:meth:`Tacotron.forward` (the encoder prenet first, then the decoder prenet
step by step), and the BatchNorms use and update batch statistics.  The JAX
model folds the train step into its dropout key and splits it per decoder
step; here one generator, seeded per step by the caller, gives masks that
are a function of that seed alone (bit equality with JAX's masks is not a
goal).  Under data parallelism ``data_shard`` (a ``DataShard``) makes the
BatchNorms and the dropout masks global (``models/modules.py``).

Speaker conditioning ('single', 'deepvoice', 'simple'): 'deepvoice' feeds a
softsign Dense of the speaker embedding to the CBHG pre-highway bias, the
encoder BiGRU initial state, the attention GRU initial state and each
decoder GRU initial state; with ``speaker_embedding_size == 1`` each site
has its own raw table instead.  'simple' concatenates the embedding at the
decoder prenet output, the attention output and the post-net output.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.attention import initial_alignments, make_attention
from ..ops.rnn import GRUCell
from ..text.symbols import VOCAB_SIZE
from .modules import CBHG, Embed, Prenet


class SpeakerConditioning(NamedTuple):
    """Per-site speaker injections (None when unused)."""

    embed: Optional[torch.Tensor] = None               # [N, E] ('simple')
    before_highway: Optional[torch.Tensor] = None      # [N, enc_prenet[-1]]
    encoder_rnn_init: Optional[torch.Tensor] = None    # [N, 2*enc_rnn_size]
    attention_rnn_init: Optional[torch.Tensor] = None  # [N, att_state]
    decoder_rnn_inits: Optional[Tuple[torch.Tensor, ...]] = None


def _speaker_concat(cfg: ModelConfig) -> int:
    """Width of the speaker embedding concatenated by 'simple' models."""
    if cfg.model_type == "simple" and cfg.num_speakers > 1:
        return cfg.speaker_embedding_size
    return 0


class DecoderStep(nn.Module):
    """One decoder step; the parameters sit under the name ``decoder``."""

    def __init__(self, cfg: ModelConfig, memory_dim: int):
        super().__init__()
        self.cfg = cfg
        spk = _speaker_concat(cfg)
        self.prenet = Prenet(cfg.num_mels + memory_dim, cfg.dec_prenet_sizes,
                             cfg.dropout_prob)
        self.attention_rnn = GRUCell(cfg.dec_prenet_sizes[-1] + spk,
                                     cfg.attention_state_size)
        self.attention = make_attention(cfg.attention_type,
                                        cfg.attention_state_size,
                                        cfg.attention_size)
        self.decoder_input_projection = nn.Linear(
            cfg.attention_state_size + memory_dim + spk, cfg.dec_rnn_size)
        for i in range(cfg.dec_layer_num):
            self.add_module(f"decoder_rnn_{i + 1}",
                            GRUCell(cfg.dec_rnn_size, cfg.dec_rnn_size))
        self.frame_projection = nn.Linear(
            cfg.dec_rnn_size, cfg.num_mels * cfg.reduction_factor)

    def forward(self, x, attn_state, context, alignments, dec_states, keys,
                values, speaker, manual_t=None, is_manual=None,
                generator: Optional[torch.Generator] = None, shard=None):
        cfg = self.cfg
        pre = self.prenet(torch.cat([x, context], dim=-1), generator, shard)
        if speaker is not None:
            pre = torch.cat([pre, speaker], dim=-1)
        attn_state = self.attention_rnn(attn_state, pre)
        computed = self.attention(attn_state, keys, alignments)
        if manual_t is not None:
            computed = torch.where(is_manual, manual_t, computed)
        context = torch.einsum("nt,ntd->nd", computed, values)
        concat = torch.cat([attn_state, context], dim=-1)
        if speaker is not None:
            concat = torch.cat([concat, speaker], dim=-1)
        h = self.decoder_input_projection(concat)
        new_states = []
        for i in range(cfg.dec_layer_num):
            state = getattr(self, f"decoder_rnn_{i + 1}")(dec_states[i], h)
            new_states.append(state)
            h = h + state
        frames = self.frame_projection(h)
        return frames, attn_state, context, computed, tuple(new_states)


class Tacotron(nn.Module):
    """Encoder, attention decoder loop and post-net."""

    def __init__(self, cfg: ModelConfig, vocab_size: int = VOCAB_SIZE):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {cfg.compute_dtype!r} is not ported; the "
                f"port computes in float32")
        self.cfg = cfg
        memory_dim = 2 * cfg.enc_rnn_size
        self.char_embedding = Embed(vocab_size, cfg.embedding_size, 0.5)
        self.encoder_prenet = Prenet(cfg.embedding_size, cfg.enc_prenet_sizes,
                                     cfg.dropout_prob)
        self.encoder_cbhg = CBHG(
            cfg.enc_prenet_sizes[-1], cfg.enc_bank_size,
            cfg.enc_bank_channel_size, cfg.enc_maxpool_width,
            cfg.enc_highway_depth, cfg.enc_rnn_size, cfg.enc_proj_sizes,
            cfg.enc_proj_width)
        self.attention_memory_layer = nn.Linear(memory_dim, cfg.attention_size,
                                                bias=False)
        self.decoder = DecoderStep(cfg, memory_dim)
        self.post_cbhg = CBHG(
            cfg.num_mels, cfg.post_bank_size, cfg.post_bank_channel_size,
            cfg.post_maxpool_width, cfg.post_highway_depth, cfg.post_rnn_size,
            cfg.post_proj_sizes, cfg.post_proj_width)
        self.linear_projection = nn.Linear(
            2 * cfg.post_rnn_size + _speaker_concat(cfg), cfg.num_freq)
        self._build_speaker_modules()

    # ------------------------------------------------------------ speaker

    def _build_speaker_modules(self):
        cfg = self.cfg
        if cfg.num_speakers <= 1:
            return
        if cfg.model_type not in ("simple", "deepvoice"):
            raise ValueError(
                f"multi-speaker requires model_type 'deepvoice' or "
                f"'simple', got {cfg.model_type!r}")
        S, E = cfg.num_speakers, cfg.speaker_embedding_size
        sites = [("before_highway", cfg.enc_prenet_sizes[-1]),
                 ("encoder_rnn_init", cfg.enc_rnn_size * 2),
                 ("attention_rnn_init", cfg.attention_state_size)] + [
                     (f"decoder_rnn_init_{i + 1}", cfg.dec_rnn_size)
                     for i in range(cfg.dec_layer_num)]
        if cfg.model_type == "simple":
            self.speaker_embedding = Embed(S, E, 0.5)
        elif E == 1:
            # raw per-site tables, under the reference's names
            names = {"before_highway": "before_highway",
                     "encoder_rnn_init": "encoder_rnn_init_state",
                     "attention_rnn_init": "attention_rnn_init_state"}
            for site, width in sites:
                name = names.get(site, site.replace(
                    "decoder_rnn_init_", "decoder_rnn_init_states_"))
                self.add_module(name, Embed(S, width, 0.1))
        else:
            self.speaker_embedding = Embed(S, E, 0.5)
            for site, width in sites:
                self.add_module(f"deep_{site}", nn.Linear(E, width))

    def speaker_conditioning(self, speaker_id: Optional[torch.Tensor]
                             ) -> SpeakerConditioning:
        cfg = self.cfg
        if cfg.num_speakers <= 1:
            return SpeakerConditioning()
        if speaker_id is None:
            raise ValueError("a multi-speaker model needs speaker_id")
        if cfg.model_type == "simple":
            return SpeakerConditioning(embed=self.speaker_embedding(speaker_id))
        n_dec = cfg.dec_layer_num
        if cfg.speaker_embedding_size == 1:
            return SpeakerConditioning(
                before_highway=self.before_highway(speaker_id),
                encoder_rnn_init=self.encoder_rnn_init_state(speaker_id),
                attention_rnn_init=self.attention_rnn_init_state(speaker_id),
                decoder_rnn_inits=tuple(
                    getattr(self, f"decoder_rnn_init_states_{i + 1}")(
                        speaker_id) for i in range(n_dec)))
        embed = self.speaker_embedding(speaker_id)

        def site(name):
            return F.softsign(getattr(self, f"deep_{name}")(embed))

        return SpeakerConditioning(
            before_highway=site("before_highway"),
            encoder_rnn_init=site("encoder_rnn_init"),
            attention_rnn_init=site("attention_rnn_init"),
            decoder_rnn_inits=tuple(site(f"decoder_rnn_init_{i + 1}")
                                    for i in range(n_dec)))

    # ------------------------------------------------------------ encoder

    def encode(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
               cond: SpeakerConditioning,
               generator: Optional[torch.Generator] = None,
               shard=None) -> torch.Tensor:
        """Token ids [N, T_in] -> memory [N, T_in, 2*enc_rnn_size]."""
        pre = self.encoder_prenet(self.char_embedding(inputs), generator,
                                  shard)
        return self.encoder_cbhg(pre, input_lengths,
                                 before_highway=cond.before_highway,
                                 rnn_init_state=cond.encoder_rnn_init,
                                 shard=shard)

    # ------------------------------------------------------------ decoder

    def run_decoder(self, memory: torch.Tensor, num_steps: int,
                    decoder_inputs: Optional[torch.Tensor],
                    cond: SpeakerConditioning,
                    manual_alignments: Optional[torch.Tensor] = None,
                    is_manual: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (frames [N, steps, M*r], alignments [N, steps, T_in])."""
        cfg = self.cfg
        N, T_in, memory_dim = memory.shape
        keys = self.attention_memory_layer(memory)
        attn_state = (cond.attention_rnn_init
                      if cond.attention_rnn_init is not None
                      else memory.new_zeros((N, cfg.attention_state_size)))
        dec_states = (cond.decoder_rnn_inits
                      if cond.decoder_rnn_inits is not None
                      else tuple(memory.new_zeros((N, cfg.dec_rnn_size))
                                 for _ in range(cfg.dec_layer_num)))
        context = memory.new_zeros((N, memory_dim))
        alignments = initial_alignments(cfg.attention_type, N, T_in,
                                        device=memory.device,
                                        dtype=memory.dtype)
        prev_frame = memory.new_zeros((N, cfg.num_mels))
        if is_manual is not None:
            is_manual = torch.as_tensor(is_manual, device=memory.device)

        all_frames, all_aligns = [], []
        for t in range(num_steps):
            x = prev_frame if decoder_inputs is None else decoder_inputs[:, t]
            manual_t = (None if manual_alignments is None
                        else manual_alignments[:, t])
            frames, attn_state, context, alignments, dec_states = \
                self.decoder(x, attn_state, context, alignments, dec_states,
                             keys, memory, cond.embed, manual_t, is_manual,
                             generator, shard)
            prev_frame = frames[:, -cfg.num_mels:]
            all_frames.append(frames)
            all_aligns.append(alignments)
        return torch.stack(all_frames, 1), torch.stack(all_aligns, 1)

    # ------------------------------------------------------------- forward

    def forward(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                speaker_id: Optional[torch.Tensor] = None,
                mel_targets: Optional[torch.Tensor] = None,
                max_steps: Optional[int] = None,
                manual_alignments: Optional[torch.Tensor] = None,
                is_manual: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None,
                data_shard=None) -> Dict[str, torch.Tensor]:
        """Teacher-forced when ``mel_targets`` is given, greedy otherwise.
        Returns ``mel_outputs`` [N, T_out, M], ``linear_outputs``
        [N, T_out, F] and ``alignments`` [N, T_in, T_dec].
        ``dropout_generator`` feeds the prenets' dropout in training mode
        (the post-net has none); ``data_shard`` makes the training-mode
        statistics and masks global over the data group."""
        cfg = self.cfg
        r = cfg.reduction_factor
        cond = self.speaker_conditioning(speaker_id)
        memory = self.encode(inputs, input_lengths, cond, dropout_generator,
                             data_shard)

        if mel_targets is not None:
            taken = mel_targets[:, r - 1::r, :]
            decoder_inputs = torch.cat(
                [torch.zeros_like(taken[:, :1]), taken[:, :-1]], dim=1)
            num_steps = decoder_inputs.shape[1]
        else:
            decoder_inputs = None
            num_steps = max_steps if max_steps is not None else cfg.max_iters

        frames, align_history = self.run_decoder(
            memory, num_steps, decoder_inputs, cond, manual_alignments,
            is_manual, dropout_generator, data_shard)
        N = inputs.shape[0]
        mel_outputs = frames.reshape(N, num_steps * r, cfg.num_mels)

        post = self.post_cbhg(mel_outputs, None, shard=data_shard)
        if cond.embed is not None:
            tiled = cond.embed[:, None, :].expand(N, post.shape[1], -1)
            post = torch.cat([tiled, post], dim=-1)
        linear_outputs = self.linear_projection(post)
        return {
            "mel_outputs": mel_outputs,
            "linear_outputs": linear_outputs,
            "alignments": align_history.transpose(1, 2),
        }
