"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``reference/``) on the same inputs, each
number beside its limit (``limits/<workload>.json``).

Offline and served synthesis, per utterance of the sample:

- ``align_gap``: the widest gap between the program's alignments and the
  reference's (the decode: frontend ids, padding, decode budget, encoder,
  attention, decoder);
- ``wave_gap``: the L2 distance between the program's waveform and the
  reference's, over the reference's norm, averaged over the sample
  (post-net, Griffin-Lim, the wire);
- ``length_mismatch``: utterances whose alignment or waveform has another
  shape than the reference's (exact: limit 0).

The model family (``families/<family>.py``, ``core.family``) gives the
reference, the decode budget and any further per-utterance numbers
(``SAMPLE_FIELDS``, ``field_gaps``); the vocoder and the wire are shared.

The control (``CONTROL``) is the reference in the program's place one
precision below what the configuration states: TF32 products in the model
(float32 with TF32 off is stated) and float8 e4m3 operands in the
vocoder's DFT products (bf16 is stated).  ``calibrate.py`` also reads
``fp8_vocoder``, the vocoder's step alone (the model in float32).
Training's control is the model's step alone, ``tf32``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch

from .core import Cell, judge
from .reference.frontend import PAD_ID, text_to_ids
from .reference.tacotron import Reference
from .reference.vocoder import int16_wire, spectrogram_to_waveform
from .traffic import generate

#: the decode-step rungs of the serving budget
STEP_LADDER = (50, 100, 150, 200)
TOKEN_BUCKET = 32


def decode_budget(cfg: dict, n_tokens: int) -> int:
    """Decode steps for a call whose longest text has ``n_tokens`` ids:
    ``steps_per_token`` a token, within [min_iters, max_iters], rounded up
    to the ladder."""
    m = cfg["model"]
    need = int(math.ceil(m["steps_per_token"] * max(1, n_tokens)))
    need = min(max(need, cfg["data"]["min_iters"]), m["max_iters"])
    for rung in STEP_LADDER:
        if need <= rung <= m["max_iters"]:
            return rung
    return m["max_iters"]


#: the controls by name, and the one that has to fail each cell's
#: numbers; offline: (the model's precision, the vocoder's)
CONTROL = {"offline": "tf32_fp8", "train": "tf32"}
OFFLINE_CONTROLS = {"tf32_fp8": ("tf32", "fp8"),
                    "fp8_vocoder": ("float32", "fp8")}


def reference_outputs(family, cfg: dict, variables, items: List[dict],
                      call_texts: Dict[int, List[str]], iters: int,
                      momentum: float, device,
                      precision: tuple = ("float32", "bf16")):
    """The family's reference's alignments, waveforms and rows of its
    ``SAMPLE_FIELDS`` for ``items``, each decoded in its call's token
    bucket and the family's budget, at ``precision`` (the model's, the
    vocoder's)."""
    m, audio = cfg["model"], cfg["audio"]
    fields = getattr(family, "SAMPLE_FIELDS", ())
    groups: Dict[tuple, List[int]] = {}
    for i, item in enumerate(items):
        longest = max(len(text_to_ids(t)) for t in call_texts[item["call"]])
        bucket = -(-longest // TOKEN_BUCKET) * TOKEN_BUCKET
        groups.setdefault((bucket, family.decode_budget(cfg, longest)),
                          []).append(i)
    ref = family.reference(variables, m, precision[0])
    aligns: List = [None] * len(items)
    wavs: List = [None] * len(items)
    rows: List = [None] * len(items)
    for (bucket, steps), idx in groups.items():
        for lo in range(0, len(idx), 16):
            block = idx[lo:lo + 16]
            ids = [text_to_ids(items[i]["text"]) for i in block]
            inputs = torch.full((len(block), bucket), PAD_ID,
                                dtype=torch.long)
            for row, x in enumerate(ids):
                inputs[row, :len(x)] = torch.tensor(x)
            lengths = torch.tensor([len(x) for x in ids])
            speaker = None
            if m["num_speakers"] > 1:
                speaker = torch.tensor([items[i].get("speaker", 0)
                                        for i in block], device=device)
            out = ref.infer(inputs.to(device), lengths.to(device), speaker,
                            steps)
            wav = int16_wire(spectrogram_to_waveform(
                out["linear_outputs"], audio, iters, momentum,
                precision[1]))
            for row, i in enumerate(block):
                aligns[i] = out["alignments"][row, :len(ids[row])].cpu()
                wavs[i] = wav[row].cpu()
                rows[i] = {f: out[f][row].cpu() for f in fields}
            del out, wav
    return aligns, wavs, rows


def gaps(items: List[dict], aligns, wavs) -> Dict[str, float]:
    """``align_gap`` (the worst utterance), ``wave_gap`` (the mean over
    the utterances: a bf16 Griffin-Lim carries a rounding difference of
    1e-7 in its input into a gap of 0.1-0.5 in single waveforms, so the
    mean is the steady reading) and ``length_mismatch``."""
    align_gap, wave = 0.0, []
    mismatch = 0
    for item, a_ref, w_ref in zip(items, aligns, wavs):
        a = torch.as_tensor(np.asarray(item["alignment"]))
        w = torch.as_tensor(np.asarray(item["wav"])).double()
        if a.shape != a_ref.shape or w.shape != w_ref.shape:
            mismatch += 1
            continue
        align_gap = max(align_gap, float((a - a_ref).abs().max()))
        w_ref = w_ref.double()
        wave.append(float((w - w_ref).norm() / w_ref.norm()))
    return {"align_gap": align_gap,
            "wave_gap": float(np.mean(wave)) if wave else float("inf"),
            "length_mismatch": float(mismatch)}


def family_gaps(family, items: List[dict], aligns, wavs, rows
                ) -> Dict[str, float]:
    """:func:`gaps`, and the family's ``field_gaps`` where it names
    ``SAMPLE_FIELDS``."""
    out = gaps(items, aligns, wavs)
    if getattr(family, "SAMPLE_FIELDS", ()):
        out.update(family.field_gaps(items, rows))
    return out


def offline_numbers(cell: Cell, family, seed: int, sample: List[dict],
                    variables, device, control: bool = False):
    """The numbers of the program's ``sample`` against ``family``'s
    reference; with ``control``, each control's numbers by name
    instead."""
    cfg, mix = cell.config["config"], cell.traffic
    iters, momentum = generate.griffin_lim(mix, cfg["audio"])
    call_texts = {item["call"]: generate.texts(mix, seed, item["call"])
                  for item in sample}
    ref = reference_outputs(family, cfg, variables, sample, call_texts,
                            iters, momentum, device)
    if not control:
        return family_gaps(family, sample, *ref)
    out = {}
    for name, precision in OFFLINE_CONTROLS.items():
        c_aligns, c_wavs, c_rows = reference_outputs(
            family, cfg, variables, sample, call_texts, iters, momentum,
            device, precision)
        as_items = [dict({k: v.numpy() for k, v in r.items()},
                         alignment=a.numpy(), wav=w.numpy())
                    for a, w, r in zip(c_aligns, c_wavs, c_rows)]
        out[name] = family_gaps(family, as_items, *ref)
    return out


def judged(cell: Cell, numbers: Dict[str, float]) -> List[dict]:
    return judge(numbers, cell.limits["limits"])


# ------------------------------------------------------------------ training

def dropout_seed(seed: int, step: int) -> int:
    """The dropout generator's seed at ``step``, by the configuration's
    seeding rule: a hash of (seed, step) alone."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0] >> 1)


def reference_batch(batch, index: Dict[bytes, tuple], data: dict, r: int):
    """The reference's batch for the utterances of the program's ``batch``
    (each found in the corpus by its token ids), padded as the reference
    pads one: tokens to a multiple of ``bucket_size_tokens``, frames to
    max + 1 rounded up to r, then to a multiple of ``bucket_size_frames``;
    the speaker is the index of its directory.  Returns (fields, the number
    of fields that differ from the program's)."""
    rows = []
    for i in range(batch.inputs.shape[0]):
        ids = np.asarray(batch.inputs[i, :batch.input_lengths[i]], np.int32)
        rows.append(index.get(ids.tobytes()))
    if any(row is None for row in rows):
        return None, len(rows)
    loaded = []
    for spk, path in rows:
        with np.load(path) as z:
            loaded.append((spk, z["tokens"], float(z["loss_coeff"]),
                           z["mel"], z["linear"]))

    def up(x, mult):
        return -(-x // mult) * mult

    tok_len = up(max(len(x[1]) for x in loaded), data["bucket_size_tokens"])
    frame_len = up(up(max(len(x[3]) for x in loaded) + 1, r),
                   max(data["bucket_size_frames"], r))
    n = len(loaded)
    f = {"inputs": np.zeros((n, tok_len), np.int32),
         "input_lengths": np.zeros(n, np.int32),
         "loss_coeff": np.zeros(n, np.float32),
         "speaker_id": np.zeros(n, np.int32),
         "target_lengths": np.zeros(n, np.int32),
         "mel_targets": np.zeros((n, frame_len, loaded[0][3].shape[1]),
                                 np.float32),
         "linear_targets": np.zeros((n, frame_len, loaded[0][4].shape[1]),
                                    np.float32)}
    for i, (spk, tokens, coeff, mel, lin) in enumerate(loaded):
        f["inputs"][i, :len(tokens)] = tokens
        f["input_lengths"][i] = len(tokens)
        f["loss_coeff"][i] = coeff
        f["speaker_id"][i] = spk
        f["target_lengths"][i] = len(mel)
        f["mel_targets"][i, :len(mel)] = mel
        f["linear_targets"][i, :len(lin)] = lin
    differ = sum(
        not (np.shape(getattr(batch, k)) == v.shape
             and np.array_equal(np.asarray(getattr(batch, k)), v))
        for k, v in f.items())
    return f, differ


def corpus_index(dirs: List[str]) -> Dict[bytes, tuple]:
    index = {}
    for spk, d in enumerate(dirs):
        for name in sorted(os.listdir(d)):
            path = os.path.join(d, name)
            with np.load(path) as z:
                index[np.asarray(z["tokens"], np.int32).tobytes()] = (spk,
                                                                      path)
    return index


def _leaf_gap(program: Dict[str, np.ndarray], ref: Dict[str, torch.Tensor],
              keys: List[str]) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    ref_n = {k: float(ref[k].double().norm()) for k in keys}
    prog_n = {k: float(np.linalg.norm(np.asarray(program[k], np.float64)))
              for k in keys}
    median = float(np.median(list(ref_n.values())))
    return max(abs(prog_n[k] - ref_n[k]) / max(ref_n[k], median, 1e-30)
               for k in keys)


def train_numbers(cell: Cell, dseed: int, kept, dirs: List[str], variables,
                  program: dict, device, control: bool = False
                  ) -> Dict[str, float]:
    """The reference follows the program's first steps on the same
    utterances: batch assembly (exact), each step's loss, the first
    gradient as the optimizer gets it (worst leaf) and the change of every
    variable over the steps (worst leaf; parameters whose reference
    gradient is under a thousandth of the median leaf's are left out: they
    move under Adam by rounding alone).  With ``control`` the reference at
    TF32 stands in the program's place."""
    from .reference.tacotron import Adam, l1_loss
    cfg = cell.config["config"]
    m, r = cfg["model"], cfg["model"]["reduction_factor"]
    index = corpus_index(dirs)
    v = {k: t.clone() for k, t in variables.items()}
    params = {k: t.requires_grad_(True) for k, t in v.items()
              if k.startswith("params/")}
    ref = Reference(v, m, "float32")
    adam = Adam(cfg["train"], params)
    twin = None
    if control:
        tv = {k: t.detach().clone() for k, t in variables.items()}
        tparams = {k: t.requires_grad_(True) for k, t in tv.items()
                   if k.startswith("params/")}
        twin = (Reference(tv, m, "tf32"), Adam(cfg["train"], tparams),
                tparams)
    mismatch, losses, grads1 = 0.0, [], None
    twin_losses, twin_grads1 = [], None
    for step, batch in enumerate(kept):
        f, differ = reference_batch(batch, index, cfg["data"], r)
        mismatch += differ
        if f is None:
            return {"batch_mismatch": mismatch, "loss_gap": float("inf"),
                    "grad_gap": float("inf"), "update_gap": float("inf")}
        t = {k: torch.as_tensor(a).to(device) for k, a in f.items()}
        speaker = (t["speaker_id"].long() if m["num_speakers"] > 1
                   else None)

        def one_step(model, opt, leaves):
            gen = torch.Generator(device=device).manual_seed(
                dropout_seed(dseed, step))
            out, stats = model.train_forward(
                t["inputs"].long(), t["input_lengths"].long(), speaker,
                t["mel_targets"], gen)
            loss = l1_loss(out, t["mel_targets"], t["linear_targets"],
                           t["loss_coeff"], t["target_lengths"], r)
            keys = list(leaves)
            got = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                      allow_unused=True)
            grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
                     for k, g in zip(keys, got)}
            clipped = opt.step(leaves, grads)
            with torch.no_grad():
                for k, s in stats.items():
                    model.v[k].copy_(s)
            return float(loss.detach()), clipped

        loss, clipped = one_step(ref, adam, params)
        losses.append(loss)
        if step == 0:
            grads1 = clipped
        if twin is not None:
            loss, clipped = one_step(*twin)
            twin_losses.append(loss)
            if step == 0:
                twin_grads1 = clipped

    def numbers(p_loss, p_grad, p_after):
        gkeys = sorted(grads1)
        gnorm = {k: float(grads1[k].double().norm()) for k in gkeys}
        median = float(np.median(list(gnorm.values())))
        moving = [k for k in gkeys if gnorm[k] >= 1e-3 * median] + sorted(
            k for k in v if k.startswith("batch_stats/"))
        delta_ref = {k: (v[k] - variables[k]).detach() for k in moving}
        delta_prog = {k: np.asarray(p_after[k], np.float64)
                      - variables[k].double().cpu().numpy() for k in moving}
        return {"batch_mismatch": mismatch,
                "loss_gap": max(abs(a - b) / abs(b)
                                for a, b in zip(p_loss, losses)),
                "grad_gap": _leaf_gap(p_grad, grads1, gkeys),
                "update_gap": _leaf_gap(delta_prog, delta_ref, moving)}

    if twin is None:
        return numbers(program["loss"], program["grad"], program["after"])
    tv = twin[0].v
    return numbers(twin_losses,
                   {k: g.detach().cpu().numpy()
                    for k, g in twin_grads1.items()},
                   {k: t.detach().cpu().numpy() for k, t in tv.items()})
