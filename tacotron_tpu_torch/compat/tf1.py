"""TF1 reference-checkpoint import: variable-name mapping -> flax trees (a
copy of the JAX package's ``compat/tf1.py``).

Maps the reference graph's variable names (scopes from the reference's
``models/tacotron.py:29`` ``model/inference/...``,
``models/modules.py`` cbhg/highway/conv scoping, TF1.3
``bidirectional_rnn/{fw,bw}/gru_cell/{gates,candidate}`` cell naming) onto
the flax param/batch_stats trees that ``params.py`` turns into the port's
state dict.

Layout notes:

- TF1 GRUCell and the port's :class:`~tacotron_tpu_torch.ops.rnn.GRUCell`
  (in the flax layout) share the ``[x, h] @ W`` layout and ``[r, u]`` gate
  order — kernels copy over unchanged.
- The reference applies a separate BatchNorm per conv-bank branch
  (``modules.py:123-131``); our fused bank uses one BN over the
  concatenated channels, so the per-branch gamma/beta/moving stats are
  concatenated in branch order (mathematically identical).
- Dense/conv kernels are identical layouts ([in, out] / [width, in, out]).

Two mappers exist: the exact rule table in :mod:`.names` (the complete
inventory including decoder wrapper-stack scopes, used whenever a
``Config`` is supplied — zero unmatched/unfilled residue, round-tripped in
``tests/test_torch_compat.py``), and the lenient regex mapper below (no config
needed; covers the common scopes when the exact hyperparameters of a
foreign bundle are unknown).  :func:`import_report` lists every source
variable that did not match and every target leaf not filled, so any
residual rename in a real ``son``/``park`` bundle is pinned down quickly.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from .bundle import read_checkpoint


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


_GRU_LEAF = {"gates/kernel": ("gates", "kernel"),
             "gates/bias": ("gates", "bias"),
             "candidate/kernel": ("candidate", "kernel"),
             "candidate/bias": ("candidate", "bias")}

_BN_PARAM = {"gamma": "scale", "beta": "bias"}
_BN_STAT = {"moving_mean": "mean", "moving_variance": "var"}


def _map_cbhg(name: str, rest: str, params: dict, stats: dict,
              arr: np.ndarray, bank_parts: dict, cbhg_key: str) -> bool:
    """Map one ``<cbhg scope>/...`` variable; returns True if consumed."""
    m = re.match(r"conv_bank/conv1d_(\d+)/conv1d/(kernel|bias)$", rest)
    if m:
        bank_parts.setdefault((cbhg_key, "conv", m.group(2)), {})[
            int(m.group(1))] = arr
        return True
    m = re.match(r"conv_bank/conv1d_(\d+)/batch_normalization/(\w+)$", rest)
    if m:
        bank_parts.setdefault((cbhg_key, "bn", m.group(2)), {})[
            int(m.group(1))] = arr
        return True
    m = re.match(r"proj_(\d+)/conv1d/(kernel|bias)$", rest)
    if m:
        _set(params, (cbhg_key, f"proj_{m.group(1)}", m.group(2)), arr)
        return True
    m = re.match(r"proj_(\d+)/batch_normalization/(\w+)$", rest)
    if m:
        what = m.group(2)
        if what in _BN_PARAM:
            _set(params, (cbhg_key, f"proj_{m.group(1)}_bn", "BatchNorm_0",
                          _BN_PARAM[what]), arr)
        elif what in _BN_STAT:
            _set(stats, (cbhg_key, f"proj_{m.group(1)}_bn", "BatchNorm_0",
                         _BN_STAT[what]), arr)
        return True
    m = re.match(r"dense/(kernel|bias)$", rest)
    if m:
        _set(params, (cbhg_key, "highway_dim_fix", m.group(1)), arr)
        return True
    m = re.match(r"highway_(\d+)/([HT])/(kernel|bias)$", rest)
    if m:
        _set(params, (cbhg_key, f"highway_{m.group(1)}", m.group(2),
                      m.group(3)), arr)
        return True
    m = re.match(r"bidirectional_rnn/(fw|bw)/gru_cell/(.+)$", rest)
    if m and m.group(2) in _GRU_LEAF:
        _set(params, (cbhg_key, "bigru", m.group(1)) + _GRU_LEAF[m.group(2)],
             arr)
        return True
    return False


def map_tf1_variables(tensors: Dict[str, np.ndarray]
                      ) -> Tuple[dict, dict, List[str]]:
    """{tf_name: array} -> (params, batch_stats, unmatched_names)."""
    params: dict = {}
    stats: dict = {}
    unmatched: List[str] = []
    bank_parts: dict = {}

    for name, arr in tensors.items():
        if name.startswith("model/"):
            name = name[len("model/"):]
        if not name.startswith("inference/"):
            # optimizer slots (Adam), global_step, loss scope etc.
            continue
        rest = name[len("inference/"):]

        if rest == "embedding":
            _set(params, ("char_embedding", "embedding"), arr)
            continue
        m = re.match(r"prenet/dense_(\d)/(kernel|bias)$", rest)
        if m:
            _set(params, ("encoder_prenet", f"dense_{m.group(1)}",
                          m.group(2)), arr)
            continue
        m = re.match(r"decoder_prenet/dense_(\d)/(kernel|bias)$", rest)
        if m:
            _set(params, ("decoder", "prenet", f"dense_{m.group(1)}",
                          m.group(2)), arr)
            continue
        m = re.match(r"(encoder_cbhg|post_cbhg)/(.+)$", rest)
        if m and _map_cbhg(name, m.group(2), params, stats, arr, bank_parts,
                           m.group(1)):
            continue
        if rest == "memory_layer/kernel":
            _set(params, ("attention_memory_layer", "kernel"), arr)
            continue
        m = re.match(r".*?(query_layer)/kernel$", rest)
        if m:
            _set(params, ("decoder", "attention", "query_layer", "kernel"),
                 arr)
            continue
        if rest.endswith("attention_v"):
            _set(params, ("decoder", "attention", "attention_v"),
                 arr.reshape(-1, 1))
            continue
        if rest.endswith("attention_score_bias"):
            # scalar bias of the monotonic mechanism only
            _set(params, ("decoder", "attention", "score_bias"),
                 arr.reshape(()))
            continue
        if rest.endswith("attention_b"):
            # [U] bias of normalized Bahdanau (bah_norm) — NOT score_bias
            _set(params, ("decoder", "attention", "attention_b"), arr)
            continue
        if rest.endswith("attention_g"):
            _set(params, ("decoder", "attention", "attention_g"),
                 arr.reshape(()))
            continue
        # decoder cells (TF1.3 dynamic_decode scope, best-effort):
        m = re.match(
            r"decoder/.*?attention_wrapper/gru_cell/(.+)$", rest)
        if m and m.group(1) in _GRU_LEAF:
            _set(params, ("decoder", "attention_rnn")
                 + _GRU_LEAF[m.group(1)], arr)
            continue
        m = re.match(
            r"decoder/.*?cell_0.*?output_projection_wrapper/"
            r"(kernel|bias)$", rest)
        if m:
            _set(params, ("decoder", "decoder_input_projection",
                          m.group(1)), arr)
            continue
        m = re.match(
            r"decoder/.*?cell_(\d+).*?gru_cell/(.+)$", rest)
        if m and m.group(2) in _GRU_LEAF:
            layer = int(m.group(1))  # cell_1.. are the residual GRUs
            _set(params, ("decoder", f"decoder_rnn_{layer}")
                 + _GRU_LEAF[m.group(2)], arr)
            continue
        m = re.match(
            r"decoder/.*?output_projection_wrapper(_1)?/(kernel|bias)$",
            rest)
        if m:
            _set(params, ("decoder", "frame_projection", m.group(2)), arr)
            continue
        m = re.match(r"dense(_1)?/(kernel|bias)$", rest)
        if m:  # final linear projection (tf.layers.dense at tacotron.py:235)
            _set(params, ("linear_projection", m.group(2)), arr)
            continue
        if rest.startswith("speaker_embedding"):
            _set(params, ("speaker_embedding", "embedding"), arr)
            continue
        unmatched.append(name)

    # assemble fused conv banks from the per-branch pieces
    for (cbhg_key, kind, leaf), branches in sorted(bank_parts.items()):
        ordered = [branches[k] for k in sorted(branches)]
        if kind == "conv":
            if leaf == "kernel":
                for k, kernel in zip(sorted(branches), ordered):
                    _set(params, (cbhg_key, "conv_bank", f"kernel_{k}"),
                         kernel)
            else:
                _set(params, (cbhg_key, "conv_bank", "bias"),
                     np.concatenate(ordered))
        else:
            cat = np.concatenate(ordered)
            if leaf in _BN_PARAM:
                _set(params, (cbhg_key, "bank_bn", "BatchNorm_0",
                              _BN_PARAM[leaf]), cat)
            elif leaf in _BN_STAT:
                _set(stats, (cbhg_key, "bank_bn", "BatchNorm_0",
                             _BN_STAT[leaf]), cat)
    return params, stats, unmatched


def resolve_checkpoint_prefix(path: str) -> str:
    """Accept either a ``model.ckpt-N`` prefix or a run DIRECTORY and
    return the newest prefix — the reference's checkpoint discovery (its
    ``models/__init__.py:10-17`` globs ``*.ckpt-*.data-*`` and takes the max
    step)."""
    import glob
    import os
    if not os.path.isdir(path):
        return path
    steps = []
    for p in glob.glob(os.path.join(path, "*.ckpt-*.index")):
        stem = p[:-len(".index")]
        try:
            steps.append((int(stem.rsplit("-", 1)[1]), stem))
        except ValueError:
            continue
    if not steps:
        raise FileNotFoundError(
            f"no model.ckpt-N bundle found in directory {path!r}")
    return max(steps)[1]


def import_tf1_checkpoint(prefix: str, config: Optional[Config] = None
                          ) -> Tuple[dict, dict, List[str]]:
    """Read a reference ``model.ckpt-N`` and map to flax trees.

    With a config, the exact rule table (:mod:`.names`) is used — zero
    residue expected; without one, the lenient regex mapper covers the
    common scopes.  ``prefix`` may be a run directory (newest bundle is
    picked, reference-style)."""
    tensors = read_checkpoint(resolve_checkpoint_prefix(prefix))
    if config is not None:
        from .names import import_tf1
        params, stats, unmatched, _ = import_tf1(tensors, config)
        return params, stats, unmatched
    return map_tf1_variables(tensors)


def import_report(prefix: str, config: Optional[Config] = None) -> str:
    """Human-readable mapping report: what matched, what didn't, and (with a
    config) which rule targets the bundle did not fill."""
    from ..params import flatten_variables

    def n_leaves(tree: dict) -> int:
        return len(flatten_variables(tree))

    tensors = read_checkpoint(resolve_checkpoint_prefix(prefix))
    if config is not None:
        from .names import import_tf1
        params, stats, unmatched, unfilled = import_tf1(tensors, config)
        lines = [f"mapped params leaves: {n_leaves(params)}",
                 f"mapped batch_stats leaves: {n_leaves(stats)}",
                 f"unmatched source variables: {len(unmatched)}"]
        lines += [f"  ? {n}" for n in unmatched]
        lines.append(f"rule targets not in bundle: {len(unfilled)}")
        lines += [f"  ! {n}" for n in unfilled]
        return "\n".join(lines)

    params, stats, unmatched = map_tf1_variables(tensors)
    lines = [f"mapped params leaves: {n_leaves(params)}",
             f"mapped batch_stats leaves: {n_leaves(stats)}",
             f"unmatched source variables: {len(unmatched)}"]
    lines += [f"  ? {n}" for n in unmatched]
    return "\n".join(lines)


def export_tf1_checkpoint(prefix: str, params: dict, batch_stats: dict,
                          config: Config) -> None:
    """Write trained flax params as a TF1 bundle under the exact reference
    variable names (readable by the reference's ``Saver.restore``)."""
    from .bundle import write_checkpoint
    from .names import export_tf1
    write_checkpoint(prefix, export_tf1(params, batch_stats, config))
