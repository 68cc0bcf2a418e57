"""The complete TF1.3 variable-name inventory of the reference graph (a
copy of the JAX package's ``compat/names.py``).

Transcribed from the reference graph code — every rule cites the construction
site — so that published ``son``/``park`` bundles (the reference's
``download.py:82-109``) import with **zero unmatched / zero unfilled**
leaves, and trained params export back under the exact reference names.

Naming model (TF 1.3): each ``tf.layers``/``RNNCell`` object contributes a
snake-cased class-name scope at its *first call site*; ``_linear`` creates
``kernel``/``bias`` in the caller's scope; ``MultiRNNCell.call`` wraps cell i
in ``cell_{i}``; ``dynamic_decode`` opens scope ``decoder``
(``tf.contrib.seq2seq``); the whole graph sits under ``model/inference``
(the reference's ``train.py:145``, ``synthesizer.py:47``,
``models/tacotron.py:29``).  The decoder wrapper stack
(``models/tacotron.py:154-181``)::

    OutputProjectionWrapper( MultiRNNCell([
        OutputProjectionWrapper( ConcatOutputAndAttentionWrapper(
            AttentionWrapper( DecoderPrenetWrapper(GRUCell) ) ) ),
        ResidualWrapper(GRUCell), ResidualWrapper(GRUCell) ]) )

yields scopes ``decoder/output_projection_wrapper/multi_rnn_cell/cell_0/
output_projection_wrapper/concat_output_and_attention_wrapper/
attention_wrapper/...`` — ResidualWrapper overrides ``__call__`` directly and
contributes no scope (TF1.3 ``rnn_cell_impl.py``), so the residual GRUs are
``cell_{1,2}/gru_cell``.

Fused-layout bridges to the flax tree (the port's canonical weight layout,
``params.py``):

- the K conv-bank branches (``modules.py:35-44``) are one wide fused conv
  here: per-branch biases and BatchNorm tensors concatenate in branch order;
- ``attention_v`` is stored [U, 1] here (column vector for the MXU) vs TF's
  [U];
- TF GRU kernels/biases copy over unchanged (same ``[x, h]`` layout and
  ``[r, u]`` gate order, verified in ``tests/test_torch_compat.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config

# rule kinds
P, S = "params", "batch_stats"

#: scope aliases
_DEC = "model/inference/decoder/output_projection_wrapper"
_CELL0 = _DEC + "/multi_rnn_cell/cell_0/output_projection_wrapper"
_ATTW = _CELL0 + "/concat_output_and_attention_wrapper/attention_wrapper"

_MECH_SCOPE = {
    # tf.contrib.seq2seq mechanism __call__ default scope names
    "bah_mon": "bahdanau_monotonic_attention",
    "bah": "bahdanau_attention",
    "bah_norm": "bahdanau_attention",
    "luong": "luong_attention",
    "luong_scaled": "luong_attention",
}


class Rule:
    """One flax leaf <-> one or more TF variables.

    ``tf_names``: list of TF variable names.  With one name, the leaf copies
    over (optionally reshaped to ``tf_shape``).  With K names, the flax leaf
    is the axis-0 concatenation of the K TF tensors in listed order (the
    fused conv-bank layout).
    """

    def __init__(self, kind: str, path: Tuple[str, ...], tf_names: List[str],
                 tf_shape: Optional[Tuple[int, ...]] = None):
        self.kind = kind
        self.path = path
        self.tf_names = tf_names
        self.tf_shape = tf_shape


def _cbhg_rules(key: str, bank_size: int, dim_fix: bool,
                highway_depth: int = 4, proj_count: int = 2) -> List[Rule]:
    """CBHG scope rules (reference ``models/modules.py:27-131``)."""
    base = f"model/inference/{key}"
    rules: List[Rule] = []
    branches = list(range(1, bank_size + 1))
    for k in branches:
        rules.append(Rule(P, (key, "conv_bank", f"kernel_{k}"),
                          [f"{base}/conv_bank/conv1d_{k}/conv1d/kernel"]))
    rules.append(Rule(P, (key, "conv_bank", "bias"),
                      [f"{base}/conv_bank/conv1d_{k}/conv1d/bias"
                       for k in branches]))
    for leaf, tf_leaf in (("scale", "gamma"), ("bias", "beta")):
        rules.append(Rule(P, (key, "bank_bn", "BatchNorm_0", leaf),
                          [f"{base}/conv_bank/conv1d_{k}/"
                           f"batch_normalization/{tf_leaf}"
                           for k in branches]))
    for leaf, tf_leaf in (("mean", "moving_mean"), ("var", "moving_variance")):
        rules.append(Rule(S, (key, "bank_bn", "BatchNorm_0", leaf),
                          [f"{base}/conv_bank/conv1d_{k}/"
                           f"batch_normalization/{tf_leaf}"
                           for k in branches]))
    for i in range(1, proj_count + 1):
        for leaf in ("kernel", "bias"):
            rules.append(Rule(P, (key, f"proj_{i}", leaf),
                              [f"{base}/proj_{i}/conv1d/{leaf}"]))
        for leaf, tf_leaf in (("scale", "gamma"), ("bias", "beta")):
            rules.append(Rule(P, (key, f"proj_{i}_bn", "BatchNorm_0", leaf),
                              [f"{base}/proj_{i}/batch_normalization/"
                               f"{tf_leaf}"]))
        for leaf, tf_leaf in (("mean", "moving_mean"),
                              ("var", "moving_variance")):
            rules.append(Rule(S, (key, f"proj_{i}_bn", "BatchNorm_0", leaf),
                              [f"{base}/proj_{i}/batch_normalization/"
                               f"{tf_leaf}"]))
    if dim_fix:
        # tf.layers.dense at modules.py:72-73 (only when highway input dim
        # != rnn size, i.e. the post-net: 80 != 256)
        for leaf in ("kernel", "bias"):
            rules.append(Rule(P, (key, "highway_dim_fix", leaf),
                              [f"{base}/dense/{leaf}"]))
    for i in range(1, highway_depth + 1):
        for gate in ("H", "T"):
            for leaf in ("kernel", "bias"):
                rules.append(Rule(P, (key, f"highway_{i}", gate, leaf),
                                  [f"{base}/highway_{i}/{gate}/{leaf}"]))
    for direction in ("fw", "bw"):
        for part in ("gates", "candidate"):
            for leaf in ("kernel", "bias"):
                rules.append(Rule(
                    P, (key, "bigru", direction, part, leaf),
                    [f"{base}/bidirectional_rnn/{direction}/gru_cell/"
                     f"{part}/{leaf}"]))
    return rules


def tf1_rules(config: Config) -> List[Rule]:
    """The complete rule table for ``config`` (all three model_types)."""
    mc = config.model
    rules: List[Rule] = []

    # embeddings (tacotron.py:34-49)
    rules.append(Rule(P, ("char_embedding", "embedding"),
                      ["model/inference/embedding"]))

    multi = mc.num_speakers > 1
    if multi and mc.speaker_embedding_size != 1:
        rules.append(Rule(P, ("speaker_embedding", "embedding"),
                          ["model/inference/speaker_embedding"]))

    # deepvoice per-site speaker conditioning (tacotron.py:51-81)
    if multi and mc.model_type == "deepvoice":
        if mc.speaker_embedding_size == 1:
            # raw get_embed tables (tacotron.py:52-66, modules.py:11-15)
            rules.append(Rule(P, ("before_highway", "embedding"),
                              ["model/inference/before_highway"]))
            rules.append(Rule(P, ("encoder_rnn_init_state", "embedding"),
                              ["model/inference/encoder_rnn_init_state"]))
            rules.append(Rule(P, ("attention_rnn_init_state", "embedding"),
                              ["model/inference/attention_rnn_init_state"]))
            for i in range(1, mc.dec_layer_num + 1):
                rules.append(Rule(
                    P, (f"decoder_rnn_init_states_{i}", "embedding"),
                    [f"model/inference/decoder_rnn_init_states{i}"]))
        else:
            # unnamed tf.layers.dense calls uniquify in construction order
            # (tacotron.py:68-79): dense, dense_1, dense_2, dense_3, ...
            rules.append(Rule(P, ("deep_before_highway", "kernel"),
                              ["model/inference/dense/kernel"]))
            rules.append(Rule(P, ("deep_before_highway", "bias"),
                              ["model/inference/dense/bias"]))
            rules.append(Rule(P, ("deep_encoder_rnn_init", "kernel"),
                              ["model/inference/dense_1/kernel"]))
            rules.append(Rule(P, ("deep_encoder_rnn_init", "bias"),
                              ["model/inference/dense_1/bias"]))
            rules.append(Rule(P, ("deep_attention_rnn_init", "kernel"),
                              ["model/inference/dense_2/kernel"]))
            rules.append(Rule(P, ("deep_attention_rnn_init", "bias"),
                              ["model/inference/dense_2/bias"]))
            for i in range(1, mc.dec_layer_num + 1):
                rules.append(Rule(P, (f"deep_decoder_rnn_init_{i}", "kernel"),
                                  [f"model/inference/dense_{2 + i}/kernel"]))
                rules.append(Rule(P, (f"deep_decoder_rnn_init_{i}", "bias"),
                                  [f"model/inference/dense_{2 + i}/bias"]))

    # encoder prenet (tacotron.py:100-103, modules.py:18-25)
    for i in range(1, len(mc.enc_prenet_sizes) + 1):
        for leaf in ("kernel", "bias"):
            rules.append(Rule(P, ("encoder_prenet", f"dense_{i}", leaf),
                              [f"model/inference/prenet/dense_{i}/{leaf}"]))

    rules += _cbhg_rules("encoder_cbhg", mc.enc_bank_size,
                         dim_fix=(mc.enc_proj_sizes[-1] != mc.enc_rnn_size),
                         highway_depth=mc.enc_highway_depth,
                         proj_count=len(mc.enc_proj_sizes))

    # attention memory projection: Dense(name="memory_layer") constructed at
    # mechanism build time under the inference scope (tacotron.py:133-147,
    # TF1.3 attention_wrapper._BaseAttentionMechanism.__init__)
    rules.append(Rule(P, ("attention_memory_layer", "kernel"),
                      ["model/inference/memory_layer/kernel"]))

    # decoder stack
    mech = _MECH_SCOPE[mc.attention_type]
    att = ("decoder", "attention")
    if mc.attention_type in ("bah_mon", "bah", "bah_norm"):
        rules.append(Rule(P, att + ("query_layer", "kernel"),
                          [f"{_ATTW}/{mech}/query_layer/kernel"]))
        rules.append(Rule(P, att + ("attention_v",),
                          [f"{_ATTW}/{mech}/attention_v"],
                          tf_shape=(mc.attention_size,)))
    if mc.attention_type == "bah_mon":
        rules.append(Rule(P, att + ("score_bias",),
                          [f"{_ATTW}/{mech}/attention_score_bias"],
                          tf_shape=()))
    if mc.attention_type == "bah_norm":
        # normalized Bahdanau adds g (scalar) and b ([U])
        # (TF1.3 attention_wrapper._bahdanau_score, normalize=True)
        rules.append(Rule(P, att + ("attention_g",),
                          [f"{_ATTW}/{mech}/attention_g"], tf_shape=()))
        rules.append(Rule(P, att + ("attention_b",),
                          [f"{_ATTW}/{mech}/attention_b"]))
    if mc.attention_type == "luong_scaled":
        rules.append(Rule(P, att + ("attention_g",),
                          [f"{_ATTW}/{mech}/attention_g"], tf_shape=()))

    for i in range(1, len(mc.dec_prenet_sizes) + 1):
        for leaf in ("kernel", "bias"):
            rules.append(Rule(
                P, ("decoder", "prenet", f"dense_{i}", leaf),
                [f"{_ATTW}/decoder_prenet_wrapper/decoder_prenet/"
                 f"dense_{i}/{leaf}"]))
    for part in ("gates", "candidate"):
        for leaf in ("kernel", "bias"):
            rules.append(Rule(
                P, ("decoder", "attention_rnn", part, leaf),
                [f"{_ATTW}/decoder_prenet_wrapper/gru_cell/{part}/{leaf}"]))
    for leaf in ("kernel", "bias"):
        rules.append(Rule(P, ("decoder", "decoder_input_projection", leaf),
                          [f"{_CELL0}/{leaf}"]))
    for i in range(1, mc.dec_layer_num + 1):
        for part in ("gates", "candidate"):
            for leaf in ("kernel", "bias"):
                rules.append(Rule(
                    P, ("decoder", f"decoder_rnn_{i}", part, leaf),
                    [f"{_DEC}/multi_rnn_cell/cell_{i}/gru_cell/"
                     f"{part}/{leaf}"]))
    for leaf in ("kernel", "bias"):
        rules.append(Rule(P, ("decoder", "frame_projection", leaf),
                          [f"{_DEC}/{leaf}"]))

    rules += _cbhg_rules("post_cbhg", mc.post_bank_size,
                         dim_fix=(mc.post_proj_sizes[-1] != mc.post_rnn_size),
                         highway_depth=mc.post_highway_depth,
                         proj_count=len(mc.post_proj_sizes))

    # final linear projection: unnamed tf.layers.dense (tacotron.py:235).
    # Uniquified against the deepvoice speaker denses created earlier in the
    # same scope: deepvoice(ses!=1) used dense..dense_{2+L}, so this becomes
    # dense_{3+L}; otherwise it is the first unnamed dense -> "dense".
    if (multi and mc.model_type == "deepvoice"
            and mc.speaker_embedding_size != 1):
        dense_name = f"dense_{3 + mc.dec_layer_num}"
    else:
        dense_name = "dense"
    for leaf in ("kernel", "bias"):
        rules.append(Rule(P, ("linear_projection", leaf),
                          [f"model/inference/{dense_name}/{leaf}"]))
    return rules


# ------------------------------------------------------------ tree plumbing

def _get(tree: dict, path: Tuple[str, ...]):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def export_tf1(params: dict, batch_stats: dict,
               config: Config) -> Dict[str, np.ndarray]:
    """flax trees -> {tf1_name: array} under the exact reference names."""
    trees = {P: params, S: batch_stats}
    out: Dict[str, np.ndarray] = {}
    for rule in tf1_rules(config):
        leaf = _get(trees[rule.kind], rule.path)
        if leaf is None:
            raise KeyError(f"flax tree missing {rule.kind}/"
                           f"{'/'.join(rule.path)}")
        leaf = np.asarray(leaf, np.float32)
        if len(rule.tf_names) == 1:
            arr = leaf.reshape(rule.tf_shape) if rule.tf_shape is not None \
                else leaf
            out[rule.tf_names[0]] = arr
        else:
            parts = np.split(leaf, len(rule.tf_names), axis=0)
            for name, part in zip(rule.tf_names, parts):
                out[name] = part
    # bookkeeping variables every reference checkpoint carries
    out.setdefault("model/global_step", np.asarray(0, np.int64))
    return out


def import_tf1(tensors: Dict[str, np.ndarray], config: Config
               ) -> Tuple[dict, dict, List[str], List[str]]:
    """{tf1_name: array} -> (params, batch_stats, unmatched, unfilled).

    ``unmatched``: model/inference variables in the bundle no rule consumed.
    ``unfilled``: rule targets with no source variable in the bundle.
    """
    params: dict = {}
    stats: dict = {}
    trees = {P: params, S: stats}
    consumed = set()
    unfilled: List[str] = []
    for rule in tf1_rules(config):
        parts = []
        missing = False
        for name in rule.tf_names:
            if name in tensors:
                parts.append(np.asarray(tensors[name], np.float32))
                consumed.add(name)
            else:
                unfilled.append(name)
                missing = True
        if missing:
            continue
        if len(parts) == 1:
            leaf = parts[0]
            if rule.tf_shape is not None:
                # stored TF-shaped; flax holds e.g. [U, 1] column vectors
                target = _flax_shape_for(rule, leaf)
                leaf = leaf.reshape(target)
        else:
            leaf = np.concatenate(parts, axis=0)
        _set(trees[rule.kind], rule.path, leaf)
    unmatched = [n for n in sorted(tensors)
                 if n.startswith("model/inference/") and n not in consumed]
    return params, stats, unmatched, unfilled


def _flax_shape_for(rule: Rule, leaf: np.ndarray) -> Tuple[int, ...]:
    if rule.path[-1] == "attention_v":
        return (leaf.size, 1)
    if rule.path[-1] in ("score_bias", "attention_g"):
        return ()
    return leaf.shape


def tf1_variable_inventory(config: Config) -> Dict[str, Tuple[int, ...]]:
    """{tf1_name: shape} for the full reference graph under ``config``.

    Derived by exporting the flax tree of the port's model for ``config``
    (its freshly built weights), so the inventory is always consistent with
    the live model.
    """
    from ..params import to_flax
    from ..train.state import create_model
    variables = to_flax(create_model(config).state_dict())
    exported = export_tf1(variables["params"],
                          variables.get("batch_stats", {}), config)
    return {name: tuple(arr.shape) for name, arr in exported.items()}
