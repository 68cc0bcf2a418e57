"""Weights across the two packages: the flax variable tree <-> the port's
``Tacotron`` state dict, plus random initialization.

The port's module tree carries the flax names, so a state-dict key is the
flax path joined by dots, with these layout rules:

- Dense ``kernel`` [in, out]        <-> ``weight`` [out, in] (transposed);
- Conv ``kernel`` [width, in, out]  <-> ``weight`` [out, in, width];
- ConvBank ``kernel_k`` [k, in, C]  <-> ``kernel_k`` [C, in, k];
- BatchNorm ``<site>/BatchNorm_0/{scale,bias}`` <-> ``<site>.{weight,bias}``,
  and ``batch_stats`` ``<site>/BatchNorm_0/{mean,var}`` <->
  ``<site>.{running_mean,running_var}`` buffers;
- everything else (``embedding``, ``bias``, ``attention_v``, ...) keeps its
  name and layout.

The decoder's parameters sit once under ``decoder`` (the flax ``nn.scan``
name), and each BiGRU keeps its ``fw``/``bw`` cells.

The flat form used by ``.npz`` files keys each array by its ``/``-joined
path including the collection, e.g. ``params/decoder/prenet/dense_1/kernel``
and ``batch_stats/encoder_cbhg/bank_bn/BatchNorm_0/mean``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_BN = "BatchNorm_0"


def flatten_variables(variables: Mapping) -> Dict[str, np.ndarray]:
    """Nested ``{"params": ..., "batch_stats": ...}`` (or an already flat
    mapping with ``/``-joined keys) -> flat ``{path: ndarray}``."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for key, value in node.items():
                walk(f"{prefix}/{key}" if prefix else str(key), value)
        else:
            flat[prefix] = np.asarray(node)

    walk("", variables)
    return flat


def unflatten_variables(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat ``{path: array}`` -> nested dicts."""
    out: dict = {}
    for path, value in flat.items():
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables (nested or flat, numpy-convertible) -> state dict."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in flatten_variables(variables).items():
        parts = path.split("/")
        collection, parts = parts[0], parts[1:]
        arr = np.asarray(value, dtype=np.float32)
        if collection == "batch_stats":
            if len(parts) < 2 or parts[-2] != _BN:
                raise KeyError(f"unexpected batch_stats path {path!r}")
            leaf = {"mean": "running_mean", "var": "running_var"}[parts[-1]]
            key = ".".join(parts[:-2] + [leaf])
        elif collection == "params":
            leaf = parts[-1]
            if len(parts) >= 2 and parts[-2] == _BN:
                key = ".".join(parts[:-2] + [
                    {"scale": "weight", "bias": "bias"}[leaf]])
            elif leaf == "kernel" and arr.ndim == 2:
                key = ".".join(parts[:-1] + ["weight"])
                arr = arr.T
            elif leaf == "kernel" and arr.ndim == 3:
                key = ".".join(parts[:-1] + ["weight"])
                arr = arr.transpose(2, 1, 0)
            elif leaf.startswith("kernel_") and arr.ndim == 3:
                key = ".".join(parts)
                arr = arr.transpose(2, 1, 0)
            else:
                key = ".".join(parts)
        else:
            raise KeyError(f"unknown variable collection {collection!r}")
        state[key] = torch.tensor(arr)
    return state


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """State dict -> nested ``{"params", "batch_stats"}`` numpy tree (the
    inverse of :func:`from_flax`)."""
    bn_sites = {k[:-len(".running_mean")] for k in state_dict
                if k.endswith(".running_mean")}
    flat: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy()
        parts = key.split(".")
        site, leaf = ".".join(parts[:-1]), parts[-1]
        head = parts[:-1]
        if site in bn_sites:
            name = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                    "running_mean": ("batch_stats", "mean"),
                    "running_var": ("batch_stats", "var")}[leaf]
            flat["/".join([name[0]] + head + [_BN, name[1]])] = arr
        elif leaf == "weight" and arr.ndim == 2:
            flat["/".join(["params"] + head + ["kernel"])] = arr.T
        elif leaf == "weight" and arr.ndim == 3:
            flat["/".join(["params"] + head + ["kernel"])] = \
                arr.transpose(2, 1, 0)
        elif leaf.startswith("kernel_") and arr.ndim == 3:
            flat["/".join(["params"] + parts)] = arr.transpose(2, 1, 0)
        else:
            flat["/".join(["params"] + parts)] = arr
    return unflatten_variables({k: v.copy() for k, v in flat.items()})


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a flat ``.npz`` of ``/``-joined flax paths."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_npz(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write a state dict as the flat flax-path ``.npz``."""
    np.savez(path, **flatten_variables(to_flax(state_dict)))


# ------------------------------------------------------------ random init

def _trunc_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std (flax ``truncated_normal``),
    by inverse-CDF sampling from a uniform draw."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return (std * z.clamp(-2.0, 2.0)).float()


def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    # variance_scaling(1, fan_in, truncated_normal): the stddev is corrected
    # for the +-2 std truncation
    return _trunc_normal(shape, math.sqrt(1.0 / fan_in) / .87962566103423978,
                         gen)


def _glorot_uniform(shape, fan_in: int, fan_out: int,
                    gen: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


@torch.no_grad()
def init_random_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialize every parameter with the distribution of its flax
    initializer (bit equality with JAX's random init is not a goal):
    Dense kernels lecun-normal, convolutions glorot-uniform (fan_avg),
    embeddings truncated normal at each table's stddev, GRU gate biases 1,
    highway transform biases -1, other biases 0, BatchNorm identity.
    Parameters are drawn on the CPU in module order from one generator, so
    the same seed gives the same weights on every device."""
    from .models.modules import (BatchNorm, Conv1d, ConvBank, Embed,
                                 HighwayNet)
    from .ops.attention import (BahdanauAttention,
                                BahdanauMonotonicAttention, LuongAttention)
    from .ops.rnn import GRUCell

    gen = torch.Generator().manual_seed(seed)

    def put(param, value):
        param.copy_(value.to(param.device, param.dtype))

    for module in model.modules():
        if isinstance(module, nn.Linear):
            put(module.weight, _lecun_normal(module.weight.shape,
                                             module.weight.shape[1], gen))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, Conv1d):
            c_out, c_in, w = module.weight.shape
            put(module.weight, _glorot_uniform(
                module.weight.shape, c_in * w, c_out * w, gen))
            module.bias.zero_()
        elif isinstance(module, ConvBank):
            for k in range(1, module.bank_size + 1):
                kernel = getattr(module, f"kernel_{k}")
                c_out, c_in, _ = kernel.shape
                put(kernel, _glorot_uniform(kernel.shape, c_in * k,
                                            c_out * k, gen))
            module.bias.zero_()
        elif isinstance(module, Embed):
            put(module.embedding, _trunc_normal(module.embedding.shape,
                                                module.init_std, gen))
        elif isinstance(module, BatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
        elif isinstance(module, (BahdanauMonotonicAttention,
                                 BahdanauAttention)):
            v = module.attention_v
            put(v, _lecun_normal(v.shape, v.shape[0], gen))
            if isinstance(module, BahdanauMonotonicAttention):
                module.score_bias.zero_()
            elif module.normalize:
                module.attention_g.fill_(math.sqrt(1.0 / v.shape[0]))
                module.attention_b.zero_()
        elif isinstance(module, LuongAttention) and module.scale:
            module.attention_g.fill_(1.0)
    # bias overrides after the generic Dense pass (they draw no numbers)
    for module in model.modules():
        if isinstance(module, GRUCell):
            module.gates.bias.fill_(1.0)
        elif isinstance(module, HighwayNet):
            module.T.bias.fill_(-1.0)
    return model
