"""Weight conversion from the JAX package's flax parameter trees.

The tree arrives as numpy arrays (``jax.tree.map(np.asarray, params)``), so
this module needs neither JAX nor flax. A bf16 leaf (a table stored in
bf16) stays bf16; every other leaf becomes fp32. :func:`shard_state` cuts
a converted state dict to one process's under a mesh, and
:func:`join_shards` puts the processes' state dicts back together;
:func:`shard_optimizer_state` and :func:`join_optimizer_shards` do the
same for an optimizer's state.
"""

from __future__ import annotations

from typing import Any, Collection, Dict, Mapping, Optional, Sequence

import numpy as np
import torch


def _tensor(x: Any) -> torch.Tensor:
    """A leaf as a tensor: bf16 (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses) carried bit for bit through an int16
    view, anything else as fp32."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _tables_and_deep(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    state = {
        "embeddings.table": _tensor(p["embeddings"]["table"]),
        "linear.weights": _tensor(p["linear"]["weights"]),
        "linear.bias": _tensor(p["linear"]["bias"]),
    }
    deep = p["deep"]
    for i in range(len(deep)):
        layer = deep[f"Dense_{i}"]
        state[f"deep.dense.{i}.weight"] = _tensor(np.asarray(layer["kernel"]).T)
        state[f"deep.dense.{i}.bias"] = _tensor(layer["bias"])
    return state


def deepfm_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``DeepFM`` parameter tree -> the port's ``DeepFM`` state dict.

    - ``embeddings/table`` (V, D) -> ``embeddings.table``;
    - ``linear/weights`` (V, 1) and ``linear/bias`` (1,) as they are;
    - ``deep/Dense_i/kernel`` (in, out) -> ``deep.dense.i.weight`` (out, in),
      transposed, and ``deep/Dense_i/bias`` -> ``deep.dense.i.bias``.

    ``params`` may be the whole ``{"params": ...}`` collection or its inside.
    """
    return _tables_and_deep(params.get("params", params))


def xdeepfm_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``XDeepFM`` parameter tree -> the port's ``XDeepFM`` state dict.

    The tables and the MLP map as in :func:`deepfm_from_flax`, and:

    - the fused stack's ``cin_w1`` (F0, F0, M1) and ``cin_w2`` (F0, M1, M2)
      as they are;
    - the layered stack's ``cins_i/kernel`` (F0, F_prev, M_i) ->
      ``cins.i.kernel`` (and ``cins_i/bias`` where present);
    - ``cin_head/kernel`` (sum M_i, 1) -> ``cin_head.weight`` (1, sum M_i).
    """
    p = params.get("params", params)
    state = _tables_and_deep(p)
    state["cin_head.weight"] = _tensor(np.asarray(p["cin_head"]["kernel"]).T)
    if "cin_w1" in p:
        state["cin_w1"] = _tensor(p["cin_w1"])
        state["cin_w2"] = _tensor(p["cin_w2"])
    i = 0
    while f"cins_{i}" in p:
        for name, value in p[f"cins_{i}"].items():
            state[f"cins.{i}.{name}"] = _tensor(value)
        i += 1
    return state


def _module_name(name: str) -> str:
    # flax's encoder_i, decoder_i, crosses_i and an MLP's Dense_i are the
    # port's ModuleList entries.
    for flax_prefix, torch_prefix in (("encoder_", "encoder_layers."),
                                      ("decoder_", "decoder_layers."),
                                      ("crosses_", "crosses."),
                                      ("Dense_", "dense.")):
        if name.startswith(flax_prefix) and name[len(flax_prefix):].isdigit():
            return torch_prefix + name[len(flax_prefix):]
    return name


def _flax_modules(p: Mapping[str, Any], prefix: str,
                  state: Dict[str, torch.Tensor]) -> None:
    """Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in), LayerNorm
    ``scale`` -> ``weight``, every other leaf (``bias``, ``table``) as it
    is; submodules recursively."""
    for name, value in p.items():
        if isinstance(value, Mapping):
            _flax_modules(value, f"{prefix}{_module_name(name)}.", state)
        elif name == "kernel":
            state[prefix + "weight"] = _tensor(np.asarray(value).T)
        elif name == "scale":
            state[prefix + "weight"] = _tensor(value)
        else:
            state[prefix + name] = _tensor(value)


def transformer_from_flax(params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """A flax ``Transformer`` parameter tree -> the port's state dict.

    - ``token_embedding/table`` -> ``token_embedding.table``;
    - ``encoder_i/{self_attention/{q,k,v,out}_proj, attn_norm, ffn/{inner,
      outer}, ffn_norm}`` -> ``encoder_layers.i.…``;
    - ``decoder_i/{self_attention, self_norm, cross_attention, cross_norm,
      ffn, ffn_norm}`` -> ``decoder_layers.i.…``;
    with each Dense ``kernel`` (in, out) transposed into a Linear ``weight``
    (out, in) and each LayerNorm ``scale`` as ``weight``.
    """
    state: Dict[str, torch.Tensor] = {}
    _flax_modules(params.get("params", params), "", state)
    return state


# The IMDB example's TransformerClassifier by the same rules: its
# ``transformer/…`` maps under ``transformer.`` and its ``head`` Dense to
# ``head``.
transformer_classifier_from_flax = transformer_from_flax


def ranking_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ranking model's parameter tree -> the port's state dict, by
    the rules of :func:`transformer_from_flax` (each Dense ``kernel``
    transposed into a Linear ``weight``, every other leaf as it is), with
    ``Dense_i`` under ``dense.i`` and ``crosses_i`` under ``crosses.i``:

    - ``FactorizationMachine``: ``linear/{weights, bias}``,
      ``embeddings/table``; ``FMLayer``: ``linear/{kernel, bias}``;
    - ``FNN``: the same and ``deep/Dense_i``;
    - ``WideDeep``: ``wide_linear/weights`` and ``wide_extra/{weights,
      bias}`` (the fused branch) or ``wide/{weights, bias}`` (the separate
      one), ``embeddings/table``, ``deep/Dense_i``;
    - ``DCN``: ``crosses_i/dense`` (full rank) or ``crosses_i/{dense_u,
      dense_v}`` (low rank), ``embeddings/table``, ``deep/Dense_i``,
      ``head``.
    """
    state: Dict[str, torch.Tensor] = {}
    _flax_modules(params.get("params", params), "", state)
    return state


# One set of rules serves each of the ranking models above.
fm_from_flax = fnn_from_flax = wide_deep_from_flax = dcn_from_flax = (
    ranking_from_flax)


def din_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``DIN`` parameter tree -> the port's ``DIN`` state dict.

    - ``ActivationUnit_0/{dense_kernel, dense_output, dense_kernel_bias,
      dense_output_bias}`` -> ``unit.…`` as they are (the port keeps the
      flax layer's flat layout);
    - ``Dense_i/kernel`` (in, out) -> ``dense.i.weight`` (out, in),
      transposed, and ``Dense_i/bias`` -> ``dense.i.bias``: the hidden
      layers, then the last Dense(1);
    - ``Dice_i/alpha`` -> ``dice.i.alpha``;
    - ``item_table`` (ids mode) as it is.
    """
    p = params.get("params", params)
    state: Dict[str, torch.Tensor] = {}
    for name, value in p.items():
        if name == "ActivationUnit_0":
            for leaf, v in value.items():
                state[f"unit.{leaf}"] = _tensor(v)
        elif name.startswith("Dense_"):
            i = name[len("Dense_"):]
            state[f"dense.{i}.weight"] = _tensor(np.asarray(value["kernel"]).T)
            state[f"dense.{i}.bias"] = _tensor(value["bias"])
        elif name.startswith("Dice_"):
            state[f"dice.{name[len('Dice_'):]}.alpha"] = _tensor(
                value["alpha"])
        else:
            state[name] = _tensor(value)
    return state


def mmoe_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``MMoE`` parameter tree -> the port's ``MMoE`` state dict.

    - the vmapped ``experts/Dense_i/kernel`` (E, in, out) and ``/bias``
      (E, out) -> ``experts.kernels.i`` and ``experts.biases.i`` as they
      are (the port's :class:`StackedMLP` keeps the leading expert axis
      and flax's (in, out) layout);
    - ``gate_t`` and ``tower_t/Dense_i`` by the rules of
      :func:`ranking_from_flax` (each Dense ``kernel`` transposed into a
      Linear ``weight``).
    """
    p = dict(params.get("params", params))
    experts = p.pop("experts")
    state: Dict[str, torch.Tensor] = {}
    for i in range(len(experts)):
        layer = experts[f"Dense_{i}"]
        state[f"experts.kernels.{i}"] = _tensor(layer["kernel"])
        state[f"experts.biases.{i}"] = _tensor(layer["bias"])
    _flax_modules(p, "", state)
    return state


# ESMM: ``embeddings/table``, ``cvr_tower/Dense_i`` and ``ctr_tower/Dense_i``
# by the ranking rules.
esmm_from_flax = ranking_from_flax


# TwoTower: ``{query,candidate}_tower/embeddings/table`` and
# ``{query,candidate}_tower/projection/Dense_i`` by the ranking rules (each
# Dense ``kernel`` (in, out) transposed into a Linear ``weight`` (out, in)).
two_tower_from_flax = ranking_from_flax


def gcn_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``GCN`` parameter tree -> the port's ``GCN`` state dict:
    ``GCNLayer_i/{kernel, bias}`` -> ``layers.i.{kernel, bias}`` as they
    are (the port keeps flax's (in, units) kernel layout)."""
    p = params.get("params", params)
    state: Dict[str, torch.Tensor] = {}
    for name, layer in p.items():
        i = name[len("GCNLayer_"):]
        for leaf, value in layer.items():
            state[f"layers.{i}.{leaf}"] = _tensor(value)
    return state


# The parameters a mesh row-shards over "model": the fused embedding tables
# (CTR models, ESMM, each two-tower tower's ``*.embeddings.table``) and
# DIN's item table, padded to a multiple of the model size; and MMoE's
# stacked experts under expert parallelism, cut along their leading expert
# axis with no padding. Everything else is replicated.
ROW_SHARDED = ("embeddings.table", "item_table")
EXPERT_SHARDED = ("experts.kernels.", "experts.biases.")


def _row_sharded(key: str) -> bool:
    return key in ROW_SHARDED or key.endswith(".embeddings.table")


def _expert_sharded(key: str) -> bool:
    return key.startswith(EXPERT_SHARDED)


def sharded_key(key: str) -> bool:
    """Whether a mesh cuts state dict entry ``key`` over "model"."""
    return _row_sharded(key) or _expert_sharded(key)


def cut(value: torch.Tensor, key: str, n_model: int,
        index: int) -> torch.Tensor:
    """Model coordinate ``index``'s rows of the whole entry ``key``: a
    table padded with zero rows to a multiple of ``n_model`` first, an
    expert axis that must divide (ValueError otherwise)."""
    v = value.shape[0]
    if _expert_sharded(key):
        if v % n_model:
            raise ValueError(f"{key}: {v} experts do not divide over the "
                             f"model axis ({n_model})")
    elif v % n_model:
        value = torch.cat([value, value.new_zeros(
            (-v % n_model,) + tuple(value.shape[1:]))])
    rows = value.shape[0] // n_model
    return value[index * rows:(index + 1) * rows].clone()


def shard_state(state: Mapping[str, torch.Tensor], n_model: int,
                index: int, keys: Optional[Collection[str]] = None
                ) -> Dict[str, torch.Tensor]:
    """One process's state dict under a mesh whose model axis has
    ``n_model`` processes, from a whole state dict (e.g.
    ``deepfm_from_flax`` of a JAX meshed model's tree, whose tables are
    padded to a multiple of the model size): each sharded entry
    (:func:`sharded_key`, or the entries named in ``keys``) cut to model
    coordinate ``index`` (:func:`cut`), every other entry as it is. The
    models it serves: DeepFM, FM, FNN, Wide & Deep, DCN, xDeepFM, DIN
    (``num_items``), ESMM (``specs``), the two-tower (both towers' tables)
    and MMoE with ``expert_parallel``."""
    is_sharded = sharded_key if keys is None else keys.__contains__
    return {key: cut(value, key, n_model, index) if is_sharded(key)
            else value for key, value in state.items()}


def join_shards(states: Sequence[Mapping[str, torch.Tensor]],
                keys: Optional[Collection[str]] = None
                ) -> Dict[str, torch.Tensor]:
    """The reverse of :func:`shard_state`: the state dicts of one data
    group's processes, in model-coordinate order, put back into one whole
    state dict (the padded tables whole, the replicated entries from the
    first)."""
    is_sharded = sharded_key if keys is None else keys.__contains__
    out = dict(states[0])
    for key in out:
        if is_sharded(key):
            out[key] = torch.cat([s[key] for s in states])
    return out


def _param_keys(optimizer_state: Mapping[str, Any],
                names: Sequence[str]) -> Dict[Any, str]:
    ids = [i for g in optimizer_state["param_groups"] for i in g["params"]]
    return dict(zip(ids, names))


def _map_moments(optimizer_state, names, fn, keys=None):
    """``optimizer_state`` with ``fn(key, tensor)`` applied to each
    non-scalar tensor of a sharded parameter's state, a moment of the
    parameter's shape (``names``: the parameter names in the optimizer's
    order)."""
    is_sharded = sharded_key if keys is None else keys.__contains__
    by_id = _param_keys(optimizer_state, names)
    out = {"param_groups": optimizer_state["param_groups"], "state": {}}
    for i, entry in optimizer_state["state"].items():
        key = by_id[i]
        out["state"][i] = {
            k: fn(key, t) if (is_sharded(key) and isinstance(t, torch.Tensor)
                              and t.dim() > 0) else t
            for k, t in entry.items()}
    return out


def shard_optimizer_state(optimizer_state: Mapping[str, Any],
                          names: Sequence[str], n_model: int, index: int,
                          keys: Optional[Collection[str]] = None
                          ) -> Dict[str, Any]:
    """:func:`shard_state` of an optimizer's state dict: the moments of
    each sharded parameter (Adam's ``exp_avg``, ``exp_avg_sq``, Adagrad's
    ``sum``) cut as the parameter is; scalars (``step``) and the
    replicated parameters' state as they are. ``names`` are the
    parameters' state dict keys in the optimizer's order; ``keys`` as in
    :func:`shard_state`."""
    return _map_moments(optimizer_state, names,
                        lambda key, t: cut(t, key, n_model, index), keys)


def join_optimizer_shards(states: Sequence[Mapping[str, Any]],
                          names: Sequence[str],
                          keys: Optional[Collection[str]] = None
                          ) -> Dict[str, Any]:
    """The reverse of :func:`shard_optimizer_state`, from one data group's
    optimizer states in model-coordinate order."""
    joined = _map_moments(states[0], names, lambda key, t: None, keys)
    for i, entry in joined["state"].items():
        for k, t in entry.items():
            if t is None:
                entry[k] = torch.cat([s["state"][i][k] for s in states])
    return joined
