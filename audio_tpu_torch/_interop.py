"""Parameters from the JAX package, as tensors.

``from_jax_params`` turns a nested dict (or list/tuple) of arrays exported
from the JAX side with ``numpy.asarray`` (filter coefficients, windows,
filterbanks, projections) into the same tree of tensors on ``device``, with
the same dtype and layout.

``rnnt_state_dict_from_jax_params`` turns the flax parameter tree of the JAX
package's RNN-T into the ``state_dict`` of the port's ``RNNT``, which carries
torchaudio's names: the inverse of the JAX package's
``import_rnnt_state_dict`` and ``import_emformer_state_dict``.  A gradient tree
in the parameters' structure goes through the same function and comes out
under the port's names, so gradients compare name by name.
``simple_heads_from_jax_params`` carries the two (D, V) heads of the pruned
loss across.

``wav2vec2_state_dict_from_jax_params`` and ``wavlm_state_dict_from_jax_params``
are the inverses of the JAX package's ``import_torchaudio_state_dict`` and
``import_wavlm_state_dict``: the flax tree of a wav2vec2/HuBERT or WavLM model
becomes the ``state_dict`` of the port's ``Wav2Vec2Model`` or ``WavLMModel``;
``hubert_pretrain_state_dict_from_jax_params`` does the same for a
``HuBERTPretrainModel`` (the backbone under ``wav2vec2``).
``conformer_state_dict_from_jax_params`` is the inverse of
``import_conformer_state_dict`` (flax ``params`` and, for BatchNorm,
``batch_stats``); ``predictor_state_dict_from_jax_params`` carries an RNN-T
predictor alone, for transducers built around it.
The positional convolution's weight norm gets ``original1 = w`` and
``original0 = |w|`` over dims (0, 1), from which it rebuilds ``w`` within a few
ulp.
``wav2letter_state_dict_from_jax_params``, ``deepspeech_state_dict_from_jax_params``,
``conv_tasnet_state_dict_from_jax_params``, ``hdemucs_state_dict_from_jax_params``,
``squim_objective_state_dict_from_jax_params`` and
``squim_subjective_state_dict_from_jax_params`` are the inverses of
``import_wav2letter_state_dict``, ``import_deepspeech_state_dict``,
``import_conv_tasnet_state_dict``, ``import_hdemucs_state_dict``,
``import_squim_objective_state_dict`` and ``import_squim_subjective_state_dict``;
``tacotron2_state_dict_from_jax_params`` and ``wavernn_state_dict_from_jax_params`` of
``import_tacotron2_state_dict`` and ``import_wavernn_state_dict`` (flax ``params`` and ``batch_stats``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["conformer_state_dict_from_jax_params", "conv_tasnet_state_dict_from_jax_params",
           "deepspeech_state_dict_from_jax_params", "from_jax_params", "hdemucs_state_dict_from_jax_params",
           "hubert_pretrain_state_dict_from_jax_params", "predictor_state_dict_from_jax_params",
           "rnnt_state_dict_from_jax_params", "simple_heads_from_jax_params",
           "squim_objective_state_dict_from_jax_params", "squim_subjective_state_dict_from_jax_params",
           "tacotron2_state_dict_from_jax_params", "wav2letter_state_dict_from_jax_params",
           "wavernn_state_dict_from_jax_params", "wav2vec2_state_dict_from_jax_params",
           "wavlm_state_dict_from_jax_params"]


def _leaf(value: Any, device) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":  # numpy has no bfloat16: carry the bits
        bits = torch.from_numpy(arr.view(np.uint16).astype(np.int16, order="C"))
        return bits.view(torch.bfloat16).to(device)
    if arr.dtype == object:
        raise TypeError(f"cannot convert a parameter of type {type(value).__name__} to a tensor")
    # a C-ordered copy: the tensor shares no memory with the caller's array
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def from_jax_params(tree: Any, device="cuda") -> Any:
    """Same tree with every array leaf as a tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    return _leaf(tree, device)


def _dense(out: dict, name: str, node: dict, device) -> None:
    """flax Dense {kernel (in, out), bias} -> torch Linear {weight (out, in), bias}."""
    out[f"{name}.weight"] = _leaf(node["kernel"], device).t().contiguous()
    if "bias" in node:
        out[f"{name}.bias"] = _leaf(node["bias"], device)


def _norm(out: dict, name: str, node: dict, device) -> None:
    """flax LayerNorm {scale, bias} -> torch LayerNorm {weight, bias}."""
    out[f"{name}.weight"] = _leaf(node["scale"], device)
    out[f"{name}.bias"] = _leaf(node["bias"], device)


def rnnt_state_dict_from_jax_params(params: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's RNN-T ``state_dict`` from the JAX package's flax parameters.

    ``params`` is ``{"params": {transcriber, predictor, joiner}}`` (or that
    inner dict) with array leaves, bf16 leaves included.  Dense kernels are
    transposed; names follow torchaudio (``transcriber.transformer.
    emformer_layers.{i}.pos_ff.{0,1,4}``, ``predictor.lstm_layers.{i}.{x2g,
    p2g,c_norm,g_norm}``, ``joiner.linear``), in the order of the model's own
    ``state_dict``.  ``RNNT.load_state_dict(..., strict=True)`` takes the result.
    A tree of gradients with respect to those parameters maps the same way:
    the result then holds each port parameter's gradient under its name.
    """
    tree = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    tr = tree["transcriber"]
    _dense(sd, "transcriber.input_linear", tr["input_linear"], device)
    layers = tr["transformer"]
    for i in range(len(layers)):
        layer, name = layers[f"emformer_layers_{i}"], f"transcriber.transformer.emformer_layers.{i}"
        for lin in ("emb_to_key_value", "emb_to_query", "out_proj"):
            _dense(sd, f"{name}.attention.{lin}", layer["attention"][lin], device)
        _norm(sd, f"{name}.pos_ff.0", layer["pos_ff_layer_norm"], device)
        _dense(sd, f"{name}.pos_ff.1", layer["pos_ff_1"], device)
        _dense(sd, f"{name}.pos_ff.4", layer["pos_ff_2"], device)
        _norm(sd, f"{name}.layer_norm_input", layer["layer_norm_input"], device)
        _norm(sd, f"{name}.layer_norm_output", layer["layer_norm_output"], device)
    _dense(sd, "transcriber.output_linear", tr["output_linear"], device)
    _norm(sd, "transcriber.layer_norm", tr["layer_norm"], device)

    sd.update(predictor_state_dict_from_jax_params(tree["predictor"], device, prefix="predictor."))
    _dense(sd, "joiner.linear", tree["joiner"]["linear"], device)
    return sd


def predictor_state_dict_from_jax_params(tree: Any, device="cuda", prefix: str = "") -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's RNN-T ``_Predictor`` (names under ``prefix``) from the JAX
    package's predictor tree ``{embedding, input_layer_norm, lstm_layers_{i}, linear,
    output_layer_norm}``."""
    sd: Dict[str, torch.Tensor] = {}
    sd[f"{prefix}embedding.weight"] = _leaf(tree["embedding"]["embedding"], device)
    _norm(sd, f"{prefix}input_layer_norm", tree["input_layer_norm"], device)
    for i in range(_count(tree, "lstm_layers_")):
        layer, name = tree[f"lstm_layers_{i}"], f"{prefix}lstm_layers.{i}"
        _dense(sd, f"{name}.x2g", layer["x2g"], device)
        _dense(sd, f"{name}.p2g", layer["p2g"], device)
        for norm in ("c_norm", "g_norm"):
            if norm in layer:
                _norm(sd, f"{name}.{norm}", layer[norm], device)
    _dense(sd, f"{prefix}linear", tree["linear"], device)
    _norm(sd, f"{prefix}output_layer_norm", tree["output_layer_norm"], device)
    return sd


def simple_heads_from_jax_params(params: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The pruned loss's simple heads ``{"simple_am", "simple_lm"}``, each (D, V), from the
    recipe's training tree.  The layout is shared (``encodings @ head``), so nothing is
    transposed; a gradient tree maps the same way."""
    return {name: _leaf(params[name], device) for name in ("simple_am", "simple_lm")}


def _conv(out: dict, name: str, node: dict, device) -> None:
    """flax Conv {kernel (K, in, out), bias} -> torch Conv1d {weight (out, in, K), bias}."""
    out[f"{name}.weight"] = _leaf(node["kernel"], device).permute(2, 1, 0).contiguous()
    if "bias" in node:
        out[f"{name}.bias"] = _leaf(node["bias"], device)


def weight_norm_pair(w: torch.Tensor):
    """torchaudio's weight-norm pair ``(g, v) = (|w|, w)`` of a positional kernel ``w`` (out, in / groups, K):
    the norm over dims 0 and 1 (``weight_norm(dim=2)``)."""
    return torch.linalg.vector_norm(w, dim=(0, 1), keepdim=True), w


def _count(tree: dict, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def _wav2vec2_like(tree: dict, projection: dict, transformer: dict, device, wavlm: bool) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    fe = tree["feature_extractor"]
    for i in range(_count(fe, "conv_layers_")):
        layer, name = fe[f"conv_layers_{i}"], f"feature_extractor.conv_layers.{i}"
        if "layer_norm" in layer:
            _norm(sd, f"{name}.layer_norm", layer["layer_norm"], device)
        _conv(sd, f"{name}.conv", layer["conv"], device)
    _norm(sd, "encoder.feature_projection.layer_norm", projection["layer_norm"], device)
    _dense(sd, "encoder.feature_projection.projection", projection["projection"], device)

    prefix = "encoder.transformer"
    pos = transformer["pos_conv_embed"]["conv"]
    w = _leaf(pos["kernel"], device).permute(2, 1, 0).contiguous()  # (out, in / groups, K)
    sd[f"{prefix}.pos_conv_embed.conv.bias"] = _leaf(pos["bias"], device)
    (sd[f"{prefix}.pos_conv_embed.conv.parametrizations.weight.original0"],
     sd[f"{prefix}.pos_conv_embed.conv.parametrizations.weight.original1"]) = weight_norm_pair(w)
    _norm(sd, f"{prefix}.layer_norm", transformer["layer_norm"], device)
    for i in range(_count(transformer, "layers_")):
        layer, name = transformer[f"layers_{i}"], f"{prefix}.layers.{i}"
        att = layer["attention"]
        if wavlm:
            if "gru_rel_pos_const" in att:
                sd[f"{name}.attention.gru_rel_pos_const"] = _leaf(att["gru_rel_pos_const"], device)
            sd[f"{name}.attention.attention.in_proj_weight"] = _leaf(att["in_proj"]["kernel"], device).t().contiguous()
            sd[f"{name}.attention.attention.in_proj_bias"] = _leaf(att["in_proj"]["bias"], device)
            _dense(sd, f"{name}.attention.attention.out_proj", att["out_proj"], device)
            if "rel_attn_embed" in att:
                sd[f"{name}.attention.rel_attn_embed.weight"] = _leaf(att["rel_attn_embed"], device)
            if "gru_rel_pos_linear" in att:
                _dense(sd, f"{name}.attention.gru_rel_pos_linear", att["gru_rel_pos_linear"], device)
        else:
            for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
                _dense(sd, f"{name}.attention.{proj}", att[proj], device)
        _norm(sd, f"{name}.layer_norm", layer["layer_norm"], device)
        _dense(sd, f"{name}.feed_forward.intermediate_dense", layer["feed_forward"]["intermediate_dense"], device)
        _dense(sd, f"{name}.feed_forward.output_dense", layer["feed_forward"]["output_dense"], device)
        _norm(sd, f"{name}.final_layer_norm", layer["final_layer_norm"], device)
    if "aux" in tree:
        _dense(sd, "aux", tree["aux"], device)
    return sd


def wav2vec2_state_dict_from_jax_params(params: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's ``Wav2Vec2Model`` ``state_dict`` from the JAX package's flax parameters
    (``{"params": {feature_extractor, encoder, aux}}`` or the inner dict), in the order of the
    model's own ``state_dict``; ``load_state_dict(..., strict=True)`` takes the result."""
    tree = params["params"] if "params" in params else params
    encoder = tree["encoder"]
    return _wav2vec2_like(tree, encoder["feature_projection"], encoder["transformer"], device, wavlm=False)


def hubert_pretrain_state_dict_from_jax_params(params: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's ``HuBERTPretrainModel`` ``state_dict`` from the JAX package's flax parameters
    (``{"params": {wav2vec2: {feature_extractor, encoder}, mask_generator, logit_generator}}`` or the
    inner dict), in the order of the model's own ``state_dict``."""
    tree = params["params"] if "params" in params else params
    sd = {f"wav2vec2.{k}": v for k, v in wav2vec2_state_dict_from_jax_params(tree["wav2vec2"], device).items()}
    sd["mask_generator.mask_embedding"] = _leaf(tree["mask_generator"]["mask_embedding"], device)
    logits = tree["logit_generator"]
    sd["logit_generator.label_embeddings"] = _leaf(logits["label_embeddings"], device)
    _dense(sd, "logit_generator.final_proj", logits["final_proj"], device)
    return sd


def wavlm_state_dict_from_jax_params(params: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's ``WavLMModel`` ``state_dict`` from the JAX package's flax parameters (flax
    names ``encoder_feature_projection`` and ``encoder_transformer``; torchaudio's
    ``encoder.feature_projection`` and ``encoder.transformer`` in the result)."""
    tree = params["params"] if "params" in params else params
    return _wav2vec2_like(tree, tree["encoder_feature_projection"], tree["encoder_transformer"], device,
                          wavlm=True)


def _ffn(out: dict, name: str, node: dict, device) -> None:
    """A Conformer feed-forward module: LayerNorm and two Dense -> ``sequential.{0,1,4}``."""
    _norm(out, f"{name}.sequential.0", node["layer_norm"], device)
    _dense(out, f"{name}.sequential.1", node["linear1"], device)
    _dense(out, f"{name}.sequential.4", node["linear2"], device)


def conformer_state_dict_from_jax_params(variables: Any, device="cuda", prefix: str = "") -> Dict[str, torch.Tensor]:
    """The port's ``Conformer`` ``state_dict`` (names under ``prefix``) from the JAX package's flax
    variables: ``{"params": {conformer_layers_{i}}, "batch_stats": ...}`` as
    ``import_conformer_state_dict`` returns them, or the bare ``params`` tree.  A layer whose norm has
    batch statistics is a BatchNorm: its ``running_mean``/``running_var`` come from them and its
    ``num_batches_tracked`` is 0.  Pointwise kernels (C_in, C_out) become (C_out, C_in, 1), the
    depthwise kernel (K, 1, C) becomes (C, 1, K); the names and order are the model's own."""
    tree = variables["params"] if "params" in variables else variables
    stats = variables.get("batch_stats", {}) if "params" in variables else {}
    sd: Dict[str, torch.Tensor] = {}
    for i in range(_count(tree, "conformer_layers_")):
        layer, name = tree[f"conformer_layers_{i}"], f"{prefix}conformer_layers.{i}"
        _ffn(sd, f"{name}.ffn1", layer["ffn1"], device)
        _norm(sd, f"{name}.self_attn_layer_norm", layer["self_attn_layer_norm"], device)
        att = layer["self_attn"]
        sd[f"{name}.self_attn.in_proj_weight"] = _leaf(att["in_proj"]["kernel"], device).t().contiguous()
        sd[f"{name}.self_attn.in_proj_bias"] = _leaf(att["in_proj"]["bias"], device)
        _dense(sd, f"{name}.self_attn.out_proj", att["out_proj"], device)
        conv, seq = layer["conv_module"], f"{name}.conv_module.sequential"
        _norm(sd, f"{name}.conv_module.layer_norm", conv["layer_norm"], device)
        for idx, sub in (("0", "pointwise_conv1"), ("2", "depthwise_conv")):
            kernel = _leaf(conv[sub]["kernel"], device)
            sd[f"{seq}.{idx}.weight"] = (kernel.t()[:, :, None] if idx == "0" else kernel.permute(2, 1, 0)).contiguous()
            if "bias" in conv[sub]:
                sd[f"{seq}.{idx}.bias"] = _leaf(conv[sub]["bias"], device)
        _norm(sd, f"{seq}.3", conv["norm"], device)
        norm_stats = stats.get(f"conformer_layers_{i}", {}).get("conv_module", {}).get("norm")
        if norm_stats is not None:
            sd[f"{seq}.3.running_mean"] = _leaf(norm_stats["mean"], device)
            sd[f"{seq}.3.running_var"] = _leaf(norm_stats["var"], device)
            sd[f"{seq}.3.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
        sd[f"{seq}.5.weight"] = _leaf(conv["pointwise_conv2"]["kernel"], device).t()[:, :, None].contiguous()
        if "bias" in conv["pointwise_conv2"]:
            sd[f"{seq}.5.bias"] = _leaf(conv["pointwise_conv2"]["bias"], device)
        _ffn(sd, f"{name}.ffn2", layer["ffn2"], device)
        _norm(sd, f"{name}.final_layer_norm", layer["final_layer_norm"], device)
    return sd


def wav2letter_state_dict_from_jax_params(params: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's ``Wav2Letter`` ``state_dict`` from the JAX package's flax parameters ``{conv_{i}}``: twelve
    convolutions are the waveform model (``acoustic_model.0.0``, then ``acoustic_model.1.{0,2,...,20}``), eleven
    the spectral one (``acoustic_model.{0,2,...,20}``)."""
    tree = params["params"] if "params" in params else params
    n = _count(tree, "conv_")
    names = ([f"acoustic_model.1.{2 * i}" for i in range(n - 1)] if n == 12 else
             [f"acoustic_model.{2 * i}" for i in range(n)])
    if n == 12:
        names.insert(0, "acoustic_model.0.0")
    sd: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(names):
        _conv(sd, name, tree[f"conv_{i}"], device)
    return sd


def deepspeech_state_dict_from_jax_params(params: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's ``DeepSpeech`` ``state_dict`` from the JAX package's flax parameters: ``fc1``-``fc4`` and
    ``out`` transposed, ``rnn_fwd``/``rnn_bwd`` as ``bi_rnn``'s forward and ``_reverse`` weights."""
    tree = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for name in ("fc1", "fc2", "fc3"):
        _dense(sd, f"{name}.fc", tree[name]["fc"], device)
    for direction, suffix in (("rnn_fwd", ""), ("rnn_bwd", "_reverse")):
        rnn = tree[direction]
        for kind in ("ih", "hh"):
            sd[f"bi_rnn.weight_{kind}_l0{suffix}"] = _leaf(rnn[f"w_{kind}"], device).t().contiguous()
        for kind in ("ih", "hh"):
            sd[f"bi_rnn.bias_{kind}_l0{suffix}"] = _leaf(rnn[f"b_{kind}"], device)
    _dense(sd, "fc4.fc", tree["fc4"]["fc"], device)
    _dense(sd, "out", tree["out"], device)
    return sd


def _conv_tasnet_pointwise(out: dict, name: str, node: dict, device) -> None:
    """flax Dense {kernel (in, out), bias} -> torch Conv1d of kernel 1 {weight (out, in, 1), bias}."""
    out[f"{name}.weight"] = _leaf(node["kernel"], device).t()[:, :, None].contiguous()
    if "bias" in node:
        out[f"{name}.bias"] = _leaf(node["bias"], device)


def conv_tasnet_state_dict_from_jax_params(params: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's ``ConvTasNet`` ``state_dict`` from the JAX package's flax parameters: the encoder's kernel
    (K, 1, F) -> (F, 1, K), the decoder's (K, F, 1) -> (F, 1, K) (``ConvTranspose1d``'s layout), the 1x1
    convolutions' Dense kernels (in, out) -> (out, in, 1), the depthwise kernels (K, 1, C) -> (C, 1, K), each
    PReLU's scalar -> (1,), each norm's scale and bias -> weight and bias."""
    tree = params["params"] if "params" in params else params
    mg = tree["mask_generator"]
    sd: Dict[str, torch.Tensor] = {"encoder.weight": _leaf(tree["encoder"]["kernel"], device).permute(2, 1, 0)
                                   .contiguous()}
    _norm(sd, "mask_generator.input_norm", mg["input_norm"], device)
    _conv_tasnet_pointwise(sd, "mask_generator.input_conv", mg["input_conv"], device)
    for i in range(_count(mg, "conv_layers_")):
        block, name = mg[f"conv_layers_{i}"], f"mask_generator.conv_layers.{i}"
        _conv_tasnet_pointwise(sd, f"{name}.conv_layers.0", block["conv1x1_in"], device)
        sd[f"{name}.conv_layers.1.weight"] = _leaf(block["prelu1"]["alpha"], device).reshape(1)
        _norm(sd, f"{name}.conv_layers.2", block["norm1"], device)
        _conv(sd, f"{name}.conv_layers.3", block["depthwise"], device)
        sd[f"{name}.conv_layers.4.weight"] = _leaf(block["prelu2"]["alpha"], device).reshape(1)
        _norm(sd, f"{name}.conv_layers.5", block["norm2"], device)
        if "res_out" in block:
            _conv_tasnet_pointwise(sd, f"{name}.res_out", block["res_out"], device)
        _conv_tasnet_pointwise(sd, f"{name}.skip_out", block["skip_out"], device)
    sd["mask_generator.output_prelu.weight"] = _leaf(mg["output_prelu"]["alpha"], device).reshape(1)
    _conv_tasnet_pointwise(sd, "mask_generator.output_conv", mg["output_conv"], device)
    sd["decoder.weight"] = _leaf(tree["decoder_kernel"], device).permute(1, 2, 0).contiguous()
    return sd


def _torch_named(out: dict, name: str, node: dict, keys, device) -> None:
    """Leaves already in torch's layout, under torch's names: ``node[k]`` -> ``{name}.{k}`` for the ``keys`` present."""
    for k in keys:
        if k in node:
            out[f"{name}.{k}"] = _leaf(node[k], device)


_LSTM_KEYS = [f"{kind}_{part}_l{layer}{rev}" for layer in range(2) for rev in ("", "_reverse")
              for kind in ("weight", "bias") for part in ("ih", "hh")]


def _hdemucs_dconv(out: dict, name: str, node: dict, device) -> None:
    """flax ``layers_{d}_{conv1, norm1, blstm, attn, conv2, norm2, scale}`` -> torchaudio's Sequential
    ``layers.{d}.{0, 1, [3: lstm], [3 or 4: attention], 3 + n, 4 + n, 6 + n}``, n the extra modules."""
    for d in range(1 + max(int(k.split("_")[1]) for k in node)):
        base, seq = f"{name}.layers.{d}", 3
        _torch_named(out, f"{base}.0", node[f"layers_{d}_conv1"], ("weight", "bias"), device)
        _torch_named(out, f"{base}.1", node.get(f"layers_{d}_norm1", {}), ("weight", "bias"), device)
        if f"layers_{d}_blstm" in node:
            blstm = node[f"layers_{d}_blstm"]
            _torch_named(out, f"{base}.{seq}.lstm", blstm, sorted(
                (k for k in blstm if not k.startswith("linear_")), key=_LSTM_KEYS.index), device)
            out[f"{base}.{seq}.linear.weight"] = _leaf(blstm["linear_weight"], device)
            out[f"{base}.{seq}.linear.bias"] = _leaf(blstm["linear_bias"], device)
            seq += 1
        if f"layers_{d}_attn" in node:
            for conv in ("content", "query", "key", "query_decay", "proj"):
                _torch_named(out, f"{base}.{seq}.{conv}", node[f"layers_{d}_attn"][conv], ("weight", "bias"), device)
            seq += 1
        _torch_named(out, f"{base}.{seq}", node[f"layers_{d}_conv2"], ("weight", "bias"), device)
        _torch_named(out, f"{base}.{seq + 1}", node.get(f"layers_{d}_norm2", {}), ("weight", "bias"), device)
        out[f"{base}.{seq + 3}.scale"] = _leaf(node[f"layers_{d}_scale"]["scale"], device)


def hdemucs_state_dict_from_jax_params(params: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's ``HDemucs`` ``state_dict`` from the JAX package's flax parameters, whose convolutions already hold
    torch's layout: ``{branch}_{i}`` -> ``{branch}.{i}`` (a decoder's index reversed: torchaudio holds the deepest
    first), each layer's ``conv``/``conv_tr``, ``norm1``, ``rewrite``, ``norm2`` and ``dconv`` (``_hdemucs_dconv``),
    and ``freq_emb_weight`` -> ``freq_emb.embedding.weight``.  An empty layer's ``norm1``, which torchaudio keeps
    and the JAX model never reads, comes across where the tree holds it (the JAX importer keeps it)."""
    tree = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for branch in ("freq_encoder", "freq_decoder", "time_encoder", "time_decoder"):
        n = _count(tree, f"{branch}_")
        parts = ("conv", "norm1", "rewrite", "norm2") if branch.endswith("encoder") else (
            "conv_tr", "norm2", "rewrite", "norm1")
        for i in range(n):
            node = tree[f"{branch}_{n - 1 - i if branch.endswith('decoder') else i}"]
            for part in parts:
                _torch_named(sd, f"{branch}.{i}.{part}", node.get(part, {}), ("weight", "bias"), device)
            if "dconv" in node:
                _hdemucs_dconv(sd, f"{branch}.{i}.dconv", node["dconv"], device)
    if "freq_emb_weight" in tree:
        sd["freq_emb.embedding.weight"] = _leaf(tree["freq_emb_weight"], device)
    return sd


def _bilstm(out: dict, name: str, node: dict, device) -> None:
    """The JAX package's one-layer bidirectional LSTM {w_ih_f (in, 4H), ...} -> ``nn.LSTM``'s
    ``weight_ih_l0`` (4H, in), ..., ``bias_hh_l0_reverse``."""
    for rev, suffix in (("", "f"), ("_reverse", "b")):
        out[f"{name}.weight_ih_l0{rev}"] = _leaf(node[f"w_ih_{suffix}"], device).t().contiguous()
        out[f"{name}.weight_hh_l0{rev}"] = _leaf(node[f"w_hh_{suffix}"], device).t().contiguous()
        out[f"{name}.bias_ih_l0{rev}"] = _leaf(node[f"b_ih_{suffix}"], device)
        out[f"{name}.bias_hh_l0{rev}"] = _leaf(node[f"b_hh_{suffix}"], device)


def squim_objective_state_dict_from_jax_params(params: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's ``SquimObjective`` ``state_dict`` from the JAX package's flax parameters: the encoder's kernel
    (K, 1, F) -> (F, 1, K), the LSTMs' kernels transposed, the Dense kernels transposed (the 1x1 ``Conv2d``'s to
    (out, in, 1, 1)), each PReLU's scalar -> (1,), the norms' scale -> weight."""
    tree = params["params"] if "params" in params else params
    dp = tree["dprnn"]
    n = _count(dp, "row_rnn_")
    sd: Dict[str, torch.Tensor] = {"encoder.conv1d.weight": _leaf(tree["encoder"]["kernel"], device).permute(2, 1, 0)
                                   .contiguous()}
    for which in ("row", "col"):
        for i in range(n):
            _bilstm(sd, f"dprnn.{which}_rnn.{i}.rnn", dp[f"{which}_rnn_{i}"]["rnn"], device)
            _dense(sd, f"dprnn.{which}_rnn.{i}.proj", dp[f"{which}_rnn_{i}"]["proj"], device)
    for which in ("row", "col"):
        for i in range(n):
            _norm(sd, f"dprnn.{which}_norm.{i}", dp[f"{which}_norm_{i}"], device)
    sd["dprnn.conv.0.weight"] = _leaf(dp["conv"]["kernel"], device).t()[:, :, None, None].contiguous()
    sd["dprnn.conv.0.bias"] = _leaf(dp["conv"]["bias"], device)
    sd["dprnn.conv.1.weight"] = _leaf(dp["conv_prelu"]["alpha"], device).reshape(1)
    for bi, metric in enumerate(("stoi", "pesq", "sisdr")):
        branch, name = tree[f"branch_{metric}"], f"branches.{bi}"
        tr = branch["transformer"]
        sd[f"{name}.0.self_attn.in_proj_weight"] = _leaf(tr["in_proj"]["kernel"], device).t().contiguous()
        sd[f"{name}.0.self_attn.in_proj_bias"] = _leaf(tr["in_proj"]["bias"], device)
        _dense(sd, f"{name}.0.self_attn.out_proj", tr["out_proj"], device)
        _dense(sd, f"{name}.0.linear1", tr["linear1"], device)
        _dense(sd, f"{name}.0.linear2", tr["linear2"], device)
        _norm(sd, f"{name}.0.norm1", tr["norm1"], device)
        _norm(sd, f"{name}.0.norm2", tr["norm2"], device)
        sd[f"{name}.1.alpha"] = _leaf(branch["autopool"]["alpha"], device)
        _dense(sd, f"{name}.2.0", branch["linear1"], device)
        sd[f"{name}.2.1.weight"] = _leaf(branch["prelu"]["alpha"], device).reshape(1)
        _dense(sd, f"{name}.2.2", branch["linear2"], device)
    return sd


def squim_subjective_state_dict_from_jax_params(params: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's ``SquimSubjective`` ``state_dict`` from the JAX package's flax parameters: the SSL model as
    ``wav2vec2_state_dict_from_jax_params`` carries it, under ``ssl_model.``, then ``projector`` and
    ``predictor.att_pool_layer.{linear1, linear2}`` transposed."""
    tree = params["params"] if "params" in params else params
    ssl = tree["ssl_model"]
    sd = {f"ssl_model.{k}": v for k, v in _wav2vec2_like(ssl, ssl["encoder"]["feature_projection"],
                                                         ssl["encoder"]["transformer"], device, wavlm=False).items()}
    _dense(sd, "projector", tree["projector"], device)
    pool = tree["predictor"]["att_pool_layer"]
    _dense(sd, "predictor.att_pool_layer.linear1", pool["linear1"], device)
    _dense(sd, "predictor.att_pool_layer.linear2", pool["linear2"], device)
    return sd


def _batch_norm(out: dict, name: str, node: dict, stats: Optional[dict], device) -> None:
    """flax BatchNorm {scale, bias} and its batch statistics {mean, var} -> torch's {weight, bias, running_mean,
    running_var, num_batches_tracked (0)}; a tree without statistics (a gradient tree) gives the first two."""
    _norm(out, name, node, device)
    if stats is not None:
        out[f"{name}.running_mean"] = _leaf(stats["mean"], device)
        out[f"{name}.running_var"] = _leaf(stats["var"], device)
        out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)


def _variables(variables: Any):
    """(params, batch_stats or None) of ``{"params": ..., "batch_stats": ...}`` or of a bare params tree."""
    if "params" in variables:
        return variables["params"], variables.get("batch_stats")
    return variables, None


def _stats(stats: Optional[dict], *path: str) -> Optional[dict]:
    for p in path:
        if stats is None:
            return None
        stats = stats.get(p)
    return stats


def _lstm_cell(out: dict, name: str, node: dict, device, suffix: str = "") -> None:
    """{w_ih (in, G), w_hh (H, G), b_ih, b_hh} -> torch's {weight_ih (G, in), weight_hh, bias_ih, bias_hh} (with
    ``suffix``, ``_l0`` for an ``nn.GRU``)."""
    out[f"{name}.weight_ih{suffix}"] = _leaf(node["w_ih"], device).t().contiguous()
    out[f"{name}.weight_hh{suffix}"] = _leaf(node["w_hh"], device).t().contiguous()
    out[f"{name}.bias_ih{suffix}"] = _leaf(node["b_ih"], device)
    out[f"{name}.bias_hh{suffix}"] = _leaf(node["b_hh"], device)


def tacotron2_state_dict_from_jax_params(variables: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's ``Tacotron2`` ``state_dict`` from the JAX package's flax variables (``{"params", "batch_stats"}``
    as ``import_tacotron2_state_dict`` returns them, or a bare params or gradient tree): ``encoder_conv_{i}`` and
    ``encoder_bn_{i}`` -> ``encoder.convolutions.{i}.{0,1}`` (kernels (K, in, out) -> (out, in, K)), the encoder's
    ``w_*_f``/``w_*_b`` -> ``encoder.lstm``'s ``*_l0``/``*_l0_reverse``, the prenet, the two LSTM cells, the
    attention's layers under ``decoder.attention_layer``, the projections and ``postnet_conv_{i}``/``postnet_bn_{i}``
    -> ``postnet.convolutions.{i}.{0,1}``; in the model's own order."""
    tree, stats = _variables(variables)
    sd: Dict[str, torch.Tensor] = {"embedding.weight": _leaf(tree["embedding"]["embedding"], device)}
    for i in range(_count(tree, "encoder_conv_")):
        _conv(sd, f"encoder.convolutions.{i}.0", tree[f"encoder_conv_{i}"], device)
        _batch_norm(sd, f"encoder.convolutions.{i}.1", tree[f"encoder_bn_{i}"], _stats(stats, f"encoder_bn_{i}"),
                    device)
    lstm = tree["encoder_lstm"]
    for rev, d in (("", "f"), ("_reverse", "b")):
        _lstm_cell(sd, "encoder.lstm", {k: lstm[f"{k}_{d}"] for k in ("w_ih", "w_hh", "b_ih", "b_hh")}, device,
                   f"_l0{rev}")
    for i in range(2):
        sd[f"decoder.prenet.layers.{i}.weight"] = _leaf(tree[f"prenet_{i + 1}"]["kernel"], device).t().contiguous()
    _lstm_cell(sd, "decoder.attention_rnn", tree["attention_rnn"], device)
    for name in ("query_layer", "memory_layer", "v"):
        _dense(sd, f"decoder.attention_layer.{name}", tree[name], device)
    _conv(sd, "decoder.attention_layer.location_layer.location_conv", tree["location_conv"], device)
    _dense(sd, "decoder.attention_layer.location_layer.location_dense", tree["location_dense"], device)
    _lstm_cell(sd, "decoder.decoder_rnn", tree["decoder_rnn"], device)
    _dense(sd, "decoder.linear_projection", tree["linear_projection"], device)
    _dense(sd, "decoder.gate_layer", tree["gate_layer"], device)
    for i in range(_count(tree, "postnet_conv_")):
        _conv(sd, f"postnet.convolutions.{i}.0", tree[f"postnet_conv_{i}"], device)
        _batch_norm(sd, f"postnet.convolutions.{i}.1", tree[f"postnet_bn_{i}"], _stats(stats, f"postnet_bn_{i}"),
                    device)
    return sd


def wavernn_state_dict_from_jax_params(variables: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's ``WaveRNN`` ``state_dict`` from the JAX package's flax variables (or a bare params or gradient
    tree): the MelResNet under ``upsample.resnet.melresnet_model`` (``conv_in`` (K, in, out) -> ``0`` (out, in, K),
    ``bn_in`` -> ``1``, ``resblock_{i}`` -> ``{3 + i}.resblock_model.{0, 1, 3, 4}`` with the Dense kernels
    (in, out) as ``Conv1d(k=1)`` weights (out, in, 1), ``conv_out`` -> ``{3 + n}``), ``up_conv_{j}`` ->
    ``upsample.upsample_layers.{2j + 1}`` (already torch's layout), ``fc``, ``rnn1``/``rnn2`` as ``nn.GRU``
    (``*_l0``), ``fc1``-``fc3``; in the model's own order."""
    tree, stats = _variables(variables)
    up, up_stats = tree["upsample"], _stats(stats, "upsample", "resnet")
    res, mel = up["resnet"], "upsample.resnet.melresnet_model"
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, f"{mel}.0", res["conv_in"], device)
    _batch_norm(sd, f"{mel}.1", res["bn_in"], _stats(up_stats, "bn_in"), device)

    def pointwise(name: str, node: dict) -> None:
        sd[f"{name}.weight"] = _leaf(node["kernel"], device).t()[:, :, None].contiguous()
        if "bias" in node:
            sd[f"{name}.bias"] = _leaf(node["bias"], device)

    n = _count(res, "resblock_")
    for i in range(n):
        block, name = res[f"resblock_{i}"], f"{mel}.{3 + i}.resblock_model"
        for conv, bn, at in (("conv1", "bn1", 0), ("conv2", "bn2", 3)):
            pointwise(f"{name}.{at}", block[conv])
            _batch_norm(sd, f"{name}.{at + 1}", block[bn], _stats(up_stats, f"resblock_{i}", bn), device)
    pointwise(f"{mel}.{3 + n}", res["conv_out"])
    for j in range(_count(up, "up_conv_")):
        sd[f"upsample.upsample_layers.{2 * j + 1}.weight"] = _leaf(up[f"up_conv_{j}"], device)
    _dense(sd, "fc", tree["fc"], device)
    for rnn in ("rnn1", "rnn2"):
        _lstm_cell(sd, rnn, tree[rnn], device, "_l0")
    for lin in ("fc1", "fc2", "fc3"):
        _dense(sd, lin, tree[lin], device)
    return sd
