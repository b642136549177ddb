"""Checkpoint tensor-name canonicalization.

A copy of inferflow_tpu/models/network_structure.py (no JAX in it), kept
so that this package imports nothing of the JAX one.

reference: src/transformer/network_structure.{h,cc} — maps source checkpoint
tensor names onto canonical layer slots with `{i}` (layer) / `{j}` (expert)
expansion, with per-archetype default tables and per-model overrides from
model_spec.json's `tensor_name_mapping`.

A canonical slot is a path into the params pytree consumed by
models/decoder.py / encoder.py:
    ('dec_embeddings',)                      top-level tensors
    ('layers', i, 'attn', 'wq')              per-layer tensors
    ('layers', i, 'moe', 'experts', j, 'w1') per-expert tensors
Weight matrices are transposed on load to the TPU convention (K=in, N=out)
unless the rule sets transpose=False (GPT-2 Conv1D checkpoints already
store (in, out)).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Rule:
    pattern: str  # regex over source names; groups: i=layer, j=expert
    slot: str  # dotted canonical path with {i}/{j} placeholders
    transpose: bool = True  # only applies to 2-D weights

    def compiled(self):
        return re.compile("^" + self.pattern + "$")


def _wn(src: str, slot: str, transpose: bool = True) -> List[Rule]:
    """weight+bias rule pair: src.{weight,bias} -> slot / slot_b."""
    return [Rule(src + r"\.weight", slot, transpose),
            Rule(src + r"\.bias", slot + "_b", False)]


_L = r"(?P<i>\d+)"
_E = r"(?P<j>\d+)"

# ---------------------------------------------------------------------------
# Default tables per source family (reference: network_structure.cc builds
# canonical-name maps per NetworkType; here: per HF checkpoint family).
# ---------------------------------------------------------------------------

LLAMA_RULES: List[Rule] = (
    [Rule(r"(model\.|tok_)?embed(_tokens|dings)?\.weight", "dec_embeddings",
          False),
     Rule(r"model\.norm\.weight", "dec_output_norm", False),
     Rule(r"norm\.weight", "dec_output_norm", False),
     Rule(r"(lm_head|output)\.weight", "lm_head")]
    + _wn(rf"(model\.)?layers\.{_L}\.self_attn\.q_proj",
          "layers.{i}.attn.wq")
    + _wn(rf"(model\.)?layers\.{_L}\.self_attn\.k_proj",
          "layers.{i}.attn.wk")
    + _wn(rf"(model\.)?layers\.{_L}\.self_attn\.v_proj",
          "layers.{i}.attn.wv")
    + _wn(rf"(model\.)?layers\.{_L}\.self_attn\.(o|dense)_proj",
          "layers.{i}.attn.wo")
    + _wn(rf"(model\.)?layers\.{_L}\.self_attn\.qkv_proj",
          "layers.{i}.attn.qkv")
    # Baichuan fused QKV (reference network_structure.cc:398)
    + _wn(rf"(model\.)?layers\.{_L}\.self_attn\.W_pack",
          "layers.{i}.attn.qkv")
    + [Rule(rf"(model\.)?layers\.{_L}\.input_layernorm\.weight",
            "layers.{i}.attn.pre_norm", False),
       Rule(rf"(model\.)?layers\.{_L}\.input_layernorm\.bias",
            "layers.{i}.attn.pre_norm_b", False),
       Rule(rf"(model\.)?layers\.{_L}\.post_attention_layernorm\.weight",
            "layers.{i}.ffn.pre_norm", False),
       Rule(rf"(model\.)?layers\.{_L}\.post_attention_layernorm\.bias",
            "layers.{i}.ffn.pre_norm_b", False)]
    + _wn(rf"(model\.)?layers\.{_L}\.mlp\.gate_proj", "layers.{i}.ffn.w1")
    + _wn(rf"(model\.)?layers\.{_L}\.mlp\.down_proj", "layers.{i}.ffn.w2")
    + _wn(rf"(model\.)?layers\.{_L}\.mlp\.up_proj", "layers.{i}.ffn.w3")
    # Mixtral-style sparse MoE
    + _wn(rf"(model\.)?layers\.{_L}\.block_sparse_moe\.gate",
          "layers.{i}.moe.gate")
    + _wn(rf"(model\.)?layers\.{_L}\.block_sparse_moe\.experts\.{_E}\.w1",
          "layers.{i}.moe.experts.{j}.w1")
    + _wn(rf"(model\.)?layers\.{_L}\.block_sparse_moe\.experts\.{_E}\.w2",
          "layers.{i}.moe.experts.{j}.w2")
    + _wn(rf"(model\.)?layers\.{_L}\.block_sparse_moe\.experts\.{_E}\.w3",
          "layers.{i}.moe.experts.{j}.w3")
    # DeepSeek-MoE style (incl. shared experts)
    + _wn(rf"(model\.)?layers\.{_L}\.mlp\.gate", "layers.{i}.moe.gate")
    + _wn(rf"(model\.)?layers\.{_L}\.mlp\.experts\.{_E}\.gate_proj",
          "layers.{i}.moe.experts.{j}.w1")
    + _wn(rf"(model\.)?layers\.{_L}\.mlp\.experts\.{_E}\.down_proj",
          "layers.{i}.moe.experts.{j}.w2")
    + _wn(rf"(model\.)?layers\.{_L}\.mlp\.experts\.{_E}\.up_proj",
          "layers.{i}.moe.experts.{j}.w3")
    + _wn(rf"(model\.)?layers\.{_L}\.mlp\.shared_experts?\.gate_proj",
          "layers.{i}.moe.shared.w1")
    + _wn(rf"(model\.)?layers\.{_L}\.mlp\.shared_experts?\.down_proj",
          "layers.{i}.moe.shared.w2")
    + _wn(rf"(model\.)?layers\.{_L}\.mlp\.shared_experts?\.up_proj",
          "layers.{i}.moe.shared.w3")
)

FALCON_RULES: List[Rule] = (
    [Rule(r"(transformer\.)?word_embeddings\.weight", "dec_embeddings",
          False),
     Rule(r"(transformer\.)?ln_f\.weight", "dec_output_norm", False),
     Rule(r"(transformer\.)?ln_f\.bias", "dec_output_norm_b", False),
     Rule(r"lm_head\.weight", "lm_head")]
    + _wn(rf"(transformer\.)?h\.{_L}\.self_attention\.query_key_value",
          "layers.{i}.attn.qkv")
    + _wn(rf"(transformer\.)?h\.{_L}\.self_attention\.dense",
          "layers.{i}.attn.wo")
    + [Rule(rf"(transformer\.)?h\.{_L}\.input_layernorm\.weight",
            "layers.{i}.attn.pre_norm", False),
       Rule(rf"(transformer\.)?h\.{_L}\.input_layernorm\.bias",
            "layers.{i}.attn.pre_norm_b", False),
       Rule(rf"(transformer\.)?h\.{_L}\.ln_attn\.weight",
            "layers.{i}.attn.pre_norm", False),
       Rule(rf"(transformer\.)?h\.{_L}\.ln_attn\.bias",
            "layers.{i}.attn.pre_norm_b", False),
       Rule(rf"(transformer\.)?h\.{_L}\.ln_mlp\.weight",
            "layers.{i}.ffn.pre_norm", False),
       Rule(rf"(transformer\.)?h\.{_L}\.ln_mlp\.bias",
            "layers.{i}.ffn.pre_norm_b", False)]
    + _wn(rf"(transformer\.)?h\.{_L}\.mlp\.dense_h_to_4h",
          "layers.{i}.ffn.w1")
    + _wn(rf"(transformer\.)?h\.{_L}\.mlp\.dense_4h_to_h",
          "layers.{i}.ffn.w2")
)

BLOOM_RULES: List[Rule] = (
    [Rule(r"(transformer\.)?word_embeddings\.weight", "dec_embeddings",
          False),
     Rule(r"(transformer\.)?word_embeddings_layernorm\.weight",
          "dec_input_norm", False),
     Rule(r"(transformer\.)?word_embeddings_layernorm\.bias",
          "dec_input_norm_b", False),
     Rule(r"(transformer\.)?ln_f\.weight", "dec_output_norm", False),
     Rule(r"(transformer\.)?ln_f\.bias", "dec_output_norm_b", False),
     Rule(r"lm_head\.weight", "lm_head")]
    + _wn(rf"(transformer\.)?h\.{_L}\.self_attention\.query_key_value",
          "layers.{i}.attn.qkv")
    + _wn(rf"(transformer\.)?h\.{_L}\.self_attention\.dense",
          "layers.{i}.attn.wo")
    + [Rule(rf"(transformer\.)?h\.{_L}\.input_layernorm\.weight",
            "layers.{i}.attn.pre_norm", False),
       Rule(rf"(transformer\.)?h\.{_L}\.input_layernorm\.bias",
            "layers.{i}.attn.pre_norm_b", False),
       Rule(rf"(transformer\.)?h\.{_L}\.post_attention_layernorm\.weight",
            "layers.{i}.ffn.pre_norm", False),
       Rule(rf"(transformer\.)?h\.{_L}\.post_attention_layernorm\.bias",
            "layers.{i}.ffn.pre_norm_b", False)]
    + _wn(rf"(transformer\.)?h\.{_L}\.mlp\.dense_h_to_4h",
          "layers.{i}.ffn.w1")
    + _wn(rf"(transformer\.)?h\.{_L}\.mlp\.dense_4h_to_h",
          "layers.{i}.ffn.w2")
)

GPT2_RULES: List[Rule] = (
    [Rule(r"(transformer\.)?wte\.weight", "dec_embeddings", False),
     Rule(r"(transformer\.)?wpe\.weight", "dec_pos_embeddings", False),
     Rule(r"(transformer\.)?ln_f\.weight", "dec_output_norm", False),
     Rule(r"(transformer\.)?ln_f\.bias", "dec_output_norm_b", False),
     Rule(r"lm_head\.weight", "lm_head")]
    # GPT-2 Conv1D stores (in, out): no transpose
    + _wn(rf"(transformer\.)?h\.{_L}\.attn\.c_attn", "layers.{i}.attn.qkv",
          False)
    + _wn(rf"(transformer\.)?h\.{_L}\.attn\.c_proj", "layers.{i}.attn.wo",
          False)
    + [Rule(rf"(transformer\.)?h\.{_L}\.ln_1\.weight",
            "layers.{i}.attn.pre_norm", False),
       Rule(rf"(transformer\.)?h\.{_L}\.ln_1\.bias",
            "layers.{i}.attn.pre_norm_b", False),
       Rule(rf"(transformer\.)?h\.{_L}\.ln_2\.weight",
            "layers.{i}.ffn.pre_norm", False),
       Rule(rf"(transformer\.)?h\.{_L}\.ln_2\.bias",
            "layers.{i}.ffn.pre_norm_b", False)]
    + _wn(rf"(transformer\.)?h\.{_L}\.mlp\.c_fc", "layers.{i}.ffn.w1", False)
    + _wn(rf"(transformer\.)?h\.{_L}\.mlp\.c_proj", "layers.{i}.ffn.w2",
          False)
)

BERT_RULES: List[Rule] = (
    [Rule(r"(bert\.)?embeddings\.word_embeddings\.weight", "enc_embeddings",
          False),
     Rule(r"(bert\.)?embeddings\.position_embeddings\.weight",
          "enc_pos_embeddings", False),
     Rule(r"(bert\.)?embeddings\.token_type_embeddings\.weight",
          "enc_token_type_embeddings", False),
     Rule(r"(bert\.)?embeddings\.LayerNorm\.weight", "enc_input_norm",
          False),
     Rule(r"(bert\.)?embeddings\.LayerNorm\.bias", "enc_input_norm_b",
          False)]
    + _wn(rf"(bert\.)?encoder\.layer\.{_L}\.attention\.self\.query",
          "enc_layers.{i}.attn.wq")
    + _wn(rf"(bert\.)?encoder\.layer\.{_L}\.attention\.self\.key",
          "enc_layers.{i}.attn.wk")
    + _wn(rf"(bert\.)?encoder\.layer\.{_L}\.attention\.self\.value",
          "enc_layers.{i}.attn.wv")
    + _wn(rf"(bert\.)?encoder\.layer\.{_L}\.attention\.output\.dense",
          "enc_layers.{i}.attn.wo")
    + [Rule(rf"(bert\.)?encoder\.layer\.{_L}\.attention\.output\.LayerNorm"
            r"\.weight", "enc_layers.{i}.attn.post_norm", False),
       Rule(rf"(bert\.)?encoder\.layer\.{_L}\.attention\.output\.LayerNorm"
            r"\.bias", "enc_layers.{i}.attn.post_norm_b", False)]
    + _wn(rf"(bert\.)?encoder\.layer\.{_L}\.intermediate\.dense",
          "enc_layers.{i}.ffn.w1")
    + _wn(rf"(bert\.)?encoder\.layer\.{_L}\.output\.dense",
          "enc_layers.{i}.ffn.w2")
    + [Rule(rf"(bert\.)?encoder\.layer\.{_L}\.output\.LayerNorm\.weight",
            "enc_layers.{i}.ffn.post_norm", False),
       Rule(rf"(bert\.)?encoder\.layer\.{_L}\.output\.LayerNorm\.bias",
            "enc_layers.{i}.ffn.post_norm_b", False)]
    + _wn(r"cls\.predictions\.transform\.dense", "mlm_transform")
    + [Rule(r"cls\.predictions\.transform\.LayerNorm\.weight",
            "mlm_norm", False),
       Rule(r"cls\.predictions\.transform\.LayerNorm\.bias", "mlm_norm_b",
            False),
       Rule(r"cls\.predictions\.bias", "lm_head_b", False),
       Rule(r"cls\.predictions\.decoder\.weight", "lm_head")]
)


def _encdec_side(side: str, prefix: str) -> List[Rule]:
    """m2m100/BART-style encoder or decoder stack rules."""
    p = rf"(model\.)?{side}\."
    tgt = prefix
    rules = (
        [Rule(p + r"embed_tokens\.weight", f"{tgt}_embeddings", False),
         Rule(p + r"layer_norm\.weight", f"{tgt}_output_norm", False),
         Rule(p + r"layer_norm\.bias", f"{tgt}_output_norm_b", False),
         Rule(p + r"embed_positions\.weight", f"{tgt}_pos_embeddings",
              False)]
    )
    lp = "enc_layers" if prefix == "enc" else "layers"
    rules += _wn(p + rf"layers\.{_L}\.self_attn\.q_proj",
                 lp + ".{i}.attn.wq")
    rules += _wn(p + rf"layers\.{_L}\.self_attn\.k_proj",
                 lp + ".{i}.attn.wk")
    rules += _wn(p + rf"layers\.{_L}\.self_attn\.v_proj",
                 lp + ".{i}.attn.wv")
    rules += _wn(p + rf"layers\.{_L}\.self_attn\.out_proj",
                 lp + ".{i}.attn.wo")
    rules += [Rule(p + rf"layers\.{_L}\.self_attn_layer_norm\.weight",
                   lp + ".{i}.attn.pre_norm", False),
              Rule(p + rf"layers\.{_L}\.self_attn_layer_norm\.bias",
                   lp + ".{i}.attn.pre_norm_b", False),
              Rule(p + rf"layers\.{_L}\.final_layer_norm\.weight",
                   lp + ".{i}.ffn.pre_norm", False),
              Rule(p + rf"layers\.{_L}\.final_layer_norm\.bias",
                   lp + ".{i}.ffn.pre_norm_b", False)]
    rules += _wn(p + rf"layers\.{_L}\.fc1", lp + ".{i}.ffn.w1")
    rules += _wn(p + rf"layers\.{_L}\.fc2", lp + ".{i}.ffn.w2")
    if prefix == "dec":
        rules += _wn(p + rf"layers\.{_L}\.encoder_attn\.q_proj",
                     lp + ".{i}.cross_attn.wq")
        rules += _wn(p + rf"layers\.{_L}\.encoder_attn\.k_proj",
                     lp + ".{i}.cross_attn.wk")
        rules += _wn(p + rf"layers\.{_L}\.encoder_attn\.v_proj",
                     lp + ".{i}.cross_attn.wv")
        rules += _wn(p + rf"layers\.{_L}\.encoder_attn\.out_proj",
                     lp + ".{i}.cross_attn.wo")
        rules += [Rule(p + rf"layers\.{_L}\.encoder_attn_layer_norm\.weight",
                       lp + ".{i}.cross_attn.pre_norm", False),
                  Rule(p + rf"layers\.{_L}\.encoder_attn_layer_norm\.bias",
                       lp + ".{i}.cross_attn.pre_norm_b", False)]
    return rules


ENCDEC_RULES: List[Rule] = (
    _encdec_side("encoder", "enc") + _encdec_side("decoder", "dec")
    + [Rule(r"lm_head\.weight", "lm_head"),
       Rule(r"(model\.)?shared\.weight", "dec_embeddings", False)]
)

# llama.cpp GGUF-native tensor names (ggml convention; the reference's GGUF
# reader maps these in model_reader.cc:2748-3247).  Appended after every
# family's rules so GGUF checkpoints load without a spec tensor_name_mapping.
GGUF_RULES: List[Rule] = (
    [Rule(r"token_embd\.weight", "dec_embeddings", False),
     Rule(r"output_norm\.weight", "dec_output_norm", False),
     Rule(r"output_norm\.bias", "dec_output_norm_b", False),
     Rule(r"output\.weight", "lm_head"),
     Rule(r"rope_freqs\.weight", "rope_freqs", False)]
    + _wn(rf"blk\.{_L}\.attn_q", "layers.{i}.attn.wq")
    + _wn(rf"blk\.{_L}\.attn_k", "layers.{i}.attn.wk")
    + _wn(rf"blk\.{_L}\.attn_v", "layers.{i}.attn.wv")
    + _wn(rf"blk\.{_L}\.attn_qkv", "layers.{i}.attn.qkv")
    + _wn(rf"blk\.{_L}\.attn_output", "layers.{i}.attn.wo")
    + [Rule(rf"blk\.{_L}\.attn_norm\.weight",
            "layers.{i}.attn.pre_norm", False),
       Rule(rf"blk\.{_L}\.attn_norm\.bias",
            "layers.{i}.attn.pre_norm_b", False),
       Rule(rf"blk\.{_L}\.ffn_norm\.weight",
            "layers.{i}.ffn.pre_norm", False),
       Rule(rf"blk\.{_L}\.ffn_norm\.bias",
            "layers.{i}.ffn.pre_norm_b", False)]
    + _wn(rf"blk\.{_L}\.ffn_gate", "layers.{i}.ffn.w1")
    + _wn(rf"blk\.{_L}\.ffn_down", "layers.{i}.ffn.w2")
    + _wn(rf"blk\.{_L}\.ffn_up", "layers.{i}.ffn.w3")
    + _wn(rf"blk\.{_L}\.ffn_gate_inp", "layers.{i}.moe.gate")
    + _wn(rf"blk\.{_L}\.ffn_gate\.{_E}", "layers.{i}.moe.experts.{j}.w1")
    + _wn(rf"blk\.{_L}\.ffn_down\.{_E}", "layers.{i}.moe.experts.{j}.w2")
    + _wn(rf"blk\.{_L}\.ffn_up\.{_E}", "layers.{i}.moe.experts.{j}.w3")
)

FAMILY_RULES: Dict[str, List[Rule]] = {
    "llama": LLAMA_RULES,
    "decoder_only": LLAMA_RULES,
    "falcon": FALCON_RULES,
    "bloom": BLOOM_RULES,
    "gpt2": GPT2_RULES,
    "bert": BERT_RULES,
    "encoder_only": BERT_RULES,
    "encoder_decoder": ENCDEC_RULES,
}


# reference canonical tensor names (network_structure.cc LayerTensorId
# name table) -> our slot paths.  Used to honor model_spec.json
# `tensor_name_mapping` values verbatim.
_CANON_TOP = {
    "dec.token_embeddings.weight": "dec_embeddings",
    "dec.pos_embeddings.weight": "dec_pos_embeddings",
    "dec.input_norm.weight": "dec_input_norm",
    "dec.input_norm.bias": "dec_input_norm_b",
    "dec.output_norm.weight": "dec_output_norm",
    "dec.output_norm.bias": "dec_output_norm_b",
    "dec.output.weight": "lm_head",
    "dec.output.bias": "lm_head_b",
    "enc.token_embeddings.weight": "enc_embeddings",
    "enc.pos_embeddings.weight": "enc_pos_embeddings",
    "enc.token_type_embeddings.weight": "enc_token_type_embeddings",
    "enc.input_norm.weight": "enc_input_norm",
    "enc.input_norm.bias": "enc_input_norm_b",
    "enc.output_norm.weight": "enc_output_norm",
    "enc.output_norm.bias": "enc_output_norm_b",
    "enc.output.weight": "lm_head",
    "enc.output.bias": "lm_head_b",
    "output_transform.weight": "mlm_transform",
    "output_transform.bias": "mlm_transform_b",
    "output_transform.post_norm.weight": "mlm_norm",
    "output_transform.post_norm.bias": "mlm_norm_b",
}

_CANON_SUB = {"self_attn": "attn", "feed_forward": "ffn", "moe": "moe",
              "cross_attn": "cross_attn"}


def canonical_to_slot(name: str) -> Optional[str]:
    """reference canonical name -> our dotted slot path (None if unknown)."""
    if name in _CANON_TOP:
        return _CANON_TOP[name]
    m = re.match(r"^(dec|enc)\.\{i\}\.(\w+)\.(.+)$", name)
    if not m:
        return None
    side, block, rest = m.groups()
    layers = "layers" if side == "dec" else "enc_layers"
    sub = _CANON_SUB.get(block)
    if sub is None:
        return None
    # In decoder-only models the reference's `self_attn.post_norm` is the
    # norm between attention and FFN (e.g. Mixtral's
    # post_attention_layernorm) — functionally the FFN pre-norm in our
    # pre-norm decoder layer.  Encoders keep it as a true post-norm.
    if side == "dec" and sub == "attn" and rest.startswith("post_norm."):
        sub, rest = "ffn", rest.replace("post_norm", "pre_norm", 1)
    expert = ""
    em = re.match(r"^(expert\.\{j\}|shared_expert)\.(.+)$", rest)
    if sub == "moe" and em:
        expert = ("experts.{j}." if em.group(1).startswith("expert")
                  else "shared.")
        rest = em.group(2)
    leaf, _, kind = rest.rpartition(".")
    if not leaf:
        return None
    if kind == "bias":
        leaf += "_b"
    return f"{layers}.{{i}}.{sub}.{expert}{leaf}"


class NameMapper:
    """Source tensor name -> canonical slot path.

    spec_map: model_spec.json `tensor_name_mapping` overrides — entries of
    source-name (with {i}/{j}) -> reference-canonical (or our dotted) slot,
    tried first (model_reader.cc:194-446 reads them;
    network_structure.cc:180-185 TransTensorName applies them).
    """

    def __init__(self, family: str, spec_map: Optional[Dict[str, str]] = None,
                 tensor_name_prefix: str = ""):
        rules = []
        for src, slot in (spec_map or {}).items():
            canon = canonical_to_slot(slot)
            if canon is not None:
                slot = canon
            pat = re.escape(src)
            pat = pat.replace(r"\{i\}", _L).replace(r"\{j\}", _E)
            transpose = not (slot.endswith(("_norm", "_norm_b", "_b",
                                            "embeddings"))
                             or ".pre_norm" in slot or ".post_norm" in slot)
            rules.append(Rule(pat, slot, transpose))
        fam = family.lower()
        for key in (fam, fam.split(".")[-1]):
            if key in FAMILY_RULES:
                rules.extend(FAMILY_RULES[key])
                break
        else:
            rules.extend(LLAMA_RULES)
        rules.extend(GGUF_RULES)  # llama.cpp names match no HF pattern
        self.prefix = tensor_name_prefix
        self._rules = [(r.compiled(), r) for r in rules]

    def map_name(self, name: str) -> Optional[Tuple[tuple, bool]]:
        """Returns (slot_path, transpose) or None if unmapped."""
        if self.prefix and name.startswith(self.prefix):
            name = name[len(self.prefix):]
        for creg, rule in self._rules:
            m = creg.match(name)
            if not m:
                continue
            gd = m.groupdict()
            slot = rule.slot
            if "{i}" in slot:
                slot = slot.replace("{i}", gd.get("i", "0") or "0")
            if "{j}" in slot:
                slot = slot.replace("{j}", gd.get("j", "0") or "0")
            path = tuple(int(p) if p.isdigit() else p
                         for p in slot.split("."))
            return path, rule.transpose
        return None
