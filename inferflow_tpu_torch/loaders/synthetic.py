"""Synthetic checkpoints on disk, for tests and the card smoke run.

The repository's model dirs hold a ``model_spec.json`` only (no weights,
no ``config.json``, no tokenizer), so whatever loads a model from disk is
exercised on files written here:

  - ``write_llama_checkpoint``: random llama-family weights under the
    Hugging Face names (``model.layers.N.self_attn.q_proj.weight``, ...,
    each (out, in)), in bf16, drawn from a seeded torch generator on any
    device and written tensor by tensor as
    safetensors shards of at most ``shard_bytes``, with a
    ``model.safetensors.index.json`` beside them, and the ``config.json``
    of the hyperparameters given;
  - ``write_tokenizer_json``: a byte-level BPE ``tokenizer.json`` in the
    layout of Llama-2's (``<unk>``, ``<s>``, ``</s>``, the 256 byte
    fallback tokens ``<0x00>``..``<0xFF>``, then merged tokens in merge
    order) with exactly ``vocab_size`` entries, its merges drawn from a
    seeded numpy generator.

Weights: the distribution of models/zoo.make_synthetic_params, so that a
model loaded from these files serves logits of the magnitude (about 2.5)
the engines' comparisons are gated for: normal with std 0.5/sqrt(in) for
the projections and the lm_head, 0.02 for the embeddings, ones for the
norms.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .safetensors import save_safetensors

_ALPHABET = "abcdefghijklmnopqrstuvwxyz ,.'ETAONISRH"


def llama_tensor_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(HF name, (out, in) shape, kind) of a llama checkpoint, in file
    order; kind is "proj", "embed" or "norm"."""
    e = cfg["hidden_size"]
    f = cfg["intermediate_size"]
    v = cfg["vocab_size"]
    heads = cfg["num_attention_heads"]
    kv = cfg.get("num_key_value_heads", heads)
    d = e // heads
    out = [("model.embed_tokens.weight", (v, e), "embed")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        out += [(f"{p}.input_layernorm.weight", (e,), "norm"),
                (f"{p}.self_attn.q_proj.weight", (heads * d, e), "proj"),
                (f"{p}.self_attn.k_proj.weight", (kv * d, e), "proj"),
                (f"{p}.self_attn.v_proj.weight", (kv * d, e), "proj"),
                (f"{p}.self_attn.o_proj.weight", (e, heads * d), "proj"),
                (f"{p}.post_attention_layernorm.weight", (e,), "norm"),
                (f"{p}.mlp.gate_proj.weight", (f, e), "proj"),
                (f"{p}.mlp.up_proj.weight", (f, e), "proj"),
                (f"{p}.mlp.down_proj.weight", (e, f), "proj")]
    out.append(("model.norm.weight", (e,), "norm"))
    if not cfg.get("tie_word_embeddings", False):
        out.append(("lm_head.weight", (v, e), "proj"))
    return out


def write_llama_checkpoint(model_dir: str, cfg: dict, seed: int = 0,
                           shard_bytes: int = 2 * 1024 ** 3,
                           device="cuda") -> dict:
    """Write config.json, the safetensors shards and their index into
    model_dir.  Tensors are drawn on `device` one at a time, so only one
    float32 tensor exists there at once and only one shard in host memory.
    Returns {"files", "bytes", "seconds"}."""
    dev = resolve_device(device)
    os.makedirs(model_dir, exist_ok=True)
    t0 = time.perf_counter()
    dtype, itemsize = torch.bfloat16, 2
    shapes = llama_tensor_shapes(cfg)
    # the shard plan: consecutive tensors up to shard_bytes
    plan: List[List[Tuple[str, tuple, str]]] = [[]]
    size = 0
    for item in shapes:
        nbytes = int(np.prod(item[1])) * itemsize
        if plan[-1] and size + nbytes > shard_bytes:
            plan.append([])
            size = 0
        plan[-1].append(item)
        size += nbytes
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    weight_map: Dict[str, str] = {}
    total = 0
    files = []
    for s, items in enumerate(plan):
        fname = f"model-{s + 1:05d}-of-{len(plan):05d}.safetensors"
        tensors = {}
        for name, shape, kind in items:
            if kind == "norm":
                t = torch.ones(shape, dtype=dtype)
            else:
                std = 0.02 if kind == "embed" else 0.5 / shape[1] ** 0.5
                t = (torch.randn(shape, generator=gen, device=dev,
                                 dtype=torch.float32) * std).to(dtype).cpu()
            tensors[name] = t
            weight_map[name] = fname
            total += t.numel() * itemsize
        save_safetensors(os.path.join(model_dir, fname), tensors,
                         {"format": "pt"})
        files.append(fname)
        del tensors
    with open(os.path.join(model_dir, "model.safetensors.index.json"),
              "w") as fh:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, fh, indent=1)
    with open(os.path.join(model_dir, "config.json"), "w") as fh:
        json.dump(cfg, fh, indent=1)
    return {"files": files, "bytes": total,
            "seconds": time.perf_counter() - t0}


def llama_config(hidden_size: int, intermediate_size: int, layers: int,
                 heads: int, kv_heads: int, vocab_size: int,
                 context: int = 4096, eps: float = 1e-5) -> dict:
    """A config.json for LlamaForCausalLM with these hyperparameters."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "hidden_size": hidden_size,
            "intermediate_size": intermediate_size,
            "num_hidden_layers": layers, "num_attention_heads": heads,
            "num_key_value_heads": kv_heads, "vocab_size": vocab_size,
            "rms_norm_eps": eps, "max_position_embeddings": context,
            "hidden_act": "silu", "rope_theta": 10000.0,
            "tie_word_embeddings": False, "torch_dtype": "bfloat16",
            "bos_token_id": 1, "eos_token_id": 2}


def write_tokenizer_json(path: str, vocab_size: int, seed: int = 0) -> None:
    """A byte-level BPE tokenizer.json of exactly vocab_size entries (at
    least 3 + 256 + the alphabet).  Merged tokens join a token to one
    character of the alphabet, so text over the alphabet tokenizes into
    multi-character tokens; every other byte takes its fallback token."""
    specials = ["<unk>", "<s>", "</s>"]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    chars = list(dict.fromkeys(_ALPHABET))
    for ch in chars:
        vocab.setdefault(ch, len(vocab))
    if vocab_size < len(vocab):
        raise ValueError(f"vocab_size {vocab_size} < {len(vocab)}")
    rng = np.random.default_rng(seed)
    merges: List[List[str]] = []
    pieces = list(chars)
    while len(vocab) < vocab_size:
        # grow a recent token by one character: short tokens first
        left = pieces[int(rng.integers(max(0, len(pieces) - 4096),
                                       len(pieces)))] \
            if rng.random() < 0.7 else chars[int(rng.integers(len(chars)))]
        right = chars[int(rng.integers(len(chars)))]
        new = left + right
        if new in vocab or len(new) > 12:
            continue
        vocab[new] = len(vocab)
        merges.append([left, right])
        pieces.append(new)
    data = {"version": "1.0",
            "added_tokens": [{"id": i, "content": t, "special": True}
                             for i, t in enumerate(specials)],
            "model": {"type": "BPE", "byte_fallback": True, "vocab": vocab,
                      "merges": merges}}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, ensure_ascii=False)


def sample_text(n_words: int, seed: int = 0) -> str:
    """Words over the tokenizer's alphabet, for prompts made from text."""
    rng = np.random.default_rng(seed)
    letters = "etaoinshrdlucmfwypvbgkjqxz"
    p = np.linspace(2.0, 0.2, len(letters))
    p /= p.sum()
    words = ["".join(rng.choice(list(letters), size=int(rng.integers(1, 9)),
                                p=p)) for _ in range(n_words)]
    return " ".join(words)
