"""Tokenizer/vocabulary loading from checkpoint files.

A copy of inferflow_tpu/tokenizer/loading.py (no JAX in it), kept so that
this package imports nothing of the JAX one.

reference: ModelReader::LoadTokenizer (src/transformer/
model_reader.cc:745-1464): HF tokenizer.json (vocab + merges + added
tokens), vocab.json + merges.txt pairs, plain-text vocab, llama2.c
tokenizer.bin (see loaders/llama2c.py), GGUF metadata vocab, byte-level
('token_bytes_mapping') GPT-2 unicode remapping, and special-token wiring.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from .vocab import Vocabulary
from .tokenizer import Tokenizer


def _gpt2_byte_decoder() -> Dict[str, int]:
    """The GPT-2 byte<->unicode bijection (token_bytes_mapping=1;
    model_reader.cc byte mapping path)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


_BYTE_DECODER = None


def token_text_to_bytes(text: str, bytes_mapping: int = 0) -> bytes:
    """Token surface -> raw bytes, honoring the byte-level mapping mode."""
    global _BYTE_DECODER
    if bytes_mapping == 1:
        if _BYTE_DECODER is None:
            _BYTE_DECODER = _gpt2_byte_decoder()
        dec = _BYTE_DECODER
        try:
            return bytes(dec[ch] for ch in text)
        except KeyError:
            return text.encode("utf-8")
    return text.encode("utf-8")


def load_token_remap(path: str) -> Dict[int, int]:
    """Token id remap table (reference LoadTokenRemapData,
    model_reader.cc:1420): JSON object {"old": new, ...}, JSON array
    [new0, new1, ...], or two-column text lines `old new`."""
    with open(path, "rb") as fh:
        head = fh.read(1)
        fh.seek(0)
        text = fh.read().decode("utf-8", "replace")
    if head in (b"{", b"["):
        data = json.loads(text)
        if isinstance(data, list):
            return {i: int(v) for i, v in enumerate(data)}
        return {int(k): int(v) for k, v in data.items()}
    remap = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) >= 2:
            remap[int(parts[0])] = int(parts[1])
    return remap


def load_tokenizer_json(path: str, bytes_mapping: int = 0,
                        token_remap: Optional[Dict[int, int]] = None
                        ) -> Vocabulary:
    """HF tokenizer.json: model.vocab (token -> id), model.merges,
    added_tokens.  token_remap redirects vocab ids at load
    (model_reader.cc LoadVocabJson token_map)."""
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    v = Vocabulary()
    model = data.get("model", {})
    vocab: Dict[str, int] = model.get("vocab", {})
    items = sorted(vocab.items(), key=lambda kv: kv[1])
    if token_remap:
        items = [(text, token_remap.get(tid, tid)) for text, tid in items]
    size = (max(t for _, t in items) + 1) if items else 0
    toks: List[Optional[bytes]] = [None] * size
    for text, tid in items:
        toks[tid] = token_text_to_bytes(text, bytes_mapping)
    for entry in data.get("added_tokens", []):
        tid = int(entry["id"])
        if tid >= len(toks):
            toks.extend([None] * (tid + 1 - len(toks)))
        toks[tid] = entry["content"].encode("utf-8")
        ttype = 2 if entry.get("special") else 0
    for tid, s in enumerate(toks):
        v.add(s if s is not None else f"<unused_{tid}>".encode(), 0.0, 0)
    merges = model.get("merges", [])
    for rank, m in enumerate(merges):
        if isinstance(m, str):
            left, _, right = m.partition(" ")
        else:
            left, right = m[0], m[1]
        v.merge_map[(token_text_to_bytes(left, bytes_mapping),
                     token_text_to_bytes(right, bytes_mapping))] = rank
    _wire_specials(v, data.get("added_tokens", []))
    v.find_byte_token_start()
    return v


def _wire_specials(v: Vocabulary, added_tokens: list) -> None:
    for entry in added_tokens:
        content = entry.get("content", "")
        tid = int(entry.get("id", -1))
        low = content.lower()
        if low in ("<s>", "<|startoftext|>", "[cls]", "<bos>"):
            v.bos_id = tid
        elif low in ("</s>", "<|endoftext|>", "[sep]", "<eos>",
                     "<|im_end|>", "<|eot_id|>"):
            if v.eos_id in (2, -1) or low == "</s>":
                v.eos_id = tid
            v.eos_set.add(tid)
        elif low in ("<unk>", "[unk]"):
            v.unk_id = tid
        elif low in ("<pad>", "[pad]"):
            v.pad_id = tid
        elif low == "[mask]":
            v.mask_id = tid


def load_vocab_json(vocab_path: str, merges_path: str = "",
                    bytes_mapping: int = 0) -> Vocabulary:
    """vocab.json (+ merges.txt) pair (GPT-2/OPT style checkpoints)."""
    with open(vocab_path, encoding="utf-8") as fh:
        vocab = json.load(fh)
    v = Vocabulary()
    items = sorted(vocab.items(), key=lambda kv: kv[1])
    for text, tid in items:
        while len(v.tokens) < tid:
            v.add(f"<unused_{len(v.tokens)}>".encode())
        v.add(token_text_to_bytes(text, bytes_mapping))
    if merges_path and os.path.isfile(merges_path):
        with open(merges_path, encoding="utf-8") as fh:
            rank = 0
            for line in fh:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                left, _, right = line.partition(" ")
                v.merge_map[(token_text_to_bytes(left, bytes_mapping),
                             token_text_to_bytes(right, bytes_mapping))] = rank
                rank += 1
    v.find_byte_token_start()
    return v


def load_gguf_vocab(gguf_vocab: dict) -> Vocabulary:
    """Vocabulary from GGUFFile.vocab() metadata."""
    v = Vocabulary()
    scores = gguf_vocab.get("scores") or []
    types = gguf_vocab.get("token_type") or []
    for i, text in enumerate(gguf_vocab.get("tokens", [])):
        score = float(scores[i]) if i < len(scores) else 0.0
        ttype = int(types[i]) if i < len(types) else 0
        # ggml token types: 1=normal 2=unknown 3=control 6=byte
        v.add(text.encode("utf-8"), score,
              {1: 0, 2: 1, 3: 2, 6: 3}.get(ttype, 0))
    for fld, key in (("bos_id", "bos_id"), ("eos_id", "eos_id"),
                     ("unk_id", "unk_id"), ("pad_id", "pad_id")):
        val = int(gguf_vocab.get(key, -1))
        if val >= 0:
            setattr(v, fld, val)
    for rank, m in enumerate(gguf_vocab.get("merges", [])):
        left, _, right = m.partition(" ")
        v.merge_map[(left.encode(), right.encode())] = rank
    v.find_byte_token_start()
    return v


def load_tokenizer(spec, model_dir: str = "") -> Optional[Tokenizer]:
    """Pick and load the tokenizer per ModelSpec (model_reader.cc:745)."""
    model_dir = model_dir or spec.dir
    remap = None
    if spec.token_remap_file:
        rpath = os.path.join(model_dir, spec.token_remap_file) \
            if model_dir else spec.token_remap_file
        if os.path.isfile(rpath):
            remap = load_token_remap(rpath)
    for fname in spec.tokenizer_files:
        path = os.path.join(model_dir, fname) if model_dir else fname
        if not os.path.isfile(path):
            continue
        if fname.endswith("tokenizer.json"):
            v = load_tokenizer_json(path, spec.token_bytes_mapping, remap)
        elif fname.endswith("vocab.json"):
            merges = os.path.join(model_dir, "merges.txt")
            v = load_vocab_json(path, merges, spec.token_bytes_mapping)
        elif fname.endswith(".bin"):
            from ..loaders.llama2c import load_llama2c_tokenizer
            v = load_llama2c_tokenizer(path, spec.hyper_params.vocab_size)
        else:
            continue
        _apply_spec_specials(v, spec)
        return Tokenizer(v, spec.tokenization_algorithm)
    # GGUF checkpoints embed the vocab
    if spec.model_file_format == "gguf" and spec.model_files:
        from ..loaders.gguf import GGUFFile
        path = os.path.join(model_dir, spec.model_files[0]) if model_dir \
            else spec.model_files[0]
        if os.path.isfile(path):
            gf = GGUFFile(path)
            try:
                v = load_gguf_vocab(gf.vocab())
            finally:
                gf.close()
            _apply_spec_specials(v, spec)
            return Tokenizer(v, spec.tokenization_algorithm)
    return None


def _apply_spec_specials(v: Vocabulary, spec) -> None:
    for attr, field in (("bos_id", "bos_token"), ("eos_id", "eos_token"),
                        ("unk_id", "unk_token"), ("pad_id", "pad_token"),
                        ("mask_id", "mask_token")):
        tok = getattr(spec, field, "")
        if tok:
            tid = v.str_to_id.get(tok.encode("utf-8"))
            if tid is not None:
                setattr(v, attr, tid)
                if attr == "eos_id":
                    v.eos_set.add(tid)


def tokenize_with_escapes(tokenizer, text: str, add_bos: bool = False):
    """Tokenize template-expanded text honoring `{#123}` token-id escapes
    (reference BuildEncoderInput/BuildDecoderInput `{#id}` keys,
    inference_engine.cc:456-709): text segments are tokenized normally,
    escape segments splice the literal token id."""
    import re as _re
    out = []
    if add_bos and tokenizer.vocab.bos_id >= 0:
        out.append(tokenizer.vocab.bos_id)
    pos = 0
    for m in _re.finditer(r"\{#(\d+)\}", text):
        if m.start() > pos:
            out.extend(tokenizer.tokenize(text[pos:m.start()]))
        out.append(int(m.group(1)))
        pos = m.end()
    if pos < len(text):
        out.extend(tokenizer.tokenize(text[pos:]))
    return out
