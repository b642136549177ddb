"""llama2.c checkpoint loader (reference: ModelReader::LoadModel_Llama2DotC,
src/transformer/model_reader.cc:3248-3430; format per karpathy/llama2.c).

A copy of inferflow_tpu/loaders/llama2c.py (no JAX in it), kept so that
this package imports nothing of the JAX one.

v0: 7 int32 header {dim, hidden_dim, n_layers, n_heads, n_kv_heads,
vocab_size (negative => untied classifier), seq_len} then fp32 tensors:
tok_embeddings, [rms_att per layer], [wq], [wk], [wv], [wo], [rms_ffn],
[w1], [w2], [w3], rms_final, freq_cis_real, freq_cis_imag, (wcls).
v1: magic 0x616b3432 'ak42', version, header, shared_classifier u8,
256-byte header pad.

Weights on disk are (out_features, in_features) row-major; we store the
TPU convention (K=in, N=out), i.e. transposed.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from ..models.spec import HyperParams, ModelSpec
from ..tokenizer.vocab import Vocabulary

MAGIC_AK42 = 0x616B3432


def load_llama2c_checkpoint(path: str) -> Tuple[ModelSpec, dict]:
    """Returns (spec, raw numpy params tree matching models/decoder.py)."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    (magic,) = struct.unpack_from("<I", data, 0)
    version = 0
    if magic == MAGIC_AK42:
        (version,) = struct.unpack_from("<I", data, 4)
        if version != 1:
            raise ValueError(f"unsupported llama2.c version {version}")
        off = 8

    dim, hidden, layers, heads, kv_heads, vocab, seq_len = struct.unpack_from(
        "<7i", data, off)
    off += 28
    shared_classifier = vocab >= 0
    vocab = abs(vocab)
    if version == 1:
        shared_classifier = data[off] != 0
        off = 256

    hp = HyperParams(vocab_size=vocab, embd_dims=dim, decoder_layers=layers,
                     decoder_heads=heads, decoder_kv_heads=kv_heads,
                     hidden_dim=dim, decoder_intermediate_size=hidden,
                     training_context_len=seq_len)
    spec = ModelSpec(sid="llama2.c", hyper_params=hp,
                     network_structure="transformer.llama",
                     norm_alg="rms", activation_fn="silu",
                     pos_embedding_alg="rope", qk_column_order=0,
                     tokenization_algorithm="bpe",
                     model_file_format="llama2.c", max_context_len=seq_len)

    head_dim = dim // heads
    kv_dim = kv_heads * head_dim

    def tensor(rows, cols=0):
        nonlocal off
        n = rows * cols if cols else rows
        a = np.frombuffer(data, dtype="<f4", count=n, offset=off)
        off += n * 4
        return a.reshape(rows, cols) if cols else a

    emb = tensor(vocab, dim)
    att_norm = [tensor(dim) for _ in range(layers)]
    wq = [tensor(heads * head_dim, dim) for _ in range(layers)]
    wk = [tensor(kv_dim, dim) for _ in range(layers)]
    wv = [tensor(kv_dim, dim) for _ in range(layers)]
    wo = [tensor(dim, heads * head_dim) for _ in range(layers)]
    ffn_norm = [tensor(dim) for _ in range(layers)]
    w1 = [tensor(hidden, dim) for _ in range(layers)]
    w2 = [tensor(dim, hidden) for _ in range(layers)]
    w3 = [tensor(hidden, dim) for _ in range(layers)]
    out_norm = tensor(dim)
    off += seq_len * head_dim * 4  # skip freq_cis_real + freq_cis_imag
    wcls = emb if shared_classifier else tensor(vocab, dim)

    params = {
        "dec_embeddings": emb,
        "dec_output_norm": out_norm,
        "lm_head": wcls.T.copy(),
        "layers": [
            {
                "attn": {"pre_norm": att_norm[i],
                         "wq": wq[i].T.copy(), "wk": wk[i].T.copy(),
                         "wv": wv[i].T.copy(), "wo": wo[i].T.copy()},
                "ffn": {"pre_norm": ffn_norm[i],
                        "w1": w1[i].T.copy(), "w2": w2[i].T.copy(),
                        "w3": w3[i].T.copy()},
            }
            for i in range(layers)
        ],
    }
    return spec, params


def load_llama2c_tokenizer(path: str, vocab_size: int) -> Vocabulary:
    """tokenizer.bin: u32 max_token_len then per token {f32 score, u32 len,
    bytes} (reference ReadVocabulary_Format2, model_reader.cc:1362-1417)."""
    v = Vocabulary()
    with open(path, "rb") as f:
        data = f.read()
    off = 4  # skip max_token_len
    for tid in range(vocab_size):
        (score,) = struct.unpack_from("<f", data, off)
        off += 4
        (ln,) = struct.unpack_from("<I", data, off)
        off += 4
        s = data[off:off + ln]
        off += ln
        ttype = 1 if s == b"\xEF\xBF\xBD" else 0
        v.add(s, score, ttype)
    v.unk_id, v.bos_id, v.eos_id = 0, 1, 2
    v.find_byte_token_start()
    return v
