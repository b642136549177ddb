"""The port's tokenizer (a copy of the JAX package's, ``tokenizer/``)
against the JAX package's, loaded from files written in tmp_path: a
Llama-style ``tokenizer.json`` (byte-fallback tokens, no byte mapping), a
GPT-2 style ``tokenizer.json`` with the byte mapping on, ``vocab.json``
with ``merges.txt``, and a GGUF file's vocab.  For each, the vocabulary,
the merges and the special ids are equal, and so are the ids of a set of
strings and their decoded text (exact comparisons)."""

import json
import os

import pytest

from inferflow_tpu.models.spec import ModelSpec as JSpec
from inferflow_tpu.tokenizer import loading as jload
from inferflow_tpu_torch.loaders.synthetic import (sample_text,
                                                   write_tokenizer_json)
from inferflow_tpu_torch.models.spec import ModelSpec as TSpec
from inferflow_tpu_torch.tokenizer import loading as tload

from test_loaders import _write_gguf

TEXTS = ("hello world", "the quick brown fox, jumps. over", "a",
         "  spaces  and\ttabs\nnewlines", "ünïcödé ✓ 日本語",
         sample_text(40, seed=3))


def _gpt2_files(d):
    """A GPT-2 style byte-level vocabulary (every byte as its mapped
    character, a few merges) as tokenizer.json and as vocab.json +
    merges.txt."""
    dec = jload._gpt2_byte_decoder()
    enc = {b: ch for ch, b in dec.items()}
    vocab = {enc[b]: b for b in range(256)}
    merges = []
    for left, right in (("t", "h"), ("th", "e"), ("Ġ", "t"), ("Ġt", "he"),
                        ("o", "r"), ("Ġ", "w"), ("Ġw", "or"), ("l", "d"),
                        ("Ġwor", "ld"), ("e", "l"), ("el", "l"),
                        ("h", "ell"), ("hell", "o")):
        vocab[left + right] = len(vocab)
        merges.append(f"{left} {right}")
    eot = len(vocab)
    tok = {"model": {"type": "BPE", "vocab": vocab, "merges": merges},
           "added_tokens": [{"id": eot, "content": "<|endoftext|>",
                             "special": True}]}
    with open(os.path.join(d, "tokenizer.json"), "w") as fh:
        json.dump(tok, fh)
    with open(os.path.join(d, "vocab.json"), "w") as fh:
        json.dump(vocab, fh)
    with open(os.path.join(d, "merges.txt"), "w") as fh:
        fh.write("#version: 0.2\n" + "\n".join(merges) + "\n")


def _same_tokenizer(tj, tt):
    vj, vt = tj.vocab, tt.vocab
    assert [(t.str, t.score, t.type) for t in vt.tokens] == [
        (t.str, t.score, t.type) for t in vj.tokens]
    assert vt.merge_map == vj.merge_map
    for attr in ("unk_id", "bos_id", "eos_id", "pad_id",
                 "byte_token_id_start"):
        assert getattr(vt, attr) == getattr(vj, attr), attr
    assert vt.eos_set == vj.eos_set
    for text in TEXTS:
        for bos in (False, True):
            ids = tt.tokenize(text, add_bos=bos)
            assert ids == tj.tokenize(text, add_bos=bos), text
            assert tt.decode(ids) == tj.decode(ids)


@pytest.mark.parametrize("kind", ["llama", "gpt2", "vocab_merges", "gguf"])
def test_tokenizer_matches_jax(tmp_path, kind):
    d = str(tmp_path)
    spec = {"tokenizer_files": ["tokenizer.json"]}
    if kind == "llama":
        write_tokenizer_json(os.path.join(d, "tokenizer.json"), 1000, seed=4)
    elif kind in ("gpt2", "vocab_merges"):
        _gpt2_files(d)
        spec["token_bytes_mapping"] = 1
        if kind == "vocab_merges":
            spec["tokenizer_files"] = ["vocab.json"]
    else:
        _write_gguf(os.path.join(d, "m.gguf"), {},
                    {"general.alignment": 32, "tokenizer.ggml.model": "llama",
                     "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>", "h",
                                               "e", "l", "o", "he", "ll",
                                               "hell", "hello", " "],
                     "tokenizer.ggml.merges": ["h e", "l l", "he ll",
                                               "hell o"],
                     "tokenizer.ggml.bos_token_id": 1,
                     "tokenizer.ggml.eos_token_id": 2})
        spec = {"tokenizer_files": [], "model_file_format": "gguf",
                "model_files": ["m.gguf"]}
    tj = jload.load_tokenizer(JSpec(**spec), d)
    tt = tload.load_tokenizer(TSpec(**spec), d)
    assert tt is not None and tj is not None
    _same_tokenizer(tj, tt)
    if kind == "llama":
        assert len(tt.vocab) == 1000 and tt.vocab.byte_token_id_start == 3
        ids = tt.tokenize(TEXTS[-1])
        assert tt.decode(ids) == TEXTS[-1]
        assert len(ids) < len(TEXTS[-1])  # merged tokens are used
    if kind == "gpt2":
        assert tt.decode(tt.tokenize("hello world")) == "hello world"
