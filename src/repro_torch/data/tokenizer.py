"""Byte-level tokenizer (the port's copy of ``repro.data.tokenizer``;
self-contained, no external vocab files).

Vocabulary: 256 byte values + special tokens. Used by the ByteCorpus
pipeline and the serving examples; models with larger vocabularies
train on the synthetic stream or external pre-tokenized data.
"""
from __future__ import annotations

PAD, BOS, EOS = 256, 257, 258
VOCAB_SIZE = 259


def encode(text: str, add_bos: bool = True, add_eos: bool = False
           ) -> list[int]:
    ids = list(text.encode("utf-8"))
    if add_bos:
        ids = [BOS] + ids
    if add_eos:
        ids = ids + [EOS]
    return ids


def decode(ids, strip_special: bool = True) -> str:
    bs = bytes(i for i in ids if i < 256 or not strip_special)
    return bs.decode("utf-8", errors="replace")
