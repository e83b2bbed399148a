"""GPT-2 byte-level BPE tokenizer, implemented from scratch (no torch/HF at
runtime). The reference uses ``GPT2TokenizerFast`` (text_decoder.py:27-30,
pad = eos); this module reproduces that behavior when ``vocab.json`` +
``merges.txt`` are available locally, and otherwise degrades to a
deterministic byte-level fallback — the same spirit as the reference's
``MinimalTokenizer`` test fallback (src/test_loader.py:27-43), so the full
pipeline stays runnable in hermetic environments.

Search order for vocab files: $VIDEO_CAPTION_TOKENIZER_DIR, ./tokenizer,
./checkpoints/tokenizer, the HF hub cache.
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import regex as re

GPT2_EOS_ID = 50256
_SPLIT_PATTERN = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode map."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class GPT2Tokenizer:
    """Byte-level BPE with merges, matching GPT-2 encoding exactly."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}
        self.eos_token_id = vocab.get("<|endoftext|>", GPT2_EOS_ID)
        self.bos_token_id = self.eos_token_id
        self.pad_token_id = self.eos_token_id  # pad = eos (text_decoder.py:29-30)
        self.vocab_size = max(len(vocab), self.eos_token_id + 1)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: List[str] = list(token)
        if not word:
            return []
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in _SPLIT_PATTERN.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.encoder[piece])
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        pieces = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i == self.eos_token_id:
                continue
            piece = self.decoder.get(i)
            if piece is not None:
                pieces.append(piece)
        text = "".join(pieces)
        data = bytes(self.byte_decoder.get(ch, ord("?") & 0xFF) for ch in text)
        return data.decode("utf-8", errors="replace")


class ByteTokenizer:
    """Deterministic byte-level fallback when GPT-2 vocab files are absent.

    Ids 0..255 are raw bytes; eos/bos/pad use the GPT-2 eos id so decode
    buffers and model vocab shapes match the real tokenizer.
    """

    eos_token_id = GPT2_EOS_ID
    bos_token_id = GPT2_EOS_ID
    pad_token_id = GPT2_EOS_ID
    vocab_size = GPT2_EOS_ID + 1

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(int(i) for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")


def _candidate_dirs() -> List[Path]:
    dirs = []
    env = os.environ.get("VIDEO_CAPTION_TOKENIZER_DIR")
    if env:
        dirs.append(Path(env))
    dirs += [Path("tokenizer"), Path("checkpoints/tokenizer")]
    hub = Path.home() / ".cache/huggingface/hub"
    if hub.is_dir():
        for snap in hub.glob("models--*gpt2*/snapshots/*"):
            dirs.append(snap)
    return dirs


def _load_vocab_files() -> Optional[Tuple[Dict[str, int], List[Tuple[str, str]]]]:
    for d in _candidate_dirs():
        vocab_path, merges_path = d / "vocab.json", d / "merges.txt"
        if vocab_path.is_file() and merges_path.is_file():
            vocab = json.loads(vocab_path.read_text(encoding="utf-8"))
            merges = []
            for line in merges_path.read_text(encoding="utf-8").splitlines():
                if line.startswith("#version") or not line.strip():
                    continue
                a, b = line.split()
                merges.append((a, b))
            return vocab, merges
    return None


_TOKENIZER = None


def get_tokenizer():
    """Singleton: real GPT-2 BPE when vocab files exist, byte fallback otherwise."""
    global _TOKENIZER
    if _TOKENIZER is None:
        loaded = _load_vocab_files()
        _TOKENIZER = GPT2Tokenizer(*loaded) if loaded else ByteTokenizer()
    return _TOKENIZER
