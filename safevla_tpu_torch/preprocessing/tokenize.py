"""Instruction tokenisation (host side, once per episode).

Copy of `safevla_tpu/preprocessing/tokenize.py` (pure numpy; the port keeps
its own copy instead of importing the JAX package). The instruction is
tokenised once per episode to a fixed length. When the HuggingFace T5
tokenizer's files are available locally it is used; otherwise a
deterministic hash tokenizer stands in (the same one as the JAX package's,
so both packages give the same tokens).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class _HashTokenizer:
    """Deterministic fallback: word -> stable hash bucket. EOS=1, PAD=0
    (T5 conventions)."""

    eos_token_id = 1
    pad_token_id = 0

    def __init__(self, vocab_size: int = 32128):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        import hashlib

        ids = []
        for word in text.lower().split():
            h = int(hashlib.md5(word.encode()).hexdigest(), 16)
            # avoid the special ids 0..2
            ids.append(3 + (h % (self.vocab_size - 3)))
        return ids + [self.eos_token_id]


_warned_fallback = False


class InstructionTokenizer:
    def __init__(
        self,
        backbone: str = "t5-small",
        max_tokens: int = 32,
        require_exact: bool = False,
    ):
        """require_exact: parity-sensitive callers (benchmark eval, golden
        recording) set this so the hash fallback is a hard error instead of a
        silent degradation — hash tokens can never be bit-comparable to the
        reference's HF T5 tokenization."""
        self.max_tokens = max_tokens
        self._tok = None
        try:  # pragma: no cover - depends on local HF cache
            from transformers import AutoTokenizer

            self._tok = AutoTokenizer.from_pretrained(backbone, local_files_only=True)
        except Exception:
            self._tok = None
        self._fallback = _HashTokenizer()
        self.using_fallback = self._tok is None
        if self.using_fallback:
            if require_exact:
                raise RuntimeError(
                    f"The {backbone} tokenizer files are not available locally "
                    "and this code path requires exact (reference-comparable) "
                    "tokenization. Fetch the tokenizer (e.g. "
                    "scripts/download_assets.py) or drop require_exact."
                )
            global _warned_fallback
            if not _warned_fallback:  # once per process, loudly
                import warnings

                warnings.warn(
                    f"{backbone} tokenizer files not found locally — using the "
                    "deterministic HASH tokenizer. Model outputs will NOT be "
                    "comparable to the reference (fine for tests/benches).",
                    RuntimeWarning,
                    stacklevel=2,
                )
                _warned_fallback = True

    def encode_batch(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """-> (tokens (B, L) int32, mask (B, L) bool), fixed L=max_tokens."""
        b = len(texts)
        tokens = np.zeros((b, self.max_tokens), np.int32)
        mask = np.zeros((b, self.max_tokens), bool)
        for i, text in enumerate(texts):
            if self._tok is not None:
                ids = self._tok.encode(text)
            else:
                ids = self._fallback.encode(text)
            ids = ids[: self.max_tokens]
            tokens[i, : len(ids)] = ids
            mask[i, : len(ids)] = True
        return tokens, mask
