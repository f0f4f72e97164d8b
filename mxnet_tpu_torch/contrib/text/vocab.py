"""Token vocabulary: a copy of ``mxnet_tpu/contrib/text/vocab.py``, which
imports no JAX (reference ``python/mxnet/contrib/text/vocab.py``)."""
from __future__ import annotations

from collections import Counter

__all__ = ["Vocabulary"]


class Vocabulary:
    """Frequency-indexed token vocabulary with an unknown token and
    optional reserved tokens (reference vocab.py:30).

    Index 0 is the unknown token; reserved tokens follow; counter keys are
    indexed by descending frequency (ties broken lexically) subject to
    ``most_freq_count`` / ``min_freq``.
    """

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("min_freq must be at least 1")
        if reserved_tokens is not None:
            seen = set(reserved_tokens)
            if unknown_token in seen or len(seen) != len(reserved_tokens):
                raise ValueError("reserved tokens must be unique and must "
                                 "not include the unknown token")
        self._unknown_token = unknown_token
        self._reserved_tokens = list(reserved_tokens) if reserved_tokens \
            else None
        self._idx_to_token = [unknown_token] + (self._reserved_tokens or [])
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        if counter is not None:
            self._index_counter(counter, most_freq_count, min_freq)

    def _index_counter(self, counter, most_freq_count, min_freq):
        if not isinstance(counter, Counter):
            counter = Counter(dict(counter))
        budget = most_freq_count if most_freq_count is not None else \
            len(counter)
        ranked = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
        for token, freq in ranked:
            if freq < min_freq or budget <= 0:
                break
            if token in self._token_to_idx:
                continue
            self._token_to_idx[token] = len(self._idx_to_token)
            self._idx_to_token.append(token)
            budget -= 1

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """Token(s) → index/indices; unknown tokens map to index 0
        (reference vocab.py to_indices)."""
        single = not isinstance(tokens, list)
        toks = [tokens] if single else tokens
        idx = [self._token_to_idx.get(t, 0) for t in toks]
        return idx[0] if single else idx

    def to_tokens(self, indices):
        """Index/indices → token(s) (reference vocab.py to_tokens)."""
        single = not isinstance(indices, list)
        idxs = [indices] if single else indices
        toks = []
        for i in idxs:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError("token index %d out of range [0, %d)"
                                 % (i, len(self._idx_to_token)))
            toks.append(self._idx_to_token[i])
        return toks[0] if single else toks
