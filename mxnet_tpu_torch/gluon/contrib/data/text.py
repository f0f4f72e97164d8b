"""Text datasets (counterpart of ``mxnet_tpu/gluon/contrib/data/text.py``;
reference ``python/mxnet/gluon/contrib/data/text.py``): WikiText2 and
WikiText103 read local files only, and nothing is downloaded.

``WikiText2``-style corpora are token streams chopped into fixed-length
(sequence, target) pairs for language modelling.
"""
from __future__ import annotations

import io
import os

import numpy as onp

from ....base import MXNetError
from ...data.dataset import Dataset
from ....contrib.text.vocab import Vocabulary

__all__ = ["LanguageModelDataset", "WikiText2", "WikiText103"]


class LanguageModelDataset(Dataset):
    """Fixed-length LM samples over a token file.

    Each item is (data, label): ``seq_len`` token indices and the same
    window shifted by one (reference _LanguageModelDataset semantics).
    """

    def __init__(self, file_path, seq_len=35, vocab=None, eos="<eos>",
                 encoding="utf8"):
        if not os.path.isfile(file_path):
            raise MXNetError(
                "corpus file %r not found; nothing is downloaded: place "
                "the tokens file there" % file_path)
        with io.open(file_path, "r", encoding=encoding) as f:
            raw = f.read()
        tokens = []
        for line in raw.split("\n"):
            line = line.strip()
            if line:
                tokens.extend(line.split())
                tokens.append(eos)
        if vocab is None:
            from collections import Counter
            vocab = Vocabulary(Counter(tokens))
        self.vocabulary = vocab
        idx = onp.asarray(vocab.to_indices(tokens), onp.int64)
        n = (len(idx) - 1) // seq_len
        self._data = idx[:n * seq_len].reshape(n, seq_len)
        self._label = idx[1:n * seq_len + 1].reshape(n, seq_len)
        self._seq_len = seq_len

    def __len__(self):
        return self._data.shape[0]

    def __getitem__(self, i):
        return (self._data[i].astype("float32"),
                self._label[i].astype("float32"))


class WikiText2(LanguageModelDataset):
    """WikiText-2 from a local extracted file (reference WikiText2;
    expects e.g. ``root/wiki.train.tokens``)."""

    def __init__(self, root=".", segment="train", seq_len=35, vocab=None):
        super().__init__(os.path.join(root, "wiki.%s.tokens" % segment),
                         seq_len=seq_len, vocab=vocab)


class WikiText103(LanguageModelDataset):
    """WikiText-103 from a local extracted file (reference WikiText103)."""

    def __init__(self, root=".", segment="train", seq_len=35, vocab=None):
        super().__init__(os.path.join(root, "wiki.%s.tokens" % segment),
                         seq_len=seq_len, vocab=vocab)
