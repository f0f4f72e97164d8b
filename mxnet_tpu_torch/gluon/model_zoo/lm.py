"""LSTM language models.

The JAX package builds these outside its model zoo, so this module is the
port's copy of both:

* :class:`LSTMLM`, ``bench.py:bench_lstm_lm``'s model (``BASELINE.json``
  config 4 at its defaults): ``Embedding(vocab, hidden)``, ``rnn.LSTM
  (hidden, num_layers, layout="NTC")`` and ``Dense(vocab,
  flatten=False)``, trained with ``SoftmaxCrossEntropyLoss``;
* :class:`RNNModel` and :class:`SeqCELoss`,
  ``example/rnn/word_lm/train.py``'s model (embedding, dropout, an LSTM
  stack with inter-layer dropout, dropout, and a vocabulary head whose
  weight may be the embedding's) and its loss over every position.
"""
from __future__ import annotations

from ..block import HybridBlock
from ..loss import Loss, SoftmaxCrossEntropyLoss
from ..nn import Dense, Dropout, Embedding
from ..rnn import LSTM

__all__ = ["LSTMLM", "RNNModel", "SeqCELoss"]


class LSTMLM(HybridBlock):
    """Embedding, a ``layers``-deep NTC LSTM and a per-position vocabulary
    head: (N, T) token ids in, (N, T, vocab) logits out."""

    def __init__(self, vocab=10000, hidden=650, layers=2, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.embed = Embedding(vocab, hidden)
            self.lstm = LSTM(hidden, num_layers=layers, layout="NTC")
            self.fc = Dense(vocab, flatten=False)

    def hybrid_forward(self, F, x):
        return self.fc(self.lstm(self.embed(x)))


class RNNModel(HybridBlock):
    """The word-level LM: embedding, dropout, LSTM stack, dropout and a
    vocabulary head, tied to the embedding's weight when ``tied``."""

    def __init__(self, vocab_size, embed_size, hidden_size, num_layers,
                 dropout=0.2, tied=False, **kwargs):
        super().__init__(**kwargs)
        self._tied = tied
        with self.name_scope():
            self.drop = Dropout(dropout) if dropout else None
            self.embed = Embedding(vocab_size, embed_size, prefix="embed_")
            self.lstm = LSTM(hidden_size, num_layers=num_layers,
                             layout="NTC", dropout=dropout, prefix="lstm_")
            if tied:
                if embed_size != hidden_size:
                    raise ValueError("weight tying needs "
                                     "embed_size == hidden_size")
                self.head = Dense(vocab_size, flatten=False,
                                  params=self.embed.params, prefix="embed_")
            else:
                self.head = Dense(vocab_size, flatten=False, prefix="head_")

    def hybrid_forward(self, F, x):
        e = self.embed(x)
        if self.drop is not None:
            e = self.drop(e)
        h = self.lstm(e)
        if self.drop is not None:
            h = self.drop(h)
        return self.head(h)


class SeqCELoss(Loss):
    """Softmax cross entropy of every position: (N, T, vocab) logits and
    (N, T) labels in, N * T losses out."""

    def __init__(self, vocab_size):
        super().__init__(weight=None, batch_axis=0)
        self._vocab = vocab_size
        self._ce = SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, logits, lab):
        return self._ce(logits.reshape(-1, self._vocab), lab.reshape(-1))
