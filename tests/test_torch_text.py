"""Port parity: the text pipeline of ``mxnet_tpu_torch`` (the copies of
``contrib/text/vocab.py`` and ``utils.py``, and
``gluon/contrib/data/{text,sampler}.py``) against the JAX package's, on a
corpus the test writes: the same vocabulary, the same (data, label)
windows, the same sampler order, and a DataLoader over the dataset.
Nothing is downloaded: ``WikiText2`` reads a local file, and a missing
one raises.
"""
import collections
import os

import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu.contrib.text import utils as jutils
from mxnet_tpu.contrib.text.vocab import Vocabulary as JVocabulary
from mxnet_tpu.gluon.contrib import data as jdata
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.contrib.text import utils as tutils
from mxnet_tpu_torch.contrib.text.vocab import Vocabulary as TVocabulary
from mxnet_tpu_torch.gluon.contrib import data as tdata

SEQ = 7


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rs = onp.random.RandomState(0)
    words = ["w%d" % i for i in range(40)]
    lines = [" ".join(words[int(rs.zipf(1.5)) % 40]
                      for _ in range(rs.randint(3, 15)))
             for _ in range(60)]
    root = tmp_path_factory.mktemp("text")
    path = root / "wiki.train.tokens"
    path.write_text("\n".join(lines) + "\n\n", encoding="utf8")
    return str(root), str(path)


def test_vocabulary_and_counts_match_jax(corpus):
    text = open(corpus[1]).read()
    jc = jutils.count_tokens_from_str(text, to_lower=True)
    tc = tutils.count_tokens_from_str(text, to_lower=True)
    assert jc == tc
    for kw in ({}, {"most_freq_count": 10}, {"min_freq": 3},
               {"reserved_tokens": ["<pad>", "<bos>"]}):
        jv, tv = JVocabulary(jc, **kw), TVocabulary(tc, **kw)
        assert tv.idx_to_token == jv.idx_to_token
        assert tv.token_to_idx == jv.token_to_idx
        assert tv.to_indices(["w1", "nope", "w3"]) == \
            jv.to_indices(["w1", "nope", "w3"])
        assert tv.to_tokens([0, 1]) == jv.to_tokens([0, 1])
    with pytest.raises(ValueError):
        TVocabulary(tc).to_tokens(10 ** 6)
    with pytest.raises(ValueError):
        TVocabulary(tc, min_freq=0)


def test_language_model_dataset_matches_jax(corpus):
    root, path = corpus
    jd = jdata.LanguageModelDataset(path, seq_len=SEQ)
    td = tdata.LanguageModelDataset(path, seq_len=SEQ)
    assert len(td) == len(jd) > 10
    assert td.vocabulary.idx_to_token == jd.vocabulary.idx_to_token
    for i in range(len(td)):
        for t, j in zip(td[i], jd[i]):
            assert t.dtype == j.dtype == onp.float32
            onp.testing.assert_array_equal(t, j)
    # the label is the data shifted by one token
    onp.testing.assert_array_equal(td[0][1][:-1], td[0][0][1:])
    wt = tdata.WikiText2(root=root, segment="train", seq_len=SEQ,
                         vocab=td.vocabulary)
    onp.testing.assert_array_equal(wt[3][0], td[3][0])
    with pytest.raises(mxt.MXNetError):
        tdata.WikiText103(root=os.path.join(root, "absent"))


@pytest.mark.parametrize("rollover", [True, False])
def test_interval_sampler_matches_jax(rollover):
    for length, interval in ((10, 3), (9, 9), (7, 1)):
        got = list(tdata.IntervalSampler(length, interval, rollover))
        want = list(jdata.IntervalSampler(length, interval, rollover))
        assert got == want
        assert len(tdata.IntervalSampler(length, interval)) == length
    with pytest.raises(AssertionError):
        tdata.IntervalSampler(3, 4)


def test_data_loader_batches_the_dataset_in_order(corpus):
    td = tdata.LanguageModelDataset(corpus[1], seq_len=SEQ)
    sampler = tdata.IntervalSampler(len(td), 4)
    with mxt.cpu():
        loader = mxt.gluon.data.DataLoader(td, batch_size=4, sampler=sampler,
                                           last_batch="discard")
        batches = [(d.asnumpy(), l.asnumpy()) for d, l in loader]
    order = list(sampler)
    assert len(batches) == len(order) // 4
    for b, (d, l) in enumerate(batches):
        rows = order[4 * b:4 * b + 4]
        onp.testing.assert_array_equal(d, onp.stack([td[i][0] for i in rows]))
        onp.testing.assert_array_equal(l, onp.stack([td[i][1] for i in rows]))
    assert collections.Counter(sampler) == collections.Counter(range(len(td)))
