"""Synthetic token-level corpus with planted relevance.

Copy of ``repro.data.synthetic.token_corpus`` (pure numpy; the port
keeps its own copy rather than importing the reference): a Zipfian
vocabulary with topic-clustered content tokens and high-frequency
stopwords.  Deterministic in ``seed`` — the same seed gives the same
arrays as the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenCorpus:
    doc_ids: np.ndarray      # (n_docs, m) int32, 0 = pad
    q_ids: np.ndarray        # (n_q, l) int32
    q_topics: np.ndarray
    d_topics: np.ndarray
    rel: np.ndarray          # (n_q, n_docs) bool
    stopword_set: np.ndarray  # (vocab,) bool
    idf: np.ndarray          # (vocab,) float32
    vocab: int


def token_corpus(seed: int = 0, *, n_docs: int = 512, n_q: int = 128,
                 n_topics: int = 16, vocab: int = 2048, m: int = 48,
                 l: int = 8, n_stop: int = 32,
                 stop_rate: float = 0.35) -> TokenCorpus:
    rng = np.random.default_rng(seed)
    reserved = 4  # 0=pad 1=[Q] 2=[D] 3=[MASK]
    n_content = vocab - reserved - n_stop
    stop_ids = np.arange(reserved, reserved + n_stop)
    content_ids = np.arange(reserved + n_stop, vocab)
    per_topic = n_content // n_topics
    topic_tokens = [content_ids[t * per_topic:(t + 1) * per_topic]
                    for t in range(n_topics)]
    zipf = 1.0 / np.arange(1, per_topic + 1) ** 1.1
    zipf /= zipf.sum()

    d_topics = rng.integers(0, n_topics, size=n_docs)
    docs = np.zeros((n_docs, m), np.int32)
    lens = rng.integers(int(0.6 * m), m + 1, size=n_docs)
    for i in range(n_docs):
        t = d_topics[i]
        n_tok = lens[i]
        is_stop = rng.random(n_tok) < stop_rate
        content = rng.choice(topic_tokens[t], size=n_tok, p=zipf)
        stop = rng.choice(stop_ids, size=n_tok)
        docs[i, :n_tok] = np.where(is_stop, stop, content)
        docs[i, 0] = 2  # [D] marker

    q_topics = rng.integers(0, n_topics, size=n_q)
    qs = np.zeros((n_q, l), np.int32)
    for i in range(n_q):
        qs[i] = rng.choice(topic_tokens[q_topics[i]], size=l, p=zipf)
        qs[i, 0] = 1  # [Q] marker

    rel = q_topics[:, None] == d_topics[None, :]
    stop_set = np.zeros((vocab,), bool)
    stop_set[stop_ids] = True
    df = np.zeros((vocab,), np.int64)
    for i in range(n_docs):
        df[np.unique(docs[i][docs[i] > 0])] += 1
    idf = np.log(n_docs / (1.0 + df))
    return TokenCorpus(doc_ids=docs, q_ids=qs, q_topics=q_topics,
                       d_topics=d_topics, rel=rel, stopword_set=stop_set,
                       idf=idf.astype(np.float32), vocab=vocab)
