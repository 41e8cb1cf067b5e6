"""Synthetic data: embedding- and token-level corpora with planted
relevance, LM prompt batches and CTR batches.

``embedding_corpus`` and ``domain_shifted`` are copies of the
reference's (pure numpy): documents are bags of token vectors built
from topic directions, per-token noise and repeated "stopword"
directions that carry no topic signal; queries are noisy topic probes;
relevance is topic match.  They drive the pruning benchmarks without an
encoder.  The same seed gives the same arrays as the reference (numpy
arrays here, float32 embeddings).

``token_corpus`` is a copy of ``repro.data.synthetic.token_corpus``
(pure numpy; the port keeps its own copy rather than importing the
reference): a Zipfian vocabulary with topic-clustered content tokens
and high-frequency stopwords.  Deterministic in ``seed`` — the same seed
gives the same arrays as the reference.

``lm_batch`` is the counterpart of the reference's ``lm_batch``: uniform
token ids from a numpy generator seeded with (seed, step).  The
reference draws from ``jax.random``, so the ids differ from its; tests
feed the same numpy ids to both packages.  ``ctr_batch`` is the
counterpart of the reference's ``ctr_batch`` in the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EmbCorpus:
    d_embs: np.ndarray       # (n_docs, m, dim) float32
    d_masks: np.ndarray      # (n_docs, m) bool
    q_embs: np.ndarray       # (n_q, l, dim) float32
    q_topics: np.ndarray     # (n_q,)
    d_topics: np.ndarray     # (n_docs,)
    rel: np.ndarray          # (n_q, n_docs) bool
    gains: np.ndarray        # (n_q, n_docs) float32
    stop_frac: float


def embedding_corpus(seed: int = 0, *, n_docs: int = 256, n_q: int = 64,
                     n_topics: int = 16, dim: int = 32, m: int = 48,
                     l: int = 8, stop_frac: float = 0.4,
                     noise: float = 0.35, n_stop_dirs: int = 8,
                     jitter: float = 0.12,
                     norm: str = "sphere") -> EmbCorpus:
    """Planted-topic embedding corpus with redundancy: documents repeat
    low-information tokens (stopword directions, many times, slightly
    jittered) while topical content lives in low-multiplicity subtopic
    directions.  ``norm="sphere"`` puts tokens on the unit sphere,
    ``"ball"`` inside the ball (topical tokens longer)."""
    rng = np.random.default_rng(seed)
    topics = rng.normal(size=(n_topics, dim))
    topics /= np.linalg.norm(topics, axis=-1, keepdims=True)
    stops = rng.normal(size=(n_stop_dirs, dim))
    stops /= np.linalg.norm(stops, axis=-1, keepdims=True)

    d_topics = rng.integers(0, n_topics, size=n_docs)
    tok = np.zeros((n_docs, m, dim))
    tok_is_stop = np.zeros((n_docs, m), bool)
    n_stop_tok = int(round(stop_frac * m))
    n_content_tok = m - n_stop_tok
    # each doc's content = few unique subtopic directions, multiplicity 1-2
    n_sub = max(2, int(np.ceil(n_content_tok / 1.5)))
    for i in range(n_docs):
        subdirs = topics[d_topics[i]][None, :] + noise * rng.normal(
            size=(n_sub, dim))
        subdirs /= np.linalg.norm(subdirs, axis=-1, keepdims=True)
        content_pick = subdirs[np.arange(n_content_tok) % n_sub]
        # stop tokens: 2-3 shared directions, repeated many times
        doc_stop_dirs = stops[rng.choice(n_stop_dirs,
                                         size=max(1, n_stop_dirs // 3),
                                         replace=False)]
        stop_pick = doc_stop_dirs[rng.integers(0, len(doc_stop_dirs),
                                               size=n_stop_tok)]
        toks = np.concatenate([content_pick, stop_pick], axis=0)
        is_stop = np.concatenate([np.zeros(n_content_tok, bool),
                                  np.ones(n_stop_tok, bool)])
        perm = rng.permutation(m)
        tok[i] = toks[perm]
        tok_is_stop[i] = is_stop[perm]
    tok = tok + jitter * rng.normal(size=(n_docs, m, dim))
    nrm = np.linalg.norm(tok, axis=-1, keepdims=True)
    if norm == "sphere":
        tok = tok / nrm
    else:  # ball: scale into (0,1) radius, topical tokens longer
        r = 0.35 + 0.6 * (~tok_is_stop[..., None])
        tok = tok / nrm * r
    # ragged doc lengths
    lens = rng.integers(int(0.6 * m), m + 1, size=n_docs)
    d_masks = np.arange(m)[None, :] < lens[:, None]

    q_topics = rng.integers(0, n_topics, size=n_q)
    q = topics[q_topics][:, None, :] + noise * rng.normal(size=(n_q, l, dim))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)

    rel = q_topics[:, None] == d_topics[None, :]
    return EmbCorpus(d_embs=tok.astype(np.float32), d_masks=d_masks,
                     q_embs=q.astype(np.float32), q_topics=q_topics,
                     d_topics=d_topics, rel=rel,
                     gains=rel.astype(np.float32), stop_frac=stop_frac)


def domain_shifted(corpus_seed: int, shift_seed: int, **kw) -> EmbCorpus:
    """BEIR-style zero-shot domain: new topics/stopword geometry drawn with
    a different seed + heavier noise (out-of-domain evaluation)."""
    kw.setdefault("noise", 0.5)
    kw.setdefault("stop_frac", 0.55)
    return embedding_corpus(seed=shift_seed * 7919 + corpus_seed, **kw)


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


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int):
    """{"tokens": (batch, seq) int32 ids in [0, vocab)}, deterministic
    in (seed, step)."""
    rng = np.random.default_rng((seed, step))
    return {"tokens": rng.integers(0, vocab, size=(batch, seq),
                                   dtype=np.int32)}


def ctr_batch(seed: int, step: int, batch: int, n_dense: int, n_sparse: int,
              table_rows: int, *, device="cpu"):
    """{"dense": (batch, n_dense) f32 N(0, 1), "sparse_ids": (batch,
    n_sparse) int32 uniform in [0, table_rows), "labels": (batch,) f32
    Bernoulli(0.3)} as tensors on ``device``, deterministic in
    (seed, step)."""
    rng = np.random.default_rng((seed, step))
    arrays = {
        "dense": rng.standard_normal((batch, n_dense), dtype=np.float32),
        "sparse_ids": rng.integers(0, table_rows, size=(batch, n_sparse),
                                   dtype=np.int32),
        "labels": (rng.random(batch) < 0.3).astype(np.float32),
    }
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
