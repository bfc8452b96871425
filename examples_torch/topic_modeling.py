#!/usr/bin/env python
"""Topic modeling with a SOM (reference examples/TopicModeling.ipynb
workload): train a tiny 2x4 map on tf-idf document vectors and read each
node's top keywords off its weight vector — SOM-as-topic-model. The
notebook's 20newsgroups download is replaced by an in-code corpus
generator over 8 seed topics; tf-idf is computed in plain numpy
(sklearn-free). The PyTorch port's twin of examples/topic_modeling.py."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.utils import resolve_device

TOPICS = {
    "space": "orbit rocket launch satellite moon lunar nasa shuttle mission astronaut",
    "hockey": "goal puck ice team season playoff skate goalie league score",
    "cars": "engine wheel brake dealer mileage sedan turbo clutch gear driver",
    "crypto": "key cipher encryption security algorithm secret signature protocol hash",
    "medicine": "doctor patient disease treatment symptom clinical drug therapy dose",
    "politics": "government policy election vote senate law congress debate bill tax",
    "graphics": "image pixel render polygon shader texture format color resolution file",
    "religion": "faith church belief scripture doctrine prayer moral sacred spirit soul",
}
FILLER = "the and for with that this from have were said which about".split()


def synth_corpus(docs_per_topic=40, words_per_doc=60, seed=1):
    rng = np.random.RandomState(seed)
    docs, labels = [], []
    for label, words in TOPICS.items():
        vocab = words.split()
        for _ in range(docs_per_topic):
            body = list(
                rng.choice(vocab, size=words_per_doc // 2)
            ) + list(rng.choice(FILLER, size=words_per_doc // 2))
            # sprinkle cross-topic noise
            other = rng.choice(list(TOPICS))
            body += list(rng.choice(TOPICS[other].split(), size=4))
            docs.append(body)
            labels.append(label)
    return docs, labels


def tfidf(docs):
    """Plain-numpy tf-idf with smoothed idf (what TfidfVectorizer does)."""
    vocab = sorted({w for d in docs for w in d})
    index = {w: i for i, w in enumerate(vocab)}
    tf = np.zeros((len(docs), len(vocab)), np.float32)
    for r, d in enumerate(docs):
        for w in d:
            tf[r, index[w]] += 1
    df = (tf > 0).sum(axis=0)
    idf = np.log((1 + len(docs)) / (1 + df)) + 1
    X = tf * idf
    X /= np.linalg.norm(X, axis=1, keepdims=True) + 1e-12
    return X.astype(np.float32), vocab


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device, e.g. 'cpu' (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device={device}")

    docs, labels = synth_corpus()
    X, vocab = tfidf(docs)
    print(f"{len(docs)} docs, {len(vocab)} terms")

    som = XPySom(2, 4, X.shape[1], random_seed=1, device=device)
    som.pca_weights_init(X)
    som.train_batch(X, 200)

    weights = som.get_weights()
    top_keywords = 10
    print(f"\nQE {som.quantization_error(X):.4f}; topics per node:")
    for i in range(2):
        for j in range(4):
            order = np.argsort(-weights[i, j])
            kws = [vocab[k] for k in order[:top_keywords]]
            print(f"  node ({i},{j}): {' '.join(kws)}")

    # quality probe: docs of one seed topic should concentrate on few nodes
    flat = som.predict(X)
    spread = [
        len(np.unique(flat[np.array(labels) == t])) for t in TOPICS
    ]
    print(f"\nnodes used per seed topic: {spread} (8 topics over 8 nodes)")


if __name__ == "__main__":
    main()
