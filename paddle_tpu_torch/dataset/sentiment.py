"""Movie-review sentiment (NLTK-based in the reference) — parity:
python/paddle/dataset/sentiment.py. Readers yield (word_id list, label)."""

from . import imdb

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000


def get_word_dict():
    return sorted(imdb.word_dict().items(), key=lambda kv: kv[1])


def train(n=NUM_TRAINING_INSTANCES):
    return imdb._make_reader(n, seed=10)


def test(n=NUM_TOTAL_INSTANCES - NUM_TRAINING_INSTANCES):
    return imdb._make_reader(n, seed=11)


def fetch():
    pass
