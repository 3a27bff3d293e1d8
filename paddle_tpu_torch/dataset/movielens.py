"""MovieLens-1M — reference parity: python/paddle/dataset/movielens.py.

Readers yield (user_id, gender_id, age_id, job_id, movie_id, category_ids,
title_ids, rating) like the reference's recommender book test expects.
"""

import numpy as np

from . import common

MAX_USER_ID = 6040
MAX_MOVIE_ID = 3952
MAX_JOB_ID = 20
AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]
CATEGORIES = 18
TITLE_VOCAB = 5174


def max_user_id():
    return MAX_USER_ID


def max_movie_id():
    return MAX_MOVIE_ID


def max_job_id():
    return MAX_JOB_ID


def age_table():
    return AGE_TABLE


def _make_reader(n, seed):
    def reader():
        rng = common.synthetic_rng("movielens", seed)
        for _ in range(n):
            user = int(rng.randint(1, MAX_USER_ID + 1))
            gender = int(rng.randint(0, 2))
            age = int(rng.randint(0, len(AGE_TABLE)))
            job = int(rng.randint(0, MAX_JOB_ID + 1))
            movie = int(rng.randint(1, MAX_MOVIE_ID + 1))
            cats = rng.randint(0, CATEGORIES,
                               size=rng.randint(1, 4)).tolist()
            title = rng.randint(0, TITLE_VOCAB,
                                size=rng.randint(1, 6)).tolist()
            # learnable signal: rating correlates with (user+movie) parity
            base = 3.0 + ((user + movie) % 3) - 1
            rating = float(np.clip(base + 0.5 * rng.randn(), 1, 5))
            yield (user, gender, age, job, movie, cats, title,
                   np.array([rating], np.float32))
    return reader


def train(n=4096):
    return _make_reader(n, seed=0)


def test(n=512):
    return _make_reader(n, seed=1)


def fetch():
    pass
