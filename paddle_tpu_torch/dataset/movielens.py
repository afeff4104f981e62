"""Counterpart of paddle_tpu/dataset/movielens.py (Paddle: python/paddle/dataset/movielens.py):
rating samples
(user_id, gender, age, job, movie_id, title-ids, genres, rating).

Synthetic fallback: latent-factor ratings (user/movie embeddings drawn
from fixed templates) so recommender models can actually fit it."""
import numpy as np

MAX_USER_ID = 944
MAX_MOVIE_ID = 1683
_K = 8


def max_user_id():
    return MAX_USER_ID


def max_movie_id():
    return MAX_MOVIE_ID


def max_job_id():
    return 20


def age_table():
    return [1, 18, 25, 35, 45, 50, 56]


def _factors():
    rng = np.random.RandomState(11)
    u = rng.randn(MAX_USER_ID + 1, _K) * 0.5
    m = rng.randn(MAX_MOVIE_ID + 1, _K) * 0.5
    return u, m


def _reader(seed, n):
    u, m = _factors()
    rng = np.random.RandomState(seed)

    def reader():
        for i in range(n):
            uid = int(rng.randint(1, MAX_USER_ID + 1))
            mid = int(rng.randint(1, MAX_MOVIE_ID + 1))
            score = float(np.clip(3.0 + u[uid] @ m[mid] + 0.3 * rng.randn(),
                                  1.0, 5.0))
            gender = uid % 2
            age = int(rng.randint(0, 7))
            job = uid % 21
            title = [mid % 100, (mid * 7) % 100]
            genres = [mid % 18]
            yield uid, gender, age, job, mid, title, genres, score

    return reader


def train():
    return _reader(0, 4000)


def test():
    return _reader(1, 800)
