"""MovieLens-1M schema (reference python/paddle/dataset/movielens.py:
per-rating rows of [user_id, gender_id, age_id, job_id, movie_id,
category_ids, title_ids, score]). Synthetic fallback with the real
cardinalities."""

import numpy as np

__all__ = ["train", "test", "get_movie_title_dict", "max_movie_id",
           "max_user_id", "max_job_id", "age_table", "movie_categories",
           "user_info", "movie_info", "MovieInfo", "UserInfo"]

_USERS = 6040
_MOVIES = 3952
_JOBS = 21
_CATS = 18
_TITLE_VOCAB = 5175
age_table = [1, 18, 25, 35, 45, 50, 56]


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)


def max_movie_id():
    return _MOVIES


def max_user_id():
    return _USERS


def max_job_id():
    return _JOBS - 1


def movie_categories():
    return {"cat_%d" % i: i for i in range(_CATS)}


def get_movie_title_dict():
    return {"w%d" % i: i for i in range(_TITLE_VOCAB)}


def movie_info():
    r = np.random.RandomState(5)
    return {i: MovieInfo(i, r.randint(0, _CATS, 2).tolist(),
                         r.randint(0, _TITLE_VOCAB, 4).tolist())
            for i in range(1, _MOVIES + 1)}


def user_info():
    r = np.random.RandomState(6)
    return {i: UserInfo(i, "M" if r.rand() < 0.5 else "F",
                        age_table[int(r.randint(0, len(age_table)))],
                        int(r.randint(0, _JOBS)))
            for i in range(1, _USERS + 1)}


def _rows(n, seed):
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            uid = int(r.randint(1, _USERS + 1))
            mid = int(r.randint(1, _MOVIES + 1))
            yield [uid, int(r.randint(0, 2)),
                   int(r.randint(0, len(age_table))),
                   int(r.randint(0, _JOBS)), mid,
                   r.randint(0, _CATS, 2).tolist(),
                   r.randint(0, _TITLE_VOCAB, 4).tolist(),
                   float(r.randint(1, 6))]
    return reader


def train():
    return _rows(8192, seed=11)


def test():
    return _rows(1024, seed=13)
