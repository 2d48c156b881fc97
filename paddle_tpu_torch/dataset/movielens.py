"""MovieLens-1M reader (reference: python/paddle/dataset/movielens.py —
yields [user_id, gender(0/1), age_index, job_id, movie_id,
[category ids], [title word ids], [rating]]). Reads
``$PADDLE_GPU_DATA/ml-1m/{ratings,movies,users}.dat`` when present, else
synthesizes a rating structure with real signal (rating is a noisy
function of user and movie latent factors).
Port of ``paddle_tpu/dataset/movielens.py``: the same seeded samples.
"""

import os

import numpy as np

from paddle_tpu_torch.dataset.common import data_path


age_table = [1, 18, 25, 35, 45, 50, 56]

_N_USERS = 200
_N_MOVIES = 300
_N_JOBS = 21
_N_CATEGORIES = 18
_TITLE_VOCAB = 500


class MovieInfo:
    """(reference: movielens.py:48)"""

    def __init__(self, index, categories, title_ids):
        self.index = int(index)
        self.categories = categories
        self.title_ids = title_ids

    def value(self):
        return [self.index, list(self.categories), list(self.title_ids)]


class UserInfo:
    """(reference: movielens.py:75)"""

    def __init__(self, index, is_male, age_idx, job_id):
        self.index = int(index)
        self.is_male = is_male
        self.age = age_idx
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age,
                self.job_id]


def _meta():
    """Synthetic user/movie tables (deterministic) or parsed ml-1m files.
    Returns (users, movies, title_dict, cat_dict) — the dicts actually
    used to encode titles/categories, so get_movie_title_dict() and
    movie_categories() always match the reader's ids."""
    users, movies = {}, {}
    udat = data_path("ml-1m", "users.dat")
    mdat = data_path("ml-1m", "movies.dat")
    if os.path.exists(udat) and os.path.exists(mdat):
        cat_dict, title_dict = {}, {}
        with open(mdat, encoding="latin-1") as f:
            for line in f:
                mid, title, cats = line.strip().split("::")
                for c in cats.split("|"):
                    cat_dict.setdefault(c, len(cat_dict))
                tids = []
                for w in title.split():
                    tids.append(title_dict.setdefault(
                        w.lower(), len(title_dict)))
                movies[int(mid)] = MovieInfo(
                    mid, [cat_dict[c] for c in cats.split("|")], tids)
        with open(udat, encoding="latin-1") as f:
            for line in f:
                uid, gender, age, job = line.strip().split("::")[:4]
                users[int(uid)] = UserInfo(
                    uid, gender == "M", age_table.index(int(age)), job)
        return users, movies, title_dict, cat_dict
    rng = np.random.RandomState(42)
    for uid in range(1, _N_USERS + 1):
        users[uid] = UserInfo(uid, bool(rng.randint(2)),
                              int(rng.randint(len(age_table))),
                              int(rng.randint(_N_JOBS)))
    for mid in range(1, _N_MOVIES + 1):
        n_cat = int(rng.randint(1, 4))
        cats = rng.choice(_N_CATEGORIES, n_cat, replace=False).tolist()
        title = rng.randint(0, _TITLE_VOCAB, int(rng.randint(1, 5)))
        movies[mid] = MovieInfo(mid, cats, title.tolist())
    title_dict = {"<t%d>" % i: i for i in range(_TITLE_VOCAB)}
    cat_dict = {"<c%d>" % i: i for i in range(_N_CATEGORIES)}
    return users, movies, title_dict, cat_dict


_USERS, _MOVIES = None, None
_TITLE_DICT, _CAT_DICT = None, None
_META_ROOT = None


def _init():
    """Load the tables of the current ``data`` root (again when the flag
    has changed since the last load)."""
    global _USERS, _MOVIES, _TITLE_DICT, _CAT_DICT, _META_ROOT
    root = data_path("ml-1m")
    if _USERS is None or _META_ROOT != root:
        _USERS, _MOVIES, _TITLE_DICT, _CAT_DICT = _meta()
        _META_ROOT = root


def _ratings(rand_seed=0, test_ratio=0.1, is_test=False):
    _init()
    rdat = data_path("ml-1m", "ratings.dat")
    rng = np.random.RandomState(rand_seed)
    if os.path.exists(rdat):
        with open(rdat, encoding="latin-1") as f:
            for line in f:
                if (rng.random_sample() < test_ratio) != is_test:
                    continue
                uid, mid, rating, _ = line.strip().split("::")
                usr, mov = _USERS[int(uid)], _MOVIES[int(mid)]
                yield usr.value() + mov.value() + [
                    [float(rating) * 2 - 5.0]]
        return
    # synthetic ratings: latent-factor structure so a recommender trains.
    # UNIQUE (user, movie) pairs routed by one split draw each — the same
    # partition discipline as the file path (one rating line per pair),
    # so train/test are disjoint.
    u_lat = np.random.RandomState(7).randn(_N_USERS + 1, 4)
    m_lat = np.random.RandomState(8).randn(_N_MOVIES + 1, 4)
    n = 4000
    pair_rng = np.random.RandomState(9)
    pairs = pair_rng.permutation(_N_USERS * _N_MOVIES)[:n]
    for pair in pairs:
        uid = 1 + int(pair) // _N_MOVIES
        mid = 1 + int(pair) % _N_MOVIES
        raw = float(u_lat[uid] @ m_lat[mid]) + 0.3 * float(rng.randn())
        rating = float(np.clip(np.round(raw + 3), 1, 5))
        if (rng.random_sample() < test_ratio) != is_test:
            continue
        usr, mov = _USERS[uid], _MOVIES[mid]
        yield usr.value() + mov.value() + [[rating * 2 - 5.0]]


def train(rand_seed=0):
    return lambda: _ratings(rand_seed=rand_seed, is_test=False)


def test(rand_seed=0):
    return lambda: _ratings(rand_seed=rand_seed, is_test=True)


def get_movie_title_dict():
    _init()
    return dict(_TITLE_DICT)


def max_movie_id():
    _init()
    return max(m.index for m in _MOVIES.values())


def max_user_id():
    _init()
    return max(u.index for u in _USERS.values())


def max_job_id():
    _init()
    return max(u.job_id for u in _USERS.values())


def movie_categories():
    _init()
    return dict(_CAT_DICT)


def movie_info():
    _init()
    return dict(_MOVIES)


def user_info():
    _init()
    return dict(_USERS)
