"""The port's ``Dataset`` views, lookups and batch iterators against the
JAX package's, on the CPU: the same data and seed give byte-identical
arrays (both draw from the dataset's numpy ``RandomState`` in the same
order), and views equal key for key."""

import numpy as np
import pytest

from cornac_tpu.data import Dataset as JDataset
from cornac_tpu_torch.data import Dataset


def _uirt(seed=3, n_users=40, n_items=30, n=500):
    rng = np.random.RandomState(seed)
    pairs = sorted({(rng.randint(n_users), rng.randint(n_items)) for _ in range(n)})
    rng.shuffle(pairs)
    return [(f"u{u}", f"i{i}", float(rng.randint(1, 6)), int(rng.randint(10**6)))
            for u, i in pairs]


@pytest.fixture(scope="module")
def pair():
    data = _uirt()
    return Dataset.from_uirt(data, seed=9), JDataset.from_uirt(data, seed=9)


def _same_arrays(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for x, y in zip(ours, theirs):
        if isinstance(x, tuple):
            assert len(x) == len(y)
            for a, b in zip(x, y):
                _same_arrays(a, b)
        else:
            _same_arrays(x, y)


def test_from_uirt(pair):
    ours, theirs = pair
    for a, b in zip(ours.uir_tuple, theirs.uir_tuple):
        _same_arrays(a, b)
    _same_arrays(ours.timestamps, theirs.timestamps)
    assert list(ours.uid_map.items()) == list(theirs.uid_map.items())
    assert list(ours.iid_map.items()) == list(theirs.iid_map.items())


@pytest.mark.parametrize("view", ["user_data", "item_data", "chrono_user_data",
                                  "chrono_item_data"])
def test_views(pair, view):
    ours, theirs = (getattr(d, view) for d in pair)
    assert list(ours) == list(theirs)
    for key in theirs:
        assert len(ours[key]) == len(theirs[key])
        for a, b in zip(ours[key], theirs[key]):
            _same_arrays(a, b)


def test_chrono_views_need_timestamps():
    data = [t[:3] for t in _uirt()]
    with pytest.raises(ValueError, match="timestamps"):
        Dataset.from_uir(data).chrono_user_data


def test_lookups(pair):
    ours, theirs = pair
    rng = np.random.RandomState(1)
    users, items = rng.randint(ours.num_users, size=2000), rng.randint(ours.num_items, size=2000)
    _same_arrays(ours.lookup_ratings(users, items), theirs.lookup_ratings(users, items))
    _same_arrays(ours.is_observed(users, items), theirs.is_observed(users, items))
    assert ours.is_observed(*ours.uir_tuple[:2]).all()


@pytest.mark.parametrize("batch_size", [1, 7, 64, 10**4])
def test_batch_counts(pair, batch_size):
    ours, theirs = pair
    for name in ("num_batches", "num_user_batches", "num_item_batches"):
        assert getattr(ours, name)(batch_size) == getattr(theirs, name)(batch_size)


@pytest.mark.parametrize("name,kwargs", [
    ("idx_iter", dict(idx_range=123, batch_size=10, shuffle=True)),
    ("idx_iter", dict(idx_range=50, batch_size=64)),
    ("uir_iter", dict(batch_size=32, shuffle=True)),
    ("uir_iter", dict(batch_size=32, shuffle=True, binary=True)),
    ("uir_iter", dict(batch_size=50, shuffle=True, num_zeros=3)),
    ("uij_iter", dict(batch_size=40, shuffle=True)),
    ("uij_iter", dict(batch_size=40, neg_sampling="popularity")),
    ("user_iter", dict(batch_size=8, shuffle=True)),
    ("item_iter", dict(batch_size=8, shuffle=True)),
])
def test_iterators_byte_identical(name, kwargs):
    data = _uirt()
    ours, theirs = Dataset.from_uirt(data, seed=4), JDataset.from_uirt(data, seed=4)
    for _ in range(2):  # two epochs: the rng carries over from one to the next
        _same_batches(getattr(ours, name)(**kwargs), getattr(theirs, name)(**kwargs))
    ours.reset(), theirs.reset()
    _same_batches(getattr(ours, name)(**kwargs), getattr(theirs, name)(**kwargs))


def test_sampled_negatives_are_rejected_as_in_jax():
    data = _uirt()
    ours, theirs = Dataset.from_uirt(data, seed=2), JDataset.from_uirt(data, seed=2)
    users = np.repeat(np.arange(ours.num_users), 5)
    reject = lambda d: (lambda us, its: d.is_observed(us, its))  # noqa: E731
    neg = ours._sample_negatives(users, reject(ours))
    _same_arrays(neg, theirs._sample_negatives(users, reject(theirs)))
    assert not ours.is_observed(users, neg).any()
    pop = ours.uir_tuple[1]
    _same_arrays(ours._sample_negatives(users, reject(ours), population=pop),
                 theirs._sample_negatives(users, reject(theirs), population=pop))
    with pytest.raises(ValueError):
        next(ours.uij_iter(neg_sampling="zipf"))
