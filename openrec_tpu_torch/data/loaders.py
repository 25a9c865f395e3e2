"""Dataset loaders: CiteULike, Tradesy, Amazon-book and Criteo, their file
layouts and their synthetic stand-ins.

Counterpart of `openrec_tpu/data/loaders.py:22-207`:
`load_citeulike` reads `user_data_{train,val,test}.npy` structured arrays
(user_id/item_id fields) from `<dataset_folder>/citeulike/`;
`load_tradesy` the same from `<dataset_folder>/tradesy/` plus
`item_features.npy` divided by 32.671101 (the reference's normalisation,
float32 stays float32); `load_amazon_book` the same from
`<dataset_folder>/amazon/` plus a LAZY float32 memmap of the item
features (`book_features_update.mem`, shape (total_items, 4096) unless
`feature_shape` says otherwise) and the int32 user categories
(`user_features_categories.npy`);
`synthetic_citeulike` draws the same shape with numpy (5,551 users x
16,980 items, 204,057 records split 80/10/10). `load_criteo` reads
`<dataset_folder>/criteo/kaggle_processed.npz` (X_int [N, 13] raw counts,
X_cat [N, 26], y, counts) and splits it 6/7 train, 1/14 val, 1/14 test
with the dense features through log(x + 1); `write_synthetic_criteo_npz`
writes that file's layout and `synthetic_criteo` draws the split arrays
directly, with labels a model can learn. `load_lastfm` reads
`<dataset_folder>/lastfm/lastfm_{train,test}.npy` (records with a `ts`
field), aliases `val_data` to the test split (the reference has no val
split) and adds `user_features` (`user_feature.npy`: user_gender,
user_geo) where that file is present. Every function is bit-identical
to the JAX package's for the same seed.
"""

from __future__ import annotations

import os

import numpy as np

CITEULIKE = {"total_users": 5551, "total_items": 16980}
TRADESY = {"total_users": 19243, "total_items": 165906}
AMAZON_BOOK = {"total_users": 99473, "total_items": 450166}
LASTFM = {"total_users": 992, "total_items": 14598}


def _load_split(folder, name):
    return {
        split: np.load(os.path.join(folder, name, f"user_data_{part}.npy"))
        for split, part in (("train_data", "train"), ("val_data", "val"),
                            ("test_data", "test"))}


def load_citeulike(dataset_folder="dataset/"):
    raw = dict(CITEULIKE)
    raw.update(_load_split(dataset_folder, "citeulike"))
    return raw


def load_tradesy(dataset_folder="dataset/"):
    raw = dict(TRADESY)
    raw.update(_load_split(dataset_folder, "tradesy"))
    raw["item_features"] = np.load(
        os.path.join(dataset_folder, "tradesy", "item_features.npy")
    ) / 32.671101          # the reference's normalisation (dataloader.py:40)
    return raw


def load_lastfm(dataset_folder="dataset/"):
    """The reference's layout (tf1_examples/rnn_rec_lastfm.py:9-10,
    youtube_rec_lastfm.py:8-10): lastfm_{train,test}.npy, and
    user_feature.npy (rows indexed by user_id) when present; `val_data`
    is the test split."""
    raw = dict(LASTFM)
    folder = os.path.join(dataset_folder, "lastfm")
    raw["train_data"] = np.load(os.path.join(folder, "lastfm_train.npy"))
    raw["test_data"] = np.load(os.path.join(folder, "lastfm_test.npy"))
    raw["val_data"] = raw["test_data"]
    feature_path = os.path.join(folder, "user_feature.npy")
    if os.path.exists(feature_path):
        raw["user_features"] = np.load(feature_path)
    return raw


def load_amazon_book(dataset_folder="dataset/", feature_shape=None):
    """The reference's layout (tf2_examples/dataloader.py:4-17). The memmap
    has no header, so `feature_shape` overrides (total_items, 4096) for
    files of another size. It stays lazy: joins and batched extraction
    read it row by row, so only the pages they touch are read (the
    reference copies all 7.4 GB into host memory)."""
    raw = dict(AMAZON_BOOK)
    raw.update(_load_split(dataset_folder, "amazon"))
    if feature_shape is None:
        feature_shape = (raw["total_items"], 4096)
    raw["item_features"] = np.memmap(
        os.path.join(dataset_folder, "amazon", "book_features_update.mem"),
        dtype=np.float32, mode="r", shape=tuple(feature_shape))
    raw["user_features"] = np.load(
        os.path.join(dataset_folder, "amazon",
                     "user_features_categories.npy"))
    return raw


def synthetic_interactions(total_users, total_items, num_records,
                           timestamps=False, seed=0):
    """Uniform random (user, item) records (+ int64 `ts` on request)."""
    rng = np.random.default_rng(seed)
    dtype = [("user_id", np.int32), ("item_id", np.int32)]
    if timestamps:
        dtype.append(("ts", np.int64))
    data = np.zeros(num_records, dtype=dtype)
    data["user_id"] = rng.integers(0, total_users, num_records)
    data["item_id"] = rng.integers(0, total_items, num_records)
    if timestamps:
        data["ts"] = rng.integers(0, 1 << 40, num_records)
    return data


def synthetic_citeulike(num_records=204057, seed=0):
    raw = dict(CITEULIKE)
    n = num_records
    all_data = synthetic_interactions(raw["total_users"],
                                      raw["total_items"], n, seed=seed)
    raw["train_data"] = all_data[:int(n * 0.8)]
    raw["val_data"] = all_data[int(n * 0.8):int(n * 0.9)]
    raw["test_data"] = all_data[int(n * 0.9):]
    return raw


def load_criteo(dataset_folder="dataset/", seed=None):
    """The reference's split (tf2_examples/dataloader.py:44-83)."""
    rng = np.random.default_rng(seed)
    with np.load(os.path.join(dataset_folder, "criteo",
                              "kaggle_processed.npz")) as data:
        X_int, X_cat = data["X_int"], data["X_cat"]
        y, counts = data["y"], data["counts"]

    indices = np.array_split(np.arange(len(y)), 7)
    indices = [rng.permutation(part) for part in indices]
    train_idx = rng.permutation(np.concatenate(indices[:-1]))
    val_idx, test_idx = np.array_split(indices[-1], 2)

    raw = {"counts": counts}
    for split, idx in (("train", train_idx), ("val", val_idx),
                       ("test", test_idx)):
        raw[f"X_cat_{split}"] = X_cat[idx].astype(np.int32)
        raw[f"X_int_{split}"] = np.log(X_int[idx] + 1).astype(np.float32)
        raw[f"y_{split}"] = y[idx].astype(np.float32)
    return raw


def _criteo_counts(rng, counts):
    if counts is None:
        # Criteo Kaggle's 26 tables span ~10 to ~10M rows; a downscaled
        # long-tail layout keeps the shape.
        counts = np.array([int(10 ** (1 + 5 * rng.random()))
                           for _ in range(26)])
    return np.asarray(counts)


def write_synthetic_criteo_npz(path, num_records=100000, counts=None,
                               seed=0):
    """Write a synthetic kaggle_processed.npz in the on-disk layout that
    `load_criteo` reads (X_int [N, 13] raw counts, X_cat [N, 26], y [N],
    counts [26]). Returns the file size in bytes."""
    rng = np.random.default_rng(seed)
    counts = _criteo_counts(rng, counts)
    n = int(num_records)
    X_cat = np.stack([rng.integers(0, c, n) for c in counts],
                     axis=1).astype(np.int32)
    # raw integer counts (the loader applies log(x+1) itself)
    X_int = (rng.pareto(2.0, size=(n, 13)) * 100).astype(np.int32)
    logits = (np.log(X_int[:, 0] + 1.0) - np.log(X_int[:, 1] + 1.0)
              + (X_cat[:, 0] % 7 < 3).astype(np.float32))
    y = (rng.random(n) < 1 / (1 + np.exp(-logits + 1.5))).astype(
        np.int32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, X_int=X_int, X_cat=X_cat, y=y, counts=counts)
    return os.path.getsize(path)


def synthetic_criteo(num_records=100000, counts=None, seed=0):
    """Split Criteo-layout arrays drawn with numpy: dense log(x + 1) of
    Pareto counts, uniform ids per table, and labels drawn from a logistic
    of two dense features and table 0's id, so a model can learn them."""
    rng = np.random.default_rng(seed)
    counts = _criteo_counts(rng, counts)
    raw = {"counts": counts}
    n = num_records
    X_cat = np.stack([rng.integers(0, c, n) for c in counts],
                     axis=1).astype(np.int32)
    X_int = np.log(rng.pareto(2.0, size=(n, 13)) * 100 + 1).astype(
        np.float32)
    logits = (X_int[:, 0] - X_int[:, 1]
              + (X_cat[:, 0] % 7 < 3).astype(np.float32))
    y = (rng.random(n) < 1 / (1 + np.exp(-logits + 1.5))).astype(
        np.float32)
    splits = [("train", slice(0, int(n * 6 / 7))),
              ("val", slice(int(n * 6 / 7), int(n * 13 / 14))),
              ("test", slice(int(n * 13 / 14), n))]
    for name, sl in splits:
        raw[f"X_cat_{name}"] = X_cat[sl]
        raw[f"X_int_{name}"] = X_int[sl]
        raw[f"y_{name}"] = y[sl]
    return raw
