"""Dataset loaders: the CiteULike file layout and its synthetic stand-in.

Counterpart of `openrec_tpu/data/loaders.py:27-41, 131-153`:
`load_citeulike` reads `user_data_{train,val,test}.npy` structured arrays
(user_id/item_id fields) from `<dataset_folder>/citeulike/`;
`synthetic_citeulike` draws the same shape with numpy (5,551 users x
16,980 items, 204,057 records split 80/10/10), bit-identical to the JAX
package's for the same seed. The other datasets come with the models
that use them.
"""

from __future__ import annotations

import os

import numpy as np

CITEULIKE = {"total_users": 5551, "total_items": 16980}


def _load_split(folder, name):
    return {
        split: np.load(os.path.join(folder, name, f"user_data_{part}.npy"))
        for split, part in (("train_data", "train"), ("val_data", "val"),
                            ("test_data", "test"))}


def load_citeulike(dataset_folder="dataset/"):
    raw = dict(CITEULIKE)
    raw.update(_load_split(dataset_folder, "citeulike"))
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
