"""HPO-B hyperparameter-optimization lookup task
(``aline_tpu/tasks/hpo.py``).

A host-side loader of the HPO-B meta-datasets and a Task that serves
random context/query/target splits of the real data.  This is the one
task whose batches are drawn on the host: the split indices come from a
numpy ``Generator``, as in ``aline_tpu``, so a seed gives the JAX
package's batches bit for bit; the gathered batch then goes to the
device once.  The files are read by ``tasks/hpob_native.py`` (a C++
extension built at first use; its arrays are the ``json`` path's).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from aline_tpu_torch.tasks.base import Batch, Task
from aline_tpu_torch.tasks.hpob_native import load_hpob_arrays

DATASET_IDS = {"ranger": "7609", "glmnet": "5860", "svm": "5891",
               "rpart": "5859", "xgboost": "5971"}
# data/ at the root of the checkout
DATA_DIR = Path(__file__).resolve().parents[2] / "data"


class HPOBHandler:
    """The full HPO-B benchmark loader: v1/v2/v3 splits, the augmented
    meta-train set, surrogate summary stats and the standard test seeds
    (``aline_tpu/tasks/hpo.py`` HPOBHandler)."""

    SEEDS = ["test0", "test1", "test2", "test3", "test4"]

    def __init__(self, root_dir: str = "HPOB/", mode: str = "v3-test",
                 surrogates_dir: str = "saved-surrogates/"):
        self.mode = mode
        self.surrogates_dir = surrogates_dir
        self.seeds = list(self.SEEDS)
        if mode == "v3-test":
            self.load_data(root_dir, only_test=True)
        elif mode == "v3-train-augmented":
            self.load_data(root_dir, only_test=False, augmented_train=True)
        elif mode in ("v1", "v2", "v3"):
            self.load_data(root_dir, version=mode, only_test=False)
        else:
            raise ValueError("Provide a valid mode")
        stats = os.path.join(surrogates_dir, "summary-stats.json")
        if os.path.isfile(stats):
            with open(stats) as f:
                self.surrogates_stats = json.load(f)

    def load_data(self, rootdir: str = "", version: str = "v3",
                  only_test: bool = True, augmented_train: bool = False):
        paths = {
            "train_aug": os.path.join(rootdir,
                                      "meta-train-dataset-augmented.json"),
            "train": os.path.join(rootdir, "meta-train-dataset.json"),
            "test": os.path.join(rootdir, "meta-test-dataset.json"),
            "valid": os.path.join(rootdir, "meta-validation-dataset.json"),
            "bo_init": os.path.join(rootdir, "bo-initializations.json"),
        }
        with open(paths["test"]) as f:
            self.meta_test_data = json.load(f)
        with open(paths["bo_init"]) as f:
            self.bo_initializations = json.load(f)
        self.meta_train_data = None
        self.meta_validation_data = None
        if not only_test:
            train_path = (paths["train_aug"]
                          if augmented_train or version == "v1"
                          else paths["train"])
            with open(train_path) as f:
                self.meta_train_data = json.load(f)
            with open(paths["valid"]) as f:
                self.meta_validation_data = json.load(f)
        if version != "v3" and self.meta_train_data is not None:
            # v1/v2: every split merged into one test view
            merged = {}
            for space, datasets in self.meta_train_data.items():
                merged[space] = dict(datasets)
                if space in self.meta_test_data:
                    merged[space].update(self.meta_test_data[space])
                    merged[space].update(
                        self.meta_validation_data.get(space, {}))
            self.meta_train_data = None
            self.meta_validation_data = None
            self.meta_test_data = merged
        self.search_space_dims = {}
        for space, datasets in self.meta_test_data.items():
            first = next(iter(datasets.values()))
            self.search_space_dims[space] = len(first["X"][0])

    @staticmethod
    def normalize(y, y_min=None, y_max=None):
        y = np.asarray(y, np.float64)
        if y_min is None:
            return (y - y.min()) / (y.max() - y.min())
        return (y - y_min) / (y_max - y_min)

    def get_search_spaces(self):
        return list(self.meta_test_data.keys())

    def get_datasets(self, search_space):
        return list(self.meta_test_data[search_space].keys())

    def get_seeds(self):
        return self.seeds

    def get_search_space_dim(self, search_space):
        return self.search_space_dims[search_space]


class HPOB:
    """One meta-dataset (``aline_tpu/tasks/hpo.py`` HPOB), read by the
    native loader."""

    def __init__(self, meta_dataset: str = "glmnet",
                 data_path: Optional[str] = None):
        self.meta_dataset = meta_dataset
        self.path = data_path or str(DATA_DIR)
        arrays = load_hpob_arrays(
            os.path.join(self.path, "HPOB", f"{meta_dataset}.json"))
        self._X = {k: v[0] for k, v in arrays.items()}
        self._y = {k: v[1] for k, v in arrays.items()}
        self.dataset_ids = list(arrays.keys())
        self.n_dataset = len(self.dataset_ids)
        self.min_data_size = min(x.shape[0] for x in self._X.values())
        self.dim_x = self._X[self.dataset_ids[0]].shape[1]

    def sample(self, rng: np.random.Generator, batch_size: int = 16,
               n_context: Optional[int] = None, n_query: Optional[int] = None,
               n_target: int = 10, min_n_context: int = 5,
               max_n_context: int = 10):
        """Random context/query/target splits: per row a dataset, then a
        permutation of its rows, both from ``rng``."""
        n_context = n_context or int(rng.integers(min_n_context,
                                                  max_n_context))
        n_query = n_query or self.min_data_size - n_context - n_target

        cx = np.zeros((batch_size, n_context, self.dim_x), np.float32)
        cy = np.zeros((batch_size, n_context, 1), np.float32)
        qx = np.zeros((batch_size, n_query, self.dim_x), np.float32)
        qy = np.zeros((batch_size, n_query, 1), np.float32)
        tx = np.zeros((batch_size, n_target, self.dim_x), np.float32)
        ty = np.zeros((batch_size, n_target, 1), np.float32)
        need = n_context + n_query + n_target
        too_small = [d for d in self.dataset_ids
                     if self._X[d].shape[0] < need]
        if too_small:
            raise ValueError(
                f"HPO-B sample needs n_context+n_query+n_target={need} "
                f"rows but datasets {too_small[:5]} have fewer; lower "
                f"n_query/n_target or drop the short datasets")
        for i in range(batch_size):
            did = self.dataset_ids[int(rng.integers(self.n_dataset))]
            X, y = self._X[did], self._y[did]
            perm = rng.permutation(X.shape[0])
            c = perm[:n_context]
            q = perm[n_context: n_context + n_query]
            t = perm[n_context + n_query: n_context + n_query + n_target]
            cx[i], cy[i] = X[c], y[c]
            qx[i], qy[i] = X[q], y[q]
            tx[i], ty[i] = X[t], y[t]
        return cx, cy, qx, qy, tx, ty

    # -- the benchmark's test protocol --------------------------------------
    def get_test_set(self) -> Dict:
        with open(os.path.join(self.path, "HPOB",
                               f"{self.meta_dataset}_test.json")) as f:
            return json.load(f)

    def get_bo_initializations(self) -> Dict:
        with open(os.path.join(self.path, "HPOB",
                               "bo-initializations.json")) as f:
            return json.load(f)

    def sample_test_set(self, n_context: int, n_query: int, n_target: int):
        """The fixed BO-initialization splits of every (dataset, seed)
        pair: the seed's initial rows as context, then the first n_query
        and the next n_target of the other rows."""
        seeds = [f"test{i}" for i in range(5)]
        inits = self.get_bo_initializations()
        data = self.get_test_set()
        rows = []
        # a custom slice (the dataset-shift 'ranger_shift') keys its
        # initializations by its own name, not an HPO-B space id
        space_key = DATASET_IDS.get(self.meta_dataset, self.meta_dataset)
        for dataset_id in data.keys():
            dataset = data[dataset_id]
            X = np.asarray(dataset["X"], np.float32)
            y = np.asarray(dataset["y"], np.float32).reshape(-1, 1)
            for seed in seeds:
                init_ids = inits[space_key][dataset_id][seed]
                mask = np.ones(X.shape[0], bool)
                mask[init_ids] = False
                Xr, yr = X[mask], y[mask]
                rows.append((X[init_ids], y[init_ids],
                             Xr[:n_query], yr[:n_query],
                             Xr[n_query:n_query + n_target],
                             yr[n_query:n_query + n_target]))
        return tuple(np.stack([r[i] for r in rows], axis=0)
                     for i in range(6))


class HPOTask(Task):
    """The Task over one HPO-B meta-dataset.  Its dim_x is the data's
    (the config's is replaced, as in ``aline_tpu``), and
    ``sample_batch`` takes a numpy Generator, not a torch one."""

    def __init__(self, cfg):
        self.hpob = HPOB(meta_dataset=cfg.meta_dataset,
                         data_path=cfg.data_path)
        if cfg.dim_x != self.hpob.dim_x:
            print(f"Warning: config dim_x ({cfg.dim_x}) differs from "
                  f"dataset dim_x ({self.hpob.dim_x}); using dataset value.")
        cfg.dim_x = self.hpob.dim_x
        cfg.dim_y = 1
        super().__init__(cfg)
        if self.embedding_type != "data":
            raise ValueError("HPO tasks only support 'data' embedding type")
        self.meta_dataset = cfg.meta_dataset
        self.min_n_context = cfg.min_n_context
        self.max_n_context = cfg.max_n_context
        self.normalize_y = cfg.normalize_y
        self.n_target_theta = 0
        self.design_scale = 1.0

    def to_design_space(self, xi):
        return xi

    def normalise_outcomes(self, y):
        """Per-row min-max normalisation of a numpy [B, n, 1] array, when
        ``normalize_y``."""
        if not self.normalize_y:
            return y
        y_min = y.min(axis=1, keepdims=True)
        y_max = y.max(axis=1, keepdims=True)
        rng = np.where(y_max - y_min == 0, 1.0, y_max - y_min)
        return (y - y_min) / rng

    def simulate(self, gen, x, theta=None):
        raise NotImplementedError(
            "the HPO task serves real data; it simulates nothing")

    def pack_splits(self, cx, cy, qx, qy, tx, ty, device) -> Batch:
        """A Batch on ``device`` of numpy splits (``HPOB.sample`` or
        ``sample_test_set``): the context first, then the query pool;
        the outcomes normalised first when ``normalize_y``."""
        if self.normalize_y:
            all_y = self.normalise_outcomes(np.concatenate([cy, qy, ty],
                                                           axis=1))
            nc, nq = cy.shape[1], qy.shape[1]
            cy, qy, ty = (all_y[:, :nc], all_y[:, nc:nc + nq],
                          all_y[:, nc + nq:])

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                device)

        B = cx.shape[0]
        x = dev(np.concatenate([cx, qx], axis=1))
        y = dev(np.concatenate([cy, qy], axis=1))
        return self._pack_batch(x, y, dev(tx), dev(ty),
                                torch.zeros(B, 0, 1, device=device), None)

    def sample_batch(self, rng: np.random.Generator, batch_size: int,
                     n_query: Optional[int] = None, device="cpu") -> Batch:
        """A batch of random splits drawn from ``rng`` on the host, on
        ``device``."""
        n_query = self.n_query_init if n_query is None else n_query
        splits = self.hpob.sample(
            rng, batch_size=batch_size, n_context=self.n_context_init,
            n_query=n_query, n_target=self.n_target_data,
            min_n_context=self.min_n_context,
            max_n_context=self.max_n_context)
        return self.pack_splits(*splits, device=device)
