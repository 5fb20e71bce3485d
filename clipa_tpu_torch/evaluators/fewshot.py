"""Few-shot linear-probe evaluator (closed-form L2-regularized regression).

Port of ``clipa_tpu/evaluators/fewshot.py``: embed the train and test
splits once, solve multi-target ridge regression against {-1, +1}
one-vs-all targets through one eigendecomposition of the (padded) gram
matrix, choose l2_reg from the grid by generalized cross-validation on the
TRAIN split, and report test accuracy at that setting per (dataset,
shots). The solver is the JAX package's numpy, verbatim, over this
package's embeddings.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from clipa_tpu_torch import registry
from clipa_tpu_torch import utils as u
from clipa_tpu_torch.evaluators import common

BIAS_CONSTANT = 100.0


def _eig_cache(x: np.ndarray, y: np.ndarray):
    """Precomputes the eigendecomposition used for every l2_reg value."""
    mean = x.mean(axis=0, keepdims=True)
    std = x.std(axis=0, keepdims=True) + 1e-5
    x = (x - mean) / std
    x = np.pad(x, ((0, 0), (0, 1)), constant_values=BIAS_CONSTANT)
    eigs, q = np.linalg.eigh(x.T @ x)
    rhs = q.T @ (x.T @ y)
    return {"eigs": eigs, "q": q, "rhs": rhs, "mean": mean, "std": std,
            "x": x, "y": y}


def _gcv_score(cache: dict, w: np.ndarray, l2_reg: float) -> float:
    """Generalized cross-validation score for ridge on the TRAIN split:
    GCV(λ) = n * RSS / (n - tr(S_λ))², tr(S_λ) = Σ eig/(eig+λ)."""
    n = cache["x"].shape[0]
    resid = cache["y"] - cache["x"] @ w
    rss = float(np.sum(resid ** 2))
    df = float(np.sum(cache["eigs"] / (cache["eigs"] + l2_reg)))
    denom = max(n - df, 1e-6)
    return n * rss / denom ** 2


def _solve(cache: dict, l2_reg: float) -> np.ndarray:
    scaling = 1.0 / (cache["eigs"] + l2_reg * np.ones_like(cache["eigs"]))
    return cache["q"] @ (scaling[:, None] * cache["rhs"])


def _predict(cache: dict, w: np.ndarray, x: np.ndarray) -> np.ndarray:
    x = (x - cache["mean"]) / cache["std"]
    x = np.pad(x, ((0, 0), (0, 1)), constant_values=BIAS_CONSTANT)
    return np.argmax(x @ w, axis=1)


class Evaluator:
    """Few-shot accuracy over {1,5,10,25}-shot subsets of labeled datasets."""

    def __init__(self, predict_fn: Callable, device="cuda", *,
                 batch_size: int = 256, datasets: Optional[dict] = None,
                 shots: Sequence[int] = (1, 5, 10, 25),
                 l2_regs: Sequence[float] = (2 ** 6, 2 ** 8, 2 ** 10, 2 ** 12),
                 pp: str = "", num_workers: int = 0, seed: int = 0):
        """datasets: {name: (train_source, test_source)} of labeled data."""
        self.predict_fn = predict_fn
        self.device = u.resolve_device(device, "fewshot.Evaluator")
        self.batch_size = batch_size
        self.datasets = datasets or {}
        self.shots = tuple(shots)
        self.l2_regs = tuple(l2_regs)
        self.num_workers = num_workers
        self.seed = seed
        self.pp_fn = registry.get_preprocess_fn(pp)

    def _embed_split(self, params, source):
        def pp(sample):
            out = self.pp_fn(dict(sample))
            return {"image": out["image"],
                    "label": np.asarray(out["label"], np.int32)}

        zs, ys, masks = [], [], []
        for batch in common.device_batches(source, pp, self.batch_size,
                                           self.device,
                                           num_workers=self.num_workers):
            zimg, _, _ = self.predict_fn(params, batch["image"], None)
            zs.append(zimg.float().cpu().numpy())
            ys.append(batch["label"].cpu().numpy())
            masks.append(batch["_mask"].cpu().numpy())
        keep = np.concatenate(masks).astype(bool)
        return np.concatenate(zs)[keep], np.concatenate(ys)[keep]

    def run(self, params):
        results = []
        rng = np.random.default_rng(self.seed)
        for name, (train_src, test_src) in self.datasets.items():
            x_tr, y_tr = self._embed_split(params, train_src)
            x_te, y_te = self._embed_split(params, test_src)
            classes = np.unique(y_tr)
            for shots in self.shots:
                idx = []
                for c in classes:
                    rows = np.flatnonzero(y_tr == c)
                    take = min(shots, len(rows))
                    idx.extend(rng.permutation(rows)[:take])
                idx = np.asarray(idx)
                y_onehot = -np.ones((len(idx), len(classes)), np.float32)
                for j, c in enumerate(classes):
                    y_onehot[y_tr[idx] == c, j] = 1.0
                cache = _eig_cache(x_tr[idx], y_onehot)
                best_gcv, best_w = np.inf, None
                for l2 in self.l2_regs:
                    w = _solve(cache, l2)
                    gcv = _gcv_score(cache, w, l2)
                    if gcv < best_gcv:
                        best_gcv, best_w = gcv, w
                pred = _predict(cache, best_w, x_te)
                acc = float((classes[pred] == y_te).mean())
                results.append((f"{name}/{shots}shot", acc))
        return results
