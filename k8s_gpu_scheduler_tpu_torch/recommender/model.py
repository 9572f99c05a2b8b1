"""Iterative ridge-regression imputer (MICE-style), numpy only (copy of
the JAX package's ``recommender/model.py``).

Fills the missing cells of the throughput/interference matrices:
round-robin regress each incomplete column on the others over a
mean-initialized completion, repeat until convergence, and keep the
per-column regressors so ``transform`` can impute unseen rows without
refitting. numpy float64 throughout, so the two packages agree bit for
bit.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class IterativeImputer:
    def __init__(self, max_iter: int = 10, ridge: float = 1e-3, tol: float = 1e-4):
        self.max_iter = max_iter
        self.ridge = ridge
        self.tol = tol
        self.means_: Optional[np.ndarray] = None
        self.weights_: Dict[int, np.ndarray] = {}  # col -> [d] (bias last)

    def fit(self, X: np.ndarray) -> "IterativeImputer":
        X = np.asarray(X, dtype=np.float64)
        n, d = X.shape
        mask = np.isnan(X)
        with np.errstate(all="ignore"):
            means = np.nanmean(X, axis=0)
        means = np.where(np.isfinite(means), means, 0.0)
        self.means_ = means

        Xc = np.where(mask, means, X)
        for _ in range(self.max_iter):
            prev = Xc.copy()
            for j in range(d):
                w = self._fit_column(X, Xc, mask, j)
                if w is None:
                    continue
                self.weights_[j] = w
                miss = mask[:, j]
                if miss.any():
                    Xc[miss, j] = self._predict_column(Xc[miss], j, w)
            if np.abs(Xc - prev).max() <= self.tol:
                break
        self.train_completed_ = Xc
        return self

    def _fit_column(self, X, Xc, mask, j) -> Optional[np.ndarray]:
        obs = ~mask[:, j]
        if obs.sum() < 2:
            return None  # not enough signal; mean fill stands
        others = np.delete(np.arange(X.shape[1]), j)
        A = Xc[obs][:, others]
        A = np.hstack([A, np.ones((A.shape[0], 1))])  # bias
        y = X[obs, j]
        # ridge normal equations — tiny d, direct solve is exact enough
        G = A.T @ A + self.ridge * np.eye(A.shape[1])
        return np.linalg.solve(G, A.T @ y)

    def _predict_column(self, rows: np.ndarray, j: int, w: np.ndarray) -> np.ndarray:
        others = np.delete(np.arange(rows.shape[1]), j)
        A = np.hstack([rows[:, others], np.ones((rows.shape[0], 1))])
        return A @ w

    def transform(self, rows: np.ndarray) -> np.ndarray:
        """Impute nan cells of ``rows`` [m, d] using the fitted regressors."""
        if self.means_ is None:
            raise RuntimeError("transform before fit")
        rows = np.asarray(rows, dtype=np.float64)
        mask = np.isnan(rows)
        out = np.where(mask, self.means_, rows)
        for _ in range(self.max_iter):
            prev = out.copy()
            for j in range(rows.shape[1]):
                miss = mask[:, j]
                if not miss.any():
                    continue
                w = self.weights_.get(j)
                if w is None:
                    continue
                out[miss, j] = self._predict_column(out[miss], j, w)
            if np.abs(out - prev).max() <= self.tol:
                break
        return out

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        self.fit(X)
        return self.train_completed_
