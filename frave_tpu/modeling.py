"""Learned context modeling: least-squares predictor fits.

Reference: context_modeling.rs:79-213 — per channel, per layer group
(group 0: finest level depth-1; group 1: level depth-2; group 2: the
rest), fit a 6-tap linear value predictor by least squares, then fit a
6-tap width predictor of |residual| on [1, 5 gradient features].

Data-parallel redesign: instead of materializing dense (N x 6) design
matrices and running an SVD per group (nalgebra lstsq,
context_modeling.rs:168,185), we accumulate 6x6 Gram matrices G = X^T X
and moments b = X^T y — a masked segment-sum that is embarrassingly
parallel, needs O(1) memory, and psum-reduces across shards for the
multi-device path (SURVEY.md section 2.3). The solve is a tiny lstsq on the
6x6 system. Rows the reference leaves as zeros (masked/None coefficients,
context_modeling.rs:109-137) contribute nothing to a Gram matrix, so that
quirk is mathematically absorbed. Fitted parameters are cast to f32 before
use because they travel in the container as f32 (serialize.rs:78-92) and
encoder-side residuals must be computed with exactly the serialized
values.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _gram_solve(G: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Minimum-norm solve of the 6x6 normal equations."""
    sol, *_ = np.linalg.lstsq(G, b, rcond=None)
    return sol


def fit_predictors_np(
    vals: np.ndarray,  # [K, 6] neighbour values (HF slots only)
    target: np.ndarray,  # [K] coefficient values
    group: np.ndarray,  # [K] int fine parameter group id
    valid: np.ndarray,  # [K] bool rows that carry a coefficient
    ngroups: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (value_params [ngroups, 6] f32, width_params [ngroups, 6]
    f32), both rounded to f16 values — format v8 ships parameters as f16
    and residuals must be computed with exactly the wire values, so the
    rounding happens here, before the width fit consumes the value fit."""
    X = vals.astype(np.float64)
    y = target.astype(np.float64)
    w = valid.astype(np.float64)

    vparams = np.zeros((ngroups, 6), dtype=np.float64)
    wparams = np.zeros((ngroups, 6), dtype=np.float64)
    for g in range(ngroups):
        m = w * (group == g)
        Xg = X * m[:, None]
        G = Xg.T @ X
        b = Xg.T @ y
        vparams[g] = _gram_solve(G, b)
    vparams = vparams.astype(np.float16).astype(np.float32)

    # Width fit: |residual| on gradient features (context_modeling.rs:144-173).
    for g in range(ngroups):
        m = w * (group == g)
        pred = (X.astype(np.float32) @ vparams[g]).astype(np.float64)
        r = np.abs(y - pred)
        F = np.stack(
            [
                np.ones_like(y),
                np.abs(X[:, 0] - X[:, 3]),
                np.abs(X[:, 1] - X[:, 2]),
                np.abs(X[:, 4] - X[:, 5]),
                np.abs(X[:, 1] - X[:, 5]),
                np.abs(X[:, 2] - X[:, 4]),
            ],
            axis=1,
        )
        Fg = F * m[:, None]
        G = Fg.T @ F
        b = Fg.T @ r
        wparams[g] = _gram_solve(G, b)

    return vparams.astype(np.float32), wparams.astype(np.float16).astype(
        np.float32
    )
