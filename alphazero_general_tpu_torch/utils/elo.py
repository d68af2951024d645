"""Pairwise-comparison ratings for round-robin tournaments — the port's own
copy of alphazero_general_tpu/utils/elo.py (numpy only).

The reference ranks checkpoints with ``choix.ilsr_pairwise_dense``
(reference: alphazero/roundrobin.py:79-87). choix is not a dependency here;
this is the same estimator — I-LSR (iterative Luce spectral ranking,
Maystre & Grossglauser 2015) for the Bradley-Terry model — plus a
conversion to Elo-like scales.
"""

from __future__ import annotations

import numpy as np


def _stationary(Q: np.ndarray) -> np.ndarray:
    """Stationary distribution of the continuous-time Markov chain with rate
    matrix Q (rows sum to 0)."""
    n = Q.shape[0]
    # Solve pi @ Q = 0, sum(pi) = 1 via least squares with the constraint row.
    A = np.vstack([Q.T, np.ones((1, n))])
    b = np.zeros(n + 1)
    b[-1] = 1.0
    pi, *_ = np.linalg.lstsq(A, b, rcond=None)
    pi = np.clip(pi, 1e-12, None)
    return pi / pi.sum()


def ilsr_pairwise_dense(wins: np.ndarray, alpha: float = 1e-4,
                        max_iter: int = 100, tol: float = 1e-9) -> np.ndarray:
    """Estimate Bradley-Terry log-strengths from a dense win-count matrix.

    wins[i, j] = number of times i beat j. ``alpha`` adds Laplace smoothing so
    undefeated/defeated-only players stay finite. Returns zero-mean
    log-strengths (same convention as choix).
    """
    n = wins.shape[0]
    W = wins.astype(np.float64) + alpha
    np.fill_diagonal(W, 0.0)
    pi = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        # Chain: rate i->j proportional to (wins of j over i) / (pi_i + pi_j).
        denom = pi[:, None] + pi[None, :]
        Q = W.T / denom  # Q[i, j]: rate from i to j ~ w_ji
        np.fill_diagonal(Q, 0.0)
        Q[np.arange(n), np.arange(n)] = -Q.sum(axis=1)
        new_pi = _stationary(Q)
        if np.max(np.abs(new_pi - pi)) < tol:
            pi = new_pi
            break
        pi = new_pi
    log_pi = np.log(pi)
    return log_pi - log_pi.mean()


def to_elo(log_strengths: np.ndarray, anchor: float = 1500.0) -> np.ndarray:
    """Convert BT log-strengths to the Elo scale (400/ln(10) per nat)."""
    return anchor + log_strengths * (400.0 / np.log(10.0))


def win_probability(log_strengths: np.ndarray, i: int, j: int) -> float:
    return float(1.0 / (1.0 + np.exp(log_strengths[j] - log_strengths[i])))
