"""Spectral initialisation of phantom factors from a dense teacher matrix:
the port's copy of the JAX package's ``core/lowrank.py`` (numpy, with
torch tensors out).

Given a dense W [n_in, n_out] (e.g. a pretrained tensor-parallel weight),
``svd_phantom_init`` produces the best rank-k phantom factors per
off-diagonal block by truncated SVD, with the shared-compressor
constraint handled by stacking the row block's targets (C^(i) must serve
every destination j).
"""
from __future__ import annotations

import numpy as np
import torch


def _numpy(W) -> np.ndarray:
    if isinstance(W, torch.Tensor):
        W = W.detach().cpu().numpy()
    return np.asarray(W, np.float64)


def svd_phantom_init(W, p: int, k: int):
    """Factor W [n_in, n_out] into global phantom params {L, C, D}.

    For row block i, the compressor C^(i) [n_in/p, k] must serve all p-1
    destinations: it is the top-k left singular vectors of the
    concatenated off-diagonal row block W^(i, !=i) [n_in/p, (p-1)n_out/p],
    and D^(i,j) = C^(i)^T W^(i,j) (least squares given C).
    """
    W = _numpy(W)
    n_in, n_out = W.shape
    bi, bo = n_in // p, n_out // p
    L = np.zeros((p, bi, bo))
    C = np.zeros((n_in, k))
    D = np.zeros((p, k, n_out))
    for i in range(p):
        rows = slice(i * bi, (i + 1) * bi)
        L[i] = W[rows, i * bo:(i + 1) * bo]
        off = np.concatenate(
            [W[rows, j * bo:(j + 1) * bo] for j in range(p) if j != i],
            axis=1) if p > 1 else np.zeros((bi, 0))
        if off.shape[1]:
            u, _, _ = np.linalg.svd(off, full_matrices=False)
            basis = u[:, :k]                      # [bi, k]
        else:
            basis = np.eye(bi)[:, :k]
        C[rows, :basis.shape[1]] = basis
        for j in range(p):
            if j != i:
                D[i, :, j * bo:(j + 1) * bo] = \
                    basis.T @ W[rows, j * bo:(j + 1) * bo]
    return {name: torch.from_numpy(a.astype(np.float32))
            for name, a in (("L", L), ("C", C), ("D", D))}


def block_lowrank_error(W, p: int, k: int) -> float:
    """Relative Frobenius error of the best phantom approximation of W."""
    from repro_torch.core.phantom import phantom_dense_equivalent
    W_hat = phantom_dense_equivalent(svd_phantom_init(W, p, k))
    W = torch.from_numpy(_numpy(W).astype(np.float32))
    return float(torch.linalg.norm(W - W_hat) / torch.linalg.norm(W))
