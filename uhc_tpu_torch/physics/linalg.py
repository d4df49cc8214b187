"""Batched blocked Cholesky (PyTorch twin of uhc_tpu.physics.linalg).

The plain version of the factorization the control-step kernel does in its
own body: matrices are padded to a multiple of 16 with an identity tail,
factored in 16×16 panels, and solved block-forward/backward with the
inverse diagonal blocks kept from the factorization.
"""
from __future__ import annotations

import torch

BS = 16  # block size


def _pad_spd(A: torch.Tensor, n_pad: int) -> torch.Tensor:
    n = A.shape[-1]
    if n == n_pad:
        return A
    out = A.new_zeros(A.shape[:-2] + (n_pad, n_pad))
    out[..., :n, :n] = A
    idx = torch.arange(n, n_pad, device=A.device)
    out[..., idx, idx] = 1.0
    return out


def _chol_block(D: torch.Tensor) -> torch.Tensor:
    """Cholesky of (..., BS, BS) SPD blocks -> lower L (column by column)."""
    L = torch.zeros_like(D)
    rows = torch.arange(BS, device=D.device)
    for j in range(BS):
        if j == 0:
            s = D[..., :, 0]
        else:
            s = D[..., :, j] - torch.einsum("...ik,...k->...i",
                                            L[..., :, :j], L[..., j, :j])
        d = torch.sqrt(torch.clamp(s[..., j], min=1e-12))
        col = s / d[..., None]
        L[..., :, j] = col * (rows >= j).to(D.dtype)
    return L


def _tri_inv_lower(L: torch.Tensor) -> torch.Tensor:
    """Inverse of lower-triangular (..., BS, BS) blocks (forward
    substitution against the identity)."""
    X = torch.zeros_like(L)
    idx = torch.arange(BS, device=L.device)
    inv_diag = 1.0 / L[..., idx, idx]
    for i in range(BS):
        if i == 0:
            row = L.new_zeros(L.shape[:-2] + (BS,))
        else:
            row = torch.einsum("...k,...kj->...j", L[..., i, :i],
                               X[..., :i, :])
        e_i = L.new_zeros(BS)
        e_i[i] = 1.0
        X[..., i, :] = (e_i - row) * inv_diag[..., i, None]
    return X


def blocked_cholesky(A: torch.Tensor, n_pad: int | None = None):
    """Factor SPD (..., n, n) -> (L (..., nb, nb, BS, BS) lower blocks,
    Linv (..., nb, BS, BS) inverse diagonal blocks)."""
    n = A.shape[-1]
    if n_pad is None:
        n_pad = -(-n // BS) * BS
    A = _pad_spd(A, n_pad)
    nb = n_pad // BS
    batch = A.shape[:-2]
    S = A.reshape(batch + (nb, BS, nb, BS)).movedim(-2, -3).clone()
    L = torch.zeros_like(S)
    Linv = A.new_zeros(batch + (nb, BS, BS))
    for k in range(nb):
        Lkk = _chol_block(S[..., k, k, :, :])
        Lkk_inv = _tri_inv_lower(Lkk)
        L[..., k, k, :, :] = Lkk
        Linv[..., k, :, :] = Lkk_inv
        if k + 1 < nb:
            panel = torch.einsum("...nab,...cb->...nac",
                                 S[..., k + 1:, k, :, :], Lkk_inv)
            L[..., k + 1:, k, :, :] = panel
            upd = torch.einsum("...nab,...mcb->...nmac", panel, panel)
            S[..., k + 1:, k + 1:, :, :] -= upd
    return L, Linv


def blocked_cho_solve(LL, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given `blocked_cholesky` output; b is (..., n) or
    (..., n, k)."""
    L, Linv = LL
    nb = Linv.shape[-3]
    n_pad = nb * BS
    vec = b.dim() == L.dim() - 3
    if vec:
        b = b[..., None]
    n = b.shape[-2]
    if n < n_pad:
        b = torch.cat([b, b.new_zeros(b.shape[:-2] + (n_pad - n,
                                                      b.shape[-1]))], -2)
    batch = b.shape[:-2]
    bb = b.reshape(batch + (nb, BS, -1))
    y = torch.zeros_like(bb)
    for i in range(nb):
        acc = bb[..., i, :, :]
        for j in range(i):
            acc = acc - torch.matmul(L[..., i, j, :, :], y[..., j, :, :])
        y[..., i, :, :] = torch.matmul(Linv[..., i, :, :], acc)
    x = torch.zeros_like(y)
    for i in reversed(range(nb)):
        acc = y[..., i, :, :]
        for j in range(i + 1, nb):
            acc = acc - torch.matmul(L[..., j, i, :, :].transpose(-1, -2),
                                     x[..., j, :, :])
        x[..., i, :, :] = torch.matmul(Linv[..., i, :, :].transpose(-1, -2),
                                       acc)
    x = x.reshape(batch + (n_pad, -1))[..., :n, :]
    return x[..., 0] if vec else x
