"""Plain PyTorch twins of the Mamba2 SSD (state-space dual) scan (port of
``repro.kernels.ssd_scan.ref``).

Per head h with scalar decay ``A_h < 0``, state S in R^{dh x ds}::

    a_t = exp(A dt_t)
    S_t = a_t S_{t-1} + (dt_t x_t) (outer) B_t
    y_t = S_t C_t  (+ D x_t skip handled by the caller)

``ssd_ref`` is the sequential recurrence (ground truth); ``ssd_chunked_ref``
is the vectorised chunked form the CUDA kernel mirrors (and the form the LM
substrate uses off the card).
"""
from __future__ import annotations

import torch

__all__ = ["ssd_ref", "ssd_chunked_ref"]


def _state_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)


def ssd_ref(x, dt, A, B, C, S0=None):
    """x: (b, l, h, dh); dt: (b, l, h); A: (h,); B, C: (b, l, ds).

    Returns y: (b, l, h, dh) and the final state (b, h, dh, ds).
    """
    b, l, h, dh = x.shape
    ds = B.shape[-1]
    S = S0 if S0 is not None else torch.zeros(b, h, dh, ds, dtype=_state_dtype(x),
                                              device=x.device)
    ys = []
    for t in range(l):
        xt, dtt, Bt, Ct = x[:, t], dt[:, t], B[:, t], C[:, t]
        a = torch.exp(A[None, :] * dtt)  # (b, h)
        dx = dtt[..., None] * xt  # (b, h, dh)
        S = a[..., None, None] * S + dx[..., None] * Bt[:, None, None, :]
        ys.append(torch.einsum("bhds,bs->bhd", S, Ct))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros(x.shape, dtype=S.dtype)
    return y, S


def ssd_chunked_ref(x, dt, A, B, C, chunk: int = 64, S0=None):
    """Chunked SSD: intra-chunk attention-like term + inter-chunk state pass."""
    b, l, h, dh = x.shape
    ds = B.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of chunk {chunk}")
    nc = l // chunk
    S = S0 if S0 is not None else torch.zeros(b, h, dh, ds, dtype=_state_dtype(x),
                                              device=x.device)

    xr = x.reshape(b, nc, chunk, h, dh)
    dtr = dt.reshape(b, nc, chunk, h)
    Br = B.reshape(b, nc, chunk, ds)
    Cr = C.reshape(b, nc, chunk, ds)

    lam = A[None, None, None, :] * dtr  # (b,nc,L,h) log-decay increments
    cum = torch.cumsum(lam, dim=2)  # inclusive cumsum
    # intra-chunk: M[t, s] = (C_t . B_s) * exp(cum_t - cum_s) for s <= t
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,t,s,h)
    mask = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = torch.where(mask[None, None, :, :, None], seg, float("-inf"))
    CB = torch.einsum("bnts,bnus->bntu", Cr, Br)  # (b,nc,t,s)
    M = CB[..., None] * torch.exp(seg)  # (b,nc,t,s,h)
    dx = dtr[..., None] * xr  # (b,nc,L,h,dh)
    y_intra = torch.einsum("bntsh,bnshd->bnthd", M, dx)

    # inter-chunk: states at chunk boundaries.
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b,nc,h)
    inc = torch.einsum("bnsh,bnshd,bnsk->bnhdk",
                       torch.exp(cum[:, :, -1:, :] - cum), dx, Br)  # (b,nc,h,dh,ds)
    S_ins = []
    for n in range(nc):
        S_ins.append(S)  # state entering chunk n
        S = chunk_decay[:, n, :, None, None] * S + inc[:, n]
    S_ins = torch.stack(S_ins, dim=1)  # (b,nc,h,dh,ds)

    y_inter = torch.einsum("bnth,bnhdk,bntk->bnthd", torch.exp(cum), S_ins, Cr)
    y = (y_intra + y_inter).reshape(b, l, h, dh)
    return y, S
