"""Plain PyTorch twins of the Mamba2 SSD (state-space dual) scan (port of
``repro.kernels.ssd_scan.ref``).

Per head h with scalar decay ``A_h < 0``, state S in R^{dh x ds}::

    a_t = exp(A dt_t)
    S_t = a_t S_{t-1} + (dt_t x_t) (outer) B_t
    y_t = S_t C_t  (+ D x_t skip handled by the caller)

``ssd_ref`` is the sequential recurrence (ground truth); ``ssd_chunked_ref``
is the vectorised chunked form the CUDA kernel mirrors (and the form the LM
substrate uses off the card); ``ssd_bwd_ref`` is the gradient of
``ssd_chunked_ref`` in the form the backward kernel computes it (the
reference has no backward kernel: it differentiates ``ssd_chunked_ref``
with ``jax.grad``).
"""
from __future__ import annotations

import torch

__all__ = ["ssd_ref", "ssd_chunked_ref", "ssd_bwd_ref"]


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


def ssd_bwd_ref(x, dt, A, B, C, dy, chunk: int = 64):
    """The gradient of ``ssd_chunked_ref(x, dt, A, B, C, chunk)[0]`` (zero
    initial state) against the cotangent ``dy``: ``(dx, ddt, dA, dB, dC)``.

    With u_s = dt_s x_s, W_ts = exp(cum_t - cum_s) (s <= t, masked before
    ``exp``) and G_n the adjoint of the state entering chunk n, carried
    backward over chunks as G_n = sum_t exp(cum_t) dy_t C_t^T + exp(cum_L)
    G_{n+1} (no division by a decay):

    * du_s = sum_t (C_t.B_s) W_ts dy_t + exp(cum_L - cum_s) G_{n+1} B_s;
      dx = dt du, and dt's direct part x.du;
    * dC_t = sum_s W_ts (dy_t.u_s) B_s + exp(cum_t) S_in^T dy_t and dB_s =
      sum_t W_ts (dy_t.u_s) C_t + exp(cum_L - cum_s) G_{n+1}^T u_s, per head,
      then summed over the heads (B and C are shared);
    * d cum_t from the decays: the row sums less the column sums of
      R_ts = (C_t.B_s) W_ts (dy_t.u_s), plus dy_t.y_inter_t, less
      u_t.(exp(cum_L - cum_t) G_{n+1} B_t), plus <G_{n+1}, S_in(n+1)> at the
      chunk's last step; d lam (lam = A dt) is its reverse cumulative sum
      (in float64, as dA's sum), giving dt's decay part A d lam and dA =
      sum dt d lam.
    """
    b, l, h, dh = x.shape
    ds = B.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of chunk {chunk}")
    nc, L = l // chunk, chunk
    xr = x.reshape(b, nc, L, h, dh)
    dtr = dt.reshape(b, nc, L, h)
    Br = B.reshape(b, nc, L, ds)
    Cr = C.reshape(b, nc, L, ds)
    dyr = dy.reshape(b, nc, L, h, dh)

    cum = torch.cumsum(A[None, None, None, :] * dtr, dim=2)  # (b,nc,L,h)
    u = dtr[..., None] * xr  # (b,nc,L,h,dh)
    to_end = torch.exp(cum[:, :, -1:, :] - cum)  # exp(cum_L - cum_s)
    decay = torch.exp(cum[:, :, -1, :])  # (b,nc,h)
    # the states entering each chunk, as the forward computes them
    inc = torch.einsum("bnsh,bnshd,bnsk->bnhdk", to_end, u, Br)
    S = torch.zeros(b, h, dh, ds, dtype=_state_dtype(x), device=x.device)
    S_ins = []
    for n in range(nc):
        S_ins.append(S)
        S = decay[:, n, :, None, None] * S + inc[:, n]
    S_ins = torch.stack(S_ins, dim=1)  # (b,nc,h,dh,ds)
    # the state adjoints, backward over chunks: G_next[n] = G_{n+1}
    g_loc = torch.einsum("bnth,bnthd,bntk->bnhdk", torch.exp(cum), dyr, Cr)
    g = torch.zeros_like(S)
    G_next = [None] * nc
    for n in reversed(range(nc)):
        G_next[n] = g
        g = g_loc[:, n] + decay[:, n, :, None, None] * g
    G_next = torch.stack(G_next, dim=1)
    # S_in(n + 1) beside G_{n+1} (the last chunk's G_next is zero)
    S_next = torch.cat([S_ins[:, 1:], S[:, None]], dim=1)

    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,t,s,h)
    mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    W = torch.exp(torch.where(mask[None, None, :, :, None], seg, float("-inf")))
    CB = torch.einsum("bntk,bnsk->bnts", Cr, Br)
    CBW = CB[..., None] * W
    dyU = torch.einsum("bnthd,bnshd->bntsh", dyr, u)
    M = W * dyU
    R = CBW * dyU

    du_inter = to_end[..., None] * torch.einsum("bnhdk,bnsk->bnshd", G_next, Br)
    du = torch.einsum("bntsh,bnthd->bnshd", CBW, dyr) + du_inter
    dx = dtr[..., None] * du
    ddt = (xr * du).sum(-1)

    dC_inter = torch.exp(cum)[..., None] * torch.einsum("bnthd,bnhdk->bnthk", dyr, S_ins)
    dC = torch.einsum("bntsh,bnsk->bnthk", M, Br) + dC_inter
    dB = (torch.einsum("bntsh,bntk->bnshk", M, Cr)
          + to_end[..., None] * torch.einsum("bnshd,bnhdk->bnshk", u, G_next))

    dcum = R.sum(3) - R.sum(2)
    dcum = dcum + (Cr[:, :, :, None, :] * dC_inter).sum(-1) - (u * du_inter).sum(-1)
    last = (G_next * S_next).sum((-2, -1))  # (b,nc,h)
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + last[:, :, None]], dim=2)
    # the reverse cumulative sum and dA's sum in float64, as the kernel
    # accumulates them (dA's terms are far larger than their sum)
    wide = torch.promote_types(dcum.dtype, torch.float64)
    dlam = torch.flip(torch.cumsum(torch.flip(dcum.to(wide), (2,)), dim=2), (2,))
    dA = (dtr.to(wide) * dlam).sum((0, 1, 2)).to(A.dtype)
    dlam = dlam.to(dcum.dtype)
    ddt = ddt + A * dlam
    return (dx.reshape(x.shape), ddt.reshape(dt.shape), dA,
            dB.sum(3).reshape(b, l, ds), dC.sum(3).reshape(b, l, ds))
