"""K9: the Mamba-2 SSD intra-chunk block — the CUDA kernel, its plain
version, and the chunked scan around it.

Port of ``repro.kernels.ssd``: ``ssd_intra_chunk`` (the Pallas kernel
``_ssd_chunk_kernel``) and ``ssd_chunked_pallas``, here
:func:`ssd_chunked_cuda`. Per (batch, chunk, head) the kernel computes

   y_intra = ((C Bᵀ) ⊙ L) · (dt·x),     L_ij = exp(acum_i - acum_j)·[j<=i]
   S_c     = (B ⊙ exp(acum_last - acum))ᵀ · (dt·x)

(``csrc/ssd.cu``, ``ssd_intra_chunk_tc``: all three products on the tensor
cores in 3xTF32, each float32 operand split into two TF32 halves, so the
result keeps float32 accuracy; 128 query rows at a time against key tiles
up to the diagonal, blocks numbered head-first over chunks). The kernel
reads its inputs through their strides, in the layout the scan makes them:
xdt (B, nc, q, H, P), acum (B, nc, q, H), and B and C per group, (B, nc, q,
G, N), head h reading group ``h // (H // G)``; it writes y in xdt's layout
and the chunk state as (B, nc, H, P, N), the order the recurrence reads.
:func:`ssd_intra_chunk_seq` takes that layout; :func:`ssd_intra_chunk` the
JAX package's (B, nc, H, q, ·), as views. Both launch the kernel for CUDA
tensors and run :func:`ssd_intra_chunk_plain` for CPU tensors. The cumsum,
the padding and the inter-chunk recurrence are PyTorch in
:func:`ssd_chunked_cuda`, as they are jnp in the JAX package.

The kernel has no backward (nor has the Pallas one), so the two bare
entries raise under grad mode. :func:`ssd_chunked_cuda` differentiates
through :class:`SSDIntraChunk`, an autograd Function whose forward is
:func:`ssd_intra_chunk_seq` and whose backward, :func:`ssd_intra_chunk_bwd`,
is written out in PyTorch ops: the counterpart of JAX's autodiff of the
XLA SSD, which the reference trains through.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

NEG_INF = -1e30
#: (state N, head P) pairs the CUDA build instantiates.
SHAPES = ((16, 64), (128, 64), (16, 128), (128, 128))

#: Launches of the CUDA kernel since the last reset.
launches = 0


def ssd_intra_chunk_plain(xdt, bh, ch, acum) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K9 computes, in plain PyTorch, in the JAX package's layout:
    xdt (B,nc,H,q,P), bh / ch (B,nc,G,q,N) with G dividing H (G == H: one
    per head), acum (B,nc,H,q), any strides. Returns ``(y_intra
    (B,nc,H,q,P), chunk_states (B,nc,H,N,P))``, in float32 (float64 inputs
    stay float64: the reference that both float32 routes are read against).
    Inputs are made contiguous first, so a strided view gives the bits of
    its contiguous copy."""
    f = torch.promote_types(xdt.dtype, torch.float32)
    xdt, bh, ch, acum = (t.to(f).contiguous() for t in (xdt, bh, ch, acum))
    h, q = xdt.shape[2], xdt.shape[3]
    rep = h // bh.shape[2]
    if rep > 1:
        bh, ch = bh.repeat_interleave(rep, dim=2), ch.repeat_interleave(rep, dim=2)
    cb = torch.einsum("bchin,bchjn->bchij", ch, bh)
    seg = acum[..., :, None] - acum[..., None, :]
    causal = torch.ones((q, q), dtype=torch.bool, device=xdt.device).tril()
    # Mask in log space BEFORE exp (above-diagonal seg > 0 overflows).
    seg = torch.where(causal, seg, torch.full_like(seg, NEG_INF))
    y = torch.einsum("bchij,bchjp->bchip", cb * torch.exp(seg), xdt)
    dte = torch.exp(acum[..., -1:] - acum)
    s = torch.einsum("bchjn,bchjp->bchnp", bh * dte[..., None], xdt)
    return y, s


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = build.bind("ssd", "ssd_intra_chunk_tc", [P] * 7 + [I] * 7 + [P])
    return _fn


def _rows_aligned(t: torch.Tensor) -> bool:
    """Last dimension contiguous and every row 16-byte aligned: what the
    kernel's 16-byte copies need."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in t.stride()[:-1]))


def _check_inputs(xdt, bh, ch, acum):
    dev = xdt.device
    for name, t in (("xdt", xdt), ("bh", bh), ("ch", ch), ("acum", acum)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, xdt on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32")
    b, nc, q, h, p = xdt.shape
    g, n = bh.shape[3], bh.shape[4]
    if (bh.shape != (b, nc, q, g, n) or ch.shape != bh.shape
            or acum.shape != (b, nc, q, h)):
        raise ValueError("bh / ch / acum shapes do not match xdt")
    if h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    if (n, p) not in SHAPES:
        raise ValueError(f"(state N, head P) = ({n}, {p}) not in {SHAPES}")


def ssd_intra_chunk_seq(xdt, bh, ch, acum) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 in the layout :func:`ssd_chunked_cuda` makes: xdt (B,nc,q,H,P)
    dt-scaled inputs, bh / ch (B,nc,q,G,N) per group (G divides H), acum
    (B,nc,q,H) inclusive cumsum of dt*A, all float32. Returns ``(y_intra
    (B,nc,q,H,P), chunk_states (B,nc,H,P,N))`` float32, both contiguous.

    CUDA tensors launch the kernel, which reads every input through its
    strides: no copy is made unless a tensor's last dimension is strided or
    one of its rows is not 16-byte aligned (acum, read a scalar at a time,
    never), and then that tensor alone is copied to a contiguous one first.
    The kernel keeps acum in shared memory beside its tiles, which bounds q
    (1664 at N 128, P 64; 8064 or more at the other shapes): a longer chunk
    raises ``ValueError``. CPU tensors take the plain version."""
    if xdt.device.type == "cpu":
        perm = (0, 1, 3, 2, 4)
        y, s = ssd_intra_chunk_plain(xdt.permute(perm), bh.permute(perm), ch.permute(perm),
                                     acum.permute(0, 1, 3, 2))
        return y.permute(perm).contiguous(), s.transpose(-1, -2).contiguous()
    _check_inputs(xdt, bh, ch, acum)
    build.refuse_grad("ssd_intra_chunk", xdt, bh, ch, acum)
    xdt, bh, ch = (t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
                   for t in (xdt, bh, ch))
    b, nc, q, h, p = xdt.shape
    g, n = bh.shape[3], bh.shape[4]
    y = torch.empty_like(xdt, memory_format=torch.contiguous_format)
    s = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=xdt.device)
    strides = (ctypes.c_longlong * 24)(
        *(st for t in (xdt, bh, ch, acum, y, s) for st in t.stride()[:4]))
    global launches
    launches += 1
    status = _kernel()(xdt.data_ptr(), bh.data_ptr(), ch.data_ptr(), acum.data_ptr(),
                       y.data_ptr(), s.data_ptr(), strides, b, nc, h, g, q, p, n,
                       build.stream_of(xdt))
    build.check(status, "ssd_intra_chunk")
    return y, s


def ssd_intra_chunk_bwd(xdt, bq, cq, acum, dy, ds
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of :func:`ssd_intra_chunk_seq`'s inputs ``(xdt, bq, cq,
    acum)`` from those of its outputs, ``dy`` (B,nc,q,H,P) and ``ds``
    (B,nc,H,P,N), in float32, each in its input's layout. Per chunk and
    head h of group g, with ``L_ij = exp(acum_i - acum_j)`` on j <= i (0
    above), ``M_ij = (C_i.B_j) L_ij``, ``w_j = exp(acum_last - acum_j)``:

      G_ij    = (dy_i . xdt_j) L_ij
      dxdt_j  = sum_i M_ij dy_i + w_j (ds B_j)
      dC_i    = sum_j G_ij B_j,  dB_j = sum_i G_ij C_i + w_j (ds^T xdt_j),
                both summed over the heads of g
      dacum_i = sum_j Q_ij - sum_j Q_ji  with Q_ij = G_ij (C_i.B_j),
                plus the decay to the chunk's end: -dw_i w_i at every row and
                sum_j dw_j w_j at the last, dw_j = xdt_j . (ds B_j).

    L is masked in log space before the exp, as the forward is: above the
    diagonal acum_i - acum_j > 0 overflows, and 0 * inf would be NaN."""
    f32 = torch.float32
    b, nc, q, h, p = xdt.shape
    g, n = bq.shape[3], bq.shape[4]
    r = h // g
    perm = (0, 1, 3, 2, 4)
    x = xdt.to(f32).permute(perm).reshape(b, nc, g, r, q, p)            # (B,nc,G,R,q,P)
    dyh = dy.to(f32).permute(perm).reshape(b, nc, g, r, q, p)
    bg = bq.to(f32).permute(perm)                                        # (B,nc,G,q,N)
    cg = cq.to(f32).permute(perm)
    a = acum.to(f32).permute(0, 1, 3, 2).reshape(b, nc, g, r, q)        # (B,nc,G,R,q)
    dsh = ds.to(f32).reshape(b, nc, g, r, p, n)

    causal = torch.ones((q, q), dtype=torch.bool, device=xdt.device).tril()
    seg = torch.where(causal, a[..., :, None] - a[..., None, :],
                      torch.full((), NEG_INF, dtype=f32, device=xdt.device))
    lmat = torch.exp(seg)                                                # (B,nc,G,R,q,q)
    cb = (cg @ bg.transpose(-1, -2))[:, :, :, None]                      # (B,nc,G,1,q,q)
    gmat = (dyh @ x.transpose(-1, -2)) * lmat                            # G = dM . L
    w = torch.exp(a[..., -1:] - a)                                       # (B,nc,G,R,q)
    t = bg[:, :, :, None] @ dsh.transpose(-1, -2)                        # ds B_j: (..., q, P)
    dx = (cb * lmat).transpose(-1, -2) @ dyh + w[..., None] * t
    gsum = gmat.sum(3)                                                   # (B,nc,G,q,q)
    dc = gsum @ bg
    db = gsum.transpose(-1, -2) @ cg + ((w[..., None] * x) @ dsh).sum(3)
    qmat = gmat * cb
    dww = (x * t).sum(-1) * w                                            # dw_j w_j
    da = qmat.sum(-1) - qmat.sum(-2) - dww
    da[..., -1] += dww.sum(-1)
    return (dx.reshape(b, nc, h, q, p).permute(perm), db.permute(perm),
            dc.permute(perm), da.reshape(b, nc, h, q).permute(0, 1, 3, 2))


class SSDIntraChunk(torch.autograd.Function):
    """:func:`ssd_intra_chunk_seq` under autograd: the forward launches K9
    for CUDA tensors (the plain version for CPU ones; grad mode is off
    inside, so the wrapper's refusal lets it through) and the backward is
    :func:`ssd_intra_chunk_bwd`."""

    @staticmethod
    def forward(ctx, xdt, bq, cq, acum):
        ctx.save_for_backward(xdt, bq, cq, acum)
        return ssd_intra_chunk_seq(xdt, bq, cq, acum)

    @staticmethod
    def backward(ctx, dy, ds):
        return ssd_intra_chunk_bwd(*ctx.saved_tensors, dy, ds)


def ssd_intra_chunk(xdt, bh, ch, acum) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 in the JAX package's layout: xdt (B,nc,H,q,P), bh / ch
    (B,nc,G,q,N) with G dividing H (G == H: one per head, as the JAX
    function takes them), acum (B,nc,H,q), all float32, any strides.
    Returns ``(y_intra (B,nc,H,q,P), chunk_states (B,nc,H,N,P))`` float32;
    on the card both are views of :func:`ssd_intra_chunk_seq`'s outputs.

    CUDA tensors launch K9; CPU tensors take the plain version."""
    if xdt.device.type == "cpu":
        return ssd_intra_chunk_plain(xdt, bh, ch, acum)
    perm = (0, 1, 3, 2, 4)
    y, s = ssd_intra_chunk_seq(xdt.permute(perm), bh.permute(perm), ch.permute(perm),
                               acum.permute(0, 1, 3, 2))
    return y.permute(perm), s.transpose(-1, -2)


def chunk_inputs(x, dt, a, b_mat, c_mat, chunk: int):
    """The scan's preparation: pad L to a multiple of q = min(chunk, L)
    (dt = 0 keeps the state exact), then the kernel's inputs in the layout
    it reads, ``(xdt (B,nc,q,H,P), bq / cq (B,nc,q,G,N), acum (B,nc,q,H))``,
    all float32. B and C stay per group: no head is expanded."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    nc = (l + pad) // q
    f32 = torch.float32
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    acum = torch.cumsum(dtc * a.to(f32)[None, None, None, :], dim=2)
    xdt = x.reshape(bsz, nc, q, h, p).to(f32) * dtc[..., None]
    bq = b_mat.reshape(bsz, nc, q, g, n).to(f32)
    cq = c_mat.reshape(bsz, nc, q, g, n).to(f32)
    return xdt, bq, cq, acum


def inter_chunk(y_intra, s_c, cq, acum, length: int,
                h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over chunk states and the cross-chunk output term
    (cheap; a loop over the L/q chunks takes the place of the JAX package's
    scan): y_intra (B,nc,q,H,P) and s_c (B,nc,H,P,N) from the kernel, cq and
    acum from :func:`chunk_inputs`. Returns ``(y (B, length, H, P) float32,
    final state (B, H, P, N) float32)``."""
    bsz, nc, q, h, p = y_intra.shape
    g, n = cq.shape[3], cq.shape[4]
    chunk_decay = torch.exp(acum[:, :, -1, :])                           # (B,nc,H)
    hprev = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=y_intra.device)
             if h0 is None else h0.to(torch.float32))
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + s_c[:, c]
    h_in = torch.stack(h_in, dim=1).view(bsz, nc, g, h // g, p, n)      # (B,nc,G,H/G,P,N)
    # C per group against each of its heads' states, then the decay.
    y_inter = torch.einsum("bcqgn,bcgrpn->bcqgrp", cq, h_in).reshape(bsz, nc, q, h, p)
    y = y_intra + y_inter * torch.exp(acum)[..., None]
    return y.reshape(bsz, nc * q, h, p)[:, :length], hprev


def ssd_chunked_cuda(x, dt, a, b_mat, c_mat, chunk: int,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``models.ssm.ssd_chunked`` with the intra-chunk block on
    K9: x (B, L, H, P), dt (B, L, H), a (H,), b_mat / c_mat (B, L, G, N),
    h0 (B, H, P, N). Returns ``(y (B, L, H, P) in x's dtype, final state
    (B, H, P, N) float32)``. Same padding (dt = 0 keeps the state exact)
    and initial-state semantics. The kernel takes its inputs and gives its
    outputs in the layouts this function makes and reads: no permute, no
    repeat of B and C per head. Differentiable in every input: the
    intra-chunk block through :class:`SSDIntraChunk`, the rest through
    autograd."""
    xdt, bq, cq, acum = chunk_inputs(x, dt, a, b_mat, c_mat, chunk)
    y_intra, s_c = SSDIntraChunk.apply(xdt, bq, cq, acum)
    y, h_final = inter_chunk(y_intra, s_c, cq, acum, x.shape[1], h0)
    return y.to(x.dtype), h_final
