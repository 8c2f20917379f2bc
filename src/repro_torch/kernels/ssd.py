"""K9: the Mamba-2 SSD intra-chunk block — the CUDA kernel, its plain
version, and the chunked scan around it.

Port of ``repro.kernels.ssd``: ``ssd_intra_chunk`` (the Pallas kernel
``_ssd_chunk_kernel``) and ``ssd_chunked_pallas``, here
:func:`ssd_chunked_cuda`. Per (batch, chunk, head) the kernel computes

   y_intra = ((C Bᵀ) ⊙ L) · (dt·x),     L_ij = exp(acum_i - acum_j)·[j<=i]
   S_c     = (B ⊙ exp(acum_last - acum))ᵀ · (dt·x)

(``csrc/ssd.cu``: 64 query rows at a time against 64-key tiles, blocks
numbered head-first over chunks). :func:`ssd_intra_chunk` launches it for
CUDA tensors and runs :func:`ssd_intra_chunk_plain` for CPU tensors. The
cumsum, the padding and the inter-chunk recurrence are PyTorch in
:func:`ssd_chunked_cuda`, as they are jnp in the JAX package. The kernel
has no backward (nor has the Pallas one): under grad mode it raises.
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
    """What K9 computes, in plain PyTorch: ``(y_intra (B,nc,H,q,P),
    chunk_states (B,nc,H,N,P))``, in float32 (float64 inputs stay float64:
    the reference that both float32 routes are read against)."""
    f = torch.promote_types(xdt.dtype, torch.float32)
    xdt, bh, ch, acum = (t.to(f) for t in (xdt, bh, ch, acum))
    q = xdt.shape[3]
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
        _fn = build.bind("ssd", "ssd_intra_chunk", [P] * 6 + [I] * 6 + [P])
    return _fn


def _check_inputs(xdt, bh, ch, acum):
    dev = xdt.device
    for name, t in (("xdt", xdt), ("bh", bh), ("ch", ch), ("acum", acum)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, xdt on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, nc, h, q, p = xdt.shape
    n = bh.shape[-1]
    if bh.shape != (b, nc, h, q, n) or ch.shape != bh.shape or acum.shape != (b, nc, h, q):
        raise ValueError("bh / ch / acum shapes do not match xdt")
    if (n, p) not in SHAPES:
        raise ValueError(f"(state N, head P) = ({n}, {p}) not in {SHAPES}")


def ssd_intra_chunk(xdt, bh, ch, acum) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt (B,nc,H,q,P) dt-scaled inputs, bh / ch (B,nc,H,q,N), acum
    (B,nc,H,q) inclusive cumsum of dt*A, all float32. Returns
    ``(y_intra (B,nc,H,q,P), chunk_states (B,nc,H,N,P))`` float32.

    CUDA tensors launch K9; CPU tensors take the plain version."""
    if xdt.device.type == "cpu":
        return ssd_intra_chunk_plain(xdt, bh, ch, acum)
    _check_inputs(xdt, bh, ch, acum)
    build.refuse_grad("ssd_intra_chunk", xdt, bh, ch, acum)
    b, nc, h, q, p = xdt.shape
    n = bh.shape[-1]
    y = torch.empty_like(xdt)
    s = torch.empty((b, nc, h, n, p), dtype=torch.float32, device=xdt.device)
    global launches
    launches += 1
    status = _kernel()(xdt.data_ptr(), bh.data_ptr(), ch.data_ptr(), acum.data_ptr(),
                       y.data_ptr(), s.data_ptr(), b, nc, h, q, p, n,
                       build.stream_of(xdt))
    build.check(status, "ssd_intra_chunk")
    return y, s


def ssd_chunked_cuda(x, dt, a, b_mat, c_mat, chunk: int,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``models.ssm.ssd_chunked`` with the intra-chunk block on
    K9: x (B, L, H, P), dt (B, L, H), a (H,), b_mat / c_mat (B, L, G, N),
    h0 (B, H, P, N). Returns ``(y (B, L, H, P) in x's dtype, final state
    (B, H, P, N) float32)``. Same padding (dt = 0 keeps the state exact)
    and initial-state semantics."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    l_pad = l + pad
    nc = l_pad // q
    f32 = torch.float32

    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    acum = torch.cumsum(dtc * a.to(f32)[None, None, None, :], dim=2)    # (B,nc,q,H)
    xdt = x.reshape(bsz, nc, q, h, p).to(f32) * dtc[..., None]
    bh = b_mat.reshape(bsz, nc, q, g, n).to(f32).repeat_interleave(rep, dim=3)
    ch = c_mat.reshape(bsz, nc, q, g, n).to(f32).repeat_interleave(rep, dim=3)

    y_intra, s_c = ssd_intra_chunk(
        xdt.permute(0, 1, 3, 2, 4).contiguous(),                         # (B,nc,H,q,P)
        bh.permute(0, 1, 3, 2, 4).contiguous(),
        ch.permute(0, 1, 3, 2, 4).contiguous(),
        acum.permute(0, 1, 3, 2).contiguous(),                           # (B,nc,H,q)
    )
    y_intra = y_intra.permute(0, 1, 3, 2, 4)                             # (B,nc,q,H,P)
    s_c = s_c.transpose(-1, -2)                                          # (B,nc,H,P,N)

    # Inter-chunk recurrence and the cross-chunk output term (cheap; a loop
    # over the L/q chunks takes the place of the JAX package's scan).
    chunk_decay = torch.exp(acum[:, :, -1, :])                           # (B,nc,H)
    hprev = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device) if h0 is None
             else h0.to(f32))
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + s_c[:, c]
    h_in = torch.stack(h_in, dim=1)                                      # (B,nc,H,P,N)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", ch * torch.exp(acum)[..., None], h_in)
    y = (y_intra + y_inter).reshape(bsz, l_pad, h, p)[:, :l]
    return y.to(x.dtype), hprev
