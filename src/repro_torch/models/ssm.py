"""Mamba-2 (SSD, arXiv:2405.21060) block: chunked scan + recurrent decode.

Port of ``repro.models.ssm``. State space:

    h_t = exp(dt_t * A_h) h_{t-1} + dt_t * B_t x_t^T,    y_t = C_t h_t + D_h x_t

with A_h a scalar per head, B/C shared across head groups, x in
(B, L, H, P) heads x head_dim, state (H, P, N). The chunked (SSD) form
splits L into chunks of Q steps: an intra-chunk quadratic term (masked
(C B^T) against decay), a per-chunk state contribution, and an inter-chunk
linear recurrence over chunk states.

:func:`ssd_chunked` is the plain version (the CPU path, and the reference
the card compares K9 against); ``kernels.ssd.ssd_chunked_cuda`` runs the
intra-chunk block on K9. :func:`_ssd` picks one by ``SSMConfig.impl`` and
the device of the tensors. :func:`mamba_train` is the training form,
:func:`mamba_block` the prefill's (with the decode cache), and
:func:`mamba_decode` one token. A layer's weights are a dict
``{"win", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "norm",
"wout"}``; ``a_log``, ``d_skip``, ``dt_bias`` and ``norm`` stay float32,
as the JAX package reads them in float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.models import layers


def _dims(d_model: int, cfg: SSMConfig):
    d_in = cfg.expand * d_model
    nheads = cfg.num_heads or d_in // cfg.head_dim
    return d_in, nheads, cfg.num_groups, cfg.state_dim, cfg.conv_width


def init_mamba(gen: torch.Generator, d_model: int, cfg: SSMConfig, *, dtype,
               device) -> dict:
    """Random weights with the distributions of ``repro.models.ssm.init_mamba``;
    matmul and conv weights in ``dtype``."""
    d_in, h, g, n, w = _dims(d_model, cfg)
    conv_ch = d_in + 2 * g * n

    def normal(shape, scale):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    f32 = dict(dtype=torch.float32, device=device)
    dt_init = torch.log(torch.expm1(torch.linspace(1e-3, 0.1, h, **f32)))  # softplus^-1
    return {
        # order of the projection: [z(d_in), x(d_in), B(g*n), C(g*n), dt(h)]
        "win": normal((d_model, 2 * d_in + 2 * g * n + h), 1.0 / math.sqrt(d_model)),
        "conv_w": normal((w, conv_ch), 0.1),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "d_skip": torch.ones((h,), **f32),
        "dt_bias": dt_init,
        "norm": torch.zeros((d_in,), **f32),
        "wout": normal((d_in, d_model), 1.0 / math.sqrt(d_in)),
    }


def _split_proj(proj, d_in, g, n, h):
    z = proj[..., :d_in]
    xbc = proj[..., d_in: 2 * d_in + 2 * g * n]
    dt = proj[..., 2 * d_in + 2 * g * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, L, C) with kernel (W, C)."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i: i + xbc.shape[1], :] * w[i][None, None, :] for i in range(width))
    return F.silu(out + b[None, None, :])


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int,
                h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain chunked scan. x (B, L, H, P) pre-scaled inputs, dt (B, L, H)
    positive step sizes, a (H,) negative decay rates, b_mat / c_mat
    (B, L, G, N), h0 (B, H, P, N). Returns (y (B, L, H, P), final state
    (B, H, P, N) float32)."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        # dt = 0 padding: decay exp(0) = 1 and a zero update leave the state exact.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    l_pad = l + pad
    nc = l_pad // q
    f32 = torch.float32

    xc = x.reshape(bsz, nc, q, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    bh = b_mat.reshape(bsz, nc, q, g, n).to(f32).repeat_interleave(rep, dim=3)
    ch = c_mat.reshape(bsz, nc, q, g, n).to(f32).repeat_interleave(rep, dim=3)

    acum = torch.cumsum(dtc * a.to(f32)[None, None, None, :], dim=2)   # (B,nc,q,H)
    xdt = xc * dtc[..., None]

    # Intra-chunk: Y[i] = sum_{j<=i} C_i.B_j exp(acum_i - acum_j) xdt_j
    seg = acum[:, :, :, None, :] - acum[:, :, None, :, :]               # (B,nc,i,j,H)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    # Mask in log space BEFORE exp: above the diagonal seg is positive and
    # exp() overflows.
    seg = torch.where(mask[None, None, :, :, None], seg, torch.full_like(seg, -1e30))
    cb = torch.einsum("bcihn,bcjhn->bcijh", ch, bh)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb * torch.exp(seg), xdt)

    # Chunk state: S_c = sum_j exp(acum_last - acum_j) B_j (x) xdt_j
    last = acum[:, :, -1:, :]
    s_c = torch.einsum("bcjhn,bcjhp->bchpn", bh * torch.exp(last - acum)[..., None], xdt)

    # Inter-chunk recurrence over chunk states (the state entering each chunk).
    chunk_decay = torch.exp(last[:, :, 0, :])                            # (B,nc,H)
    hprev = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device) if h0 is None \
        else h0.to(f32)
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + s_c[:, c]
    h_in = torch.stack(h_in, dim=1)                                      # (B,nc,H,P,N)

    y_inter = torch.einsum("bcihn,bchpn->bcihp", ch * torch.exp(acum)[..., None], h_in)
    y = (y_intra + y_inter).reshape(bsz, l_pad, h, p)[:, :l]
    return y.to(x.dtype), hprev


def ssd_recurrent_ref(x, dt, a, b_mat, c_mat, h0=None):
    """O(L) exact recurrence: the test oracle for :func:`ssd_chunked`."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    f32 = torch.float32
    bh = b_mat.repeat_interleave(rep, dim=2).to(f32)
    ch = c_mat.repeat_interleave(rep, dim=2).to(f32)
    hs = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device) if h0 is None \
        else h0.to(f32)
    ys = []
    for t in range(l):
        dtt = dt[:, t].to(f32)
        dec = torch.exp(dtt * a.to(f32)[None, :])
        upd = torch.einsum("bhn,bhp->bhpn", bh[:, t], x[:, t].to(f32) * dtt[..., None])
        hs = hs * dec[:, :, None, None] + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", ch[:, t], hs))
    return torch.stack(ys, dim=1).to(x.dtype), hs


def _ssd(cfg: SSMConfig, x: torch.Tensor):
    """The chunked SSD of ``cfg.impl``: ``"auto"`` runs K9
    (``ssd_chunked_cuda``) on CUDA tensors and the plain version on CPU
    tensors; ``"cuda"`` and ``"plain"`` pin one."""
    impl = plan_lib.resolve_impl(cfg.impl, x.device.type)
    return ssd_kernel.ssd_chunked_cuda if impl == "cuda" else ssd_chunked


def _split_inputs(p, proj, d_model: int, cfg: SSMConfig):
    """The projection's gate z, conv channels xbc, step sizes dt and the
    per-head decay rate a (negative), dt and a in float32."""
    d_in, h, g, n, _ = _dims(d_model, cfg)
    z, xbc, dt_raw = _split_proj(proj, d_in, g, n, h)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    return z, xbc, dt, a


def _finish(p, y, xs, z, d_in):
    """Skip term, gate, norm and the output projection of a block."""
    y = y + xs * p["d_skip"].to(y.dtype)[..., :, None]
    y = y.reshape(*y.shape[:-2], d_in)
    y = layers.rmsnorm(p["norm"], y * F.silu(z))
    return y @ p["wout"].to(y.dtype)


def _scan_inputs(p, x, d_model: int, cfg: SSMConfig):
    """A full-sequence block up to the scan: the gate z, the conv channels
    before the conv (the decode cache's history), dt, a, and the scan's x,
    B and C, cut from the conv's output."""
    d_in, h, g, n, _ = _dims(d_model, cfg)
    b, length, _ = x.shape
    proj = x @ p["win"].to(x.dtype)
    z, xbc, dt, a = _split_inputs(p, proj, d_model, cfg)
    xbc_conv = _causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    xs = xbc_conv[..., :d_in].reshape(b, length, h, d_in // h)
    b_mat = xbc_conv[..., d_in: d_in + g * n].reshape(b, length, g, n)
    c_mat = xbc_conv[..., d_in + g * n:].reshape(b, length, g, n)
    return z, xbc, dt, a, xs, b_mat, c_mat


def mamba_train(p: dict, x: torch.Tensor, d_model: int, cfg: SSMConfig) -> torch.Tensor:
    """The training form of the block, x (B, L, D) -> (B, L, D): the JAX
    package's ``mamba_block``, over the whole unpadded sequence, with no
    decode cache. Differentiable in x and every weight; on the card the
    intra-chunk block runs K9 forward (``ssd.SSDIntraChunk``)."""
    z, _, dt, a, xs, b_mat, c_mat = _scan_inputs(p, x, d_model, cfg)
    y, _ = _ssd(cfg, x)(xs, dt, a, b_mat, c_mat, cfg.chunk)
    return _finish(p, y, xs, z, _dims(d_model, cfg)[0])


def mamba_block(p: dict, x: torch.Tensor, d_model: int, cfg: SSMConfig, *,
                last_positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence Mamba-2 block, x (B, L, D) -> (y (B, L, D), decode
    cache ``{"conv", "ssm"}``): the JAX package's ``mamba_block`` and the
    prefill's ``transformer._mamba_with_cache`` in one.

    ``last_positions`` (B,): each row's last real position in a
    right-padded batch (default L - 1). The cache is the one the unpadded
    prompt would leave: dt is 0 past ``last_positions`` (decay 1, no
    update: the state stays exact, the same trick as :func:`ssd_chunked`'s
    own padding), and the conv history is the ``w - 1`` pre-activation rows
    that end at ``last_positions``, zeros before position 0. Outputs at
    real positions do not depend on the padding."""
    d_in, _, _, _, w = _dims(d_model, cfg)
    b, length, _ = x.shape
    z, xbc, dt, a, xs, b_mat, c_mat = _scan_inputs(p, x, d_model, cfg)
    if last_positions is None:
        last = torch.full((b,), length - 1, dtype=torch.long, device=x.device)
    else:
        last = last_positions.to(x.device).long()
        live = torch.arange(length, device=x.device)[None, :] <= last[:, None]
        dt = torch.where(live[..., None], dt, torch.zeros_like(dt))
    y, h_final = _ssd(cfg, x)(xs, dt, a, b_mat, c_mat, cfg.chunk)
    out = _finish(p, y, xs, z, d_in)
    # Pre-activation history: rows last - w + 2 .. last, zeros before 0.
    hist = F.pad(xbc, (0, 0, w - 1, 0))
    idx = last[:, None] + 1 + torch.arange(w - 1, device=x.device)[None, :]
    conv = torch.gather(hist, 1, idx[..., None].expand(b, w - 1, xbc.shape[-1]))
    return out, {"conv": conv, "ssm": h_final}


def init_mamba_cache(d_model: int, cfg: SSMConfig, batch: int, dtype, device) -> dict:
    d_in, h, g, n, w = _dims(d_model, cfg)
    return {
        "conv": torch.zeros((batch, w - 1, d_in + 2 * g * n), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, d_in // h, n), dtype=torch.float32, device=device),
    }


def mamba_decode(p: dict, x: torch.Tensor, d_model: int, cfg: SSMConfig,
                 cache: dict) -> Tuple[torch.Tensor, dict]:
    """One-token step, x (B, 1, D). The cache (possibly a view of the
    serving backend's slots) is updated in place and returned."""
    d_in, h, g, n, w = _dims(d_model, cfg)
    bsz = x.shape[0]
    proj = x[:, 0] @ p["win"].to(x.dtype)
    z, xbc, dt, a = _split_inputs(p, proj, d_model, cfg)
    hist = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)          # (B, w, C)
    conv = torch.einsum("bwc,wc->bc", hist, p["conv_w"].to(x.dtype)) + p["conv_b"].to(x.dtype)
    xbc = F.silu(conv)
    xs = xbc[:, :d_in].reshape(bsz, h, d_in // h)
    rep = h // g
    bh = xbc[:, d_in: d_in + g * n].reshape(bsz, g, n).repeat_interleave(rep, dim=1).float()
    ch = xbc[:, d_in + g * n:].reshape(bsz, g, n).repeat_interleave(rep, dim=1).float()
    dec = torch.exp(dt * a[None, :])
    upd = torch.einsum("bhn,bhp->bhpn", bh, xs.float() * dt[..., None])
    hnew = cache["ssm"] * dec[:, :, None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", ch, hnew).to(x.dtype)
    out = _finish(p, y, xs, z, d_in)[:, None]
    cache["conv"].copy_(hist[:, 1:])
    cache["ssm"].copy_(hnew)
    return out, cache
