"""Mamba2 block: the SSD (state-space duality) chunked forward and the
recurrent one-token decode (the JAX package's ``repro.models.mamba2``).

The minimal SSD algorithm (Dao & Gu 2024, arXiv:2405.21060): a quadratic
attention-like term within each chunk and a linear recurrence across
chunks. The state of a layer is (B, H, P, N): H SSM heads of P channels,
N state entries each, whatever the sequence length. One group (G = 1)
for the B/C projections, as in mamba2-370m.

Numerics follow the reference: the four contractions accumulate in f32
(the reference's ``preferred_element_type``; a bf16 operand is upcast,
and a bf16 x bf16 product is exact in f32), and the mask and the scaled
inputs round back to the model dtype where the reference rounds them.
``ssd_chunked`` needs the sequence to be a multiple of the chunk, as the
reference's does; nothing pads a prompt.

``mamba_decode`` writes the conv window and the SSM state IN PLACE (the
reference donates its decode state and returns updated copies): the
tensors it returns are the ones it was given.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dense_init, rmsnorm, rmsnorm_init

f32 = torch.float32


def mamba_init(generator, cfg: ModelConfig, device, lead=()) -> dict:
    """The reference's shapes and scales; ``lead``: leading stack axes."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    lead = tuple(lead)
    dt = cfg.param_dtype
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=device))
    return {
        # in_proj's columns: [z (di), x (di), B (n), C (n), dt (h)]
        "in_proj": _dense_init(generator, lead + (d, 2 * di + 2 * n + h), dt,
                               None, device, fan_in=d),
        "conv_w": _dense_init(generator, lead + (cfg.conv_width, conv_dim),
                              dt, 1.0 / math.sqrt(cfg.conv_width), device),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dt, device=device),
        "A_log": a_log.expand(lead + (h,)).contiguous(),
        "D": torch.ones(lead + (h,), dtype=f32, device=device),
        "dt_bias": torch.zeros(lead + (h,), dtype=f32, device=device),
        "norm": rmsnorm_init(di, dt, device, lead),
        "out_proj": _dense_init(generator, lead + (di, d), dt,
                                1.0 / math.sqrt(di * 2 * cfg.num_layers),
                                device),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) lower-triangular cumulative segment
    sums, -inf above the diagonal (whose exp, and its gradient, is 0)."""
    t = x.shape[-1]
    csum = torch.cumsum(x, dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, torch.full_like(diff, -math.inf))


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int):
    """SSD scan. x: (B, S, H, P); dt: (B, S, H) f32; a_log: (H,); b, c:
    (B, S, N). Returns y (B, S, H, P) in x's dtype and the final state
    (B, H, P, N) f32."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the SSD chunk "
                         f"{chunk}")
    nc = s // chunk
    a = -torch.exp(a_log)                                     # (H,)
    dta = (dt * a).to(f32)                                    # (B, S, H)

    xc = x.reshape(bs, nc, chunk, h, p)
    dtc = dt.reshape(bs, nc, chunk, h).to(f32).transpose(2, 3)  # (B,nc,H,Q)
    dtac = dta.reshape(bs, nc, chunk, h).transpose(2, 3)      # (B,nc,H,Q)
    bc = b.reshape(bs, nc, chunk, n).to(f32)
    cc = c.reshape(bs, nc, chunk, n).to(f32)
    dtac_cs = torch.cumsum(dtac, dim=-1)                      # (B,nc,H,Q)

    # 1. within each chunk: the mask M = CB . L . dt, (B, nc, H, Q, Q),
    #    then one batched (Q, Q) x (Q, P) product with X
    l = torch.exp(_segsum(dtac))
    cb = torch.einsum("bcln,bcsn->bcls", cc, bc)              # (B,nc,Q,Q)
    m = cb[:, :, None] * l * dtc[:, :, :, None, :]
    y_diag = torch.einsum("bchls,bcshp->bclhp", m.to(x.dtype).to(f32),
                          xc.to(f32))

    # 2. each chunk's state (B, nc, H, P, N): X scaled by decay * dt
    decay_out = torch.exp(dtac_cs[..., -1:] - dtac_cs)        # (B,nc,H,Q)
    w = decay_out * dtc
    x_scaled = xc * w.transpose(2, 3)[..., None].to(x.dtype)
    states = torch.einsum("bcsn,bcshp->bchpn", bc, x_scaled.to(f32))

    # 3. across chunks: state_{c+1} = state_c * exp(sum dta_c) + states_c;
    #    the state ENTERING each chunk is kept
    chunk_decay = torch.exp(dtac_cs[..., -1])                 # (B, nc, H)
    carry = torch.zeros((bs, h, p, n), dtype=f32, device=x.device)
    entering = []
    for i in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(entering, dim=1)                # (B,nc,H,P,N)

    # 4. the entering state's share: contract N first, then the decay
    #    from the chunk's start through each position
    decay_in = torch.exp(dtac_cs)                             # (B,nc,H,Q)
    y_off = torch.einsum("bcln,bchpn->bclhp", cc, prev_states)
    y_off = y_off * decay_in.transpose(2, 3)[..., None]

    y = (y_diag + y_off).to(x.dtype).reshape(bs, s, h, p)
    y = y + d_skip[None, None, :, None].to(x.dtype) * x
    return y, carry


def _causal_conv(seq, w, bias):
    """seq: (B, S, C); w: (W, C) depthwise, causal."""
    width = w.shape[0]
    pad = F.pad(seq, (0, 0, width - 1, 0))
    out = pad[:, 0:seq.shape[1], :] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + seq.shape[1], :] * w[i]
    return out + bias


def _split(cfg: ModelConfig, zxbcdt):
    di, n = cfg.d_inner, cfg.ssm_state
    return torch.split(zxbcdt, [di, di, n, n, cfg.ssm_heads], dim=-1)


def mamba_forward(p, cfg: ModelConfig, x):
    """Full-sequence forward. x: (B, S, d) -> (out (B, S, d), the final
    SSM state (B, H, P, N), the conv inputs (B, S, conv_dim))."""
    bsz, s, _ = x.shape
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, b, c, dt = _split(cfg, x @ p["in_proj"])
    conv_in = torch.cat([xs, b, c], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])                # (B, S, H)
    y, state = ssd_chunked(xs.reshape(bsz, s, h, hp), dt, p["A_log"], b, c,
                           p["D"], cfg.ssm_chunk)
    y = y.reshape(bsz, s, di) * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return y @ p["out_proj"], state, conv_in


def mamba_apply(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> (B, S, d), the final SSM state."""
    out, state, _ = mamba_forward(p, cfg, x)
    return out, state


def mamba_decode(p, cfg: ModelConfig, x, conv_state, ssm_state):
    """One-token step. x: (B, 1, d); conv_state: (B, W-1, conv_dim);
    ssm_state: (B, H, P, N) f32, both written in place. Returns (y (B, 1,
    d), conv_state, ssm_state)."""
    bsz = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, b, c, dt = _split(cfg, x[:, 0] @ p["in_proj"])
    conv_in = torch.cat([xs, b, c], dim=-1)                   # (B, conv_dim)
    window = torch.cat([conv_state, conv_in[:, None]], dim=1)  # (B, W, C)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"])
                      + p["conv_b"])
    xs, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])                # (B, H)
    da = torch.exp(dt * -torch.exp(p["A_log"]))               # (B, H)
    xh = xs.reshape(bsz, h, hp).to(f32)
    dbx = torch.einsum("bh,bn,bhp->bhpn", dt, b.to(f32), xh)
    ssm_state.mul_(da[..., None, None]).add_(dbx)
    y = torch.einsum("bhpn,bn->bhp", ssm_state, c.to(f32))
    y = y + p["D"][None, :, None] * xh
    y = (y.reshape(bsz, di) * F.silu(z).to(f32)).to(x.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    conv_state.copy_(window[:, 1:])
    return (y @ p["out_proj"])[:, None], conv_state, ssm_state
