"""Recurrent sequence mixers: Mamba (hymba's SSM heads) and xLSTM's mLSTM
and sLSTM blocks.

Port of ``repro.models.ssm``.  No softmax attention, so no segment means
to exchange: across sequence partitions each mixer hands its final state
to the next partition (``repro_torch.core.handoff``), and every scan here
takes an optional starting state and returns its final state.

Forms, per mixer:
  * ``*_scan`` — the whole sequence (prefill, forward): a loop over the
    time steps, in place of the JAX package's ``lax.scan``
    (``chunked_time_scan`` there only changes what the backward pass
    keeps; at inference it is a plain scan).  The work that does not
    depend on the carried state (projections, gates, Mamba's decay and
    input terms, a ``chunk`` of steps at a time) runs over all the steps
    at once; the loop carries only the recurrence.
  * ``*_step`` — one token of decode with the O(1) carried state.

The loops keep their steps as a list and stack it once, so autograd
(a train step) can follow them.  Under grad each block of ``cfg.chunk``
steps is rematerialised (``remat.region``; ``chunked_time_scan``'s
``jax.checkpoint`` and its rule: none when ``chunk <= 1``, ``T % chunk``
or ``T <= chunk``), so the backward keeps the state only at block
boundaries and recomputes the steps inside.

Under tensor parallelism over a mesh row (``tp``: a ``models.tp.Split``,
the row's group and the rank's block ``[lo, hi)`` of the mixer's
channels; the params are the rank's blocks, ``TPPlan.leaf_block``) each
mixer enters the row's parallel region (``copy_to``) and leaves it by a
row-parallel product summed over the row (``reduce_from``):

* Mamba: the rank's inner channels of ``w_in``'s x and z halves, the
  conv, ``dt``, ``A``, the skip, and the scan state ``h [B, w, S]`` and
  conv carry ``[B, W − 1, w]``; ``B``/``C`` (``xc @ w_bc``) from the
  rank's rows, summed over the row; ``dt`` from every channel of ``xc``,
  gathered over the row (``gather_to``: in bf16 half the bytes of a
  reduce-scatter of f32 partial products, and ``w_dt``'s column block is
  the JAX block);
* mLSTM: the rank's value channels (``w_v``'s columns, the z half of
  ``w_up``, ``gn_scale``, ``w_down``'s rows) of its heads, and its
  matrix memory ``C [B, nh, dh, ne]``; ``xin``, q, k, the gates, ``n``
  and ``m`` whole on every rank (a rank's gradient of them is its
  channels' part, which the row sums); where a head's channels span
  ranks its groupnorm's mean of squares is a row sum;
* sLSTM: the rank's whole heads (its recurrence mixes a head's channels
  at every step): its columns of each gate, its heads of ``r``, its
  state ``[B, w]``; the cell's output gathered over the row
  (``gather_from``) into the FFN, whole unless M divides its width.

Numerics follow the JAX package: the states are f32, the casts to the
model dtype sit where it casts, log σ(f) is ``-softplus(-f)``, the
stabiliser ``m`` starts at −1e30, the mLSTM's denominator is
``max(|q·n|, exp(−m))`` and the sLSTM's FFN takes the tanh GELU.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMCfg
from repro_torch.models import remat
from repro_torch.models.layers import dense_init

Params = Dict[str, Any]
State = Dict[str, torch.Tensor]

M_INIT = -1e30          # the exponential gates' stabiliser before any token


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) at every x (``jax.nn.softplus``; torch's ``softplus``
    returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _log_sigmoid(f: torch.Tensor) -> torch.Tensor:
    return -_softplus(-f)


# ---------------------------------------------------------------------------
# Mamba (selective SSM) — hymba's parallel SSM heads
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, d: int, cfg: SSMCfg, dtype,
               d_inner: Optional[int] = None) -> Params:
    di = d_inner or cfg.expand * d
    dev = gen.device
    conv = torch.randn((cfg.conv_width, di), generator=gen, device=dev,
                       dtype=torch.float32) * (cfg.conv_width ** -0.5)
    a = torch.arange(1, cfg.state_size + 1, dtype=torch.float32, device=dev)
    return {
        "w_in": dense_init(gen, d, 2 * di, dtype),
        "conv": conv.to(dtype),
        "w_bc": dense_init(gen, di, 2 * cfg.state_size, dtype),
        "w_dt": dense_init(gen, di, di, dtype, scale=d ** -0.5),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=dev),
        "a_log": torch.log(a).repeat(di, 1),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, di, d, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 carry: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. x: [B, N, di]; w: [W, di]; carry:
    the W − 1 inputs before x (zeros by default) → (out [B, N, di], the
    last W − 1 inputs of ``[carry ‖ x]``: the next call's carry)."""
    W = w.shape[0]
    if carry is None:
        carry = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([carry.to(x.dtype), x], dim=1)
    N = x.shape[1]
    out = xp[:, 0:N] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + N] * w[i]
    return out, xp[:, xp.shape[1] - (W - 1):]


def _entered(x: torch.Tensor, tp) -> torch.Tensor:
    """The mixer's input entering the row's parallel region under ``tp``."""
    return x if tp is None else tp.group.copy_to(x)


def _left(y: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel product's partial sums summed over the row."""
    return y if tp is None else tp.group.reduce_from(y)


def _mamba_inner(params: Params, x: torch.Tensor, cfg: SSMCfg,
                 conv: Optional[torch.Tensor] = None, tp=None):
    """Shared projections → (xc, z, dt f32, B_in, C_in, conv carry), each
    of the rank's channels under ``tp`` (``B_in``/``C_in`` whole)."""
    di = params["d_skip"].shape[0]
    xz = _entered(x, tp) @ params["w_in"]
    xs, z = xz[..., :di], xz[..., di:]
    xc, conv_carry = _causal_conv(xs, params["conv"], conv)
    xc = F.silu(xc)
    bc = xc @ params["w_bc"]
    xd = xc
    if tp is not None:      # B, C: a sum over the channels; dt: all of xc
        bc = tp.group.copy_to(tp.group.reduce_from(bc))
        xd = tp.group.gather_to(xc)
    B_in, C_in = bc[..., :cfg.state_size], bc[..., cfg.state_size:]
    dt = _softplus((xd @ params["w_dt"]).float() + params["dt_bias"])
    return xc, z, dt, B_in, C_in, conv_carry


def _mamba_out(params: Params, ys: torch.Tensor, xc, z, dtype, tp=None):
    """(ys f32 [B, N, di]) → the mixer's output [B, N, D]."""
    y = ys.to(dtype) + xc * params["d_skip"].to(dtype)
    y = y * F.silu(z)
    return _left(y @ params["w_out"], tp)


def mamba_scan(params: Params, x: torch.Tensor, cfg: SSMCfg,
               h0: Optional[torch.Tensor] = None,
               conv: Optional[torch.Tensor] = None, tp=None
               ) -> Tuple[torch.Tensor, State]:
    """Whole-sequence selective scan. x: [B, N, D]; ``h0`` [B, di, S] f32
    and ``conv`` (the W − 1 pre-conv inputs before x, [B, W − 1, di])
    default to zeros → (y [B, N, D], final state ``{"h", "conv"}``, the
    layout of ``init_mamba_state``; under ``tp`` di is the rank's
    channels)."""
    B, N, _ = x.shape
    di = params["d_skip"].shape[0]
    xc, z, dt, B_in, C_in, conv_carry = _mamba_inner(params, x, cfg, conv,
                                                     tp)
    A = -torch.exp(params["a_log"])                       # [di, S]
    h = (torch.zeros((B, di, cfg.state_size), dtype=torch.float32,
                     device=x.device) if h0 is None else h0)
    xcf = xc.float()
    step = max(cfg.chunk, 1)
    run = remat.region if remat.chunked(N, cfg.chunk) else _call
    blocks = []
    for t0 in range(0, N, step):                # time-major blocks of steps
        y_c, h = run(_mamba_block, h, dt, A, B_in, C_in, xcf, t0,
                     min(t0 + step, N))
        blocks.append(y_c)
    ys = torch.cat(blocks)                                # [N, B, di]
    y = _mamba_out(params, ys.transpose(0, 1), xc, z, x.dtype, tp)
    return y, {"h": h, "conv": conv_carry}


def _call(fn, *args):
    return fn(*args)


def _mamba_block(h, dt, A, B_in, C_in, xcf, t0: int, t1: int):
    """Time steps t0 .. t1 − 1 of the selective scan from state ``h`` →
    (their y [t1 − t0, B, di] f32, the state after them)."""
    dt_c = dt[:, t0:t1].transpose(0, 1)[..., None]        # [c, B, di, 1]
    dA = torch.exp(dt_c * A)                              # [c, B, di, S]
    b = B_in[:, t0:t1].float().transpose(0, 1)[:, :, None, :]
    dBx = dt_c * b * xcf[:, t0:t1].transpose(0, 1)[..., None]
    steps = []
    for t in range(t1 - t0):
        h = torch.addcmul(dBx[t], dA[t], h)
        steps.append(h)
    hs = torch.stack(steps)
    c = C_in[:, t0:t1].float().transpose(0, 1)            # [c, B, S]
    return torch.matmul(hs, c[..., None])[..., 0], hs[-1].clone()


def mamba_step(params: Params, x: torch.Tensor, cfg: SSMCfg,
               state: State, tp=None) -> Tuple[torch.Tensor, State]:
    """One token. x: [B, 1, D]; state: ``{"h": [B, di, S] f32, "conv": [B,
    W − 1, di]}`` (under ``tp`` the rank's channels) → (y [B, 1, D], the
    new state)."""
    xc, z, dt, B_in, C_in, conv_carry = _mamba_inner(params, x, cfg,
                                                     state["conv"], tp)
    A = -torch.exp(params["a_log"])
    dA = torch.exp(dt[:, 0, :, None] * A[None])
    dBx = (dt[:, 0, :, None] * B_in.float()[:, 0, None, :]
           * xc.float()[:, 0, :, None])
    h = dA * state["h"] + dBx
    y = torch.matmul(h, C_in.float()[:, 0, :, None])[..., 0][:, None, :]
    return (_mamba_out(params, y, xc, z, x.dtype, tp),
            {"h": h, "conv": conv_carry.to(state["conv"].dtype)})


def init_mamba_state(batch: int, d: int, cfg: SSMCfg, dtype,
                     d_inner: Optional[int] = None, device=None) -> State:
    di = d_inner or cfg.expand * d
    return {"h": torch.zeros((batch, di, cfg.state_size),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM's matrix-memory cell)
# ---------------------------------------------------------------------------

def mlstm_dims(d: int, cfg: SSMCfg) -> Tuple[int, int]:
    """(heads, head width) of the mLSTM's up-projected space."""
    H = cfg.mlstm_heads
    return H, int(d * cfg.proj_factor) // H


def init_mlstm(gen: torch.Generator, d: int, cfg: SSMCfg, dtype) -> Params:
    H, dh = mlstm_dims(d, cfg)
    di = H * dh
    dev = gen.device
    return {
        "w_up": dense_init(gen, d, 2 * di, dtype),
        "w_q": dense_init(gen, di, di, dtype),
        "w_k": dense_init(gen, di, di, dtype),
        "w_v": dense_init(gen, di, di, dtype),
        "w_if": dense_init(gen, di, 2 * H, dtype, scale=0.02),
        "b_if": torch.cat([torch.zeros(H), 3.0 * torch.ones(H)]).to(
            device=dev, dtype=torch.float32),
        "gn_scale": torch.ones((di,), dtype=torch.float32, device=dev),
        "w_down": dense_init(gen, di, d, dtype),
    }


def _stabilised_gates(i_pre: torch.Tensor, logf: torch.Tensor,
                      m0: torch.Tensor):
    """Time-major [N, ...] input and log-forget pre-activations and the
    stabiliser before them → (the forget and input gates, each step's
    stabiliser m_t = max(log f_t + m_{t−1}, i_t)); only m is sequential."""
    m = m0
    steps = []
    for t in range(i_pre.shape[0]):
        m = torch.maximum(logf[t] + m, i_pre[t])
        steps.append(m)
    ms = torch.stack(steps)
    m_prev = torch.cat([m0[None], ms[:-1]])
    fg = torch.exp(logf + m_prev - ms)
    ig = torch.exp(i_pre - ms)
    return fg, ig, ms


def _value_block(di: int, H: int, tp) -> Tuple[int, int, int]:
    """The mLSTM's value channels a rank holds → (first head, heads,
    channels a head): every head's all of them, or under ``tp`` whole
    heads or a part of one."""
    dh = di // H
    lo, hi = (0, di) if tp is None else (tp.lo, tp.hi)
    return lo // dh, max((hi - lo) // dh, 1), min(hi - lo, dh)


def mlstm_scan(params: Params, x: torch.Tensor, cfg: SSMCfg,
               state0: Optional[State] = None, tp=None
               ) -> Tuple[torch.Tensor, State]:
    """Whole-sequence mLSTM. x: [B, N, D] → (y [B, N, D], final state
    ``{"C": [B, H, dh, dh], "n": [B, H, dh], "m": [B, H]}``, f32; under
    ``tp`` ``C`` is the rank's ``[B, nh, dh, ne]``).

    Stabilised exponential gating (Beck et al. 2024): m tracks the running
    max of (log f + m_prev, ĩ), and C and n are rescaled by it."""
    B, N, D = x.shape
    H = cfg.mlstm_heads
    di = params["w_q"].shape[0]
    dh = di // H
    h0, nh, ne = _value_block(di, H, tp)
    heads = slice(h0, h0 + nh)
    up = _entered(x, tp) @ params["w_up"]
    xin, z = up[..., :di], up[..., di:]
    q = (xin @ params["w_q"]).reshape(B, N, H, dh) * (dh ** -0.5)
    k = (xin @ params["w_k"]).reshape(B, N, H, dh) * (dh ** -0.5)
    v = (xin @ params["w_v"]).reshape(B, N, nh, ne)
    gates = (xin @ params["w_if"]).float() + params["b_if"]
    if state0 is None:
        state0 = init_mlstm_state(B, D, cfg, device=x.device,
                                  values=nh * ne)
    # time-major, f32
    qf, kf, vf = (t.float().transpose(0, 1) for t in (q, k, v))
    i_pre, f_pre = (g.transpose(0, 1) for g in (gates[..., :H],
                                                gates[..., H:]))
    fg, ig, ms = _stabilised_gates(i_pre, _log_sigmoid(f_pre), state0["m"])
    C, n = state0["C"], state0["n"]
    step = max(cfg.chunk, 1) if remat.chunked(N, cfg.chunk) else N
    run = remat.region if step < N else _call
    n_blocks, num_blocks = [], []
    for t0 in range(0, N, step):
        C, n, ns_c, nums_c = run(_mlstm_block, C, n, qf, kf, vf, fg, ig,
                                 heads, t0, min(t0 + step, N))
        n_blocks.append(ns_c)
        num_blocks.append(nums_c)
    ns, nums = torch.cat(n_blocks), torch.cat(num_blocks)
    qn = (qf[:, :, heads] * ns[:, :, heads]).sum(dim=-1)    # [N, B, nh]
    den = torch.maximum(qn.abs(), torch.exp(-ms[:, :, heads]))[..., None]
    h = (nums[..., 0, :] / den).transpose(0, 1).reshape(B, N, nh * ne)
    h = _groupnorm_split(h, nh, params["gn_scale"], dh, h0, H,
                         tp).to(x.dtype)
    y = _left((h * F.silu(z)) @ params["w_down"], tp)
    return y, {"C": C, "n": n.clone(), "m": ms[-1].clone()}


def _mlstm_block(C, n, qf, kf, vf, fg, ig, heads: slice, t0: int, t1: int):
    """Time steps t0 .. t1 − 1 of the mLSTM cell from (C, n) → (C, n after
    them, each step's n [t1 − t0, B, H, dh] and q·C [t1 − t0, B, nh, 1,
    ne]); ``C`` and the values ``vf`` are the ``heads``' (the rank's)."""
    n_list, num_list = [], []
    for t in range(t0, t1):
        f, i = fg[t][:, heads], ig[t][:, heads]
        kv = kf[t][:, heads, :, None] * vf[t][..., None, :]  # [B, nh, dh, ne]
        C = (f[..., None, None] * C).addcmul_(i[..., None, None], kv)
        n = (fg[t][..., None] * n).addcmul_(ig[t][..., None], kf[t])
        n_list.append(n)
        num_list.append(torch.matmul(qf[t][:, heads, None, :], C))
    return C, n, torch.stack(n_list), torch.stack(num_list)


def _groupnorm_heads(h: torch.Tensor, H: int,
                     scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS-style groupnorm after the cell (f32 out)."""
    B, N, di = h.shape
    hh = h.reshape(B, N, H, di // H).float()
    var = hh.square().mean(dim=-1, keepdim=True)
    hh = hh * torch.rsqrt(var + 1e-6)
    return hh.reshape(B, N, di) * scale


def _groupnorm_split(h: torch.Tensor, nh: int, scale: torch.Tensor, dh: int,
                     h0: int, H: int, tp) -> torch.Tensor:
    """``_groupnorm_heads`` of the rank's ``nh`` heads of ``h`` [B, N,
    nh·ne]; where a rank holds part of one head (ne < dh) the mean of
    squares is the row's sum of every rank's ``[B, N, H]`` partial sums
    (the head's, at its index; zeros elsewhere), over dh."""
    B, N, w = h.shape
    if w == nh * dh:
        return _groupnorm_heads(h, nh, scale)
    hh = h.float()
    part = hh.new_zeros((B, N, H))
    part[..., h0] = hh.square().sum(dim=-1)
    var = tp.group.copy_to(tp.group.reduce_from(part))[..., h0:h0 + 1] / dh
    return hh * torch.rsqrt(var + 1e-6) * scale


def mlstm_step(params: Params, x: torch.Tensor, cfg: SSMCfg,
               state: State, tp=None) -> Tuple[torch.Tensor, State]:
    """One token — the same math as one scan step."""
    return mlstm_scan(params, x, cfg, state0=state, tp=tp)


def init_mlstm_state(batch: int, d: int, cfg: SSMCfg, device=None,
                     values: Optional[int] = None) -> State:
    """The mLSTM's zero state; ``values``: the value channels a rank holds
    (``C``'s heads and last dim those of ``_value_block``)."""
    H, dh = mlstm_dims(d, cfg)
    f32 = dict(dtype=torch.float32, device=device)
    w = H * dh if values is None else values
    nh, ne = max(w // dh, 1), min(w, dh)
    return {"C": torch.zeros((batch, nh, dh, ne), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), M_INIT, **f32)}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM's scalar-memory cell with recurrent mixing)
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, d: int, cfg: SSMCfg, dtype) -> Params:
    """Input weights for the (i, f, z, o) gates, block-diagonal recurrent
    weights per head, and the post-cell gated FFN (factor 4/3)."""
    H = cfg.mlstm_heads
    dh = d // H
    dev = gen.device
    r = torch.randn((4, H, dh, dh), generator=gen, device=dev,
                    dtype=torch.float32) * (dh ** -0.5)
    du = int(d * 4 / 3)
    return {
        "w_x": dense_init(gen, d, 4 * d, dtype),
        "r": r.to(dtype),
        "b": torch.cat([torch.zeros(d), 3.0 * torch.ones(d),
                        torch.zeros(2 * d)]).to(device=dev,
                                                dtype=torch.float32),
        "gn_scale": torch.ones((d,), dtype=torch.float32, device=dev),
        "w_up": dense_init(gen, d, du * 2, dtype),
        "w_down": dense_init(gen, du, d, dtype),
    }


def slstm_scan(params: Params, x: torch.Tensor, cfg: SSMCfg,
               state0: Optional[State] = None, tp=None
               ) -> Tuple[torch.Tensor, State]:
    """Strictly sequential sLSTM over time. x: [B, N, D] → (y, final state
    ``{"c", "n", "h", "m"}``, each [B, D] f32; under ``tp`` [B, w], the
    rank's heads' channels)."""
    B, N, D = x.shape
    w = D if tp is None else tp.hi - tp.lo
    H = cfg.mlstm_heads * w // D                          # the rank's heads
    wx = (_entered(x, tp) @ params["w_x"]).float().transpose(0, 1)
    r = params["r"].float()                               # wx: [N, B, 4w]
    b = params["b"]
    if state0 is None:
        state0 = init_slstm_state(B, w, device=x.device)
    c, n, h, m = (state0[k] for k in ("c", "n", "h", "m"))
    step = max(cfg.chunk, 1) if remat.chunked(N, cfg.chunk) else N
    run = remat.region if step < N else _call
    blocks = []
    for t0 in range(0, N, step):
        c, n, h, m, hs_c = run(_slstm_block, c, n, h, m, wx, r, b, H, t0,
                               min(t0 + step, N))
        blocks.append(hs_c)
    hs = torch.cat(blocks)
    hseq = _groupnorm_heads(hs.transpose(0, 1), H,
                            params["gn_scale"]).to(x.dtype)
    du = params["w_down"].shape[0]
    ffn = None                      # the FFN split where M divides its width
    if tp is not None:
        hseq = tp.group.gather_from(hseq)
        ffn = tp if du != int(D * 4 / 3) else None
    up = _entered(hseq, ffn) @ params["w_up"]
    y = _left((F.gelu(up[..., :du], approximate="tanh") * up[..., du:])
              @ params["w_down"], ffn)
    return y, {"c": c, "n": n, "h": h.clone(), "m": m}


def _slstm_block(c, n, h, m, wx, r, b, H: int, t0: int, t1: int):
    """Time steps t0 .. t1 − 1 of the sLSTM cell from (c, n, h, m) → (the
    state after them, each step's h [t1 − t0, B, D])."""
    B, D = h.shape
    hs = []
    for t in range(t0, t1):
        rec = torch.einsum("bhd,ghde->bghe", h.reshape(B, H, D // H), r)
        pre = wx[t] + rec.reshape(B, 4 * D) + b
        i_p, f_p, z_p, o_p = pre.split(D, dim=-1)
        logf = _log_sigmoid(f_p)
        m_new = torch.maximum(logf + m, i_p)
        ig = torch.exp(i_p - m_new)
        fg = torch.exp(logf + m - m_new)
        c = fg * c + ig * torch.tanh(z_p)
        n = fg * n + ig
        h = torch.div(torch.sigmoid(o_p) * c, torch.clamp(n, min=1.0))
        hs.append(h)
        m = m_new
    return c, n, h, m, torch.stack(hs)


def slstm_step(params: Params, x: torch.Tensor, cfg: SSMCfg,
               state: State, tp=None) -> Tuple[torch.Tensor, State]:
    return slstm_scan(params, x, cfg, state0=state, tp=tp)


def init_slstm_state(batch: int, d: int, device=None) -> State:
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), M_INIT, **f32)}
