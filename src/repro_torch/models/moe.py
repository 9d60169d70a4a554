"""Mixture-of-Experts FFN (DeepSeek-style: fine-grained routed + shared).

Port of ``repro.models.moe``.  The JAX package dispatches with one-hot
einsums over ``[G, S, E, C]`` (capacity-based, MaxText-style); here the
same capacity buffers are filled and read by index: each (token, choice)
that fits goes to slot ``pos`` of its expert's buffer ``[E, G·C, D]``,
the expert MLPs are batched matmuls over every slot of every expert, and
each token gathers its choices' slots back.  The (token, choice) pairs
dropped are exactly the JAX package's:

* router logits in f32, softmax, top-k in descending order, the k
  probabilities renormalised;
* ``pos`` of a (token, choice) is the number of earlier selections of its
  expert in the token's group, counted over the ``[S·k]`` axis in
  token-then-choice order; it fits when ``pos < C``,
  ``C = expert_capacity(S)``;
* sequences longer than ``GROUP_TOKENS`` that divide into it are routed
  in groups of ``GROUP_TOKENS`` tokens.

The shared experts always run; the Switch-style load-balance loss
``router_aux_weight · E · Σ_e f_e p_e`` comes back beside the output.

Under a seq group (``group``) each rank holds its part ``[B, Np, D]`` of
the global ``[B, P·Np, D]`` and the routing is that of the whole sequence:
one staged call a layer gathers every rank's per-(group, expert) counts
and the sums behind the loss (booked as ``meta``); a rank's positions
start after the selections of the ranks before it in the same group, C
and the loss come from the global group length and sums.  The expert
weights are whole on every rank, so no token moves.  (The JAX package's
``_pin_expert`` is a GSPMD sharding hint with no counterpart here.)

Under tensor parallelism over a mesh row (``models.tp.ffn``: the
JAX plan shards the experts over ``model``) a rank holds ``E / M`` of the
experts and runs them over all the row's tokens, the same on every rank
of the row: the router is whole, so the routing, the capacity and
``fits`` are identical everywhere; the rank fills only its experts'
buffers, and the row sums the ranks' outputs (``reduce_from``).  The
shared expert runs whole on every rank of the row after that sum (the
JAX plan shards it as an expert stack, over its layers, never its
width).
Where the batch is sharded over the mesh's ``data`` axis
(``models.tp.batch_group``), the loss's ``sum_sel`` and ``sum_p`` and the
token count are summed over the column (one ``meta`` gather, whose
backward sums the cotangents over the column), so the aux loss is the
whole batch's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MoECfg
from repro_torch.models import tp as tpm
from repro_torch.models.layers import _act, apply_mlp, dense_init, init_mlp

Params = Dict[str, Any]

GROUP_TOKENS = 4096      # re-group long sequences so capacity (∝S) stays sane


def expert_capacity(tokens_per_group: int, cfg: MoECfg) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            // cfg.n_experts)
    return max(c, 1)


def init_moe(gen: torch.Generator, d: int, cfg: MoECfg, dtype) -> Params:
    E, f = cfg.n_experts, cfg.d_ff_expert
    dev = gen.device

    def normal(shape, scale):      # scaled in place: the f32 draw of a
        w = torch.randn(shape, generator=gen, device=dev,   # full-width
                        dtype=torch.float32)   # expert stack is 5 GB
        return w.mul_(scale).to(dtype)

    p = {"router": dense_init(gen, d, E, torch.float32, scale=0.02),
         "w_gate": normal((E, d, f), d ** -0.5),
         "w_up": normal((E, d, f), d ** -0.5),
         "w_down": normal((E, f, d), f ** -0.5)}
    if cfg.n_shared:
        p["shared"] = init_mlp(gen, d, cfg.n_shared * f, dtype)
    return p


def group_length(n_tokens: int) -> int:
    """Tokens per routing group of an ``n_tokens`` sequence."""
    if n_tokens > GROUP_TOKENS and n_tokens % GROUP_TOKENS == 0:
        return GROUP_TOKENS
    return n_tokens


def apply_moe(params: Params, x: torch.Tensor, cfg: MoECfg,
              act: str = "silu", group=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] → (y [B, S, D], aux loss f32 scalar).  With ``group``
    (a ``SeqGroup``), x is this rank's part of a sequence of
    ``S · world_size`` tokens, routed as the whole sequence."""
    B, n, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    P = 1 if group is None else group.world_size
    start = 0 if group is None else group.rank * n
    N = n * P                               # the whole sequence
    GS = group_length(N)
    C = expert_capacity(GS, cfg)
    dev = x.device

    logits = x.float() @ params["router"]                  # [B, n, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1, sorted=True)   # [B, n, k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # the routing groups this rank's tokens fall in: g0 .. g0 + n_lg - 1
    g0 = start // GS
    n_lg = (start + n - 1) // GS - g0 + 1
    lg = (start + torch.arange(n, device=dev)) // GS - g0      # [n]
    sel = torch.nn.functional.one_hot(top_i, E).to(torch.int32)  # [B,n,k,E]
    counts = torch.zeros((B, n_lg, E), dtype=torch.int32, device=dev)
    counts.index_add_(1, lg, sel.sum(2, dtype=torch.int32))
    # a position counts from its group's first token: less the selections
    # in this rank's earlier groups, plus (in a seq group) those on the
    # ranks before it in the same group
    offset = counts - counts.cumsum(1, dtype=torch.int32)
    sum_sel = counts.sum((0, 1)).float()                        # [E]
    sum_p = probs.sum((0, 1))                                   # [E]
    if group is not None:
        NG = N // GS
        mine = torch.zeros((B, NG, E), dtype=torch.float32, device=dev)
        mine[:, g0:g0 + n_lg] = counts.float()
        got = group.all_gather(torch.cat([mine.reshape(-1), sum_p,
                                          sum_sel]), kind="meta")  # [P, ·]
        cnt = got[:, :B * NG * E].reshape(P, B, NG, E)
        earlier = cnt[:group.rank].sum(0)[:, g0:g0 + n_lg]
        offset = offset + earlier.round().to(torch.int32)
        sum_p = got[:, B * NG * E:B * NG * E + E].sum(0)
        sum_sel = got[:, B * NG * E + E:].sum(0)

    # position of each (token, choice) within its expert's capacity buffer
    run = sel.reshape(B, n * k, E).cumsum(1, dtype=torch.int32)
    run = run.reshape(B, n, k, E).gather(3, top_i[..., None])[..., 0] - 1
    pos = run + offset[:, lg].gather(2, top_i)                 # [B, n, k]
    fits = pos < C

    # capacity buffers [El, G·C, D] (G = B · n_lg local groups) of this
    # rank's experts e0 .. e0 + El - 1 (all E without TP), the expert MLPs
    # over every slot, and each token's choices gathered back
    tp = tpm.ffn(E)
    El = E if tp is None else E // tp.world_size
    e0 = 0 if tp is None else tp.rank * El
    x_in = x
    if tp is not None:
        x, top_p = tp.copy_to(x), tp.copy_to(top_p)
        fits = fits & (top_i >= e0) & (top_i < e0 + El)
    G = B * n_lg
    gid = (torch.arange(B, device=dev)[:, None] * n_lg + lg[None])  # [B, n]
    slot = ((top_i - e0).clamp(0, El - 1) * (G * C) + gid[..., None] * C
            + pos.clamp(max=C - 1))                            # [B, n, k]
    xe = torch.zeros((El * G * C, D), dtype=x.dtype, device=dev)
    rows = x[:, :, None].expand(B, n, k, D)
    if dev.type == "meta":    # no values to select by: every (token,
        xe[slot.reshape(-1)] = rows.reshape(-1, D)     # choice) kept
    else:
        xe[slot[fits]] = rows[fits]
    xe = xe.reshape(El, G * C, D)
    h = _act(torch.bmm(xe, params["w_gate"]), act) * torch.bmm(
        xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"]).reshape(El * G * C, D)
    comb = (top_p * fits).to(x.dtype)                          # [B, n, k]
    y = torch.bmm(comb.reshape(B * n, 1, k),
                  ye[slot.reshape(-1)].reshape(B * n, k, D)).reshape(B, n, D)

    if tp is not None:
        y = tp.reduce_from(y)
    if cfg.n_shared and "shared" in params:
        y = y + apply_mlp(params["shared"], x_in, act)

    # Switch-style load balance: E * Σ_e f_e · p_e over all B · N tokens
    # (the whole batch's, where it is sharded over the mesh's data axis)
    T = B * N
    col = tpm.batch_group()
    if col is not None and col.world_size > 1:
        got = col.all_gather(torch.cat([sum_sel, sum_p]), kind="meta")
        tot = got.sum(0)
        sum_sel, sum_p = tot[:E], tot[E:]
        T = T * col.world_size
    aux = cfg.router_aux_weight * E * torch.sum((sum_sel / T) * (sum_p / T))
    return y, aux
