"""The recurrent families' state hand-off across the ranks of a seq group.

A Mamba, mLSTM or sLSTM mixer has no softmax attention to exchange K/V or
segment means for.  Under a partitioned plan (``voltage``, ``prism``, a
codec, the ring) rank p holds tokens ``[p·Np, (p+1)·Np)``, and its mixer
must start from the state the mixer ended with on rank p − 1: the JAX
package's GSPMD scan runs over the whole time axis, and its docstring
names this mechanism (``repro.models.ssm``: "a P-step ``ppermute``
chain").  Each mixer packs its hand-off into one buffer:

* Mamba: h ``[B, di, S]`` f32 and the conv tail, the last W − 1 pre-conv
  inputs ``[B, W − 1, di]`` (the halo ``_causal_conv`` needs);
* mLSTM: C ``[B, H, dh, dh]``, n ``[B, H, dh]`` and m ``[B, H]``, f32;
* sLSTM: c, n, h and m ``[B, D]``, f32.

The chain (``SeqGroup.pass_on``) is exact: rank 0 starts from zeros, as
the whole-sequence scan does, and rank p's outputs equal the global
scan's at its positions.  P − 1 messages a mixer cross the group, their
bytes booked under ``GatherStats.state_bytes``.  Under autograd the
received leaves require grad, and the backward runs the chain in reverse,
rank P − 1 → 0: rank p's mixer gets the cotangent of the state it handed
on from rank p + 1, and sends rank p − 1 the cotangent of the state it
received (f32, one ``grad`` message a mixer), as the transpose of the
JAX package's scan over the whole time axis.  Decode needs no hand-off:
every rank holds the decoded token and a full copy of the state, and
updates it alike.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

# state_bytes: one hand-off's bytes; pack / unpack: the state's leaves as
# one flat uint8 buffer and back, the layout ``SeqGroup.pass_on`` sends
from repro_torch.core.seq_group import SeqGroup
from repro_torch.core.seq_group import leaves_bytes as state_bytes  # noqa
from repro_torch.core.seq_group import pack_leaves as pack  # noqa: F401
from repro_torch.core.seq_group import unpack_leaves as unpack  # noqa

State = Dict[str, torch.Tensor]


def handoff_scan(group: Optional[SeqGroup],
                 scan: Callable[[Optional[State]],
                                Tuple[torch.Tensor, State]],
                 like: Callable[[], State], device,
                 anchor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run ``scan(state0) → (y, final state)`` on this rank's part of the
    sequence, starting from rank p − 1's final state (None, the scan's
    zeros, on rank 0 and without a group), and hand its final state to
    rank p + 1 → y.  ``like()`` gives the state's leaves (shapes and
    dtypes; on the ``meta`` device, nothing allocated) in the order they
    travel; it is called only across a group.  The received state lands
    on ``device``.  ``anchor`` is the scan's input (every model passes
    it): where it requires grad the hand-off is differentiable
    (``SeqGroup.pass_on``)."""
    if group is None or group.world_size == 1:
        return scan(None)[0]
    tmpl = like()

    def run(got):
        y, final = scan(got)
        return y, {name: final[name].to(t.dtype)
                   for name, t in tmpl.items()}

    return group.pass_on(run, tmpl, device, anchor, kind="state")
