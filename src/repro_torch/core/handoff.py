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
bytes booked under ``GatherStats.state_bytes``.  Decode needs no
hand-off: every rank holds the decoded token and a full copy of the
state, and updates it alike.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.seq_group import SeqGroup

State = Dict[str, torch.Tensor]


def state_bytes(like: State) -> int:
    """Bytes of one hand-off of a state shaped as ``like``."""
    return sum(t.numel() * t.element_size() for t in like.values())


def pack(state: State) -> torch.Tensor:
    """The state's leaves, in key order, as one flat uint8 buffer."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in state.values()])


def unpack(buf: torch.Tensor, like: State) -> State:
    """``pack``'s inverse: leaves shaped and typed as ``like``'s, on
    ``buf``'s device."""
    out, off = {}, 0
    for name, t in like.items():
        n = t.numel() * t.element_size()
        out[name] = buf[off:off + n].view(t.dtype).reshape(t.shape)
        off += n
    return out


def handoff_scan(group: Optional[SeqGroup],
                 scan: Callable[[Optional[State]],
                                Tuple[torch.Tensor, State]],
                 like: Callable[[], State], device) -> torch.Tensor:
    """Run ``scan(state0) → (y, final state)`` on this rank's part of the
    sequence, starting from rank p − 1's final state (None, the scan's
    zeros, on rank 0 and without a group), and hand its final state to
    rank p + 1 → y.  ``like()`` gives the state's leaves (shapes and
    dtypes; on the ``meta`` device, nothing allocated) in the order they
    travel; it is called only across a group.  The received state lands
    on ``device``."""
    if group is None or group.world_size == 1:
        return scan(None)[0]
    tmpl = like()

    def run(got):
        y, final = scan(None if got is None else unpack(got, tmpl))
        return y, pack({name: final[name].to(t.dtype)
                        for name, t in tmpl.items()})

    return group.pass_on(run, state_bytes(tmpl), device, kind="state")
