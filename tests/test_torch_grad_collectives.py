"""The backwards of the port's staged collectives, across 2 and 4 gloo ranks
on the CPU (one spawn per world size; rank body
``tests/_torch_ranks.py:grad_collectives``).

Each backward is the transpose of its forward, as JAX's transpose of the
collective it stands for: for a forward ``op`` and a cotangent y on every
rank, Σ_ranks ⟨op(x), y⟩ = Σ_ranks ⟨x, opᵀ(y)⟩, where opᵀ(y) is what
autograd gives x.  The inputs are small multiples of 1/4, so every sum is
exact in f32 as in f64 and the identity holds bit for bit (the gathers'
backward reduce-scatters in f32, ``pass_on``'s chain sends f32).

* ``shift`` (every ``sft``): the halo's ``ppermute`` and its reverse;
* ``ring_shift`` + ``ring_forward`` over the whole ring, in 1 and 2
  chunks;
* ``all_gather_packed`` of an f32, an int8 and an f64 piece;
* ``pass_on``: the recurrent hand-off's chain and its reverse;
* ``broadcast`` from the first and the last rank.

The bytes each backward books under ``grad`` equal the shapes, and
``all_reduce`` still refuses a tensor that requires grad
(``tests/test_torch_grad_ops.py``).
"""
import numpy as np
import pytest

import _torch_ranks
from repro_torch.core.seq_group import spawn

_RUNS = {}


def _ranks(P):
    if P not in _RUNS:
        _RUNS[P] = spawn(_torch_ranks.grad_collectives, P, dict(seed=3),
                         timeout=120)
    return _RUNS[P]


def _names(P):
    return ([f"shift/{s}" for s in range(1, P)] + ["ring/1", "ring/2",
                                                     "packed", "pass_on"]
            + [f"broadcast/{s}" for s in sorted({0, P - 1})])


CASES = [(P, name) for P in (2, 4) for name in _names(P)]


@pytest.mark.parametrize("P,name", CASES)
def test_backward_is_the_transpose(P, name):
    runs = _ranks(P)
    dot = sum(r[name]["dot"] for r in runs)
    back = sum(r[name]["back"] for r in runs)
    assert dot == back, (dot, back)
    assert any(r[name]["dot"] != 0 for r in runs)
    # a gradient reached every rank's input that the op sends anywhere
    # (the last rank's hand-off state and a broadcast's non-source
    # inputs go nowhere)
    for rank, r in enumerate(runs):
        unused = (name.startswith("broadcast/")
                  and rank != int(name.split("/")[1]))
        if name == "pass_on" and rank == P - 1:
            assert r[name]["no_grad"] == [True, True, False]
        else:
            assert r[name]["no_grad"] == [unused] * len(r[name]["no_grad"])


def _grad_bytes(P, name, rank):
    """(grad bytes, calls) rank ``rank``'s backward of ``name`` books."""
    if name.startswith("shift/"):
        sft = int(name.split("/")[1])
        return (2 * 3 * 5 * 8 if rank + sft < P else 0), 1
    if name.startswith("ring/"):
        return (P - 1) * 4 * 6 * 8, P - 1
    if name == "packed":               # the float pieces, f32
        return (P - 1) * 4 * (3 * 4 + 2 * 2), 1
    if name == "pass_on":              # f32 cotangent of the state sent
        last = rank == P - 1
        return (0, 0) if last else (4 * (2 * 3 + 4), 1)
    src = int(name.split("/")[1])       # broadcast: summed onto src
    return ((P - 1) * 4 * 3 * 7 if rank == src else 0), 1


@pytest.mark.parametrize("P,name", CASES)
def test_backward_books_its_bytes_as_grad(P, name):
    for rank, r in enumerate(_ranks(P)):
        assert (r[name]["grad"], r[name]["calls"]) == _grad_bytes(P, name,
                                                                  rank)


@pytest.mark.parametrize("P", [2, 4])
def test_ring_and_chain_tags_pair_up_across_cases(P):
    """Every case ran in one process group after the others, forward and
    backward, so the tags reserved in each forward matched on every rank;
    the forward of each booked its own calls."""
    runs = _ranks(P)
    for r in runs:
        assert r["ring/1"]["fwd_calls"] == P - 1
        assert r["pass_on"]["fwd_calls"] == (0 if r is runs[0] else 1)
    np.testing.assert_array_equal(
        [r["packed"]["fwd_calls"] for r in runs], [1] * P)
