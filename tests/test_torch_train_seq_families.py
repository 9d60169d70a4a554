"""Partitioned training of every family in the port against the JAX
package (CPU, reduced f32 configs, the JAX weights carried across by the
bridge, 2 and 4 gloo ranks, one spawn per world size; rank body
``tests/_torch_ranks.py:train_families``).

For each case the ranks' loss shares sum to JAX ``loss_fn``'s loss, and
their gradients, summed by the staged ``all_reduce``, equal
``jax.value_and_grad`` of it, with the JAX package's partitioned exchanges
composed per partition by ``tests/_exchange_oracle.py`` (its mesh path
does not run on the installed JAX):

* gemma2 under ``prism`` (at P 4 the windowed layer's halo: ``shift`` and
  its backward, halo calls asserted) and ``voltage``;
* llama under ``voltage`` with ``overlap_chunks`` (the ring and its
  backward; ``ring_oracle``) and under ``prism`` with the int8, int4 and
  topk codecs (``all_gather_packed`` and its reduce-scatter;
  ``codec_oracle``);
* deepseek-moe-16b with its aux loss (the routing call's gather carries
  ``sum_p``'s gradient) and deepseek-v2-236b (MLA's latent and its
  means; ``mla_oracle``);
* whisper (the per-rank encoder) and vision (the gated cross layers, gates
  0.5) through the cross-attention exchange (``cross_oracle``);
* hymba and xLSTM (the state hand-off and its reverse chain) against the
  JAX package's scan over the whole sequence;

and two train steps from the same weights match JAX's
``build_train_step`` metrics, with every rank ending on the same params
bit for bit.  Last, the logits broadcasts take a gradient across the
ranks: the ViT's class loss and a loss of an LM's ``last_only`` logits,
against ``jax.value_and_grad`` of the JAX forwards with the exchange
composed per partition.

Tolerances (PERF.md §6): gradients ≤ 2e-5 of each leaf's largest value,
the loss ≤ 1e-5 relative, the two steps' metrics ≤ 1e-4.  The codec cases
pass at the same gradient tolerance on these inputs; an int8 / int4 code
rounding apart between the packages would move a gradient through its
scale (ROADMAP §3, "Watched").
"""
import concurrent.futures
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks
import _train_oracle as orc
from _exchange_oracle import (codec_oracle, cross_oracle, mla_oracle,
                              prism_oracle, ring_oracle, voltage_oracle)
from repro.core import exchange as jx
from repro.models import mla as jmla
from repro.models import registry as jreg
from repro.models import transformer as jtfm
from repro.models import vit as jvit
from repro.train.optimizer import OptConfig as JOpt
from repro.train.optimizer import adamw_init as jinit
from repro.train.train_step import build_train_step as jbuild
from repro.train.train_step import loss_fn as jloss
from repro.transport import executor as jex
from repro_torch.core.seq_group import spawn
from repro_torch.models.bridge import params_from_numpy
from repro_torch.utils.tree import tree_unflatten_like

B = 2
L_OF = {2: 4, 4: 2}
GATE = 0.5                 # the vlm's gates: tanh(0) erases the memory
MEMORY_LEN = 13            # frames / image tokens: padded under every plan
GRAD_RTOL, LOSS_RTOL, STEP_RTOL = 2e-5, 1e-5, 1e-4
GEMMA, LLAMA = "gemma2-27b", "llama3.2-1b"
MOE, MLA = "deepseek-moe-16b", "deepseek-v2-236b"
WHISPER, VISION = "whisper-large-v3", "llama-3.2-vision-11b"
HYMBA, XLSTM = "hymba-1.5b", "xlstm-350m"

# label → (arch, mode, N, exchange options)
CASES = {
    "gemma2/prism": (GEMMA, "prism", 32, {}),
    "gemma2/voltage": (GEMMA, "voltage", 32, {}),
    "llama/ring": (LLAMA, "voltage", 16, dict(overlap_chunks=2)),
    "llama/int8": (LLAMA, "prism", 16, dict(codec="int8")),
    "llama/int4": (LLAMA, "prism", 16, dict(codec="int4")),
    "llama/topk": (LLAMA, "prism", 16, dict(codec="topk", codec_param=8)),
    "moe/voltage": (MOE, "voltage", 16, {}),
    "moe/prism": (MOE, "prism", 16, {}),
    "mla/voltage": (MLA, "voltage", 16, {}),
    "mla/prism": (MLA, "prism", 16, {}),
    "whisper/voltage": (WHISPER, "voltage", 16, {}),
    "whisper/prism": (WHISPER, "prism", 16, {}),
    "vision/voltage": (VISION, "voltage", 16, {}),
    "vision/prism": (VISION, "prism", 16, {}),
    "hymba/voltage": (HYMBA, "voltage", 16, {}),
    "hymba/prism": (HYMBA, "prism", 16, {}),
    "xlstm/voltage": (XLSTM, "voltage", 16, {}),
    "xlstm/prism": (XLSTM, "prism", 16, {}),
}
# voltage cases whose JAX reference is the plain one for every P (exact
# attention over the same keys): computed once for both world sizes
# (whisper's encoder attends its padded frames, so its pads matter)
EXACT = ("gemma2/voltage", "moe/voltage", "mla/voltage", "vision/voltage",
         "hymba/voltage", "xlstm/voltage")
# two train steps held against JAX's, one world size a family
STEP_RUNS = ((4, "gemma2/prism"), (2, "llama/int8"), (2, "moe/prism"),
             (4, "hymba/prism"))
VIT = "vit-base-16"


@pytest.fixture(scope="module")
def side():
    """{arch: (JAX config, port config, JAX params)}; the vlm's gates 0.5."""
    out = {}
    for arch in {c[0] for c in CASES.values()} | {VIT}:
        jcfg, cfg = orc.configs(arch)
        jp = jax.jit(lambda c=jcfg: jreg.init_params(c, seed=0))()
        if "cross_layers" in jp:
            jp = dict(jp, cross_layers=dict(
                jp["cross_layers"],
                gate=jnp.full_like(jp["cross_layers"]["gate"], GATE)))
        out[arch] = (jcfg, cfg, jp)
    _start(out)
    return out


def _batch(cfg, N, seed):
    """``orc.batch`` with the memory cut to ``MEMORY_LEN`` tokens."""
    b = orc.batch(cfg, B, N, seed)
    for name in ("frames", "image_embeds"):
        if name in b:
            b[name] = np.ascontiguousarray(b[name][:, :MEMORY_LEN])
    return b


def _broadcast_cases(side, P):
    """The ViT (class logits from rank 0) and llama's ``last_only`` logits
    (from the last rank) under ``prism``."""
    vit = side[VIT][2]
    rng = np.random.RandomState(11)
    llama = side[LLAMA]
    return {
        "vit/broadcast": dict(
            arch=VIT, mode="prism", L=L_OF[P],
            params=jax.tree.map(np.asarray, vit),
            images=rng.randn(B, 224, 224, 3).astype(np.float32),
            labels=rng.randint(0, side[VIT][1].vocab_size, (B,))),
        "llama/last_only": dict(
            arch=LLAMA, mode="prism", L=L_OF[P],
            params=jax.tree.map(np.asarray, llama[2]),
            tokens=_batch(llama[1], 16, seed=1)["tokens"])}


def _job(side, P):
    cases = {}
    for label, (arch, mode, N, kw) in CASES.items():
        cases[label] = dict(arch=arch, mode=mode, **kw,
                            L=L_OF[P] if mode == "prism" else 0)
    return dict(
        cases=cases, reduced={"dtype": "float32"},
        params={a: jax.tree.map(np.asarray, side[a][2]) for a in
                {c[0] for c in CASES.values()}},
        batch={lb: _batch(side[c[0]][1], c[2], seed=1)
               for lb, c in CASES.items()},
        steps={lb: ([_batch(side[c[0]][1], c[2], seed=s) for s in (2, 3)]
                    if (P, lb) in STEP_RUNS else [])
               for lb, c in CASES.items()},
        broadcast=_broadcast_cases(side, P))


_RUNS = {}


def _start(side):
    """Start both world sizes' ranks in the background: their processes
    run while the JAX references are computed here."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    for n in (2, 4):
        _RUNS[n] = pool.submit(spawn, _torch_ranks.train_families, n,
                               _job(side, n), timeout=600)
    pool.shutdown(wait=False)


def _ranks(P):
    return _RUNS[P].result()


def _ring(q, k, v, cfg, *, causal=False, window=None, logit_softcap=None,
          scale=None, kv_mask=None):
    """The JAX Voltage exchange with ``overlap_chunks``: the ring composed
    per partition (``ring_oracle``); a windowed layer takes the gather."""
    if window is not None or cfg.overlap_chunks <= 0:
        return voltage_oracle(q, k, v, cfg, causal=causal, window=window,
                              logit_softcap=logit_softcap, scale=scale,
                              kv_mask=kv_mask)
    assert scale is None
    return ring_oracle(q, k, v, cfg.seq_shards, causal=causal,
                       logit_softcap=logit_softcap, kv_mask=kv_mask)


@contextlib.contextmanager
def _oracles():
    with mock.patch.object(jx, "prism_prefill_attention", prism_oracle), \
            mock.patch.object(jx, "voltage_prefill_attention", _ring), \
            mock.patch.object(jex, "codec_prefill_attention", codec_oracle), \
            mock.patch.object(jmla, "exchange_attention_mla", mla_oracle), \
            mock.patch.object(jtfm, "exchange_cross_attention",
                              cross_oracle):
        yield


def _jxcfg(label, P):
    _, mode, _, kw = CASES[label]
    return jx.ExchangeConfig(jx.ExchangeMode(mode), seq_axis="seq",
                             seq_shards=P,
                             L=L_OF[P] if mode == "prism" else 0, **kw)


_JAX = {}


def _jax_grads(side, label, P):
    """JAX ``value_and_grad`` of ``loss_fn`` → (loss, aux, flat grads);
    the ``EXACT`` cases under JAX ``local``, once for both world sizes."""
    key = (label, None if label in EXACT else P)
    if key not in _JAX:
        arch, _, N, _ = CASES[label]
        jcfg, cfg, jp = side[arch]
        b = orc.to_jax(_batch(cfg, N, seed=1))
        xcfg = jx.ExchangeConfig() if label in EXACT else _jxcfg(label, P)
        with _oracles():
            (loss, parts), g = jax.value_and_grad(
                lambda p: jloss(p, b, jcfg, xcfg), has_aux=True)(jp)
        _JAX[key] = float(loss), float(parts["aux"]), orc.flat(g)
    return _JAX[key]


GRAD_CASES = [(P, label) for P in (2, 4) for label in CASES]


@pytest.mark.parametrize("P,label", GRAD_CASES)
def test_summed_gradients_match_jax(side, P, label):
    arch = CASES[label][0]
    _, cfg, jp = side[arch]
    want_loss, want_aux, want = _jax_grads(side, label, P)
    runs = _ranks(P)
    got_loss = sum(r[label]["loss"] for r in runs)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(sum(r[label]["aux"] for r in runs), want_aux,
                               rtol=LOSS_RTOL, atol=1e-9)
    _check_grads(jp, cfg, runs, label, want)


def _check_grads(jp, cfg, runs, label, want):
    """Rank 0's summed gradient against JAX's, each leaf within
    ``GRAD_RTOL`` of its largest value; every rank's bit for bit rank
    0's."""
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    got = orc.flat(orc.jax_layout(jp, tree_unflatten_like(
        tp, runs[0][label]["grads"])))
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= GRAD_RTOL * scale, (k, err, scale)
    for r in runs[1:]:
        for a, b in zip(r[label]["grads"], runs[0][label]["grads"]):
            np.testing.assert_array_equal(a, b)


def _expect(cfg, label, P, rank):
    """What ``label``'s forward + backward make rank ``rank`` call: (halo
    calls, hand-offs, state bytes received) from the shapes."""
    arch, mode, N, kw = CASES[label]
    Np = N // P
    halo = 0
    if cfg.local_global and mode == "prism" and not kw:
        n_halo = min(-(-cfg.window // Np), P - 1)
        halo = n_halo * (cfg.n_layers // 2) if n_halo < P - 1 else 0
    s = cfg.ssm
    if cfg.family == "hybrid":
        di = s.expand * cfg.d_model
        mixers = [B * di * (s.state_size + (s.conv_width - 1)) * 4
                  ] * cfg.n_layers
    elif cfg.family == "ssm":
        H = s.mlstm_heads
        dh = int(cfg.d_model * s.proj_factor) // H
        groups = cfg.n_layers // s.slstm_every
        mixers = ([B * H * (dh * dh + dh + 1) * 4] * (s.slstm_every - 1)
                  + [4 * B * cfg.d_model * 4]) * groups
    else:
        mixers = []
    return halo, len(mixers), (sum(mixers) if rank > 0 else 0)


@pytest.mark.parametrize("P,label", GRAD_CASES)
def test_halo_and_state_calls_and_bytes(side, P, label):
    """The halo runs at P 4 only (at P 2 the window spans the one other
    part: the gather); every mixer hands its state on once a forward, and
    its cotangent comes back once a backward, f32, in the same layout."""
    cfg = side[CASES[label][0]][1]
    for rank, r in enumerate(_ranks(P)):
        bk = r[label]["booked"]
        halo, mixers, state = _expect(cfg, label, P, rank)
        assert bk["halo_calls"] == halo and bk["state_calls"] == mixers
        assert bk["state"] == state and bk["output"] == 0
        if label == "gemma2/prism" and P == 4:
            assert halo == 2 * (cfg.n_layers // 2) > 0
        # xLSTM's last rank gathers nothing and receives no cotangent
        assert bk["grad"] > 0 or (cfg.family == "ssm" and rank == P - 1)


@pytest.mark.parametrize("label", CASES)
def test_the_state_cotangent_bytes(side, label):
    """The reverse chain at P 4: rank p < P − 1 receives, per mixer, the
    f32 cotangent of the state it sent (the same bytes as the state: its
    leaves are f32, the conv tail too in f32 configs)."""
    cfg = side[CASES[label][0]][1]
    runs = _ranks(4)
    if cfg.family not in ("hybrid", "ssm"):
        assert all(r[label]["booked"]["state"] == 0 for r in runs)
        return
    fwd = [r[label]["booked"]["state"] for r in runs]
    assert fwd[0] == 0 and len(set(fwd[1:])) == 1
    grads = [r[label]["booked"]["grad"] for r in runs]
    # the last rank receives no state cotangent: the others' grad bytes
    # exceed its by the state's bytes (the gathers' cotangents alike)
    assert {g - grads[-1] for g in grads[:-1]} == {fwd[1]}


def _jax_steps(side, label, P):
    arch, _, N, _ = CASES[label]
    jcfg, cfg, jp = side[arch]
    p, o, out = jp, jinit(jp), []
    with _oracles():
        step = jax.jit(jbuild(jcfg, _jxcfg(label, P),
                              JOpt(lr=1e-3, warmup_steps=1)))
        for s in (2, 3):
            p, o, m = step(p, o, orc.to_jax(_batch(cfg, N, seed=s)))
            out.append(m)
    return out


@pytest.mark.parametrize("P,label", STEP_RUNS)
def test_two_steps_match_jax_and_replicas_stay_identical(side, P, label):
    want = _jax_steps(side, label, P)
    runs = _ranks(P)
    for r in runs[1:]:
        for a, b in zip(r[label]["params"], runs[0][label]["params"]):
            np.testing.assert_array_equal(a, b)
    assert len(runs[0][label]["metrics"]) == len(want) == 2
    for got, m in zip(runs[0][label]["metrics"], want):
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], float(m[k]), rtol=STEP_RTOL,
                                       atol=1e-9, err_msg=k)


def _jax_broadcast(side, label, P):
    """JAX's loss of the broadcast logits and its gradient, the exchange
    composed per partition."""
    c = _broadcast_cases(side, P)[label]
    jcfg, _, jp = side[c["arch"]]
    xcfg = jx.ExchangeConfig(jx.ExchangeMode.PRISM, seq_axis="seq",
                             seq_shards=P, L=c["L"])

    def loss(p):
        if label.startswith("vit"):
            logits = jvit.forward_vit(p, jnp.asarray(c["images"]), jcfg,
                                      xcfg)
            z = jax.nn.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, jnp.asarray(c["labels"])[
                :, None], axis=-1)[:, 0]
            return jnp.mean(z - gold)
        logits, _ = jtfm.forward_lm(p, {"tokens": jnp.asarray(c["tokens"])},
                                    jcfg, xcfg, last_only=True)
        return jnp.mean(jax.nn.logsumexp(logits, axis=-1))
    with _oracles():
        value, g = jax.value_and_grad(loss)(jp)
    return float(value), orc.flat(g)


BROADCAST_CASES = [(P, label) for P in (2, 4)
                   for label in ("vit/broadcast", "llama/last_only")]


@pytest.mark.parametrize("P,label", BROADCAST_CASES)
def test_broadcast_logits_take_the_gradient(side, P, label):
    """Every rank holds the logits (the ViT's from rank 0, the LM's last
    position from rank P − 1) and takes 1/P of the loss; the broadcast's
    backward sums the cotangents onto the source: the summed gradient is
    JAX's, and only the source books the reduce's f32 bytes."""
    arch = VIT if label.startswith("vit") else LLAMA
    _, cfg, jp = side[arch]
    want_loss, want = _jax_broadcast(side, label, P)
    runs = _ranks(P)
    np.testing.assert_allclose(runs[0][label]["loss"], want_loss,
                               rtol=LOSS_RTOL)
    _check_grads(jp, cfg, runs, label, want)
    src = 0 if arch == VIT else P - 1
    n = runs[0][label]["logits"].size * 4
    for rank, r in enumerate(runs):
        bk = r[label]["booked"]
        assert bk["output"] == (0 if rank == src else n)
        gathers = bk["grad"] - ((P - 1) * n if rank == src else 0)
        assert gathers == runs[src][label]["booked"]["grad"] - (P - 1) * n
