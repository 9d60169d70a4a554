"""Shared pieces of the port's training tests: the JAX weights and batches
of a reduced f32 config, and the port's trees in the JAX package's layout.

The JAX package stacks each layer stack on leading axes
(``transformer._stack``); the port keeps its layers as lists
(``repro_torch.models.bridge``).  ``jax_layout`` stacks a port tree (its
gradients, its updated params) back into the JAX layout, so every leaf
compares with the JAX one of the same name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import registry as jreg
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_numpy

LM_ARCHS = ("llama3.2-1b", "internlm2-1.8b", "qwen1.5-32b", "gemma2-27b",
            "deepseek-moe-16b", "deepseek-v2-236b", "whisper-large-v3",
            "llama-3.2-vision-11b", "hymba-1.5b", "xlstm-350m")


def configs(arch, **over):
    """(JAX config, port config): the reduced f32 variant of ``arch``."""
    over = {"dtype": "float32", **over}
    return jget(arch).reduced(**over), get_config(arch).reduced(**over)


def weights(jcfg, cfg, seed=0):
    """(JAX params, port params carried across by the bridge)."""
    jp = jreg.init_params(jcfg, seed=seed)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg)


def batch(cfg, B, N, seed):
    """A numpy batch: tokens and labels [B, N] int32, and the memory
    families' frames / image embeddings (f32)."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (B, N)).astype(np.int32),
           "labels": rng.randint(0, cfg.vocab_size, (B, N)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.randn(B, cfg.encoder_seq,
                                  cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.randn(B, cfg.image_tokens,
                                        cfg.d_model).astype(np.float32)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _collect(jsub, plist):
    """The stacked JAX subtree ``jsub`` rebuilt from its port layers
    ``plist`` (a list inside a layer is an inner stack: its items follow
    the layer's, as the JAX package's ``[groups, inner, ...]``)."""
    if jsub is None:
        return None
    if isinstance(plist[0], list):
        return _collect(jsub, [x for p in plist for x in p])
    if isinstance(jsub, dict):
        return {k: _collect(jsub[k], [p[k] for p in plist]) for k in jsub}
    arr = np.stack([_np(p) for p in plist])
    return arr.reshape(np.shape(jsub))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def jax_layout(jtree, ptree):
    """The port tree ``ptree`` (params or gradients) as numpy f32 in the
    JAX tree ``jtree``'s layout."""
    out = {}
    for k, j in jtree.items():
        p = ptree[k]
        if isinstance(p, list) and not isinstance(j, list):
            out[k] = _collect(j, p)
        elif isinstance(j, dict):
            out[k] = jax_layout(j, p)
        else:
            out[k] = None if j is None else _np(p)
    return out


def flat(tree):
    """{key path: numpy f32 leaf} of a JAX-layout tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in leaves}


# --- one train step against JAX's build_train_step --------------------------

GRAD_RTOL = 2e-5       # of the leaf's largest JAX gradient
STEP_RTOL = 1e-5       # loss, nll, aux, grad_norm
PARAM_ATOL = 1e-6      # updated params where the gradient's sign is sure
SURE = 100.0           # |g| above SURE × the leaf's gradient disagreement


def _split(b, n):
    B = next(iter(b.values())).shape[0]
    return [{k: v[i * B // n:(i + 1) * B // n] for k, v in b.items()}
            for i in range(n)]


def check_step(arch, jx, tx, *, grad_accum=1, B=2, N=16, over=None,
               gates=False):
    """One train step of the port against JAX's ``build_train_step`` from
    the same weights and batch, and each microbatch's gradient against
    ``jax.grad`` of JAX's ``loss_fn``.

    Gradients: every leaf within ``GRAD_RTOL`` of its largest JAX value.
    Metrics: loss, nll, aux, grad_norm and lr within ``STEP_RTOL``.
    Params after the update: AdamW's first step moves a parameter by about
    lr · sign(g) (m̂/(√v̂ + ε) = g/(|g| + ε)), so an element whose gradient
    sits within the two packages' disagreement of zero may move the other
    way, and one whose |g| is near ε moves by a fraction that follows g's
    last bits.  The line: where JAX's |g| exceeds ``SURE`` × the leaf's
    largest gradient disagreement (so the signs agree and g differs by at
    most 1 %), or where both gradients are exactly 0 (an embedding row no
    token reads), the params match within ``PARAM_ATOL``; elsewhere they
    differ by at most 2 · lr (plus ``PARAM_ATOL``); at least 90 % of the
    elements must be on the sure side."""
    from repro.train.optimizer import OptConfig as JOpt
    from repro.train.optimizer import adamw_init as jinit
    from repro.train.train_step import build_train_step as jbuild
    from repro.train.train_step import loss_fn as jloss
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.train_step import _grads_of, build_train_step
    from repro_torch.utils.tree import tree_unflatten_like

    jcfg, cfg = configs(arch, **(over or {}))
    jp, tp = weights(jcfg, cfg)
    if gates:                          # the vlm's gates at 0 erase the memory
        jp = dict(jp, cross_layers=dict(jp["cross_layers"],
                                        gate=jp["cross_layers"]["gate"] + 0.5))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    b = batch(cfg, B * grad_accum, N, seed=2)
    jgrad = jax.jit(jax.grad(lambda p, bb: jloss(p, bb, jcfg, jx)[0]))
    g_mean, t_mean, noise = None, None, None
    for mb in _split(b, grad_accum):
        want = jax_layout(jp, jgrad(jp, to_jax(mb)))
        _, _, g = _grads_of(tp, to_torch(mb), cfg, tx)
        got = jax_layout(jp, tree_unflatten_like(tp, g))
        fw, fg = flat(want), flat(got)
        assert fw.keys() == fg.keys()
        for k in fw:
            scale = max(float(np.abs(fw[k]).max()), 1e-30)
            err = float(np.abs(fg[k] - fw[k]).max())
            assert err <= GRAD_RTOL * scale, (k, err, scale)
        g_mean = ({k: fw[k] / grad_accum for k in fw} if g_mean is None else
                  {k: g_mean[k] + fw[k] / grad_accum for k in fw})
        t_mean = ({k: fg[k] / grad_accum for k in fg} if t_mean is None else
                  {k: t_mean[k] + fg[k] / grad_accum for k in fg})
        noise = {k: max(float(np.abs(fg[k] - fw[k]).max()),
                        0.0 if noise is None else noise[k]) for k in fw}
    opt = dict(lr=1e-3, warmup_steps=1)
    jnew, _, jm = jax.jit(jbuild(jcfg, jx, JOpt(**opt), grad_accum=grad_accum)
                          )(jp, jinit(jp), to_jax(b))
    tnew, ts, tm = build_train_step(cfg, tx, OptConfig(**opt),
                                    grad_accum=grad_accum)(
        tp, adamw_init(tp), to_torch(b))
    assert int(ts.step) == 1
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=STEP_RTOL, atol=1e-7, err_msg=k)
    lr = float(jm["lr"])
    fj, ft = flat(jnew), flat(jax_layout(jp, tnew))
    n_sure = 0
    for k in fj:
        sure = ((np.abs(g_mean[k]) > SURE * max(noise[k], 1e-12))
                | ((g_mean[k] == 0) & (t_mean[k] == 0)))
        d = np.abs(ft[k] - fj[k])
        assert (d[sure] <= PARAM_ATOL).all(), (k, float(d[sure].max()))
        assert (d <= 2 * lr + PARAM_ATOL).all(), (k, float(d.max()))
        n_sure += int(sure.sum())
    assert n_sure > 0.9 * sum(v.size for v in fj.values())
    return tm


# --- a mesh gradient's bytes under ZeRO-3 gathered a layer at a time --------

def _axes(entry):
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def zero3_count(shapes, spec, leads, D, M, *, tied=False, tp_keys=(),
                moved=(), sliced=(), seq_row=False, remat=True,
                accum=1, itemsize=4):
    """What one rank of a ``("data", "model")`` mesh receives in one mesh
    gradient (``train_step.mesh_gradients``) for its parameters, from the
    shapes and the specs alone → ``{axis: {kind: bytes}}`` with ``param``
    and ``grad``, and ``{axis: {kind: calls}}`` (the model's layers
    counted by their first stack dim: the archs whose layers are one
    stack dim).

    ``shapes``/``spec``/``leads``: each JAX-layout key's whole shape, param
    spec and stack dims.  A layer is gathered as the model reaches it: one
    staged call over ``data`` of the rank's block of each of its leaves
    the spec shards there (a stack-sharded leaf: the owner's row, every
    rank sending a row), then one over ``model`` of the leaves the rank
    runs whole or moved (``tp_keys``/``moved``: the TP leaves, those not
    the JAX block); in the forward and again in the recompute (``remat``),
    the top-level leaves once a use (a tied table twice).  The backward
    reduce-scatters each gathered piece's f32 gradient once a use over
    ``data`` (the batch sharded there), and over ``model`` the moved and
    ``sliced`` ones, or with ``seq_row`` (the sequence over the row) every
    leaf gathered there.  At the end the row sums, in one call, every
    leaf's block it did not sum yet (``seq_row``) or the sliced and moved
    ones, and ``data`` the leaves it replicates.
    ``accum`` microbatches gather and reduce-scatter each time."""
    byts = {a: {"param": 0, "grad": 0} for a in ("data", "model")}
    calls = {a: {"param": 0, "grad": 0} for a in ("data", "model")}
    layers = {}                          # (stack, kind of call) → layers
    end = {"data": False, "model": False}
    for k, W in shapes.items():
        s = list(spec[k]) + [None] * (len(W) - len(spec[k]))
        lead = leads[k]
        L = int(np.prod(W[:lead])) if lead else 1
        uses = (1 + tied) if k == "embed/table" else 1
        fwd = L * uses * (2 if remat and lead else 1) * accum
        bwd = L * uses * accum
        div = [D if "data" in _axes(e) else M if "model" in _axes(e) else 1
               for e in s]
        block = [w // d for w, d in zip(W, div)]
        piece = int(np.prod(block[lead:]))
        on_data = D > 1 and any("data" in _axes(e) for e in s)
        on_model = (M > 1 and any("model" in _axes(e) for e in s)
                    and (k not in tp_keys or k in moved))
        stack = k.split("/")[0] if lead else k
        if on_data:
            byts["data"]["param"] += fwd * (D - 1) * piece * itemsize
            byts["data"]["grad"] += bwd * (D - 1) * piece * 4
            layers.setdefault((stack, "data"), (L, uses, lead))
        model_sum = seq_row or k in moved or k in sliced
        if on_model:
            mpiece = int(np.prod([w // (M if "model" in _axes(e) else 1)
                                  for w, e in zip(W[lead:], s[lead:])]))
            byts["model"]["param"] += fwd * (M - 1) * mpiece * itemsize
            layers.setdefault((stack, "model"), (L, uses, lead))
            if model_sum:
                byts["model"]["grad"] += bwd * (M - 1) * mpiece * 4
                layers[(stack, "model-grad")] = (L, uses, lead)
        n = int(np.prod(block))
        if M > 1 and (seq_row or model_sum) and not (on_model and model_sum):
            byts["model"]["grad"] += (M - 1) * n * 4
            end["model"] = True
        if D > 1 and not on_data:
            byts["data"]["grad"] += (D - 1) * n * 4
            end["data"] = True
    for (stack, kind), (L, uses, lead) in layers.items():
        n = L * uses * accum
        axis = "data" if kind == "data" else "model"
        if kind != "model-grad":
            calls[axis]["param"] += n * (2 if remat and lead else 1)
        if kind != "model":
            calls[axis]["grad"] += n
    for axis, more in end.items():
        calls[axis]["grad"] += int(more)
    return byts, calls


# --- a rank's peak under ZeRO-3, counted by the dry run ---------------------

def added_layer_bytes(arch, kind, shape, mode, *, B, N, L, accum=1,
                      fsdp=False, n=2):
    """What each layer added to the reduced f32 ``arch`` (from n to 2n
    layers) adds to the peak of the step of ``kind`` of rank (0, 0) of a
    ``shape`` mesh at global batch ``B``, counted by the dry run
    (``launch.dryrun.trace_step`` on meta tensors: its ``StepCounter``
    holds every storage the step allocates until it is freed).  ``fsdp``:
    the serving plan forced to ZeRO-3."""
    import dataclasses
    from unittest import mock

    from repro_torch.core.exchange import ExchangeMode
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.sharding import specs

    make = specs.make_plan

    def plan(*a, **k):
        return dataclasses.replace(make(*a, **k), fsdp=True)

    mesh = make_auto_mesh(shape, ("data", "model"))
    peaks = []
    for layers in (n, 2 * n):
        cfg = get_config(arch).reduced(dtype="float32", n_layers=layers)
        with mock.patch.object(specs, "make_plan", plan if fsdp else make):
            got = trace_step(cfg, kind, mesh, mode=ExchangeMode(mode), B=B,
                             N=N, L=L, grad_accum=accum,
                             coords={"data": 0, "model": 0})
        peaks.append(got["counter"].peak)
    return (peaks[1] - peaks[0]) / n
