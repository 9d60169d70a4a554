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
