"""The recurrent mixers in the port (``repro_torch.models.ssm``: Mamba,
mLSTM, sLSTM) against the JAX package's, f32, the JAX weights carried
across; the state hand-off's packing; the configs of every arch.

* each mixer's scan and step against the JAX package's on the same
  weights and inputs, from zeros and from a given starting state: output
  and final state within 1e-5 (PERF.md §6, modules);
* step by step equals the scan, in the port;
* a scan split in two, the second part starting from the first part's
  final state (Mamba: and its conv tail), equals the whole-sequence scan
  of the port and of the JAX package, with a second part shorter than
  the conv's W − 1 = 3 tokens included: the hand-off is exact;
* ``handoff.pack`` / ``unpack`` round trips bit for bit and
  ``state_bytes`` counts what travels;
* every arch of the JAX package's config registry has a port config equal
  field for field, full and reduced.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import ssm as jssm
from repro_torch.core import handoff
from repro_torch.models import ssm as tssm
from repro_torch.models.bridge import tensor_from_numpy

MOD_TOL = 1e-5
D = 64
B, N = 2, 20                  # N: two chunks of the reduced chunk 8 and a
                              # partial one
SPLITS = (7, 18, 2)           # where the split scans cut N (18: a second
                              # part of 2 < W − 1 tokens; 2: a first one)
MIXERS = ("mamba", "mlstm", "slstm")


def _cfg(mixer):
    arch = "hymba-1.5b" if mixer == "mamba" else "xlstm-350m"
    return jget(arch).reduced(dtype="float32").ssm


def _diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _weights(mixer, seed=0):
    cfg = _cfg(mixer)
    key = jax.random.PRNGKey(seed)
    init = {"mamba": lambda: jssm.init_mamba(key, D, cfg, jnp.float32),
            "mlstm": lambda: jssm.init_mlstm(key, D, cfg, jnp.float32),
            "slstm": lambda: jssm.init_slstm(key, D, cfg, jnp.float32)}
    p = jax.tree.map(np.asarray, init[mixer]())
    if mixer == "mamba":        # a nonzero time-step bias and skip
        g = np.random.RandomState(seed + 7)
        p["dt_bias"] = g.randn(*p["dt_bias"].shape).astype(np.float32)
        p["d_skip"] = g.randn(*p["d_skip"].shape).astype(np.float32)
    return p, jax.tree.map(tensor_from_numpy, p)


def _x(seed, n=N):
    return np.random.RandomState(seed).randn(B, n, D).astype(np.float32)


def _state(mixer, seed):
    """A random starting state in the mixer's layout (numpy)."""
    cfg, g = _cfg(mixer), np.random.RandomState(seed)
    if mixer == "mamba":
        di = cfg.expand * D
        return {"h": g.randn(B, di, cfg.state_size).astype(np.float32),
                "conv": g.randn(B, cfg.conv_width - 1, di).astype(np.float32)}
    if mixer == "mlstm":
        H, dh = tssm.mlstm_dims(D, cfg)
        return {"C": g.randn(B, H, dh, dh).astype(np.float32),
                "n": g.randn(B, H, dh).astype(np.float32),
                "m": g.randn(B, H).astype(np.float32)}
    return {"c": g.randn(B, D).astype(np.float32),
            "n": np.abs(g.randn(B, D)).astype(np.float32) + 0.5,
            "h": g.randn(B, D).astype(np.float32),
            "m": g.randn(B, D).astype(np.float32)}


def _jax_scan(mixer, p, x, st=None):
    """The JAX package's scan → (y, final state as a dict; Mamba's
    without its conv tail, which its scan does not return)."""
    cfg = _cfg(mixer)
    x = jnp.asarray(x)
    if mixer == "mamba":
        y, h = jssm.mamba_scan(p, x, cfg,
                               None if st is None else jnp.asarray(st["h"]))
        return np.asarray(y), {"h": np.asarray(h)}
    fn = jssm.mlstm_scan if mixer == "mlstm" else jssm.slstm_scan
    y, fin = fn(p, x, cfg, state0=None if st is None else
                jax.tree.map(jnp.asarray, st))
    return np.asarray(y), jax.tree.map(np.asarray, fin)


def _port_scan(mixer, p, x, st=None):
    cfg = _cfg(mixer)
    x = torch.from_numpy(x)
    st = None if st is None else {k: torch.from_numpy(v)
                                  for k, v in st.items()}
    if mixer == "mamba":
        h0, conv = (None, None) if st is None else (st["h"], st["conv"])
        y, fin = tssm.mamba_scan(p, x, cfg, h0, conv)
    else:
        fn = tssm.mlstm_scan if mixer == "mlstm" else tssm.slstm_scan
        y, fin = fn(p, x, cfg, st)
    return y.numpy(), {k: v.numpy() for k, v in fin.items()}


@pytest.mark.parametrize("start", ["zeros", "given"])
@pytest.mark.parametrize("mixer", MIXERS)
def test_scan_matches_jax(mixer, start):
    """From zeros (the JAX default) and from a given state: Mamba's given
    state is h alone here, since the JAX scan starts its conv from zeros."""
    jp, tp = _weights(mixer)
    x = _x(1)
    st = None if start == "zeros" else _state(mixer, 2)
    if st is not None and mixer == "mamba":
        st = {"h": st["h"], "conv": np.zeros_like(st["conv"])}
    yj, fj = _jax_scan(mixer, jp, x, st)
    yt, ft = _port_scan(mixer, tp, x, st)
    assert yt.shape == (B, N, D)
    assert _diff(yt, yj) <= MOD_TOL
    for k, v in fj.items():
        assert ft[k].shape == v.shape and ft[k].dtype == np.float32
        assert _diff(ft[k], v) <= MOD_TOL * max(1.0, np.abs(v).max())
    if mixer == "mamba":        # the conv tail: the last W − 1 inputs
        assert ft["conv"].shape == (B, 3, 2 * D)


@pytest.mark.parametrize("mixer", MIXERS)
def test_step_matches_jax(mixer):
    """One decode token from a given state (Mamba: its conv tail too)."""
    cfg = _cfg(mixer)
    jp, tp = _weights(mixer)
    x = _x(3, 1)
    st = _state(mixer, 4)
    step_j = {"mamba": jssm.mamba_step, "mlstm": jssm.mlstm_step,
              "slstm": jssm.slstm_step}[mixer]
    step_t = {"mamba": tssm.mamba_step, "mlstm": tssm.mlstm_step,
              "slstm": tssm.slstm_step}[mixer]
    yj, fj = step_j(jp, jnp.asarray(x), cfg, jax.tree.map(jnp.asarray, st))
    yt, ft = step_t(tp, torch.from_numpy(x), cfg,
                    {k: torch.from_numpy(v) for k, v in st.items()})
    assert _diff(yt.numpy(), yj) <= MOD_TOL
    for k, v in fj.items():
        assert _diff(ft[k].numpy(), v) <= MOD_TOL * max(1.0, np.abs(v).max())


@pytest.mark.parametrize("mixer", MIXERS)
def test_step_by_step_equals_the_scan(mixer):
    cfg = _cfg(mixer)
    _, tp = _weights(mixer)
    x = torch.from_numpy(_x(5))
    step = {"mamba": tssm.mamba_step, "mlstm": tssm.mlstm_step,
            "slstm": tssm.slstm_step}[mixer]
    init = {"mamba": lambda: tssm.init_mamba_state(B, D, cfg, torch.float32),
            "mlstm": lambda: tssm.init_mlstm_state(B, D, cfg),
            "slstm": lambda: tssm.init_slstm_state(B, D)}[mixer]
    y_scan, fin = _port_scan(mixer, tp, x.numpy())
    st, ys = init(), []
    for t in range(N):
        y, st = step(tp, x[:, t:t + 1], cfg, st)
        ys.append(y)
    assert _diff(torch.cat(ys, dim=1).numpy(), y_scan) <= MOD_TOL
    for k, v in fin.items():
        assert _diff(st[k].numpy(), v) <= MOD_TOL * max(1.0, np.abs(v).max())


@pytest.mark.parametrize("cut", SPLITS)
@pytest.mark.parametrize("mixer", MIXERS)
def test_split_scan_hands_off_exactly(mixer, cut):
    """The second part from the first part's final state equals the JAX
    package's whole-sequence scan at its positions."""
    jp, tp = _weights(mixer)
    x = _x(6)
    yj, fj = _jax_scan(mixer, jp, x)
    y0, f0 = _port_scan(mixer, tp, x[:, :cut])
    y1, f1 = _port_scan(mixer, tp, x[:, cut:], f0)
    assert _diff(np.concatenate([y0, y1], axis=1), yj) <= MOD_TOL
    for k, v in fj.items():
        assert _diff(f1[k], v) <= MOD_TOL * max(1.0, np.abs(v).max())
    if mixer == "mamba":        # the conv tail spans both parts at cut 18
        whole = _port_scan(mixer, tp, x)[1]["conv"]
        np.testing.assert_array_equal(f1["conv"], whole)


def test_mamba_conv_tail_is_the_pre_conv_inputs():
    """The conv tail is the last W − 1 inputs of the conv (``xs``, the
    in-projection's first half), not its outputs: a second part of one
    token reads two of the first part's inputs."""
    cfg = _cfg("mamba")
    _, tp = _weights("mamba")
    x = torch.from_numpy(_x(8))
    di = cfg.expand * D
    xs = (x @ tp["w_in"])[..., :di]
    _, fin = tssm.mamba_scan(tp, x, cfg)
    np.testing.assert_array_equal(fin["conv"].numpy(),
                                  xs[:, -(cfg.conv_width - 1):].numpy())


@pytest.mark.parametrize("mixer", MIXERS)
def test_pack_round_trips_and_counts_the_bytes(mixer):
    st = {k: torch.from_numpy(v) for k, v in _state(mixer, 9).items()}
    if mixer == "mamba":         # the conv tail in the model dtype
        st["conv"] = st["conv"].to(torch.bfloat16)
    buf = handoff.pack(st)
    assert buf.dtype == torch.uint8
    assert buf.numel() == handoff.state_bytes(st) == sum(
        t.numel() * t.element_size() for t in st.values())
    back = handoff.unpack(buf, st)
    for k, v in st.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)


def test_handoff_without_a_group_is_the_plain_scan():
    _, tp = _weights("slstm")
    cfg = _cfg("slstm")
    x = torch.from_numpy(_x(10))
    def like():
        raise AssertionError("no state template without a group")
    got = handoff.handoff_scan(
        None, lambda st: tssm.slstm_scan(tp, x, cfg, st), like, x.device)
    assert torch.equal(got, tssm.slstm_scan(tp, x, cfg)[0])


def _jax_archs():
    from repro.configs import _MODULES
    return sorted(_MODULES)


@pytest.mark.parametrize("arch", _jax_archs())
def test_every_jax_arch_has_a_port_config(arch):
    from repro_torch.configs import get_config as tget
    assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(jget(arch))
    assert dataclasses.asdict(tget(arch).reduced(dtype="float32")) == \
        dataclasses.asdict(jget(arch).reduced(dtype="float32"))
