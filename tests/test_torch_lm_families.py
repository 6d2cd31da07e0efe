"""The port's LM families beyond the dense ones (``repro_torch.models``:
linear attention, RWKV6, Mamba, MoE, the encoder-decoder and the VLM's
patch front end) against the JAX package's, on the CPU in float32.

Inputs are drawn with NumPy from a seed; weights come from the
reference's own initialisers (``init_tree``/``init_params``; the
zero-initialised mixing constants, decays, bonuses and biases are
redrawn so that they take part) and are carried across as NumPy arrays.
Contract:

  * each module (``chunked_gla``, ``gla_decode``, the time and channel
    mix, Mamba, the MoE FFN, non-causal, cross and decode attention)
    within ``ATOL`` = 1e-4 of its reference twin (outputs of up to about
    30 differ by the order of float32 sums, a few 1e-6);
  * whole models (``tests/test_decode.py``'s ``t-rwkv``, ``t-jamba`` and
    ``t-encdec``, and ``internvl2-2b`` reduced) within ``ATOL`` of the
    reference's logits in ``forward``, ``prefill`` and every
    ``decode_step``, and prefill plus decode within the reference's own
    decode tolerance (``DECODE_TOL`` = 2e-3) of the full forward;
  * ROADMAP C.9: at the chunk every config ships (64) the reference's
    ``chunked_gla`` overflows where decays lie near the bound; the port's
    is finite and agrees with the sequential oracle, and any prompt
    length prefills;
  * ROADMAP C.10: the reference's ``generate`` grows recurrent caches
    whose axis 2 equals the prompt length (RWKV's state: it raises;
    Mamba's conv cache: wrong tokens); the port's equals greedy decoding
    by full forwards.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig, all_configs
from repro.launch.mesh import make_mesh, use_mesh
from repro.launch.train import reduced_config
from repro.models import attention as jattn
from repro.models import linear_attn as jla
from repro.models import mamba as jmb
from repro.models import model as M
from repro.models import moe as jmoe
from repro.models import rwkv as jrk
from repro.models.layers import init_tree
from repro.models.sharding import MeshAxes
from repro.serve.engine import LMServer as JaxLMServer
from repro_torch.models import LM, params_from_arrays
from repro_torch.models import attention as tattn
from repro_torch.models import linear_attn as tla
from repro_torch.models import mamba as tmb
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trk
from repro_torch.models.layers import Init
from repro_torch.serve import LMServer

ATOL = 1e-4
DECODE_TOL = 2e-3
B = 2

# tests/test_decode.py's configs
CONFIGS = {
    "t-rwkv": ModelConfig(
        name="t-rwkv", family="rwkv", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=100, head_dim=16, rwkv_head_dim=16, dtype="float32", la_chunk=4),
    "t-jamba": ModelConfig(
        name="t-jamba", family="hybrid", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=100, n_experts=4, moe_top_k=2, moe_dff=128, moe_every=2,
        attn_every=4, mamba_d_state=8, mamba_head_dim=16, dtype="float32", la_chunk=4,
        chunk_q=16, capacity_factor=8.0),
    "t-encdec": ModelConfig(
        name="t-encdec", family="encdec", n_layers=2, encoder_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=100, dtype="float32", chunk_q=16,
        frontend="audio_stub"),
}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _module(cls, cfg, tree):
    """The port's module ``cls(cfg, ...)`` holding the reference's weights."""
    mod = cls(cfg, Init(None, "cpu", torch.float32, empty=True))
    mod.load_state_dict({name: _t(v) for name, v in _flat(tree)})
    return mod


def _tree(defs, seed, redraw=()):
    """The reference's initialiser over ``defs``; the leaves named in
    ``redraw`` (zeros or ones there) get normal draws of scale 0.5."""
    tree = jax.tree.map(np.array, init_tree(defs, jax.random.key(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    for name in redraw:
        tree[name] = rng.normal(0, 0.5, tree[name].shape).astype(np.float32)
    return tree


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0)


# --------------------------------------------------------------------------
# the chunked GLA engine
# --------------------------------------------------------------------------
def _gla_inputs(seed, s=32, h=4, dk=16, dv=8, scalar=False, bound=False):
    rng = np.random.default_rng(seed)
    r = rng.normal(0, 1, (B, s, h, dk)).astype(np.float32)
    k = rng.normal(0, 1, (B, s, h, dk)).astype(np.float32)
    v = rng.normal(0, 1, (B, s, h, dv)).astype(np.float32)
    # decays near the bound (raw logits of 8 to 12: log w within 1e-3 of -2.5)
    raw = (rng.uniform(8, 12, (B, s, h, 1 if scalar else dk)) if bound
           else rng.normal(0, 2, (B, s, h, 1 if scalar else dk)))
    log_w = np.asarray(jla.bounded_log_decay(jnp.asarray(raw, jnp.float32)))
    # the two sigmoids may differ in the last bit
    _close(tla.bounded_log_decay(_t(raw.astype(np.float32))), log_w, atol=1e-6)
    return r, k, v, log_w


@pytest.mark.parametrize("scalar", [False, True], ids=["vector", "scalar"])
@pytest.mark.parametrize("bonus", [False, True], ids=["no_u", "u"])
@pytest.mark.parametrize("start", [False, True], ids=["zero_state", "state0"])
def test_chunked_gla_matches_the_reference(scalar, bonus, start):
    """Four chunks of 8 against the reference's chunked form and both
    packages' sequential oracles: outputs and final states."""
    r, k, v, log_w = _gla_inputs(1, scalar=scalar)
    rng = np.random.default_rng(2)
    u = rng.normal(0, 1, (4, 16)).astype(np.float32) if bonus else None
    s0 = rng.normal(0, 1, (B, 4, 16, 8)).astype(np.float32) if start else None
    jargs = [jnp.asarray(a) for a in (r, k, v, log_w)]
    jkw = {"u": None if u is None else jnp.asarray(u),
           "state0": None if s0 is None else jnp.asarray(s0)}
    targs = [_t(a) for a in (r, k, v, log_w)]
    tkw = {"u": None if u is None else _t(u), "state0": None if s0 is None else _t(s0)}
    want_y, want_s = jla.chunked_gla(*jargs, chunk=8, **jkw)
    oracle_y, oracle_s = jla.gla_reference(*jargs, **jkw)
    got_y, got_s = tla.chunked_gla(*targs, chunk=8, **tkw)
    port_oracle_y, port_oracle_s = tla.gla_reference(*targs, **tkw)
    assert got_y.dtype == torch.float32 and got_s.shape == (B, 4, 16, 8)
    for got, want in ((got_y, want_y), (got_s, want_s), (got_y, oracle_y),
                      (got_s, oracle_s), (port_oracle_y, oracle_y),
                      (port_oracle_s, oracle_s)):
        _close(got, want)


@pytest.mark.parametrize("scalar", [False, True], ids=["vector", "scalar"])
def test_gla_decode_matches_the_reference(scalar):
    r, k, v, log_w = _gla_inputs(3, s=1, scalar=scalar)
    state = np.random.default_rng(4).normal(0, 1, (B, 4, 16, 8)).astype(np.float32)
    u = np.random.default_rng(5).normal(0, 1, (4, 16)).astype(np.float32)
    want = jla.gla_decode(*(jnp.asarray(a[:, 0]) for a in (r, k, v, log_w)),
                          jnp.asarray(state), u=jnp.asarray(u))
    got = tla.gla_decode(*(_t(a[:, 0]) for a in (r, k, v, log_w)), _t(state), u=_t(u))
    for g, w in zip(got, want):
        _close(g, w)


def test_chunk_and_padding_do_not_change_the_function():
    """The port's chunk is at most ``GLA_MAX_CHUNK``; a length that is no
    multiple of it is padded.  Any chunk gives the oracle's answer."""
    r, k, v, log_w = _gla_inputs(6, s=37)
    args = [_t(a) for a in (r, k, v, log_w)]
    want_y, want_s = tla.gla_reference(*args)
    for chunk in (1, 5, 16, 32, 64, 1000):
        y, s = tla.chunked_gla(*args, chunk=chunk)
        assert y.shape == (B, 37, 4, 8)
        _close(y, _np(want_y))
        _close(s, _np(want_s))


def test_c9_reference_overflows_at_the_shipped_chunk_and_the_port_does_not():
    """ROADMAP C.9: decays near the bound over one 64-position chunk (the
    ``la_chunk`` every config ships) make the reference's ``exp(-la_inc)``
    reach about e^160, beyond float32; its output is not finite.  The
    port's is, and agrees with the sequential oracle within 1e-4 of the
    oracle's largest magnitude.  The reference also refuses a length that
    is no multiple of its chunk; the port runs it."""
    for scalar in (False, True):
        r, k, v, log_w = _gla_inputs(7, s=64, scalar=scalar, bound=True)
        jargs = [jnp.asarray(a) for a in (r, k, v, log_w)]
        want_y, _ = jla.chunked_gla(*jargs, chunk=64)
        assert not np.isfinite(np.asarray(want_y)).all()
        oracle_y, oracle_s = jla.gla_reference(*jargs)
        got_y, got_s = tla.chunked_gla(*(_t(a) for a in (r, k, v, log_w)), chunk=64)
        assert torch.isfinite(got_y).all() and torch.isfinite(got_s).all()
        scale = np.abs(np.asarray(oracle_y)).max()
        assert np.abs(_np(got_y) - np.asarray(oracle_y)).max() <= 1e-4 * scale
        assert (np.abs(_np(got_s) - np.asarray(oracle_s)).max()
                <= 1e-4 * np.abs(np.asarray(oracle_s)).max())
    r, k, v, log_w = _gla_inputs(8, s=100)
    with pytest.raises(AssertionError, match="chunk multiple"):
        jla.chunked_gla(*(jnp.asarray(a) for a in (r, k, v, log_w)), chunk=64)
    y, _ = tla.chunked_gla(*(_t(a) for a in (r, k, v, log_w)), chunk=64)
    assert y.shape == (B, 100, 4, 8) and torch.isfinite(y).all()


# --------------------------------------------------------------------------
# the mixers and FFNs
# --------------------------------------------------------------------------
_RWKV = CONFIGS["t-rwkv"]


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_time_mix_matches_the_reference(carried, mesh):
    """``time_mix`` over 12 positions (chunks of 4), from zeros or from a
    carried shift and state, then three ``time_mix_decode`` steps."""
    cfg = _RWKV
    tree = _tree(jrk.rwkv_tm_defs(cfg), 11, redraw=("mix", "w0", "u"))
    mod = _module(trk.TimeMix, cfg, tree)
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (B, 15, 64)).astype(np.float32)
    prev = rng.normal(0, 1, (B, 64)).astype(np.float32) if carried else None
    s0 = rng.normal(0, 1, (B, 4, 16, 16)).astype(np.float32) if carried else None
    p = jax.tree.map(jnp.asarray, tree)
    with use_mesh(mesh):
        want = jrk.time_mix(p, cfg, jnp.asarray(x[:, :12]), MeshAxes(),
                            prev=None if prev is None else jnp.asarray(prev),
                            state0=None if s0 is None else jnp.asarray(s0))
        got = mod(_t(x[:, :12]), None if prev is None else _t(prev),
                  None if s0 is None else _t(s0))
        for g, w in zip(got, want):
            _close(g, w)
        jprev, jstate = want[1], want[2]
        tprev, tstate = got[1], got[2]
        for t in range(12, 15):
            w_out, jprev, jstate = jrk.time_mix_decode(p, cfg, jnp.asarray(x[:, t]), jprev,
                                                       jstate)
            g_out, tprev, tstate = mod.decode(_t(x[:, t]), tprev, tstate)
            _close(g_out, w_out)
            _close(tstate, jstate)


def test_channel_mix_matches_the_reference():
    cfg = _RWKV
    tree = _tree(jrk.rwkv_cm_defs(cfg), 13, redraw=("mix",))
    mod = _module(trk.ChannelMix, cfg, tree)
    rng = np.random.default_rng(14)
    x = rng.normal(0, 1, (B, 10, 64)).astype(np.float32)
    prev = rng.normal(0, 1, (B, 64)).astype(np.float32)
    p = jax.tree.map(jnp.asarray, tree)
    for pv in (None, prev):
        want = jrk.channel_mix(p, cfg, jnp.asarray(x), prev=None if pv is None else
                               jnp.asarray(pv))
        got = mod(_t(x), None if pv is None else _t(pv))
        for g, w in zip(got, want):
            _close(g, w)
    want = jrk.channel_mix_decode(p, cfg, jnp.asarray(x[:, 0]), jnp.asarray(prev))
    got = mod.decode(_t(x[:, 0]), _t(prev))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("s", [2, 12])
def test_mamba_mix_matches_the_reference(s, mesh):
    """``mamba_mix`` over ``s`` positions (2: the conv cache keeps a zero
    row), its conv cache and state, then three ``mamba_mix_decode``
    steps."""
    cfg = CONFIGS["t-jamba"]
    tree = _tree(jmb.mamba_defs(cfg), 15, redraw=("dt_bias", "D"))
    mod = _module(tmb.Mamba, cfg, tree)
    x = np.random.default_rng(16).normal(0, 1, (B, s + 3, 64)).astype(np.float32)
    p = jax.tree.map(jnp.asarray, tree)
    with use_mesh(mesh):
        want = jmb.mamba_mix(p, cfg, jnp.asarray(x[:, :s]), MeshAxes())
    got = mod(_t(x[:, :s]))
    assert got[1].shape == (B, tmb.CONV_K - 1, 128) and got[2].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w)
    jconv, jstate = want[1], want[2]
    tconv, tstate = got[1], got[2]
    for t in range(s, s + 3):
        w_out, jconv, jstate = jmb.mamba_mix_decode(p, cfg, jnp.asarray(x[:, t]), jconv,
                                                    jstate)
        g_out, tconv, tstate = mod.decode(_t(x[:, t]), tconv, tstate)
        for g, w in ((g_out, w_out), (tconv, jconv), (tstate, jstate)):
            _close(g, w)


def _dropped(cfg, experts, chunk):
    """Assignments past their expert's capacity, per chunk (a count)."""
    c = tmoe.capacity(cfg, chunk)
    n = 0
    for i in range(0, len(experts), chunk):
        counts = np.bincount(experts[i:i + chunk].reshape(-1), minlength=cfg.n_experts)
        n += int(np.maximum(counts - c, 0).sum())
    return n


@pytest.mark.parametrize("dense", [False, True], ids=["moe", "dense_residual"])
@pytest.mark.parametrize("token_chunk", [8192, 16], ids=["one_chunk", "four_chunks"])
def test_moe_ffn_matches_the_reference(dense, token_chunk, mesh, monkeypatch):
    """A router skewed towards two experts, so that the shipped capacity
    factor (1.25) drops assignments; four token chunks when both modules'
    ``TOKEN_CHUNK`` is 16.  Outputs within 1e-4, the same experts chosen
    and the port's drop count equal to a count over those experts."""
    monkeypatch.setattr(jmoe, "TOKEN_CHUNK", token_chunk)
    monkeypatch.setattr(tmoe, "TOKEN_CHUNK", token_chunk)
    cfg = ModelConfig(name="t-moe", family="moe", n_layers=1, d_model=64, n_heads=4,
                      n_kv_heads=4, d_ff=96, vocab=100, n_experts=8, moe_top_k=2,
                      moe_dff=80, dense_residual=dense, dtype="float32")
    defs = jmoe.moe_defs(cfg)
    if dense:
        from repro.models.layers import mlp_defs

        defs["dense"] = mlp_defs(64, cfg.d_ff)
    tree = _tree(defs, 17)
    tree["router"][:, :2] += 0.6            # experts 0 and 1 take most tokens
    mod = _module(tmoe.MoE, cfg, tree)
    x = np.random.default_rng(18).normal(0, 1, (B, 32, 64)).astype(np.float32)
    with use_mesh(mesh):
        want = jax.jit(lambda p, x: jmoe.moe_ffn(p, cfg, x, MeshAxes()))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    got = mod(_t(x))
    _close(got, want)
    gates = jax.nn.softmax(jnp.asarray(x.reshape(-1, 64)) @ jnp.asarray(tree["router"]))
    want_e = np.asarray(jax.lax.top_k(gates, 2)[1])
    _, got_e = mod.route(_t(x.reshape(-1, 64)))
    np.testing.assert_array_equal(_np(got_e), want_e)
    n = _dropped(cfg, want_e, min(token_chunk, 64))
    assert n > 0 and int(mod.dropped) == n


def test_moe_routing_keeps_lax_top_k_order_on_ties():
    """Equal gates pick the lower expert first, as ``lax.top_k`` does
    (``torch.topk`` leaves ties unordered)."""
    cfg = ModelConfig(name="t-tie", family="moe", n_layers=1, d_model=8, n_heads=1,
                      n_kv_heads=1, d_ff=8, vocab=10, n_experts=6, moe_top_k=3,
                      moe_dff=8, dtype="float32")
    mod = tmoe.MoE(cfg, Init(torch.Generator().manual_seed(0), "cpu", torch.float32))
    mod.router.data.zero_()                  # every gate equal
    x = torch.randn(5, 8, generator=torch.Generator().manual_seed(1))
    w, e = mod.route(x)
    want = jax.lax.top_k(jnp.full((5, 6), 1 / 6, jnp.float32), 3)[1]
    np.testing.assert_array_equal(_np(e), np.asarray(want))
    _close(w, np.full((5, 3), 1 / 3))


def test_encoder_cross_attention_and_encode_kv_match_the_reference(mesh):
    """The encoder's non-causal attention (with rotary embedding), the
    decoder's cross-attention and ``encode_kv`` (no rotary embedding, q/k
    norms with ``qk_norm``)."""
    cfg = dataclasses.replace(CONFIGS["t-encdec"], qk_norm=True, n_kv_heads=2)
    tree = _tree(jattn.attn_defs(cfg), 19, redraw=("q_norm", "k_norm"))
    mod = _module(tattn.Attention, cfg, tree)
    rng = np.random.default_rng(20)
    x = rng.normal(0, 1, (B, 20, 64)).astype(np.float32)
    enc = rng.normal(0, 1, (B, 24, 64)).astype(np.float32)
    p = jax.tree.map(jnp.asarray, tree)
    with use_mesh(mesh):
        want = jattn.attention(p, cfg, jnp.asarray(x), MeshAxes(), causal=False)
        want_kv = jattn.encode_kv(p, cfg, jnp.asarray(enc))
        want_x = jattn.cross_attention(p, cfg, jnp.asarray(x), *want_kv, MeshAxes())
        causal = jattn.attention(p, cfg, jnp.asarray(x), MeshAxes())
    got = mod(_t(x), causal=False)
    for g, w in zip(got, want):
        _close(g, w)
    got_kv = mod.encode_kv(_t(enc))
    for g, w in zip(got_kv, want_kv):
        _close(g, w)
    _close(mod.cross(_t(x), *got_kv), want_x)
    _close(mod(_t(x))[0], causal[0])
    assert np.abs(_np(got[0]) - np.asarray(causal[0])).max() > 1e-2


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------
_MODELS = {}


def _models(name):
    """(config, JAX parameters, the port's LM carried across), once each."""
    if name not in _MODELS:
        cfg = CONFIGS.get(name) or reduced_config(all_configs()[name], d_model=64,
                                                  vocab=300)
        params = M.init_params(cfg, jax.random.key(1), jnp.float32)
        lm = LM(cfg, device="cpu", empty=True)
        lm.load_state_dict(params_from_arrays(cfg, jax.tree.map(np.asarray, params)))
        _MODELS[name] = (cfg, params, lm)
    return _MODELS[name]


def _grow(cache, n, by):
    """tests/test_decode.py's growth of the reference's prefill cache:
    every axis 2 (else axis 1) of length ``n`` gains ``by`` zero rows."""
    def f(x):
        if x.ndim >= 3 and x.shape[2] == n:
            return jnp.concatenate([x, jnp.zeros(x.shape[:2] + (by,) + x.shape[3:],
                                                 x.dtype)], axis=2)
        if x.ndim >= 2 and x.shape[1] == n:
            return jnp.concatenate([x, jnp.zeros((x.shape[0], by) + x.shape[2:],
                                                 x.dtype)], axis=1)
        return x

    return jax.tree.map(f, cache)


def _check_model(name, mesh, s, tail, extra, n_patch=0):
    """Logits of ``forward``, ``prefill`` (the first ``s - tail`` tokens)
    and ``tail`` decode steps against the reference's, and the port's
    prefill plus decode against its own forward."""
    cfg, params, lm = _models(name)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab, (B, s))
    jextra = {key: jnp.asarray(v) for key, v in extra.items()}
    s0 = s - tail
    axes = MeshAxes()
    forward = jax.jit(lambda p, b: M.forward(p, cfg, b, axes, mode="train")[0])
    prefill = jax.jit(lambda p, b: M.prefill(p, cfg, b, axes))
    decode = jax.jit(lambda p, t, c, pos: M.decode_step(p, cfg, t, c, pos, axes))
    with use_mesh(mesh):
        want_full = forward(params, {"tokens": jnp.asarray(toks), **jextra})
        want_pre, jcache = prefill(params, {"tokens": jnp.asarray(toks[:, :s0]), **jextra})
        jcache = _grow(jcache, n_patch + s0, tail)
        want_steps = []
        for t in range(s0, s):
            lg, jcache = decode(params, jnp.asarray(toks[:, t:t + 1]), jcache,
                                jnp.full((B,), n_patch + t, jnp.int32))
            want_steps.append(np.asarray(lg[:, 0]))
    full = _np(lm(toks, **extra))
    assert full.shape == (B, n_patch + s, cfg.padded_vocab)
    _close(full, want_full)
    pre, cache = lm.prefill(toks[:, :s0], cache_len=n_patch + s, **extra)
    _close(pre[:, -1], want_pre[:, -1])
    assert np.abs(_np(pre[:, -1]) - full[:, n_patch + s0 - 1]).max() < DECODE_TOL
    for t, want in zip(range(s0, s), want_steps):
        lg, cache = lm.decode_step(toks[:, t:t + 1], cache, np.full(B, n_patch + t))
        _close(lg[:, 0], want)
        assert np.abs(_np(lg[:, 0]) - full[:, n_patch + t]).max() < DECODE_TOL
    return cfg, lm


@pytest.mark.parametrize("name", ["t-rwkv", "t-jamba"])
def test_recurrent_models_match_the_reference(name, mesh):
    cfg, lm = _check_model(name, mesh, 32, 4, {})
    cache = lm.new_cache(B, 40)
    if name == "t-rwkv":
        assert cache[0]["state"].shape == (B, 4, 16, 16)
        assert cache[0]["state"].dtype == torch.float32
        assert {"shift_tm", "shift_cm"} <= set(cache[0])
    else:
        assert [sorted(c) for c in cache[:2]] == [["k", "v"], ["conv", "state"]]
        assert cache[1]["conv"].shape == (B, 3, 128)
        assert cache[1]["state"].shape == (B, 8, 8, 16)
        assert [layer.ffn_kind for layer in lm.layers] == ["dense", "moe"] * 4
        assert int(lm.layers[1].ffn.dropped) == 0


def test_encoder_decoder_matches_the_reference(mesh):
    """``t-encdec``: frames of 32 positions, a 16-token decoder, 4 decode
    steps against cached cross-attention keys and values."""
    frames = np.random.default_rng(3).normal(0, 1, (B, 32, 64)).astype(np.float32)
    _, lm = _check_model("t-encdec", mesh, 16, 4, {"frames": frames})
    _, cache = lm.prefill(np.zeros((B, 3), np.int64), cache_len=8, frames=frames)
    assert cache[0]["xk"].shape == (B, 32, 4, 16)
    with pytest.raises(ValueError, match="frames"):
        lm(np.zeros((B, 3), np.int64))
    with pytest.raises(ValueError, match="prefill"):
        LMServer(lm).generate(np.zeros((B, 3), np.int64), 2)


def test_vlm_patches_count_in_the_positions(mesh):
    """``internvl2-2b`` reduced: 8 patch embeddings projected by
    ``patch_proj`` before 20 tokens; the cache and the decode positions
    count the patches."""
    pe = np.random.default_rng(4).normal(0, 1, (B, 8, 64)).astype(np.float32)
    cfg, lm = _check_model("internvl2-2b", mesh, 20, 4, {"patch_embeds": pe}, n_patch=8)
    assert cfg.frontend == "patch_stub" and lm.patch_proj.shape == (64, 64)
    with pytest.raises(ValueError, match="patch_embeds"):
        lm(np.zeros((B, 3), np.int64))


def test_any_prompt_length_prefills_and_decodes_as_the_full_forward():
    """ROADMAP C.9's second trigger: at ``la_chunk`` 64 a 37-token prompt
    is no multiple of the chunk (the reference's prefill asserts).  The
    port's prefill and 5 decode steps equal its full forward over the 42
    tokens within ``DECODE_TOL``, for RWKV6 and the Mamba hybrid."""
    for name in ("t-rwkv", "t-jamba"):
        cfg, _, carried = _models(name)
        lm = LM(dataclasses.replace(cfg, la_chunk=64), device="cpu", empty=True)
        lm.load_state_dict(carried.state_dict())
        toks = np.random.default_rng(22).integers(0, cfg.vocab, (B, 42))
        full = _np(lm(toks))
        assert np.isfinite(full).all()
        pre, cache = lm.prefill(toks[:, :37], cache_len=42)
        errs = [np.abs(_np(pre[:, -1]) - full[:, 36]).max()]
        for t in range(37, 42):
            lg, cache = lm.decode_step(toks[:, t:t + 1], cache, np.full(B, t))
            errs.append(np.abs(_np(lg[:, 0]) - full[:, t]).max())
        assert max(errs) < DECODE_TOL, (name, errs)


@pytest.mark.parametrize("name", ["t-rwkv", "t-jamba", "t-encdec"])
def test_float64_model_is_the_same_function_in_float64(name):
    """A float64 model (the card's witness for RWKV6's checks) holds the
    float32 model's weights and computes the same function: logits within
    ``ATOL`` of the float32 port's.  Every internal widens: recurrent
    caches are float64, and prefill plus 4 decode steps equal the full
    forward within 1e-9, which a single float32 rounding would exceed."""
    cfg, _, carried = _models(name)
    lm = LM(dataclasses.replace(cfg, dtype="float64"), device="cpu", empty=True)
    lm.load_state_dict(carried.state_dict())
    extra = ({"frames": np.random.default_rng(3).normal(0, 1, (B, 32, 64))}
             if cfg.encoder_layers else {})
    toks = np.random.default_rng(23).integers(0, cfg.vocab, (B, 20))
    full = _np(lm(toks, **extra))
    f32 = {k: v.astype(np.float32) for k, v in extra.items()}
    v = cfg.vocab                       # the padded rows' -1e30 rounds apart
    _close(full[..., :v], _np(carried(toks, **f32))[..., :v])
    pre, cache = lm.prefill(toks[:, :16], cache_len=20, **extra)
    assert {c.dtype for layer in cache for c in layer.values()} == {torch.float64}
    errs = [np.abs(_np(pre[:, -1]) - full[:, 15]).max()]
    for t in range(16, 20):
        lg, cache = lm.decode_step(toks[:, t:t + 1], cache, np.full(B, t))
        errs.append(np.abs(_np(lg[:, 0]) - full[:, t]).max())
    assert max(errs) < 1e-9, errs


def _greedy_by_full_forwards(lm, prompt, max_new):
    seq = torch.as_tensor(prompt)
    for _ in range(max_new):
        seq = torch.cat([seq, lm(seq)[:, -1].argmax(dim=-1)[:, None]], dim=1)
    return _np(seq[:, prompt.shape[1]:])


@pytest.mark.parametrize("name,prompt_len", [("t-rwkv", 4), ("t-jamba", 3)])
def test_c10_generate_keeps_recurrent_caches_at_their_size(name, prompt_len, mesh):
    """ROADMAP C.10: the reference's ``generate`` grows every cache whose
    axis 2 equals the prompt length.  A 4-token prompt matches ``t-rwkv``'s
    4 heads (the state's axis 2): the reference raises.  A 3-token one
    matches the Mamba conv cache's 3 rows: the conv then reads the oldest
    rows of a grown cache and the reference's tokens silently differ from
    greedy decoding.  The port allocates every cache at its final size
    and its ``generate`` equals greedy decoding by full forwards."""
    cfg, params, lm = _models(name)
    prompt = np.random.default_rng(23).integers(0, cfg.vocab, (B, prompt_len))
    greedy = _greedy_by_full_forwards(lm, prompt, 4)
    with use_mesh(mesh):
        if name == "t-rwkv":
            with pytest.raises(ValueError, match="label 'h'"):
                JaxLMServer(cfg, params).generate(prompt, 4)
        else:
            assert not np.array_equal(JaxLMServer(cfg, params).generate(prompt, 4), greedy)
    got = LMServer(lm).generate(prompt, 4)
    assert got.shape == (B, 4)
    np.testing.assert_array_equal(got, greedy)


@pytest.mark.parametrize("name", ["t-rwkv", "t-jamba"])
def test_generate_matches_the_reference_where_it_is_right(name, mesh):
    """A prompt length that no cache axis shares: the reference's
    ``generate`` runs, and the port's gives the same tokens."""
    cfg, params, lm = _models(name)
    prompt = np.random.default_rng(24).integers(0, cfg.vocab, (B, 12))
    with use_mesh(mesh):
        want = JaxLMServer(cfg, params).generate(prompt, 5)
    got = LMServer(lm).generate(prompt, 5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _greedy_by_full_forwards(lm, prompt, 5))


@pytest.mark.parametrize("name", ["t-rwkv", "t-jamba", "t-encdec", "internvl2-2b"])
def test_parameters_carry_across_bit_for_bit(name):
    """Every reference leaf lands in the port's state once, bit for bit
    (stacked blocks and encoder layers unstacked by row)."""
    cfg, params, lm = _models(name)
    state = lm.state_dict()
    n = 0
    for key, value in _flat(jax.tree.map(np.asarray, params)):
        top, rest = key.split(".", 1) if "." in key else (key, "")
        if top == "blocks":
            pos, leaf = rest.split(".", 1)
            for b in range(cfg.n_blocks):
                li = b * cfg.superblock + int(pos[1:])
                np.testing.assert_array_equal(_np(state[f"layers.{li}.{leaf}"]), value[b])
                n += 1
        elif top == "encoder":
            for j in range(cfg.encoder_layers):
                np.testing.assert_array_equal(_np(state[f"encoder.{j}.{rest}"]), value[j])
                n += 1
        elif top.startswith("rem"):
            li = cfg.n_blocks * cfg.superblock + int(top[3:])
            np.testing.assert_array_equal(_np(state[f"layers.{li}.{rest}"]), value)
            n += 1
        else:
            np.testing.assert_array_equal(_np(state[key]), value)
            n += 1
    assert n == len(state)
    bad = dict(jax.tree.map(np.asarray, params), stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="stray"):
        params_from_arrays(cfg, bad)
