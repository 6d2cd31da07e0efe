"""The port's LM (``repro_torch.models``) and ``LMServer`` against
the JAX package's, on the CPU in float32.

Each reduced config's parameters come from the JAX package's
``init_params`` and are carried across by ``params_from_arrays``; the
same tokens go through both models.  Contract:

  * the carried state equals the JAX arrays bit for bit;
  * logits of ``forward`` (train mode), of ``prefill`` (the last prompt
    position) and of every ``decode_step`` within ``ATOL`` = 1e-4 of the
    reference's (logits are of unit scale; the two differ by the order of
    float32 sums, about 1e-5 at these widths), and the port's decode
    within the reference's own decode tolerance (``tests/test_decode.py``:
    2e-3) of its full forward;
  * ``LMServer.generate`` equals the reference's where the reference is
    right, and greedy decoding by full forwards everywhere; in the
    ROADMAP C.8 case (a remainder local layer, a prompt shorter than the
    window) the reference's ``generate`` differs from that greedy
    decoding and the port's does not;
  * every config of ``configs/`` builds, reduced, and its carried-across
    logits match the reference's (the other families in detail:
    ``tests/test_torch_lm_families.py``).

Configs: ``tests/test_decode.py``'s ``t-dense`` (GQA, qk-norm) and
``t-gemma`` (local:global rings), ``t-dense`` with tied embeddings, and
C.8's config (one superblock of two local layers and a global one, then
a remainder local layer, window 12).
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
from repro.models import model as M
from repro.models.sharding import MeshAxes
from repro.serve.engine import LMServer as JaxLMServer
from repro_torch.configs import get_config
from repro_torch.models import LM, params_from_arrays
from repro_torch.serve import LMServer

ATOL = 1e-4
DECODE_TOL = 2e-3
B, S, TAIL = 2, 32, 4

_DENSE = ModelConfig(
    name="t-dense", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=100, qk_norm=True, dtype="float32", chunk_q=16)
CONFIGS = {
    "t-dense": _DENSE,
    "t-gemma": ModelConfig(
        name="t-gemma", family="dense", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=100, local_window=8, local_per_global=2,
        dtype="float32", chunk_q=16),
    "t-tied": dataclasses.replace(_DENSE, name="t-tied", tied_embeddings=True),
    "t-c8": ModelConfig(
        name="t-c8", family="dense", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=100, local_window=12, local_per_global=2,
        dtype="float32", chunk_q=16),
}
# (prompt length, new tokens) of the generate cases; the reference is right
# on every one except C.8's
GENERATE = {"t-dense": (12, 5), "t-gemma": (12, 6), "t-tied": (12, 5), "t-c8": (8, 6)}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


_MODELS = {}


def _models(name):
    """(config, JAX parameters, the port's LM carried across), once per
    config."""
    if name not in _MODELS:
        cfg = CONFIGS[name]
        params = M.init_params(cfg, jax.random.key(1), jnp.float32)
        lm = LM(cfg, device="cpu", empty=True)
        lm.load_state_dict(params_from_arrays(cfg, jax.tree.map(np.asarray, params)))
        _MODELS[name] = (cfg, params, lm)
    return _MODELS[name]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_parameters_carry_across_bit_for_bit(name):
    cfg, params, lm = _models(name)
    state = lm.state_dict()
    rows = [a.shape[0] for a in jax.tree.leaves(params["blocks"])]   # n_blocks each
    rest = [a for key in params if key != "blocks" for a in jax.tree.leaves(params[key])]
    assert len(state) == sum(rows) + len(rest)
    sb = cfg.superblock
    for li, layer in enumerate(lm.layers):
        b, i = divmod(li, sb)
        src = (jax.tree.map(lambda a: a[b], params["blocks"][f"l{i}"]) if b < cfg.n_blocks
               else params[f"rem{li - cfg.n_blocks * sb}"])
        for key, value in layer.state_dict().items():
            want = src
            for part in key.split("."):
                want = want[part]
            np.testing.assert_array_equal(_np(value), np.asarray(want), err_msg=f"{li}.{key}")
    np.testing.assert_array_equal(_np(lm.embed.tok), np.asarray(params["embed"]["tok"]))
    assert hasattr(lm.embed, "out") != cfg.tied_embeddings


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_the_reference(name, mesh):
    """Train-mode logits, prefill's last position and every decode step
    against the reference's, and the port's decode against its forward."""
    cfg, params, lm = _models(name)
    toks = _tokens(cfg, (B, S), 7)
    s0 = S - TAIL
    axes = MeshAxes()
    forward = jax.jit(lambda p, t: M.forward(p, cfg, {"tokens": t}, axes, mode="train")[0])
    prefill = jax.jit(lambda p, t: M.prefill(p, cfg, {"tokens": t}, axes))
    decode = jax.jit(lambda p, t, c, pos: M.decode_step(p, cfg, t, c, pos, axes))
    with use_mesh(mesh):
        want_full = forward(params, jnp.asarray(toks))
        want_pre, jcache = prefill(params, jnp.asarray(toks[:, :s0]))
        jcache = jax.tree.map(  # grow to S positions as tests/test_decode.py does
            lambda x: jnp.concatenate(
                [x, jnp.zeros(x.shape[:2] + (TAIL,) + x.shape[3:], x.dtype)], axis=2)
            if x.ndim >= 3 and x.shape[2] == s0 else
            jnp.concatenate([x, jnp.zeros((x.shape[0], TAIL) + x.shape[2:], x.dtype)], axis=1)
            if x.ndim >= 2 and x.shape[1] == s0 else x, jcache)
        want_steps = []
        for t in range(s0, S):
            lg, jcache = decode(params, jnp.asarray(toks[:, t:t + 1]), jcache,
                                jnp.full((B,), t, jnp.int32))
            want_steps.append(np.asarray(lg[:, 0]))
    full = _np(lm(toks))
    assert full.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(full, np.asarray(want_full), atol=ATOL, rtol=0)
    pre, cache = lm.prefill(toks[:, :s0], cache_len=S)
    np.testing.assert_allclose(_np(pre[:, -1]), np.asarray(want_pre[:, -1]), atol=ATOL, rtol=0)
    assert np.abs(_np(pre[:, -1]) - full[:, s0 - 1]).max() < DECODE_TOL
    for t, want in zip(range(s0, S), want_steps):
        lg, cache = lm.decode_step(toks[:, t:t + 1], cache, np.full(B, t))
        np.testing.assert_allclose(_np(lg[:, 0]), want, atol=ATOL, rtol=0)
        assert np.abs(_np(lg[:, 0]) - full[:, t]).max() < DECODE_TOL
    if cfg.padded_vocab > cfg.vocab:
        assert (full[..., cfg.vocab:] == -1e30).all()


def _greedy_by_full_forwards(lm, prompt, max_new):
    seq = torch.as_tensor(prompt)
    for _ in range(max_new):
        seq = torch.cat([seq, lm(seq)[:, -1].argmax(dim=-1)[:, None]], dim=1)
    return _np(seq[:, prompt.shape[1]:])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generate_is_greedy_and_matches_the_reference_where_it_is_right(name, mesh):
    cfg, params, lm = _models(name)
    s, max_new = GENERATE[name]
    prompt = _tokens(cfg, (B, s), 0)
    got = LMServer(lm).generate(prompt, max_new)
    assert got.shape == (B, max_new) and got.dtype.kind == "i"
    np.testing.assert_array_equal(got, _greedy_by_full_forwards(lm, prompt, max_new))
    with use_mesh(mesh):
        want = JaxLMServer(cfg, params).generate(prompt, max_new)
    if name == "t-c8":
        # ROADMAP C.8: the reference leaves the remainder local layer's
        # ring as wide as the prompt, so its decode differs from greedy
        assert not np.array_equal(want, got)
    else:
        np.testing.assert_array_equal(got, want)


def test_generate_takes_an_explicit_cache_length():
    """A longer cache changes nothing; a cache too short for the last
    decode position is refused."""
    _, _, lm = _models("t-gemma")
    prompt = _tokens(lm.cfg, (B, 12), 3)
    srv = LMServer(lm)
    np.testing.assert_array_equal(srv.generate(prompt, 5, cache_len=40),
                                  srv.generate(prompt, 5))
    srv.generate(prompt, 5, cache_len=16)
    with pytest.raises(ValueError, match="cache_len"):
        srv.generate(prompt, 5, cache_len=15)


def test_ring_caches_are_allocated_at_their_final_size():
    _, _, lm = _models("t-c8")
    cache = lm.new_cache(B, 14)
    assert [c["k"].shape[1] for c in cache] == [12, 12, 14, 12]
    assert [c["k"].shape[1] for c in lm.new_cache(B, 9)] == [9, 9, 9, 9]


# one whole superblock of the hybrid (1 attention + 7 Mamba layers, 4 MoE
# FFNs); see test_deep_hybrid_agrees_within_the_references_own_rounding_noise
LAYERS = {"jamba-v0.1-52b": 1}


def _reduced(arch, layers=None):
    return reduced_config(all_configs()[arch], layers=layers or LAYERS.get(arch, 2),
                          d_model=64, vocab=300)


def _reduced_batch(cfg):
    """32 tokens (a multiple of the reduced ``la_chunk``, 16, which the
    reference's chunked form asserts), with 32 frames of an encoder or 8
    patch embeddings."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (B, 32))
    extra = {}
    if cfg.encoder_layers:
        extra["frames"] = rng.normal(0, 1, (B, 32, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patch_stub":
        extra["patch_embeds"] = rng.normal(0, 1, (B, 8, cfg.d_model)).astype(np.float32)
    return toks, extra


def _reference_logits(cfg, params, toks, extra, mesh):
    batch = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in extra.items()}}
    with use_mesh(mesh):
        return np.asarray(jax.jit(lambda p, b: M.forward(p, cfg, b, MeshAxes(),
                                                         mode="train")[0])(params, batch))


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_families_build_and_agree(arch, mesh):
    """All ten configs, reduced as the reference's smoke tests reduce them
    (d_model 64, vocab 300, two superblocks; the hybrid one): the port's
    configs equal the reference's, every layer kind builds, and the
    logits of the carried-across model match."""
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(all_configs()[arch])
    cfg = _reduced(arch)
    params = M.init_params(cfg, jax.random.key(2), jnp.float32)
    lm = LM(cfg, device="cpu", empty=True)
    lm.load_state_dict(params_from_arrays(cfg, jax.tree.map(np.asarray, params)))
    kinds = cfg.layer_kinds()
    assert [layer.kind for layer in lm.layers] == [
        kinds[li % cfg.superblock] for li in range(cfg.n_layers)]
    toks, extra = _reduced_batch(cfg)
    want = _reference_logits(cfg, params, toks, extra, mesh)
    np.testing.assert_allclose(_np(lm(toks, **extra)), want, atol=ATOL, rtol=0)


def test_deep_hybrid_agrees_within_the_references_own_rounding_noise(mesh):
    """The hybrid reduced at two superblocks (16 layers) amplifies float32
    rounding: a relative change of 2^-24 (half a unit in the last place)
    to each embedding moves the reference's own logits by about 2e-4,
    above ``ATOL``, so no float32 implementation that sums in another
    order can hold 1e-4 there.  The port stays within twice that
    movement of the reference."""
    cfg = _reduced("jamba-v0.1-52b", layers=2)
    assert cfg.n_layers == 16
    params = M.init_params(cfg, jax.random.key(2), jnp.float32)
    lm = LM(cfg, device="cpu", empty=True)
    lm.load_state_dict(params_from_arrays(cfg, jax.tree.map(np.asarray, params)))
    toks, extra = _reduced_batch(cfg)
    want = _reference_logits(cfg, params, toks, extra, mesh)
    tok = np.asarray(params["embed"]["tok"])
    sign = np.random.default_rng(0).choice([-1.0, 1.0], tok.shape)
    nudged = dict(params, embed=dict(params["embed"], tok=jnp.asarray(
        (tok * (1 + sign * 2.0 ** -24)).astype(np.float32))))
    noise = np.abs(_reference_logits(cfg, nudged, toks, extra, mesh) - want).max()
    assert noise > ATOL
    assert np.abs(_np(lm(toks)) - want).max() <= 2 * noise


def test_seeded_init_is_reproducible_and_needs_a_card_by_default(monkeypatch):
    cfg = CONFIGS["t-gemma"]
    a = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
