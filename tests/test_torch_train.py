"""The port's training and launch layers (``repro_torch.train``,
``repro_torch.data``, ``repro_torch.launch``, ``LM.loss``) against the JAX
package's, on the CPU in float32: the same NumPy-seeded inputs through
both.

Contract (tolerances named in each test):

  * optimizers: ``adamw`` and ``adafactor`` updates of the port's
    parameters (each reference leaf stacked from the port's layers,
    updated, written back) equal the reference's ``update`` on the same
    params, grads and steps within ``OPT_RTOL`` = 1e-6, state included;
    Adafactor factors a stacked ``(n_blocks, D)`` norm scale and clips over
    the whole stacked leaf, as the reference does;
  * ``LM.loss`` within ``LOSS_RTOL`` = 1e-5 of ``M.loss_fn`` and every
    gradient, carried back by ``arrays_from_params``, within ``GRAD_RTOL``
    = 1e-4 in L2 of ``jax.value_and_grad``'s, for every config reduced;
  * ``make_train_step`` at ``n_micro`` 1 and 2, three steps: losses and
    grad norms within ``LOSS_RTOL`` of the reference's jitted step, every
    parameter within ``STEP_RTOL`` = 1e-5 in L2;
  * ``TokenPipeline`` bit for bit; checkpoints in the reference's layout,
    each package resuming the other's; the bfloat16 round trip the
    reference cannot make (ROADMAP C.11).
"""
import json
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import all_configs
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.launch.mesh import make_mesh, use_mesh
from repro.launch.train import main as jax_train_main
from repro.launch.train import reduced_config as jax_reduced_config
from repro.models import model as M
from repro.models import moe as jax_moe
from repro.models.sharding import MeshAxes
from repro.train import optimizer as jax_opt
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineState, TokenPipeline
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.train import main as train_main
from repro_torch.models import LM, arrays_from_params, params_from_arrays, reference_leaves
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import adafactor, adamw, get_optimizer, pick_for
from repro_torch.train.trainer import init_state, make_train_step, value_and_grad

REPO = pathlib.Path(__file__).resolve().parents[1]
OPT_RTOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEP_RTOL = 1e-5
B, S = 2, 32
# the hybrid at one superblock (8 layers): at two (16) its float32 rounding
# is amplified past these limits (tests/test_torch_lm.py)
LAYERS = {"jamba-v0.1-52b": 1}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


@pytest.fixture
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for one test: without it
    the embedding's gradient (an accumulating ``index_put_``) sums in an
    order that varies from run to run, on the CPU too."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _walk(tree, prefix=()):
    """``(path, leaf)`` of a nested dict, keys sorted (the reference's leaf
    order)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _reduced(arch):
    return jax_reduced_config(all_configs()[arch], layers=LAYERS.get(arch, 2), d_model=64,
                              vocab=300)


def _models(cfg, seed):
    """JAX parameters of ``cfg`` and the port's LM carried across."""
    params = M.init_params(cfg, jax.random.key(seed), jnp.float32)
    lm = LM(cfg, device="cpu", empty=True)
    lm.load_state_dict(params_from_arrays(cfg, jax.tree.map(np.asarray, params)))
    return params, lm


def _batch(cfg, seed, b=B, s=S):
    """Tokens as labels, with 32 frames of an encoder or 8 patches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patch_stub":
        batch["patch_embeds"] = rng.normal(0, 1, (b, 8, cfg.d_model)).astype(np.float32)
    return batch


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _port_tree(lm, tensors):
    """``tensors`` (``lm.parameters()`` order) in the reference's tree."""
    names = [n for n, _ in lm.named_parameters()]
    return arrays_from_params(lm.cfg, dict(zip(names, tensors)))


# -- the reference's tree and leaf order -----------------------------------------
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_arrays_from_params_inverts_params_from_arrays(arch):
    """The reference's tree comes back bit for bit, keys in its leaf order,
    every stacked leaf a copy with its leading axis."""
    cfg = _reduced(arch)
    params, lm = _models(cfg, 3)
    want = list(_walk(jax.tree.map(np.asarray, params)))
    got = list(_walk(arrays_from_params(cfg, lm.state_dict())))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [p for p, _ in got] == [tuple(k.key for k in path)
                                   for path, _ in jax.tree_util.tree_leaves_with_path(params)]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(_np(g), w, err_msg="/".join(path))
    leaves = reference_leaves(cfg, lm.state_dict())
    assert [path for path, _, _ in leaves] == [p for p, _ in want]
    assert all(stacked == (path[0] in ("blocks", "encoder")) for path, _, stacked in leaves)


# -- optimizers -----------------------------------------------------------------
def _grads_like(params, rng):
    return jax.tree.map(lambda p: jnp.asarray(rng.normal(0, 1e-2, p.shape), jnp.float32),
                        params)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-235b-a22b"])
def test_optimizer_matches_the_reference(arch, opt_name):
    """Three updates from the same params, grads and (global) steps, as
    the reference's ``update`` and as the port's step applies them to its
    layers: parameters and state within ``OPT_RTOL``, relative to each
    entry or, where a difference cancels to about zero, to the leaf's
    largest entry (XLA contracts ``a * b + c`` into one rounding, PyTorch's
    CPU kernels do not)."""
    cfg = _reduced(arch)
    params, lm = _models(cfg, 4)
    jopt = getattr(jax_opt, opt_name)(lr=1e-2)
    opt = get_optimizer(opt_name, lr=1e-2)
    jstate = jopt.init(params)
    state = init_state(opt, lm)
    assert len(state) == len(jstate)
    for s, js in zip(state, jstate):
        assert {k: tuple(v.shape) for k, v in s.items()} == {k: v.shape for k, v in js.items()}
    if opt_name == "adafactor":     # the stacked (2, D) norm scale is factored
        i = [p for p, _ in _walk(params)].index(("blocks", "l0", "norm1"))
        assert set(state[i]) == {"row", "col"} and state[i]["row"].shape == (2,)
    step_fn = make_train_step(lm, opt)
    names = [n for n, _ in lm.named_parameters()]
    rng = np.random.default_rng(5)
    for step in (7, 8, 9):                  # a resumed run's global steps
        jg = _grads_like(params, rng)
        params, jstate = jopt.update(jg, jstate, params, jnp.asarray(step, jnp.int32))
        g = params_from_arrays(cfg, jax.tree.map(np.asarray, jg))
        state, _ = step_fn.apply(state, [g[n] for n in names], step)
    got = list(_walk(arrays_from_params(cfg, lm.state_dict())))
    for (path, p), (_, w) in zip(got, _walk(params)):
        _close(_np(p), np.asarray(w), "/".join(path))
    for i, (s, js) in enumerate(zip(state, jstate)):
        for k in js:
            _close(_np(s[k]), np.asarray(js[k]), f"state {i} {k}")


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=OPT_RTOL, atol=OPT_RTOL * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("make", [adamw, adafactor])
def test_optimizer_minimizes_quadratic(make):
    """The reference's scenario (``tests/test_train_infra.py``) on the
    port: 60 steps of lr 0.1 cut a sum of squares below 5 %."""
    opt = make(lr=0.1)
    params = [torch.ones(4, 8) * 3.0, torch.ones(5)]      # the reference's a/w, b/0
    state = opt.init(params)

    def loss(ps):
        return sum(float((x ** 2).sum()) for x in ps)

    l0 = loss(params)
    for step in range(60):
        params, state = opt.update([2 * p for p in params], state, params, step)
    assert loss(params) < l0 * 0.05


def test_adafactor_state_is_factored():
    opt = adafactor()
    st_ = opt.init([torch.ones(16), torch.ones(16, 32)])    # b, w: sorted-key order
    sizes = [sum(x.numel() for x in s.values()) for s in st_]
    assert sizes == [16, 16 + 32]


def test_pick_for_sizes():
    assert pick_for(get_config("arctic-480b")) == "adafactor"
    assert pick_for(get_config("qwen3-0.6b")) == "adamw"
    for arch, cfg in all_configs().items():
        assert pick_for(get_config(arch)) == jax_opt.pick_for(cfg)


def test_pick_microbatches_matches_the_reference():
    from repro.configs.base import SHAPES
    from repro.train.trainer import pick_microbatches as jax_pick
    from repro_torch.train.trainer import pick_microbatches

    for arch, cfg in all_configs().items():
        for shape in SHAPES.values():
            for n_dp in (1, 2, 16):
                assert pick_microbatches(get_config(arch), shape, n_dp) == jax_pick(
                    cfg, shape, n_dp)


# -- loss and gradients -----------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_loss_and_every_gradient_match_the_reference(arch, mesh):
    """Every config reduced (d_model 64, vocab 300, two superblocks; the
    hybrid one): ``LM.loss`` within ``LOSS_RTOL`` of ``M.loss_fn`` and every
    gradient within ``GRAD_RTOL`` (relative L2) of ``jax.value_and_grad``'s,
    the port's gradients carried back to the reference's leaves."""
    cfg = _reduced(arch)
    params, lm = _models(cfg, 6)
    batch = _batch(cfg, 7)
    with use_mesh(mesh):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: M.loss_fn(p, cfg, b, MeshAxes())))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(lm, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    got = list(_walk(_port_tree(lm, grads)))
    want = list(_walk(jax.tree.map(np.asarray, jgrads)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert np.linalg.norm(w) > 0, path
        assert _rel_l2(_np(g), w) <= GRAD_RTOL, ("/".join(path), _rel_l2(_np(g), w))


def test_vlm_loss_counts_token_positions_only():
    """The VLM's loss is over its tokens: patches change it only through
    the positions they precede."""
    cfg = _reduced("internvl2-2b")
    _, lm = _models(cfg, 8)
    batch = _batch(cfg, 9)
    with torch.no_grad():
        h = lm.hidden(batch["tokens"], patch_embeds=batch["patch_embeds"])
    assert h.shape == (B, 8 + S, cfg.d_model)
    lg = lm.embed.logits(h[:, 8:])[:, :-1]
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, torch.as_tensor(batch["labels"][:, 1:, None],
                                                                  dtype=torch.int64))[..., 0]
    with torch.no_grad():
        np.testing.assert_allclose(float(lm.loss(batch)), float(nll.mean()), rtol=LOSS_RTOL)


def test_loss_chunks_shrink_to_a_divisor(monkeypatch, mesh):
    """``LOSS_CHUNK`` shrinks to a divisor of ``S - 1`` (31 positions at a
    chunk of 8: one position a chunk, as the reference's), with the same
    loss as one chunk."""
    from repro_torch.models import model as PM

    cfg = _reduced("qwen3-0.6b")
    params, lm = _models(cfg, 10)
    batch = _batch(cfg, 11)
    with torch.no_grad():
        whole = float(lm.loss(batch))
    monkeypatch.setattr(PM, "LOSS_CHUNK", 8)
    monkeypatch.setattr(M, "LOSS_CHUNK", 8)
    with torch.no_grad():
        chunked = float(lm.loss(batch))
    with use_mesh(mesh):
        want = float(M.loss_fn(params, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
                               MeshAxes()))
    np.testing.assert_allclose(chunked, whole, rtol=LOSS_RTOL)
    np.testing.assert_allclose(chunked, want, rtol=LOSS_RTOL)


def test_aux_loss_matches_the_reference():
    """``MoE.aux_loss`` (the Switch f * P over the stable top-k) against
    ``moe.aux_loss``, within 1e-6 relative; the LM's loss does not add it."""
    for arch in ("qwen3-moe-235b-a22b", "arctic-480b"):
        cfg = _reduced(arch)
        params, lm = _models(cfg, 12)
        x = np.random.default_rng(13).normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
        layer0 = jax.tree.map(lambda a: a[0], params["blocks"]["l0"]["ffn"])
        want = jax_moe.aux_loss(layer0, cfg, jnp.asarray(x))
        got = lm.layers[0].ffn.aux_loss(torch.from_numpy(x))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_moe_drops_are_counted_once_under_rematerialisation():
    """A loss and its backward (every layer recomputed) count the same
    dropped assignments as one forward."""
    cfg = _reduced("qwen3-moe-235b-a22b")
    _, lm = _models(cfg, 14)
    batch = _batch(cfg, 15)
    moes = [layer.ffn for layer in lm.layers]
    lm(batch["tokens"])
    once = [int(m.dropped) for m in moes]
    assert sum(once) > 0                         # capacity 1.25 over a random router
    for m in moes:
        m.dropped.zero_()
    value_and_grad(lm, batch)
    assert [int(m.dropped) for m in moes] == once


# -- the train step ---------------------------------------------------------------
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-235b-a22b"])
def test_train_step_matches_the_reference(arch, n_micro, mesh):
    """Three AdamW steps (lr 1e-3) on the same params and batches as the
    reference's jitted ``make_train_step``: each loss and grad norm within
    ``LOSS_RTOL``, every parameter within ``STEP_RTOL`` (relative L2)."""
    cfg = _reduced(arch)
    params, lm = _models(cfg, 16)
    jopt, opt = jax_opt.adamw(lr=1e-3), adamw(lr=1e-3)
    jstep = jax.jit(jax_make_train_step(cfg, MeshAxes(), jopt, n_micro))
    jstate, state = jopt.init(params), init_state(opt, lm)
    step_fn = make_train_step(lm, opt, n_micro)
    for step in range(3):
        batch = _batch(cfg, 20 + step, b=4)
        with use_mesh(mesh):
            params, jstate, jm = jstep(params, jstate,
                                       {k: jnp.asarray(v) for k, v in batch.items()},
                                       jnp.asarray(step, jnp.int32))
        state, m = step_fn(state, batch, step)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
    for (path, p), (_, w) in zip(_walk(arrays_from_params(cfg, lm.state_dict())),
                                 _walk(params)):
        assert _rel_l2(_np(p), np.asarray(w)) <= STEP_RTOL, "/".join(path)


def test_microbatches_accumulate_in_float32():
    """``n_micro = 2`` on a bfloat16 model: the gradients come back as
    float32 buffers, the mean of the two halves' bf16 gradients summed in
    float32 (bit for bit); ``n_micro = 1`` keeps the parameters' dtype."""
    import dataclasses

    cfg = dataclasses.replace(_reduced("qwen3-0.6b"), dtype="bfloat16")
    lm = LM(cfg, device="cpu")
    batch = _batch(cfg, 30, b=4)
    loss1, g1 = value_and_grad(lm, batch)
    assert all(g.dtype == torch.bfloat16 for g in g1)
    loss2, g2 = value_and_grad(lm, batch, n_micro=2)
    assert all(g.dtype == torch.float32 for g in g2)
    halves = [value_and_grad(lm, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()})
              for i in range(2)]
    for i, g in enumerate(g2):
        want = (torch.zeros_like(g) + halves[0][1][i].float() + halves[1][1][i].float()) / 2
        assert torch.equal(g, want)
    assert float(loss2) == float((halves[0][0] + halves[1][0]) / 2)
    assert abs(float(loss1) - float(loss2)) < 1e-2


# -- checkpoints -------------------------------------------------------------------
def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"p": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "opt": [{"m": torch.ones(3)}, {"v": torch.zeros(2)}]}
    for step in (1, 2, 3):
        mgr.save(step, tree, extra={"step": step, "note": "x"})
    assert mgr.steps() == [2, 3]  # keep=2 garbage-collected step 1
    got, extra = mgr.restore(device="cpu")
    assert extra["step"] == 3
    assert torch.equal(got["p"]["w"], tree["p"]["w"])
    assert isinstance(got["opt"], list) and len(got["opt"]) == 2


def test_checkpoint_crash_safety(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, {"w": torch.ones(3)}, extra={"step": 5})
    # simulate a crashed writer: snapshot without the commit marker
    bad = pathlib.Path(tmp_path) / "step_9"
    (bad / "arrays").mkdir(parents=True)
    (bad / "manifest.json").write_text("{}")
    assert mgr.latest_step() == 5  # incomplete snapshot ignored


def test_checkpoint_async_copies_before_it_returns(tmp_path):
    """``save_async`` takes its host copies before returning: a tensor
    updated in place right after (as the optimizer does) is saved as it
    was."""
    mgr = CheckpointManager(tmp_path)
    w = torch.full((4,), 7.0)
    mgr.save_async(7, {"w": w}, extra={"step": 7})
    w.add_(1.0)
    mgr.wait()
    got, extra = mgr.restore(device="cpu")
    assert extra["step"] == 7
    assert torch.equal(got["w"], torch.full((4,), 7.0))


def test_checkpoint_restore_needs_cuda_or_cpu(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore()
    assert mgr.restore(device="cpu")[0]["w"].device.type == "cpu"


def test_bfloat16_round_trip_c11(tmp_path):
    """ROADMAP C.11: the reference writes a bfloat16 leaf as raw ``|V2``
    bytes that its restore gives back unreadable; the port writes the 16
    bits with ``"dtype": "bfloat16"`` and restores bfloat16 bit for bit,
    and reads the reference's ``|V2`` file too."""
    bits = np.random.default_rng(0).normal(0, 1, (3, 5)).astype(np.float32)
    t = torch.from_numpy(bits).to(torch.bfloat16)
    mgr = CheckpointManager(tmp_path / "port")
    mgr.save(1, {"w": t, "f": torch.ones(2)}, extra={"step": 1})
    man = json.loads((tmp_path / "port" / "step_1" / "manifest.json").read_text())
    assert man["leaves"]["w"]["dtype"] == "bfloat16"
    got, _ = mgr.restore(device="cpu")
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)
    assert got["f"].dtype == torch.float32

    jmgr = JaxCheckpointManager(tmp_path / "ref")
    jw = jnp.asarray(bits, jnp.bfloat16)
    jmgr.save(1, {"w": jw}, extra={"step": 1})
    jgot, _ = jmgr.restore()
    assert jgot["w"].dtype.str == "|V2"           # the reference's fault, recorded
    with pytest.raises(TypeError):
        jnp.asarray(jgot["w"])
    ported = CheckpointManager(tmp_path / "ref").restore(device="cpu")[0]["w"]
    assert ported.dtype == torch.bfloat16 and torch.equal(ported, t)


_ARGS = ["--arch", "qwen3-0.6b", "--batch", "4", "--seq", "64", "--reduced",
         "--ckpt-every", "4", "--lr", "1e-3"]


def test_reference_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """A float32 checkpoint the reference's launcher wrote at step 4 resumes
    in the port's launcher: steps 4-7 within ``LOSS_RTOL`` of the reference's
    own uninterrupted run."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    jax_train_main(_ARGS + ["--steps", "4", "--ckpt-dir", str(ref)])
    shutil.copytree(ref, port)
    want = jax_train_main(_ARGS + ["--steps", "8", "--ckpt-dir", str(ref)])
    got = train_main(_ARGS + ["--steps", "8", "--ckpt-dir", str(port), "--device", "cpu"])
    assert "restored step 4" in capsys.readouterr().out
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_port_checkpoint_resumes_in_the_reference(tmp_path, capsys):
    """The port's step-4 checkpoint (the reference's layout: params tree,
    optimizer leaves, pipeline state) resumes in the reference's launcher,
    steps 4-7 within ``LOSS_RTOL`` of the port's own run."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    train_main(_ARGS + ["--steps", "4", "--ckpt-dir", str(port), "--device", "cpu"])
    man = json.loads((port / "step_4" / "manifest.json").read_text())
    assert man["extra"] == {"step": 4, "pipeline": {"epoch": 0, "cursor": 1024, "seed": 0}}
    assert "params/blocks/l0/mixer/wq" in man["leaves"] and "opt/0#/m" in man["leaves"]
    shutil.copytree(port, ref)
    want = train_main(_ARGS + ["--steps", "8", "--ckpt-dir", str(port), "--device", "cpu"])
    got = jax_train_main(_ARGS + ["--steps", "8", "--ckpt-dir", str(ref)])
    assert capsys.readouterr().out.count("restored step 4") == 2
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


# -- data pipeline --------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 4])
def test_pipeline_matches_the_reference(n_shards):
    """Shard assignment, documents, every batch and the state bit for bit,
    over more than one epoch of a shard."""
    kw = dict(vocab=100, seq_len=32, n_docs=64, n_shards=n_shards, seed=3)
    p, j = TokenPipeline(**kw), JaxPipeline(**kw)
    np.testing.assert_array_equal(p.shard_of, j.shard_of)
    assert all(np.array_equal(a, b) for a, b in zip(p.docs, j.docs))
    assert p.shard_balance() == j.shard_balance()
    for _ in range(40):
        got, want = p.global_batch(16), j.global_batch(16)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
        assert p.state.as_dict() == j.state.as_dict()
    assert p.state.epoch > 0


def test_pipeline_deterministic_and_balanced():
    p1 = TokenPipeline(vocab=100, seq_len=32, n_docs=512, n_shards=4, seed=3)
    p2 = TokenPipeline(vocab=100, seq_len=32, n_docs=512, n_shards=4, seed=3)
    b1, b2 = p1.next_batch(4, shard=1), p2.next_batch(4, shard=1)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert p1.shard_balance() < 1.25  # FMBI-balanced shards (paper: ~1.06)


def test_pipeline_state_restore():
    p = TokenPipeline(vocab=100, seq_len=16, n_docs=64, seed=0)
    p.next_batch(2)
    saved = p.state.as_dict()
    a = p.next_batch(2)["tokens"]
    p2 = TokenPipeline(vocab=100, seq_len=16, n_docs=64, seed=0)
    p2.state = PipelineState.from_dict(saved)
    b = p2.next_batch(2)["tokens"]
    np.testing.assert_array_equal(a, b)


# -- launchers ----------------------------------------------------------------------------
def test_train_launcher_loss_decreases_and_restarts(tmp_path, deterministic):
    """16 steps (lr 1e-2): the mean loss of the last four below the first
    four's; a restart with ``--steps 20`` runs only steps 16-19; a restart
    from step 8 repeats steps 8-15 bit for bit (deterministic algorithms
    on)."""
    args = ["--arch", "qwen3-0.6b", "--batch", "4", "--seq", "64", "--reduced",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "8", "--lr", "1e-2",
            "--device", "cpu"]
    losses = train_main(args + ["--steps", "16"])
    assert len(losses) == 16
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    more = train_main(args + ["--steps", "20"])
    assert len(more) == 4                   # only steps 16..19 ran after restore
    shutil.rmtree(tmp_path / "step_16")
    again = train_main(args + ["--steps", "16"])
    assert again == losses[8:]


def test_serve_launcher(capsys):
    out = serve_mod.main(["--arch", "qwen3-0.6b", "--reduced", "--batch", "2",
                          "--prompt-len", "8", "--max-new", "4", "--device", "cpu"])
    assert out.shape == (2, 4) and ((out >= 0) & (out < 512)).all()
    assert "generated (2, 4) tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve_mod.main(["--arch", "seamless-m4t-medium", "--reduced", "--device", "cpu"])


def test_train_launcher_needs_cuda_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_train_launcher_runs_as_a_module(tmp_path):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--steps", "2",
         "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.count("loss") == 2
