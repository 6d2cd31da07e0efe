"""The LM on a device mesh (``repro_torch.models.sharding``,
``launch/mesh.py``, the expert-parallel MoE, DTensor parameters in the
trainer) against the JAX package and against one device, on the CPU.

  * ``MeshAxes.resolve``, ``shape_safe_spec`` and ``constrain`` keep the
    reference's rules; without a mesh nothing changes.
  * Shard shapes, exactly: every parameter, optimizer-state, input and
    cache leaf of every cell, on both production meshes (fake process
    groups of 256 and 512 ranks), has rank 0's local shape equal to JAX's
    ``NamedSharding(mesh, shape_safe_spec(...)).shard_shape(shape)``
    (the JAX package in one subprocess with 512 forced host devices).
  * Four gloo ranks on the CPU at ``(2, 2)`` and ``(1, 4)``: the reduced
    dense, MoE, RWKV6, Jamba and encoder-decoder configs
    (``launch/train.py:reduced_config``), their logits, loss and every
    gradient within ``REL`` = 1e-5 relative (``|a - b| / |b|`` in the
    Frobenius norm, per tensor) of the one-device step.  MoE runs at
    capacity factor ``E / top_k`` (no drop: a sharded MoE counts capacity
    on a shard's tokens, a different function wherever it drops).  RWKV6
    and Jamba run in float64: their chunked decays amplify float32
    rounding, so the order of a split sum alone moves them by up to
    6.8e-5 (measured at these sizes); in float64 they agree to 1e-13.
  * The expert-parallel MoE against the reference's ``moe_ffn`` on a
    ``(2, 2)`` host mesh (a subprocess with 4 host devices), a router
    skewed towards two experts, ``TOKEN_CHUNK`` set in both packages for
    two chunks per data shard: outputs within ``MOE_ATOL`` = 1e-5 and the
    drops of every (data, model) shard equal to the reference's routing
    counted per shard, and to ``moe.shard_drops``.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import mesh_ranks as MR
from repro_torch.configs.base import SHAPES, all_configs, cells
from repro_torch.core import mesh as core_mesh
from repro_torch.launch.mesh import make_production_mesh, use_mesh
from repro_torch.models import model as M
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import reference_leaves
from repro_torch.models.sharding import (MeshAxes, Replicate, Shard, constrain,
                                         shape_safe_spec)
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import init_state

REPO = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-5
MOE_ATOL = 1e-5
FAMILIES = {"dense": ("qwen3-0.6b", {}),
            "moe": ("qwen3-moe-235b-a22b", {"capacity_factor": 2.0}),
            "rwkv6": ("rwkv6-3b", {"dtype": "float64"}),
            "jamba": ("jamba-v0.1-52b", {"dtype": "float64", "capacity_factor": 2.0}),
            "encdec": ("seamless-m4t-medium", {})}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}


# --------------------------------------------------------------------------
# the logical-axis rules
# --------------------------------------------------------------------------
def test_resolve_gives_one_placement_per_mesh_dim():
    one = MeshAxes(dp=("data",))
    assert one.resolve(("fsdp", "tp")) == [Shard(0), Shard(1)]
    assert one.resolve(("tp", "fsdp", None)) == [Shard(1), Shard(0)]
    assert one.resolve((None, "seq")) == [Replicate(), Shard(1)]
    assert one.resolve((None,)) == [Replicate(), Replicate()]
    assert one.resolve(("dp+tp", None)) == [Shard(0), Shard(0)]
    multi = MeshAxes(dp=("pod", "data"))
    # 'fsdp' over both data dims, pod major: the rank order of P(('pod', 'data'))
    assert multi.resolve(("fsdp", None)) == [Shard(0), Shard(0), Replicate()]
    assert multi.resolve(("dp+tp",)) == [Shard(0), Shard(0), Shard(0)]
    with pytest.raises(ValueError, match="unknown logical axis"):
        one.resolve(("expert",))


def test_shape_safe_spec_drops_axes_that_do_not_divide():
    class Mesh:
        shape = (2, 4)

        def size(self, m):
            return self.shape[m]

    mesh = Mesh()
    assert shape_safe_spec(mesh, [Shard(0), Shard(1)], (6, 8)) == [Shard(0), Shard(1)]
    assert shape_safe_spec(mesh, [Shard(0), Shard(1)], (3, 8)) == [Replicate(), Shard(1)]
    assert shape_safe_spec(mesh, [Shard(0), Shard(1)], (6, 6)) == [Shard(0), Replicate()]
    # one dim over both mesh dims: 2 * 4 = 8 must divide it, else both go
    assert shape_safe_spec(mesh, [Shard(0), Shard(0)], (8, 1)) == [Shard(0), Shard(0)]
    assert shape_safe_spec(mesh, [Shard(0), Shard(0)], (4, 1)) == [Replicate(), Replicate()]


def test_constrain_is_a_no_op_without_a_mesh():
    x = torch.randn(2, 3)
    assert constrain(x, MeshAxes(), ("fsdp", None)) is x
    assert constrain(x, None, ("fsdp", None)) is x


# --------------------------------------------------------------------------
# shard shapes against JAX on the production meshes
# --------------------------------------------------------------------------
SHAPES_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
sys.path.insert(0, "src")
import jax
from jax.sharding import NamedSharding
if len(jax.devices()) < 512:
    print(f"REF-SKIP: only {len(jax.devices())} devices"); sys.exit(0)
from repro.configs.base import all_configs, cells
from repro.launch.mesh import make_production_mesh
from repro.models import model as M
from repro.models.sharding import axes_for_mesh, shape_safe_spec
from repro.train import optimizer as opt_mod
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    tag = "x".join(str(s) for s in mesh.devices.shape)
    axes = axes_for_mesh(mesh)
    def ss(shape, spec):
        return list(NamedSharding(mesh, shape_safe_spec(mesh, spec, shape)).shard_shape(shape))
    for name, cfg in sorted(all_configs().items()):
        params = M.abstract_params(cfg, mesh)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{tag}|{name}|param|{jax.tree_util.keystr(path)}"] = list(
                leaf.sharding.shard_shape(leaf.shape))
        opt = opt_mod.get_optimizer(opt_mod.pick_for(cfg))
        state = jax.eval_shape(opt.init, params)
        specs = opt.state_specs(M.param_pspecs(cfg, axes))
        for i, (st, sp) in enumerate(zip(state, specs)):
            for k in st:
                out[f"{tag}|{name}|opt|{i}|{k}"] = ss(st[k].shape, sp[k])
    for cfg, shape, _ in cells():
        inputs = M.input_specs(cfg, shape, mesh)
        for path, leaf in jax.tree_util.tree_flatten_with_path(inputs)[0]:
            out[f"{tag}|{cfg.name}|{shape.name}|{jax.tree_util.keystr(path)}"] = list(
                leaf.sharding.shard_shape(leaf.shape))
json.dump(out, open(sys.argv[1], "w"))
print("REF-OK")
"""


def _key(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _port_shapes(tag, multi_pod) -> dict:
    """Rank 0's local shapes of every leaf, keyed as the reference's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = make_production_mesh(multi_pod=multi_pod)
    out = {}
    with FakeTensorMode(allow_non_fake_inputs=True):
        for name, cfg in sorted(all_configs().items()):
            lm = M.abstract_params(cfg, mesh)
            named = dict(lm.named_parameters())
            leaves = reference_leaves(cfg, list(named))
            for path, rows, stacked in leaves:
                for r in rows:
                    local = list(named[r].to_local().shape)
                    out.setdefault(f"{tag}|{name}|param|{_key(path)}", []).append(
                        ([len(rows)] if stacked else []) + local)
            opt = opt_mod.get_optimizer(opt_mod.pick_for(cfg))
            for i, st in enumerate(init_state(opt, lm)):
                for k, t in st.items():
                    out[f"{tag}|{name}|opt|{i}|{k}"] = [list(t.to_local().shape)]
        for cfg, shape, _ in cells():
            inputs = M.input_specs(cfg, shape, mesh)
            sb, nb = cfg.superblock, cfg.n_blocks
            for k, v in inputs.items():
                if k != "cache":
                    out[f"{tag}|{cfg.name}|{shape.name}|[{k!r}]"] = [list(v.to_local().shape)]
                    continue
                for li, layer in enumerate(v):
                    b, i = divmod(li, sb)
                    for name, t in layer.items():
                        if b < nb:
                            key = f"['cache']['blocks']['l{i}'][{name!r}]"
                            local = [nb] + list(t.to_local().shape)
                        else:
                            key = f"['cache']['rem{li - nb * sb}'][{name!r}]"
                            local = list(t.to_local().shape)
                        out.setdefault(f"{tag}|{cfg.name}|{shape.name}|{key}", []).append(local)
    return out


@pytest.fixture(scope="module")
def jax_shard_shapes(tmp_path_factory):
    path = tmp_path_factory.mktemp("shards") / "ref.json"
    res = subprocess.run([sys.executable, "-c", SHAPES_SCRIPT, str(path)], cwd=str(REPO),
                         capture_output=True, text=True, timeout=600)
    if "REF-SKIP" in res.stdout:
        pytest.skip("could not provision 512 virtual devices for the JAX package")
    assert "REF-OK" in res.stdout, res.stdout + res.stderr
    return json.loads(path.read_text())


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_every_leaf_shards_as_jax_does(jax_shard_shapes, multi_pod):
    """Parameters (each layer's row of a stacked leaf), optimizer state,
    inputs and caches of every cell: rank 0's shard shape equals JAX's."""
    tag = "2x16x16" if multi_pod else "16x16"
    want = {k: v for k, v in jax_shard_shapes.items() if k.startswith(tag + "|")}
    got = _port_shapes(tag, multi_pod)
    assert set(got) == set(want)
    for key, shapes in got.items():
        for shape in shapes:
            assert shape == want[key], key
    assert len(want) > 1000


# --------------------------------------------------------------------------
# four gloo ranks against one device, and the MoE against the reference
# --------------------------------------------------------------------------
MOE_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
if len(jax.devices()) < 4:
    print(f"REF-SKIP: only {len(jax.devices())} devices"); sys.exit(0)
from repro.configs.base import ModelConfig
from repro.launch.mesh import make_mesh, use_mesh
from repro.models import moe as jmoe
from repro.models.sharding import MeshAxes
data = np.load(sys.argv[1])
chunk = int(sys.argv[2])
jmoe.TOKEN_CHUNK = chunk
cfg = ModelConfig(name="t-moe", family="moe", n_layers=1, d_model=64, n_heads=4,
                  n_kv_heads=4, d_ff=96, vocab=100, n_experts=8, moe_top_k=2,
                  moe_dff=80, dtype="float32")
tree = {k: jnp.asarray(data[k]) for k in ("router", "w1", "w3", "w2")}
x = data["x"]
mesh = make_mesh((2, 2), ("data", "model"))
with use_mesh(mesh):
    out = jax.jit(lambda p, x: jmoe.moe_ffn(p, cfg, x, MeshAxes()))(tree, jnp.asarray(x))
drops = np.zeros((2, 2), np.int64)
for i in range(2):                        # the body's routing, per data shard
    xs = x[i * x.shape[0] // 2:(i + 1) * x.shape[0] // 2].reshape(-1, 64)
    gates = jax.nn.softmax(jnp.asarray(xs) @ tree["router"], axis=-1)
    tope = np.asarray(jax.lax.top_k(gates, 2)[1])
    t = xs.shape[0]
    c = min(chunk, t)
    while t % c:
        c -= 1
    cap = jmoe.capacity(cfg, c)
    for j in range(0, t, c):
        over = np.maximum(np.bincount(tope[j:j + c].reshape(-1), minlength=8) - cap, 0)
        drops[i] += [over[:4].sum(), over[4:].sum()]
np.savez(sys.argv[3], out=np.asarray(out), drops=drops)
print("REF-OK")
"""
MOE_CHUNK = MR.MOE_CHUNK


def _lm_batch(arch, overrides):
    cfg = MR.mesh_config(arch, **overrides)
    return cfg, MR.lm_batch(cfg)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One device's step of each family, the ranks' steps on each mesh and
    the reference's expert-parallel MoE, the JAX subprocess running while
    the ranks do."""
    path = tmp_path_factory.mktemp("moe")
    cfg, tree, x = MR.moe_case()
    np.savez(path / "in.npz", x=x, **tree)
    ref_proc = subprocess.Popen([sys.executable, "-c", MOE_SCRIPT, str(path / "in.npz"),
                                 str(MOE_CHUNK), str(path / "ref.npz")],
                                cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
    try:
        one, jobs = {}, []
        for fam, (arch, overrides) in FAMILIES.items():
            fcfg, batch = _lm_batch(arch, overrides)
            torch.manual_seed(0)
            one[fam] = MR.lm_step(fcfg, batch)
            jobs.append(("lm", arch, batch, overrides))
        ranks = {}
        for tag, shape in MESHES.items():
            extra = [("moe", cfg, tree, x, MOE_CHUNK)] if tag == "2x2" else []
            ranks[tag] = core_mesh.run_ranks(MR.jobs_rank, 4, backend="gloo",
                                             devices=["cpu"] * 4, timeout=600,
                                             args=(shape, jobs + extra))
        stdout, stderr = ref_proc.communicate(timeout=300)
    finally:
        ref_proc.kill()
    if "REF-OK" in stdout:
        ref = dict(np.load(path / "ref.npz"))
    elif "REF-SKIP" in stdout:
        ref = None
    else:
        raise AssertionError(stdout + stderr)
    return one, ranks, ref


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_step_matches_one_device(mesh_runs, family, tag):
    """Every rank's logits, loss and gradients equal one device's within
    ``REL`` (relative Frobenius norm per tensor)."""
    one, ranks, _ = mesh_runs
    want = one[family]
    j = list(FAMILIES).index(family)
    for rank, results in enumerate(ranks[tag]):
        got = results[j]
        assert MR.rel_err(got["logits"], want["logits"]) < REL, (rank, "logits")
        assert abs(got["loss"] - want["loss"]) <= REL * abs(want["loss"]), rank
        assert set(got["grads"]) == set(want["grads"])
        for name, g in want["grads"].items():
            assert MR.rel_err(got["grads"][name], g) < REL, (rank, name)
        # at capacity E / top_k nothing drops, on a shard or on one device
        assert not any(got["drops"]) and not any(want["drops"])


def test_expert_parallel_moe_matches_the_reference(mesh_runs):
    """The ``(2, 2)`` expert-parallel MoE: every rank's full output within
    ``MOE_ATOL`` of the reference's ``moe_ffn`` on a ``(2, 2)`` host mesh,
    and each rank's drops equal to the reference's routing counted on its
    (data, model) shard and to ``moe.shard_drops``."""
    _, ranks, ref = mesh_runs
    if ref is None:
        pytest.skip("could not provision 4 virtual devices for the JAX package")
    cfg, tree, x = MR.moe_case()
    oracle = tmoe.shard_drops(cfg, torch.as_tensor(tree["router"]), torch.as_tensor(x),
                              2, 2, MOE_CHUNK)
    assert np.asarray(oracle).tolist() == ref["drops"].tolist()
    assert ref["drops"].sum() > 0 and ref["drops"][:, 1].sum() < ref["drops"][:, 0].sum()
    for results in ranks["2x2"]:
        got = results[-1]
        np.testing.assert_allclose(got["out"], ref["out"], atol=MOE_ATOL, rtol=0)
        i, j = got["coord"]
        assert got["drops"] == ref["drops"][i, j]


def test_moe_drop_counts_per_shard_sum_to_one_devices():
    """On a mesh of one, ``shard_drops`` is the one-device count."""
    cfg, tree, x = MR.moe_case()
    mod = tmoe.MoE(cfg, __import__("repro_torch.models.layers", fromlist=["Init"]).Init(
        None, torch.device("cpu"), torch.float32, empty=True))
    for k, v in tree.items():
        getattr(mod, k).data.copy_(torch.as_tensor(v))
    tmoe_chunk = tmoe.TOKEN_CHUNK
    try:
        tmoe.TOKEN_CHUNK = MOE_CHUNK
        with torch.no_grad():
            mod(torch.as_tensor(x))
    finally:
        tmoe.TOKEN_CHUNK = tmoe_chunk
    assert tmoe.shard_drops(cfg, torch.as_tensor(tree["router"]), torch.as_tensor(x),
                            1, 1, MOE_CHUNK) == [[int(mod.dropped)]]


def test_production_meshes_and_fake_worlds():
    """The production meshes lie on fake worlds of 256 and 512 ranks with the
    reference's dim names; a mesh asks for as many ranks as the group has."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_world, make_mesh

    single = make_production_mesh(multi_pod=False)
    assert tuple(single.shape) == (16, 16) and single.mesh_dim_names == ("data", "model")
    multi = make_production_mesh(multi_pod=True)
    assert tuple(multi.shape) == (2, 16, 16)
    assert multi.mesh_dim_names == ("pod", "data", "model")
    assert dist.get_world_size() == 512 and dist.get_backend() == "fake"
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((2, 2), ("data", "model"))
    fake_world(4)
    with use_mesh(make_mesh((2, 2), ("data", "model"))) as mesh:
        from repro_torch.models.sharding import ambient_mesh

        assert ambient_mesh() is mesh
    assert ambient_mesh() is None


@pytest.fixture(scope="module", autouse=True)
def _no_fake_world_left():
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype,n_micro", [("bfloat16", 2), ("float32", 1)])
def test_a_mesh_of_one_is_bit_for_bit_the_plain_step(dtype, n_micro):
    """DTensor parameters on a ``(1, 1)`` mesh of one gloo rank take the
    plain step's path through every op (a local product, the loss's
    gather and log-sum-exp where the vocab is not split): loss and every
    updated leaf bit for bit, under deterministic algorithms, and the
    same ``FlopCounterMode`` count."""
    cfg = MR.mesh_config("qwen3-0.6b", dtype=dtype)
    batch = MR.lm_batch(cfg)
    (res,) = core_mesh.run_ranks(MR.mesh_of_one_rank, 1, backend="gloo", devices=["cpu"],
                                 timeout=300, args=("qwen3-0.6b", dtype, n_micro, batch))
    a, b = res["dtensor"], res["plain"]
    np.testing.assert_array_equal(a["loss"], b["loss"])
    for x, y in zip(a["bits"], b["bits"]):
        np.testing.assert_array_equal(x, y)
    assert a["flops"] == b["flops"] > 0
