"""The port's sharding rules, flags and meshes (``repro_torch.sharding``,
``repro_torch.launch.mesh``) against the JAX reference, in one process
with no process group.

* The rules at full width: for all ten architectures (the reference's
  trees from ``jax.eval_shape``, the port's built on the meta device),
  on the (16,16), (2,16,16), (2,4), (8,1) and (2,2) meshes (the
  reference's ``AbstractMesh``, the port's ``MeshShape``), under the four
  combinations of ``strict_heads`` and ``fsdp_params``: ``param_spec`` on
  every parameter leaf, ``opt_state_shardings`` on every ``TrainState``
  leaf, ``cache_spec`` on ``SHAPES["decode_32k"]``'s cache and
  ``batch_spec`` on every cell's inputs, each equal exactly.
* The reference's divisibility cases (``tests/test_distribution.py``).
* ``to_placements`` on single and tuple axes; ``FLAGS`` and ``VARIANTS``
  equal to the reference's; ``variant()`` restores on exit and on an
  exception; the meta device's generator.
"""

import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.config import SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.models.registry import get_model as j_model
from repro.sharding import perf as J_perf
from repro.sharding import rules as J_rules
from repro.train.step import make_train_state as j_state
from repro_torch.config import SHAPES
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.errors import generator
from repro_torch.launch import mesh as T_mesh
from repro_torch.launch.steps import input_specs
from repro_torch.models.registry import get_model
from repro_torch.pytree import flatten_with_path
from repro_torch.sharding import perf as T_perf
from repro_torch.sharding import rules as T_rules
from repro_torch.sharding.rules import P
from repro_torch.train.step import make_train_state

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "8x1": ((8, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}
#: the four combinations of strict_heads x fsdp_params, by variant name
FLAG_VARIANTS = ("baseline", "strict_heads", "nofsdp", "nofsdp_strict")
DECODE = "decode_32k"


def _j_names(path) -> str:
    def one(p):
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                return str(getattr(p, attr))
        return str(p)

    return "/".join(one(p) for p in path)


def _j_leaves(tree) -> dict:
    return {_j_names(path): (path, leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _j_specs(sharding_tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        sharding_tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {_j_names(path): tuple(s.spec) for path, s in flat}


@pytest.fixture(scope="module")
def trees():
    """Per arch: the reference's and the port's full-width params,
    TrainState and decode_32k cache (shapes only), and the cells'
    inputs."""
    out = {}
    for arch in ARCH_IDS:
        jc, tc = j_config(arch), get_config(arch)
        japi, tapi = j_model(jc), get_model(tc)
        d = J_SHAPES[DECODE]
        out[arch] = {
            "cfg": (jc, tc),
            "params": (jax.eval_shape(
                lambda: japi.init_params(jc, jax.random.PRNGKey(0))),
                tapi.init_params(tc, 0, device="meta")),
            "state": (jax.eval_shape(
                lambda: j_state(jc, jax.random.PRNGKey(0))),
                make_train_state(tc, 0, device="meta")),
            "cache": (jax.eval_shape(
                lambda: japi.init_cache(jc, d.global_batch, d.seq_len)),
                tapi.init_cache(tc, SHAPES[DECODE].global_batch,
                                SHAPES[DECODE].seq_len, device="meta")),
        }
    return out


def test_meta_trees_match_the_reference_shapes(trees):
    for arch, t in trees.items():
        for kind in ("params", "state", "cache"):
            j, p = t[kind]
            want = {n: tuple(leaf.shape) for n, (_, leaf) in
                    _j_leaves(j).items()}
            got = {n: tuple(x.shape) for n, x in flatten_with_path(p)}
            assert got == want, (arch, kind)
            assert all(x.device.type == "meta"
                       for _, x in flatten_with_path(p)), (arch, kind)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_equal_the_reference_at_full_width(trees, arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    j_mesh = AbstractMesh(sizes, names)
    t_mesh = T_mesh.MeshShape(names, sizes)
    t = trees[arch]
    jc, tc = t["cfg"]
    checked = 0
    for var in FLAG_VARIANTS:
        with J_perf.variant(var), T_perf.variant(var):
            # parameters, leaf by leaf
            jp, tp = t["params"]
            j_leaves = _j_leaves(jp)
            for name, x in flatten_with_path(tp):
                path, leaf = j_leaves[name]
                want = J_rules.param_spec(jc, path, leaf.shape, j_mesh)
                got = T_rules.param_spec(tc, name, tuple(x.shape), t_mesh)
                assert isinstance(got, P)
                assert tuple(got) == tuple(want), (var, name, got, want)
                checked += 1
            got = T_rules.tree_param_shardings(tc, tp, t_mesh)
            want = _j_specs(J_rules.tree_param_shardings(jc, jp, j_mesh))
            assert {n: tuple(s) for n, s in
                    _spec_items(got, tp)} == want, var
            # the TrainState: params, mu, nu, the step counters
            js, ts = t["state"]
            got = T_rules.opt_state_shardings(tc, ts, t_mesh)
            want = _j_specs(J_rules.opt_state_shardings(jc, js, j_mesh))
            got = {n: tuple(s) for n, s in _spec_items(got, ts)}
            assert got == want, var
            checked += len(want)
            # the decode_32k cache
            jk, tk = t["cache"]
            got = T_rules.tree_cache_shardings(tc, tk, t_mesh)
            want = _j_specs(J_rules.tree_cache_shardings(jc, jk, j_mesh))
            assert {n: tuple(s) for n, s in
                    _spec_items(got, tk)} == want, var
            checked += len(want)
    # every cell's batch inputs
    for shape_name, shape in SHAPES.items():
        if shape.kind == "decode":
            specs = {"token": (shape.global_batch, 1)}
        else:
            specs = {n: tuple(x.shape) for n, x in
                     input_specs(tc, shape).items()}
        for n, s in specs.items():
            want = J_rules.batch_spec(s, j_mesh)
            got = T_rules.batch_spec(s, t_mesh)
            assert tuple(got) == tuple(want), (shape_name, n)
            assert T_rules.batch_axes_for(s[0], t_mesh) \
                == J_rules.batch_axes_for(s[0], j_mesh)
            checked += 1
    assert checked > 100


def _spec_items(spec_tree, like):
    return T_rules.spec_leaves(spec_tree, like).items()


def test_divisibility_fallbacks():
    """The reference's cases (tests/test_distribution.py), on a (2,4)
    shape, and a DeviceMesh-free MeshShape."""
    mesh = T_mesh.MeshShape(("data", "model"), (2, 4))
    cfg = get_config("gemma-2b")
    spec = T_rules.param_spec(cfg, "layers/mlp/w_up", (18, 2048, 16384),
                              mesh)
    assert spec == P(None, "data", "model"), spec
    spec = T_rules.param_spec(cfg, "embed", (256000, 2048), mesh)
    assert spec == P("model", "data"), spec
    cfg2 = get_config("internvl2-26b")
    spec = T_rules.param_spec(cfg2, "embed", (92553, 6144), mesh)
    assert spec[0] is None, spec
    spec = T_rules.param_spec(cfg, "layers/norm1/scale", (18, 2048), mesh)
    assert spec == P(), spec
    # zamba's 56 ssm heads do not divide 16 model shards
    z = get_config("zamba2-7b")
    big = T_mesh.MeshShape(("data", "model"), (16, 16))
    assert T_rules.cache_spec(z, "state/ssm", (81, 1, 56, 64, 64), big) \
        == P(None, None, None, None, None)


def test_mesh_shape_helpers():
    m = T_mesh.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert T_mesh.dp_axes(m) == ("pod", "data")
    assert (T_mesh.model_size(m), T_mesh.dp_size(m)) == (16, 32)
    m = T_mesh.MeshShape(("data",), (4,))
    assert (T_mesh.dp_axes(m), T_mesh.model_size(m), T_mesh.dp_size(m)) \
        == (("data",), 1, 4)
    with pytest.raises(ValueError, match="names"):
        T_mesh.MeshShape(("data",), (2, 2))
    with pytest.raises(TypeError):
        T_mesh.mesh_shape((2, 2))


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_production_mesh_names_the_world_size(multi_pod, need):
    with pytest.raises(ValueError, match=f"{need} ranks; this one has 1"):
        T_mesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")


@pytest.mark.parametrize("spec,names,want", [
    (P(None, "data", "model"), ("data", "model"), (Shard(1), Shard(2))),
    (P("model", "data"), ("data", "model"), (Shard(1), Shard(0))),
    (P(), ("data", "model"), (Replicate(), Replicate())),
    (P(None, None), ("data",), (Replicate(),)),
    (P(("pod", "data"), None, "model"), ("pod", "data", "model"),
     (Shard(0), Shard(0), Shard(2))),
    (P(None, ("pod", "data")), ("pod", "data", "model"),
     (Shard(1), Shard(1), Replicate())),
    (P("data", None), ("pod", "data", "model"),
     (Replicate(), Shard(0), Replicate())),
])
def test_to_placements(spec, names, want):
    mesh = T_mesh.MeshShape(names, (2,) * len(names))
    assert T_rules.to_placements(spec, mesh) == want


@pytest.mark.parametrize("spec,match", [
    (P("pod", None), "lacks"),
    (P("data", "data"), "twice"),
    (P(("data", "pod"),), "order"),
])
def test_to_placements_refuses(spec, match):
    mesh = T_mesh.MeshShape(("pod", "data", "model"), (2, 2, 2)) \
        if match == "order" else T_mesh.MeshShape(("data", "model"), (2, 2))
    with pytest.raises(ValueError, match=match):
        T_rules.to_placements(spec, mesh)


def test_flags_and_variants_equal_the_reference():
    assert dataclasses.asdict(T_perf.PerfFlags()) \
        == dataclasses.asdict(J_perf.PerfFlags())
    assert [f.name for f in dataclasses.fields(T_perf.PerfFlags)] \
        == [f.name for f in dataclasses.fields(J_perf.PerfFlags)]
    assert T_perf.VARIANTS == J_perf.VARIANTS
    assert dataclasses.asdict(T_perf.FLAGS) \
        == dataclasses.asdict(J_perf.FLAGS)


@pytest.mark.parametrize("name", sorted(J_perf.VARIANTS))
def test_variant_restores_on_exit_and_on_exception(name):
    before = dataclasses.asdict(T_perf.FLAGS)
    flags = T_perf.FLAGS
    with T_perf.variant(name) as f:
        assert f is flags
        for k, v in T_perf.VARIANTS[name].items():
            assert getattr(T_perf.FLAGS, k) == v
    assert dataclasses.asdict(T_perf.FLAGS) == before
    with pytest.raises(RuntimeError, match="boom"):
        with T_perf.variant(name):
            raise RuntimeError("boom")
    assert dataclasses.asdict(T_perf.FLAGS) == before
    assert T_perf.FLAGS is flags


def test_constraint_leaves_plain_tensors_alone():
    x = torch.ones(2, 3, 4)
    assert T_perf.constraint(x, "data", None) is x
    assert T_perf.constrain_bs(x, seq=True) is x
    assert T_perf.replicate_dims(x, -1) is x


def test_meta_generator_leaves_cpu_draws_unchanged():
    a = torch.randn(64, generator=generator(11, "cpu"))
    b = torch.randn(64, generator=torch.Generator().manual_seed(11))
    assert torch.equal(a, b)
    assert generator(11, "cpu").device.type == "cpu"
    g = generator(11, "meta")
    assert g.device.type == "cpu"
    x = torch.randn((3, 5), generator=g, device="meta")
    assert x.device.type == "meta" and x.shape == (3, 5)
    # the meta tree of the full-width model has no storage
    p = get_model(get_config("qwen1.5-4b")).init_params(
        get_config("qwen1.5-4b"), 0, device="meta")
    assert p["embed"].shape == (151936, 2560) and p["embed"].is_meta
