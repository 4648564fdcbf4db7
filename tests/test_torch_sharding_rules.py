"""Meshes and sharding rules of the port against the JAX package's, in
one process (no spawn).

- ``MeshSpec`` and ``MeshSpec.for_devices``: axes, size and the error
  messages, against ``ray_tpu.parallel.mesh``'s.
- ``spec_for`` of every leaf path of the dense and MoE Llama, ViT, CLIP
  and DiT trees (the port's own inits, whose paths must be the JAX
  trees' paths) under every mode of each family's rules and of
  ``ShardingConfig``, against JAX's ``spec_for`` on JAX's tree.
- Every device's local shard of tiny Llama under fsdp_tp on
  ``MeshSpec(data=2, fsdp=2, model=2)`` and of tiny MoE under ep on
  ``MeshSpec(data=2, expert=4)``, cut by the port's pure
  ``local_shards``, against the shard JAX places on that device
  (``addressable_shards`` on the 8-device CPU mesh).
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ray_tpu.models import dit as jd
from ray_tpu.models import llama as jl
from ray_tpu.models import vit as jv
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsh
from ray_tpu_torch.models import dit as td
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import vit as tv
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh
from ray_tpu_torch.parallel.sharding import P

torch.set_num_threads(1)

# family: (JAX init, JAX config, the port's tree, the rules' modes, the
# JAX rules function, the port's)
FAMILIES = {
    "llama": (jl.llama_init, jl.LlamaConfig.tiny(),
              lambda: tl.llama_init(0, tl.LlamaConfig.tiny(), "cpu"),
              ("ddp", "fsdp", "tp", "fsdp_tp", "ep"),
              jl.llama_sharding_rules, tl.llama_sharding_rules),
    "llama_moe": (jl.llama_init, jl.LlamaConfig.tiny_moe(),
                  lambda: tl.llama_init(0, tl.LlamaConfig.tiny_moe(),
                                        "cpu"),
                  ("ddp", "fsdp", "tp", "fsdp_tp", "ep"),
                  jl.llama_sharding_rules, tl.llama_sharding_rules),
    "vit": (jv.vit_init, jv.ViTConfig.tiny(n_classes=5, pool="cls"),
            lambda: tv.vit_init(0, tv.ViTConfig.tiny(n_classes=5,
                                                     pool="cls"), "cpu"),
            ("ddp", "fsdp", "tp", "fsdp_tp"),
            jv.vit_sharding_rules, tv.vit_sharding_rules),
    "clip": (jv.clip_init, jv.CLIPConfig.tiny(),
             lambda: tv.clip_init(0, tv.CLIPConfig.tiny(), "cpu"),
             ("ddp", "fsdp", "tp", "fsdp_tp"),
             jv.clip_sharding_rules, tv.clip_sharding_rules),
    "dit": (jd.dit_init, jd.DiTConfig.tiny(),
            lambda: td.dit_init(0, td.DiTConfig.tiny(), "cpu"),
            ("ddp", "fsdp", "tp", "fsdp_tp"),
            jd.dit_sharding_rules, td.dit_sharding_rules),
}


def _entry(e):
    """A spec entry in one form: None, a name, or a tuple of two or more
    names (JAX writes a tuple of one name as the name)."""
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _same_spec(port, want):
    return tuple(map(_entry, port)) == tuple(map(_entry, want))


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


# --- MeshSpec ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(data=2, fsdp=2, model=2),
                                dict(seq=4, data=2), dict(expert=4, pipe=2)])
def test_mesh_spec_axes_and_size(kw):
    want, got = jmesh.MeshSpec(**kw), tmesh.MeshSpec(**kw)
    assert got.axes() == want.axes()
    assert list(got.axes()) == list(want.axes())
    assert got.size == want.size
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER


@pytest.mark.parametrize("n, kw", [
    (8, dict(model=2)), (8, dict(model=2, fsdp=2)), (16, dict(seq=2,
                                                                expert=2)),
    (8, dict(fsdp=8)), (4, dict(pipe=4))])
def test_for_devices_matches(n, kw):
    assert (tmesh.MeshSpec.for_devices(n, **kw)
            == tmesh.MeshSpec(**jmesh.MeshSpec.for_devices(n, **kw)
                              .__dict__))


@pytest.mark.parametrize("n, kw", [(8, dict(model=3)), (8, dict(fsdp=3)),
                                   (6, dict(seq=4))])
def test_for_devices_errors_match(n, kw):
    assert (_error(lambda: tmesh.MeshSpec.for_devices(n, **kw))
            == _error(lambda: jmesh.MeshSpec.for_devices(n, **kw)))


def test_mesh_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tmesh.make_mesh(tmesh.MeshSpec())
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tmesh.single_device_mesh()


def test_mesh_axis_size_reads_the_mesh():
    mesh = types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_ORDER,
                                 shape=(1, 2, 2, 1, 1, 2))
    assert tmesh.mesh_axis_size(mesh, "model") == 2
    assert tmesh.mesh_axis_size(mesh, "seq") == 1
    assert tmesh.mesh_axis_size(mesh, "nope") == 1


def test_initialize_distributed_is_a_no_op_for_one_process():
    before = torch.distributed.is_initialized()
    tmesh.initialize_distributed(num_processes=1)
    tmesh.initialize_distributed()
    assert torch.distributed.is_initialized() == before


# --- rules -------------------------------------------------------------------

def test_sharding_rules_match():
    """The reference's scenario (tests/test_parallel.py:42-50)."""
    rules = tsh.ShardingRules(rules=[
        (r"dense/kernel", P("fsdp", "model")),
        (r".*", P()),
    ])
    assert rules.spec_for("model/dense/kernel", 2) == P("fsdp", "model")
    assert rules.spec_for("model/bias", 1) == P()
    assert rules.spec_for("dense/kernel", 1) == P("fsdp")
    assert repr(P(None, ("fsdp", "model"))) == "P(None, ('fsdp', 'model'))"


def _jax_tree(family):
    init, cfg = FAMILIES[family][:2]
    return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def trees():
    """family -> (JAX's (path, ndim) list, the port's tree)."""
    out = {}
    for family, (_i, _c, port_init, *_rest) in FAMILIES.items():
        want = [(p, len(leaf.shape))
                for p, leaf in jsh._tree_paths(_jax_tree(family))]
        out[family] = (want, port_init())
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_trees_have_the_jax_paths(trees, family):
    want, port_tree = trees[family]
    got = [(p, leaf.ndim) for p, leaf in tsh._tree_paths(port_tree)]
    assert got == want


@pytest.mark.parametrize("family, mode", [
    (f, m) for f, spec in FAMILIES.items() for m in spec[3]])
def test_spec_for_every_leaf_matches_jax(trees, family, mode):
    jrules, trules = (FAMILIES[family][4](mode), FAMILIES[family][5](mode))
    for path, ndim in trees[family][0]:
        want, got = jrules.spec_for(path, ndim), trules.spec_for(path, ndim)
        assert isinstance(got, P)
        assert _same_spec(got, want), (path, got, want)


@pytest.mark.parametrize("mode", ["ddp", "fsdp", "tp", "fsdp_tp"])
def test_sharding_config_matches_jax(trees, mode):
    jcfg, tcfg = jsh.ShardingConfig(mode=mode), tsh.ShardingConfig(mode=mode)
    assert _same_spec(tcfg.batch_spec(), jcfg.batch_spec())
    jrules, trules = jcfg.rules(), tcfg.rules()
    for family in ("llama", "vit", "clip"):
        for path, ndim in trees[family][0]:
            assert _same_spec(trules.spec_for(path, ndim),
                              jrules.spec_for(path, ndim)), (family, path)


@pytest.mark.parametrize("rules", [
    lambda m: m.ShardingConfig(mode="bogus").rules(),
    lambda m: m.llama_sharding_rules("bogus"),
    lambda m: m.vit_sharding_rules("bogus"),
    lambda m: m.dit_sharding_rules("bogus")])
def test_unknown_modes_raise_as_in_jax(rules):
    port = types.SimpleNamespace(
        ShardingConfig=tsh.ShardingConfig,
        llama_sharding_rules=tl.llama_sharding_rules,
        vit_sharding_rules=tv.vit_sharding_rules,
        dit_sharding_rules=td.dit_sharding_rules)
    ref = types.SimpleNamespace(
        ShardingConfig=jsh.ShardingConfig,
        llama_sharding_rules=jl.llama_sharding_rules,
        vit_sharding_rules=jv.vit_sharding_rules,
        dit_sharding_rules=jd.dit_sharding_rules)
    assert _error(lambda: rules(port)) == _error(lambda: rules(ref))


def test_infer_sharding_gives_a_tree_of_specs(trees):
    mesh = types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_ORDER,
                                 shape=(1, 2, 2, 1, 1, 2))
    port_tree = trees["llama"][1]
    specs = tsh.infer_sharding(port_tree, mesh,
                               tl.llama_sharding_rules("fsdp_tp"))
    assert specs["layers"]["wq"] == P(None, "fsdp", "model")
    assert specs["lm_head"] == P(None, ("fsdp", "model"))
    assert specs["final_norm"] == P()
    with pytest.raises(ValueError, match="no mesh axis"):
        tsh.infer_sharding(port_tree, mesh, tsh.ShardingRules(
            rules=[(r".*", P("nope"))]))


# --- every device's shard ----------------------------------------------------

def _device_coords(mesh):
    """device id -> {axis: coordinate} on a jax Mesh."""
    out = {}
    for index in np.ndindex(mesh.devices.shape):
        out[mesh.devices[index].id] = dict(zip(mesh.axis_names, index))
    return out


@pytest.mark.parametrize("cfg, spec, mode", [
    (jl.LlamaConfig.tiny(), dict(data=2, fsdp=2, model=2), "fsdp_tp"),
    (jl.LlamaConfig.tiny_moe(), dict(data=2, expert=4), "ep"),
    (jl.LlamaConfig.tiny_moe(), dict(fsdp=2, model=4), "fsdp_tp")],
    ids=["dense-fsdp_tp", "moe-ep", "moe-fsdp_tp"])
def test_every_device_shard_matches_jax(cpu_mesh8, cfg, spec, mode):
    mesh = jmesh.make_mesh(jmesh.MeshSpec(**spec), cpu_mesh8)
    params = jl.llama_init(jax.random.PRNGKey(0), cfg)
    placed = jsh.shard_pytree(params, mesh, jl.llama_sharding_rules(mode))
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    coords = _device_coords(mesh)
    whole = jax.tree_util.tree_map(np.asarray, params)
    rules = tl.llama_sharding_rules(mode)
    by_device = {d: dict(tsh._tree_paths(tsh.local_shards(
        whole, rules, sizes, at))) for d, at in coords.items()}
    split = 0
    for path, leaf in jsh._tree_paths(placed):
        for shard in leaf.addressable_shards:
            got = by_device[shard.device.id][path]
            want = np.asarray(shard.data)
            assert got.shape == want.shape, (path, shard.device)
            np.testing.assert_array_equal(got, want, err_msg=path)
            split += got.shape != leaf.shape
    assert split > 0


def test_a_dimension_its_axes_do_not_divide_raises_as_in_jax(cpu_mesh8):
    mesh = jmesh.make_mesh(jmesh.MeshSpec(data=2, model=4), cpu_mesh8)
    x = np.ones((6, 8), np.float32)
    with pytest.raises(ValueError):
        jax.device_put(x, jax.sharding.NamedSharding(mesh, JP("model")))
    with pytest.raises(ValueError, match="does not divide 6"):
        tsh.shard_slices(x.shape, P("model"), dict(data=2, model=4),
                         dict(data=0, model=1))
    # a tuple entry splits over the product, the first axis major
    assert tsh.shard_slices((8, 16), P(None, ("data", "model")),
                            dict(data=2, model=4), dict(data=1, model=2)) \
        == (slice(0, 8), slice(12, 14))
