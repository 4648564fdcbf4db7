"""The port's MoE Llama with expert parallelism and under sequence
parallelism against the JAX package's unsharded MoE Llama: tiny_moe
under ep (data 2, expert 2) at capacity factors 0.5 and 2.0, and under
ring and Ulysses attention at seq 4 (through a mesh, and through a
sequence group without one) at 0.5, in one gloo spawn at world 4.

The reference routes the global token set: the capacity comes from the
global T and the slots fill in global token order. At capacity factor
0.5 the unsharded dispatch drops tokens (E x C slots for k x T choices),
so a routing local to each shard would give another loss; these cases
hold the port's global routing (parallel/moe.py) to the reference's.
Weights: ``LlamaConfig.tiny_moe()``'s JAX weights (PRNGKey(0)); tokens
B4 S32 from a numpy seed. Tolerances: loss 1e-5 relative, grads 1e-4
relative L2 a leaf, each rank's grads against the same slice of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import llama as jl
from ray_tpu.parallel import moe as jmoe
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel.moe import moe_capacity
from ray_tpu_torch.parallel.sharding import _tree_paths, local_shards
from test_torch_seq_parallel_card import GroupRun
from test_torch_sharded_card import sharded_worker

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
B, S, EXPERTS, TOP_K = 4, 32, 4, 2
# name: (sharding mode, or None for a sequence group without a mesh;
# mesh axes; tiny_moe keywords); the JAX target is the unsharded loss at
# the case's capacity factor
CASES = {
    "ep-cf0.5": ("ep", dict(data=2, expert=2),
                 dict(moe_capacity_factor=0.5)),
    "ep-cf2.0": ("ep", dict(data=2, expert=2),
                 dict(moe_capacity_factor=2.0)),
    "ring-cf0.5": ("ddp", dict(seq=4), dict(moe_capacity_factor=0.5,
                                            attention="ring")),
    "ulysses-cf0.5": ("ddp", dict(seq=4), dict(moe_capacity_factor=0.5,
                                               attention="ulysses")),
    "ring-group-cf0.5": (None, dict(seq=4), dict(moe_capacity_factor=0.5,
                                                 attention="ring")),
    "ep-ring-cf0.5": ("ep", dict(seq=2, expert=2),
                      dict(moe_capacity_factor=0.5, attention="ring")),
}


def _moe_config(kw):
    return dict(moe_experts=EXPERTS, moe_top_k=TOP_K, **kw)


@pytest.fixture(scope="module")
def weights():
    jp = jl.llama_init(jax.random.PRNGKey(0), jl.LlamaConfig.tiny_moe())
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    tgts = rng.integers(0, 256, (B, S)).astype(np.int32)
    return jax.tree_util.tree_map(np.asarray, jp), toks, tgts


@pytest.fixture(scope="module")
def port(weights, tmp_path_factory):
    """The port's gloo run at world 4, started before the JAX side."""
    params, toks, tgts = weights
    run = GroupRun(sharded_worker, 4, dict(
        params={"moe": params}, tokens=toks, targets=tgts,
        cases=[("moe", mode, axes, _moe_config(kw))
               for mode, axes, kw in CASES.values()]),
        tmp_path_factory.mktemp("expert"))
    yield run
    run.close()


@pytest.fixture(scope="module")
def jax_side(weights):
    """JAX's unsharded (loss, grads) at each capacity factor; and the
    slots the unsharded dispatch keeps of the first layer's routing at
    0.5."""
    params, toks, tgts = weights
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = {}
    for cf in (0.5, 2.0):
        cfg = jl.LlamaConfig.tiny_moe(moe_capacity_factor=cf)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, c=cfg: jl.llama_loss(p, jnp.asarray(toks),
                                           jnp.asarray(tgts), c)))(jp)
        want[cf] = (float(loss), jax.tree_util.tree_map(np.asarray, grads))
    x = jp["embedding"][jnp.asarray(toks)].reshape(B * S, -1)
    gates, idx, _aux = jmoe.top_k_gating(x, jp["layers"]["router"][0], TOP_K)
    capacity = moe_capacity(B * S, EXPERTS, TOP_K, 0.5)
    dispatch, _ = jmoe.moe_dispatch(gates, idx, EXPERTS, capacity)
    return want, int(np.asarray(dispatch).sum())


@pytest.fixture(scope="module")
def results(port, jax_side):
    return port.join()


def test_capacity_half_drops_tokens_in_the_unsharded_dispatch(port,
                                                              jax_side):
    # k x T choices for E x C slots: at least half of them are dropped
    capacity = moe_capacity(B * S, EXPERTS, TOP_K, 0.5)
    assert EXPERTS * capacity < TOP_K * B * S
    assert jax_side[1] < TOP_K * B * S  # kept < chosen


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_jax_unsharded_on_every_rank(results, jax_side, name):
    i = list(CASES).index(name)
    want = jax_side[0][CASES[name][2]["moe_capacity_factor"]][0]
    for r in results:
        np.testing.assert_allclose(r["cases"][i][0], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_local_grads_are_slices_of_jax_unsharded_grads(results, jax_side,
                                                       name):
    i = list(CASES).index(name)
    mode, _axes, kw = CASES[name]
    rules = tl.llama_sharding_rules(mode or "ddp")
    grads = jax_side[0][kw["moe_capacity_factor"]][1]
    for rank, r in enumerate(results):
        _loss, got, sizes, coords = r["cases"][i]
        want = dict(_tree_paths(local_shards(grads, rules, sizes, coords)))
        got = dict(_tree_paths(got))
        assert got.keys() == want.keys()
        for path, w in want.items():
            assert got[path].shape == w.shape, (rank, path)
            rel = np.linalg.norm(got[path] - w) / np.linalg.norm(w)
            assert rel <= GRAD_RTOL, (name, rank, path, rel)


def test_expert_stacks_are_split_on_the_expert_axis(results):
    """Under ep at expert 2 each rank holds 2 of the 4 experts."""
    cfg = tl.LlamaConfig.tiny_moe()
    got = dict(_tree_paths(results[0]["cases"][0][1]))
    assert got["layers/w1"].shape == (cfg.n_layers, EXPERTS // 2, cfg.dim,
                                      cfg.hidden_dim)
    assert got["layers/router"].shape == (cfg.n_layers, cfg.dim, EXPERTS)
