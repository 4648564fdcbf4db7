"""The port's Llama with ring and Ulysses attention (sequence sharded
over a gloo group) against the JAX package's on the 8-device CPU mesh
(seq 4, data 2).

Both sides start from ``LlamaConfig.tiny()``'s JAX weights (PRNGKey(0),
carried over by ``params_from_jax``) and score the same tokens (B2 S64,
numpy seed). The JAX side is ``jax.value_and_grad(llama_loss)`` with the
mesh; the port runs at world 2 and 4 in spawned processes
(``GroupRun``), each rank on its contiguous shard of tokens and
targets, its grads summed over the group (``all_reduce_grads``), and
one AdamW step of ``make_train_step`` against ``optax.adamw``.
Tolerances: loss 1e-5, grads rtol 1e-4 / atol 1e-5 (f32), parameters
after the step 3e-5, a tenth of the learning rate: AdamW's first update
is lr * g / (|g| + 1e-8), so a grad of order 1e-8 turns its last-bit
difference into a visible share of lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import MeshSpec, make_mesh
from ray_tpu_torch.models import llama as tl
from test_torch_seq_parallel_card import GroupRun, llama_worker

LOSS_TOL, GRAD_RTOL, GRAD_ATOL, PARAM_TOL = 1e-5, 1e-4, 1e-5, 3e-5
B, S = 2, 64
# name: (the port's LlamaConfig.tiny keywords, the JAX attention it is
# held to; chunked CE and remat change no value, so JAX's dense ring
# loss is the target)
CASES = {
    "ring": (dict(attention="ring"), "ring"),
    "ulysses": (dict(attention="ulysses"), "ulysses"),
    "ring-chunked-remat": (dict(attention="ring", ce_chunk_tokens=24,
                                remat=True), "ring"),
}
STEP = dict(attention="ring")


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _at(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.fixture(scope="module")
def weights():
    """JAX's tiny weights (numpy), tokens and targets."""
    jp = jl.llama_init(jax.random.PRNGKey(0), jl.LlamaConfig.tiny())
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    tgts = rng.integers(0, 256, (B, S)).astype(np.int32)
    return jax.tree_util.tree_map(np.asarray, jp), toks, tgts


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """The port's gloo runs at world 2 and 4, started at once, before the
    JAX side is computed."""
    params, toks, tgts = weights
    started = {world: GroupRun(llama_worker, world, dict(
        params=params, tokens=toks, targets=tgts,
        cases=[kw for kw, _ in CASES.values()], step=STEP),
        tmp_path_factory.mktemp(f"llama{world}")) for world in (2, 4)}
    yield started
    for run in started.values():
        run.close()


@pytest.fixture(scope="module")
def jax_side(weights):
    """JAX's (loss, grads) with ring and with Ulysses attention on the
    mesh, and the parameters after one optax.adamw step from the ring
    grads."""
    params, toks, tgts = weights
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    mesh = make_mesh(MeshSpec(seq=4, data=2))
    want = {}
    for attention in ("ring", "ulysses"):
        cfg = jl.LlamaConfig.tiny(attention=attention)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, c=cfg: jl.llama_loss(p, jnp.asarray(toks),
                                           jnp.asarray(tgts), c, mesh)))(jp)
        want[attention] = (float(loss), grads)
    opt = optax.adamw(3e-4, weight_decay=0.01)
    updates, _ = opt.update(want["ring"][1], opt.init(jp), jp)
    return want, optax.apply_updates(jp, updates)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def port(request, runs, jax_side):
    return request.param, runs[request.param].join()


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_jax_on_every_rank(port, jax_side, name):
    _world, results = port
    i = list(CASES).index(name)
    want = jax_side[0][CASES[name][1]][0]
    for r in results:
        np.testing.assert_allclose(r["cases"][i][0], want, atol=LOSS_TOL,
                                   rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_summed_grads_match_jax(port, jax_side, name):
    _world, results = port
    i = list(CASES).index(name)
    for path, want in _leaves(jax_side[0][CASES[name][1]][1]):
        for r in results:  # the sum is the same on every rank
            np.testing.assert_allclose(
                _at(r["cases"][i][1], path), np.asarray(want),
                rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=str(path))


def test_one_training_step_matches_optax(port, jax_side):
    _world, results = port
    want_loss = jax_side[0]["ring"][0]
    for r in results:
        np.testing.assert_allclose(r["step_loss"], want_loss, atol=LOSS_TOL,
                                   rtol=0)
        for path, want in _leaves(jax_side[1]):
            np.testing.assert_allclose(_at(r["stepped"], path),
                                       np.asarray(want), atol=PARAM_TOL,
                                       rtol=0, err_msg=str(path))


def test_single_device_attention_takes_no_group():
    cfg = tl.LlamaConfig.tiny()
    params = tl.llama_init(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="takes no group"):
        tl.llama_forward(params, torch.zeros((1, 8), dtype=torch.long), cfg,
                         group=object())
