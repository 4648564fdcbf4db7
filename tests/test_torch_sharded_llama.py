"""The port's Llama on sharded parameters against the JAX package's
unsharded Llama: tiny dense Llama under ddp (data 4), fsdp (fsdp 4), tp
(data 2, model 2) and fsdp_tp (fsdp 2, model 2), in one gloo spawn at
world 4.

Both sides start from ``LlamaConfig.tiny()``'s JAX weights (PRNGKey(0),
carried over by ``params_from_jax``) and score the same tokens (B4 S32,
numpy seed). Each rank holds its local shards
(``shard_pytree(params, mesh, llama_sharding_rules(mode))``) and its
shard of the batch (rows over data x fsdp); its loss must equal JAX's
unsharded loss, and each of its grads the same slice of JAX's unsharded
grads (cut by ``local_shards``, which test_torch_sharding_rules.py holds
against JAX's own placement). One AdamW step of ``make_train_step`` on
the fsdp_tp shards must give the slices of ``optax.adamw``'s step.
Tolerances: loss 1e-5 relative, grads 1e-4 relative L2 a leaf,
parameters 3e-5 (a tenth of the learning rate; see
test_torch_llama_seq_parallel.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel.sharding import _tree_paths, local_shards
from test_torch_seq_parallel_card import GroupRun
from test_torch_sharded_card import sharded_worker

LOSS_RTOL, GRAD_RTOL, PARAM_TOL = 1e-5, 1e-4, 3e-5
B, S = 4, 32
CASES = {
    "ddp": ("ddp", dict(data=4), {}),
    "fsdp": ("fsdp", dict(fsdp=4), {}),
    "tp": ("tp", dict(data=2, model=2), {}),
    "fsdp_tp": ("fsdp_tp", dict(fsdp=2, model=2), {}),
    # chunked CE and remat change no value: JAX's dense loss is the target
    "fsdp_tp-chunked-remat": ("fsdp_tp", dict(fsdp=2, model=2),
                              dict(ce_chunk_tokens=24, remat=True)),
}


@pytest.fixture(scope="module")
def weights():
    jp = jl.llama_init(jax.random.PRNGKey(0), jl.LlamaConfig.tiny())
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    tgts = rng.integers(0, 256, (B, S)).astype(np.int32)
    return jax.tree_util.tree_map(np.asarray, jp), toks, tgts


@pytest.fixture(scope="module")
def port(weights, tmp_path_factory):
    """The port's gloo run at world 4, started before the JAX side."""
    params, toks, tgts = weights
    run = GroupRun(sharded_worker, 4, dict(
        params={"dense": params}, tokens=toks, targets=tgts,
        cases=[("dense", mode, axes, kw) for mode, axes, kw
               in CASES.values()],
        step=("dense", "fsdp_tp", dict(fsdp=2, model=2), {})),
        tmp_path_factory.mktemp("sharded"))
    yield run
    run.close()


@pytest.fixture(scope="module")
def jax_side(weights):
    """JAX's unsharded (loss, grads), and the parameters after one
    optax.adamw step from them (numpy)."""
    params, toks, tgts = weights
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    cfg = jl.LlamaConfig.tiny()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jl.llama_loss(p, jnp.asarray(toks), jnp.asarray(tgts),
                                cfg)))(jp)
    opt = optax.adamw(3e-4, weight_decay=0.01)
    updates, _ = opt.update(grads, opt.init(jp), jp)
    stepped = optax.apply_updates(jp, updates)
    as_np = jax.tree_util.tree_map(np.asarray, (grads, stepped))
    return float(loss), *as_np


@pytest.fixture(scope="module")
def results(port, jax_side):
    return port.join()


def _by_path(tree):
    return dict(_tree_paths(tree))


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_jax_unsharded_on_every_rank(results, jax_side, name):
    i = list(CASES).index(name)
    for r in results:
        np.testing.assert_allclose(r["cases"][i][0], jax_side[0],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_local_grads_are_slices_of_jax_unsharded_grads(results, jax_side,
                                                       name):
    i = list(CASES).index(name)
    rules = tl.llama_sharding_rules(CASES[name][0])
    for rank, r in enumerate(results):
        _loss, grads, sizes, coords = r["cases"][i]
        want = _by_path(local_shards(jax_side[1], rules, sizes, coords))
        got = _by_path(grads)
        assert got.keys() == want.keys()
        for path, w in want.items():
            assert got[path].shape == w.shape, (rank, path)
            rel = np.linalg.norm(got[path] - w) / np.linalg.norm(w)
            assert rel <= GRAD_RTOL, (name, rank, path, rel)


def test_shards_split_what_the_mode_says(results):
    """fsdp_tp's shards at fsdp 2 x model 2: wq [L, D/2, H*hd/2], lm_head
    [D, V/4]; ddp's are whole."""
    cfg = tl.LlamaConfig.tiny()
    hd = cfg.head_dim
    fsdp_tp = _by_path(results[0]["cases"][list(CASES).index("fsdp_tp")][1])
    assert fsdp_tp["layers/wq"].shape == (2, cfg.dim // 2,
                                          cfg.n_heads * hd // 2)
    assert fsdp_tp["lm_head"].shape == (cfg.dim, cfg.vocab_size // 4)
    ddp = _by_path(results[0]["cases"][0][1])
    assert ddp["layers/wq"].shape == (2, cfg.dim, cfg.n_heads * hd)


def test_one_sharded_training_step_matches_optax(results, jax_side):
    rules = tl.llama_sharding_rules("fsdp_tp")
    for rank, r in enumerate(results):
        np.testing.assert_allclose(r["step_loss"], jax_side[0],
                                   rtol=LOSS_RTOL)
        _loss, _grads, sizes, coords = r["cases"][list(CASES).index(
            "fsdp_tp")]
        want = _by_path(local_shards(jax_side[2], rules, sizes, coords))
        got = _by_path(r["stepped"])
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, atol=PARAM_TOL, rtol=0,
                                       err_msg=f"rank {rank} {path}")
