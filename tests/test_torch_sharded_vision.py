"""The port's ViT, CLIP and DiT on sharded parameters against the JAX
package's unsharded models: tiny f32 configs under fsdp_tp (fsdp 2,
model 2) and fsdp (data 2, fsdp 2), in one gloo spawn at world 4.

Both sides start from the JAX package's tiny weights (PRNGKey(0),
carried over by ``params_from_jax``; DiT's adaLN-Zero leaves replaced by
the same seeded noise, where a zero init proves nothing) and score the
same global batch (B 8, numpy seed; DiT's draws replay ``jax.random``'s
for its key). Each rank holds its local shards (``shard_pytree``) and
its rows of the batch (over data x fsdp); its loss must equal JAX's
unsharded loss, and each of its grads the same slice of JAX's unsharded
grads (cut by ``local_shards``). One AdamW step of ``make_step`` on the
fsdp_tp shards must give the slices of ``optax.adamw``'s step.
Tolerances: loss 1e-5 relative, grads 1e-4 relative L2 a leaf (the
reference's bars, tests/test_vision.py:81, :162 and
tests/test_diffusion.py:105, tightened as test_torch_sharded_llama.py
tightens Llama's), parameters 3e-5 (a tenth of the learning rate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tpu.models import dit as jd
from ray_tpu.models import vit as jv
from ray_tpu_torch.parallel.sharding import _tree_paths, local_shards
from test_torch_seq_parallel_card import GroupRun
from test_torch_sharded_vision_card import RULES, vision_worker

LOSS_RTOL, GRAD_RTOL, PARAM_TOL = 1e-5, 1e-4, 3e-5
B, LABEL_DROP = 8, 0.5
MODES = {"fsdp_tp": dict(fsdp=2, model=2), "fsdp": dict(data=2, fsdp=2)}
CASES = [(model, mode) for model in ("vit", "clip", "dit") for mode in MODES]
ADALN = ("final_mod_w", "final_mod_b", "final_w", "layers/mod_w",
         "layers/mod_b")


def _jax_models():
    """(JAX config, numpy weights) of each tiny model."""
    key = jax.random.PRNGKey(0)
    vcfg = jv.ViTConfig.tiny(n_classes=10, pool="cls")
    ccfg = jv.CLIPConfig.tiny()
    dcfg = jd.DiTConfig.tiny(n_classes=10)
    trees = {"vit": jv.vit_init(key, vcfg), "clip": jv.clip_init(key, ccfg),
             "dit": jd.dit_init(key, dcfg)}
    trees = jax.tree_util.tree_map(np.asarray, trees)
    rng = np.random.default_rng(1)
    dit = dict(trees["dit"], layers=dict(trees["dit"]["layers"]))
    for path in ADALN:
        node = dit["layers"] if path.startswith("layers/") else dit
        name = path.split("/")[-1]
        node[name] = (rng.standard_normal(node[name].shape) * 0.1).astype(
            np.float32)
    trees["dit"] = dit
    return {"vit": vcfg, "clip": ccfg, "dit": dcfg}, trees


def _dit_draws(key, shape):
    """``dit_loss``'s draws for ``key`` (ray_tpu/models/dit.py:243-251)."""
    k_t, k_eps, k_drop = jax.random.split(key, 3)
    b = shape[0]
    return {"t": np.asarray(jax.random.uniform(
                k_t, (b,), minval=1e-4, maxval=1.0 - 1e-4)),
            "eps": np.asarray(jax.random.normal(k_eps, shape, jnp.float32)),
            "drop": np.asarray(jax.random.uniform(k_drop, (b,)))}


@pytest.fixture(scope="module")
def inputs():
    cfgs, trees = _jax_models()
    rng = np.random.default_rng(0)
    v, t, d = cfgs["vit"], cfgs["clip"].text, cfgs["dit"]

    def images(size, ch=3):
        return rng.standard_normal((B, size, size, ch)).astype(np.float32)

    dshape = (B, d.input_size, d.input_size, d.channels)
    batches = {
        "vit": {"images": images(v.image_size),
                "labels": rng.integers(0, 10, B).astype(np.int64)},
        "clip": {"images": images(cfgs["clip"].vision.image_size),
                 "tokens": rng.integers(0, t.vocab_size, (B, 8)).astype(
                     np.int64)},
        "dit": {"x0": rng.standard_normal(dshape).astype(np.float32),
                "labels": rng.integers(0, 10, B).astype(np.int64),
                "noise": _dit_draws(jax.random.PRNGKey(7), dshape)},
    }
    return cfgs, trees, batches


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """The port's gloo run at world 4, started before the JAX side."""
    _cfgs, trees, batches = inputs
    run = GroupRun(vision_worker, 4, dict(
        params=trees, batches=batches,
        cases=[(model, mode, MODES[mode]) for model, mode in CASES],
        steps=[(model, "fsdp_tp", MODES["fsdp_tp"])
               for model in ("vit", "clip", "dit")]),
        tmp_path_factory.mktemp("sharded_vision"))
    yield run
    run.close()


def _jax_loss(model, cfgs, batches):
    b = batches[model]
    if model == "vit":
        return lambda p: jv.vit_loss(p, b["images"],
                                     b["labels"].astype(np.int32),
                                     cfgs["vit"])
    if model == "clip":
        return lambda p: jv.clip_loss(p, b["images"],
                                      b["tokens"].astype(np.int32),
                                      cfgs["clip"])
    return lambda p: jd.dit_loss(p, jax.random.PRNGKey(7), b["x0"],
                                 cfgs["dit"], b["labels"].astype(np.int32),
                                 LABEL_DROP)


@pytest.fixture(scope="module")
def jax_side(inputs):
    """Per model: JAX's unsharded (loss, grads), and the parameters after
    one optax.adamw step from them (numpy)."""
    cfgs, trees, batches = inputs
    out = {}
    for model in ("vit", "clip", "dit"):
        jp = jax.tree_util.tree_map(jnp.asarray, trees[model])
        loss, grads = jax.jit(jax.value_and_grad(
            _jax_loss(model, cfgs, batches)))(jp)
        opt = optax.adamw(3e-4, weight_decay=0.01)
        updates, _ = opt.update(grads, opt.init(jp), jp)
        stepped = optax.apply_updates(jp, updates)
        out[model] = (float(loss),
                      *jax.tree_util.tree_map(np.asarray, (grads, stepped)))
    return out


@pytest.fixture(scope="module")
def results(port, jax_side):
    return port.join()


def _by_path(tree):
    return dict(_tree_paths(tree))


def test_dit_draws_drop_some_labels(inputs):
    drop = inputs[2]["dit"]["noise"]["drop"] < LABEL_DROP
    assert drop.any() and not drop.all()


@pytest.mark.parametrize("model,mode", CASES)
def test_loss_matches_jax_unsharded_on_every_rank(results, jax_side, model,
                                                  mode):
    i = CASES.index((model, mode))
    for r in results:
        np.testing.assert_allclose(r["cases"][i][0], jax_side[model][0],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("model,mode", CASES)
def test_local_grads_are_slices_of_jax_unsharded_grads(results, jax_side,
                                                       model, mode):
    i = CASES.index((model, mode))
    rules = RULES[model](mode)
    for rank, r in enumerate(results):
        _loss, grads, sizes, coords = r["cases"][i]
        want = _by_path(local_shards(jax_side[model][1], rules, sizes,
                                     coords))
        got = _by_path(grads)
        assert got.keys() == want.keys()
        for path, w in want.items():
            assert got[path].shape == w.shape, (rank, path)
            rel = np.linalg.norm(got[path] - w) / max(np.linalg.norm(w),
                                                      1e-30)
            assert rel <= GRAD_RTOL, (model, mode, rank, path, rel)


def test_shards_split_what_the_mode_says(results):
    """fsdp_tp at fsdp 2 x model 2: ViT's wq [L, D/2, D/2] and w2
    [L, H/2, D/2]; CLIP's text embedding [V/2, D/2]; DiT's mod_w
    [L, D/2, 3D]."""
    cases = results[0]["cases"]
    vit = _by_path(cases[CASES.index(("vit", "fsdp_tp"))][1])
    assert vit["layers/wq"].shape == (2, 16, 16)
    assert vit["layers/w2"].shape == (2, 32, 16)
    clip = _by_path(cases[CASES.index(("clip", "fsdp_tp"))][1])
    assert clip["text/embedding"].shape == (64, 16)
    dit = _by_path(cases[CASES.index(("dit", "fsdp_tp"))][1])
    assert dit["layers/mod_w"].shape == (2, 16, 96)


@pytest.mark.parametrize("model", ["vit", "clip", "dit"])
def test_one_sharded_training_step_matches_optax(results, jax_side, model):
    rules = RULES[model]("fsdp_tp")
    i = CASES.index((model, "fsdp_tp"))
    for rank, r in enumerate(results):
        loss, stepped = r["steps"][["vit", "clip", "dit"].index(model)]
        np.testing.assert_allclose(loss, jax_side[model][0], rtol=LOSS_RTOL)
        _loss, _grads, sizes, coords = r["cases"][i]
        want = _by_path(local_shards(jax_side[model][2], rules, sizes,
                                     coords))
        got = _by_path(stepped)
        assert got.keys() == want.keys()
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, atol=PARAM_TOL, rtol=0,
                                       err_msg=f"rank {rank} {path}")


def test_model_axis_must_divide_the_heads(results):
    for r in results:
        assert "must divide n_heads (2)" in r["bad_heads"]
