"""The port's MLP, ViT and CLIP (ray_tpu_torch.models) against the JAX
package's.

Both sides run the JAX package's weights, carried over by
``params_from_jax``, on inputs from a numpy seed, in f32 on the CPU:
forwards and losses agree within 1e-5 relative, grads within 1e-4
relative L2. The port also runs ``attention="flash"``, which on a CPU
tensor is its plain version (and under autograd the plain K2/K3); one
case runs the JAX side's Pallas kernel in interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models import mlp as jmlp
from ray_tpu.models import vit as jv
from ray_tpu.ops import attention as jatt
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.models import vit as tv
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.llama import unstack_layers
from ray_tpu_torch.scripts.bench_train import parameters


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """``jax.jit`` of a JAX function with its config arguments static
    (eager JAX dispatches op by op, which is most of a test's time)."""
    return jax.jit(fn, static_argnums=static)


_vit_value_and_grad = _jit(jax.value_and_grad(jv.vit_loss), 3)
_clip_value_and_grad = _jit(jax.value_and_grad(jv.clip_loss), 3)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _flat(tree, prefix=""):
    """path -> leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _to_port(jp):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")


def _grads_of(tp):
    for leaf in parameters(tp):
        leaf.requires_grad_(True)
    return tp


def _check_grads(tp, jgrads, skip=()):
    got = _flat(tp)
    want = _flat(jgrads)
    assert set(got) == set(want)
    for path, leaf in got.items():
        if path in skip:
            continue
        assert leaf.grad is not None, path
        assert _rel_l2(leaf.grad.numpy(), want[path]) <= 1e-4, path


def _images(b, size, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


# --- MLP -------------------------------------------------------------------

MLP = jmlp.MLPConfig(in_dim=20, hidden=(16, 8), out_dim=5)


def test_mlp_loss_and_grads_match_jax():
    jcfg = MLP
    jp = _jit(jmlp.mlp_init, 1)(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 20)).astype(np.float32)
    y = rng.integers(0, 5, 6).astype(np.int32)
    jloss, jgrads = _jit(jax.value_and_grad(jmlp.mlp_loss))(
        jp, jnp.asarray(x), jnp.asarray(y))
    tp = _grads_of(_to_port(jp))
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == 3
    logits = tmlp.mlp_forward(tp, torch.from_numpy(x))
    assert _rel_l2(logits.detach().numpy(),
                   _jit(jmlp.mlp_forward)(jp, jnp.asarray(x))) <= 1e-5
    tloss = tmlp.mlp_loss(tp, torch.from_numpy(x), torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _check_grads(tp, jgrads)
    own = tmlp.mlp_init(0, tmlp.MLPConfig(in_dim=20, hidden=(16, 8),
                                          out_dim=5), device="cpu")
    assert ([tuple(lp["w"].shape) for lp in own["layers"]]
            == [lp["w"].shape for lp in jp["layers"]])


# --- the trees carried over ----------------------------------------------

@pytest.mark.parametrize("family", ["mlp", "vit", "clip"])
def test_params_from_jax_carries_every_leaf(family):
    key = jax.random.PRNGKey(1)
    # the configs of the tests below, whose compiled inits are cached
    init, cfg = {"mlp": (jmlp.mlp_init, MLP),
                 "vit": (jv.vit_init, jv.ViTConfig.tiny(n_classes=5,
                                                        pool="cls")),
                 "clip": (jv.clip_init, jv.CLIPConfig.tiny())}[family]
    jp = _jit(init, 1)(key, cfg)
    got, want = _flat(_to_port(jp)), _flat(jp)
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(leaf))
    if family == "clip":
        assert got["/logit_scale"].dim() == 0


@pytest.mark.parametrize("kw", [dict(n_classes=5, pool="cls"), dict(),
                                dict(image_size=8, patch_size=2, n_heads=2)],
                         ids=["cls_head", "mean", "narrow"])
def test_vit_init_tree_and_count_match_jax(kw):
    jcfg, tcfg = jv.ViTConfig.tiny(**kw), tv.ViTConfig.tiny(**kw)
    jp = jax.eval_shape(lambda key: jv.vit_init(key, jcfg),
                        jax.random.PRNGKey(0))
    tp = tv.vit_init(0, tcfg, device="cpu")
    got, want = _flat(tp), _flat(jp)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert tcfg.num_params() == jcfg.num_params() == sum(
        v.numel() for v in got.values())
    assert tp["layers"]["wq"].dtype == torch.float32


# --- ViT ---------------------------------------------------------------------

VIT_CASES = {
    "cls_head_ref": (dict(n_classes=5, pool="cls"), "reference", False),
    "cls_head_flash_remat": (dict(n_classes=5, pool="cls"), "flash", True),
    "mean_flash": (dict(), "flash", False),
}


@pytest.mark.parametrize("name", sorted(VIT_CASES))
def test_vit_forward_loss_and_grads_match_jax(name):
    kw, attention, remat = VIT_CASES[name]
    jcfg = jv.ViTConfig.tiny(**kw)
    tcfg = tv.ViTConfig.tiny(attention=attention, remat=remat, **kw)
    jp = _jit(jv.vit_init, 1)(jax.random.PRNGKey(0), jcfg)
    images = _images(3, 16)
    jout = _jit(jv.vit_forward, 2, 3)(jp, jnp.asarray(images), jcfg)
    tp = _to_port(jp)
    with torch.no_grad():
        tout = tv.vit_forward(tp, torch.from_numpy(images), tcfg)
    assert tout.shape == jout.shape
    assert _rel_l2(tout.numpy(), jout) <= 1e-5
    if not jcfg.n_classes:
        return
    assert tout.dtype == torch.float32
    pooled = tv.vit_forward(tp, torch.from_numpy(images), tcfg,
                            return_pooled=True)
    assert _rel_l2(pooled.detach().numpy(), _jit(jv.vit_forward, 2, 3)(
        jp, jnp.asarray(images), jcfg, True)) <= 1e-5
    labels = np.array([0, 4, 2], np.int32)
    jloss, jgrads = _vit_value_and_grad(
        jp, jnp.asarray(images), jnp.asarray(labels), jcfg)
    tp = _grads_of(tp)
    tloss = tv.vit_loss(tp, torch.from_numpy(images),
                        torch.from_numpy(labels), tcfg)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _check_grads(tp, jgrads)


def test_vit_unstacked_layers_give_the_same_grads():
    """Training keeps one leaf per layer (``unstack_layers``); the loss
    and the layers' grads are those of the stacked tree."""
    tcfg = tv.ViTConfig.tiny(n_classes=5, pool="cls", remat=True)
    images = torch.from_numpy(_images(2, 16, seed=3))
    labels = torch.tensor([1, 3])
    stacked = _grads_of(tv.vit_init(0, tcfg, device="cpu"))
    per_layer = _grads_of(unstack_layers(
        {k: (v.detach().clone() if isinstance(v, torch.Tensor) else
             {n: s.detach().clone() for n, s in v.items()})
         for k, v in stacked.items()}))
    loss_s = tv.vit_loss(stacked, images, labels, tcfg)
    loss_s.backward()
    loss_u = tv.vit_loss(per_layer, images, labels, tcfg)
    loss_u.backward()
    assert loss_s.item() == pytest.approx(loss_u.item(), rel=1e-6)
    for name, stack in stacked["layers"].items():
        got = torch.stack([lp[name].grad for lp in per_layer["layers"]])
        torch.testing.assert_close(got, stack.grad, rtol=1e-5, atol=1e-7)


def test_vit_flash_at_kernel_shape_matches_jax_pallas_interpret():
    """head_dim 128 and seq 256: the JAX side takes its Pallas kernel (in
    interpret mode), the port its flash path (plain on the CPU)."""
    kw = dict(image_size=64, patch_size=4, dim=256, n_heads=2,
              hidden_dim=64, n_layers=1)
    jcfg = jv.ViTConfig.tiny(attention="flash", **kw)
    tcfg = tv.ViTConfig.tiny(attention="flash", **kw)
    assert jcfg.head_dim == 128 and jcfg.seq_len == 256
    jp = jv.vit_init(jax.random.PRNGKey(0), jcfg)
    images = _images(1, 64, seed=1)
    prev = jatt._INTERPRET
    jatt._INTERPRET = True
    try:
        q = jnp.zeros((1, 256, 2, 128))
        assert jatt._kernel_plan(q, q) is not None  # the Pallas kernel
        jout = jv.vit_forward(jp, jnp.asarray(images), jcfg)
    finally:
        jatt._INTERPRET = prev
    with torch.no_grad():
        tout = tv.vit_forward(_to_port(jp), torch.from_numpy(images), tcfg)
    assert _rel_l2(tout.numpy(), jout) <= 1e-5


# --- the numerics the port must keep ----------------------------------------

def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation, PyTorch's
    ``F.gelu`` to erf: the port's encoder uses the tanh form."""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    got = tv.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - erf).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """f32 statistics with the biased variance, the result cast back to
    the input dtype; in bf16 within one bf16 step."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 7, 48)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(48)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = jv.layer_norm(*(jnp.asarray(a).astype(jdt)
                           for a in (x, scale, bias)), 1e-6)
    tdt = getattr(torch, dtype)
    got = tv.layer_norm(*(torch.from_numpy(a).to(tdt)
                          for a in (x, scale, bias)), 1e-6)
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                                   atol=1e-2)


def test_patchify_matches_jax():
    cfg_kw = dict(image_size=8, patch_size=2)
    images = _images(2, 8)
    want = jv.patchify(jnp.asarray(images), jv.ViTConfig.tiny(**cfg_kw))
    got = tv.patchify(torch.from_numpy(images), tv.ViTConfig.tiny(**cfg_kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- CLIP --------------------------------------------------------------------

@pytest.mark.parametrize("attention", ["reference", "flash"])
def test_clip_embeddings_loss_and_grads_match_jax(attention):
    jcfg = jv.CLIPConfig.tiny()
    tcfg = tv.CLIPConfig.tiny(
        vision=tv.ViTConfig.tiny(attention=attention),
        text=tv.CLIPTextConfig.tiny(attention=attention,
                                    remat=attention == "flash"))
    jp = _jit(jv.clip_init, 1)(jax.random.PRNGKey(0), jcfg)
    images = _images(4, 16, seed=2)
    tokens = np.random.default_rng(3).integers(0, 128, (4, 16)).astype(
        np.int32)
    tp = _to_port(jp)
    for enc, arg in (("clip_encode_image", images),
                     ("clip_encode_text", tokens)):
        want = _jit(getattr(jv, enc), 2)(jp, jnp.asarray(arg), jcfg)
        with torch.no_grad():
            got = getattr(tv, enc)(tp, torch.from_numpy(arg), tcfg)
        assert _rel_l2(got.numpy(), want) <= 1e-5, enc
        np.testing.assert_allclose(
            torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, rtol=1e-6)
    jloss, jgrads = _clip_value_and_grad(
        jp, jnp.asarray(images), jnp.asarray(tokens), jcfg)
    tp = _grads_of(tp)
    tloss = tv.clip_loss(tp, torch.from_numpy(images),
                         torch.from_numpy(tokens), tcfg)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _check_grads(tp, jgrads)


@pytest.mark.parametrize("logit_scale", [-7.0, 6.0])
def test_clip_logit_scale_is_clipped_like_jax(logit_scale):
    jcfg, tcfg = jv.CLIPConfig.tiny(), tv.CLIPConfig.tiny()
    jp = _jit(jv.clip_init, 1)(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, logit_scale=jnp.asarray(logit_scale, jnp.float32))
    images = _images(3, 16, seed=4)
    tokens = np.arange(48, dtype=np.int32).reshape(3, 16)
    want, _ = _clip_value_and_grad(jp, jnp.asarray(images),
                                   jnp.asarray(tokens), jcfg)
    got = tv.clip_loss(_to_port(jp), torch.from_numpy(images),
                       torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
