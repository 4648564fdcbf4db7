"""The port's DiT (ray_tpu_torch.models.dit) against the JAX package's.

Both sides run the JAX package's weights, carried over by
``params_from_jax``, in f32 on the CPU. adaLN-Zero starts every block
as the identity and the predicted noise at exactly zero, where a
comparison proves nothing, so every parity case first replaces the
modulation and output projections with the same seeded noise on both
sides. The loss and the sampler replay the reference's ``jax.random``
draws through the port's draw dict (``draw_dit_noise``'s keys).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import dit as jd
from ray_tpu.ops import attention as jatt
from ray_tpu_torch.models import dit as td
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.scripts.bench_train import parameters

ZERO_INIT = ("final_mod_w", "final_mod_b", "final_w", "layers/mod_w",
             "layers/mod_b")


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """``jax.jit`` with the config arguments static."""
    return jax.jit(fn, static_argnums=static)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _with_random_adaln(jp, seed=0, std=0.1):
    """``jp`` (numpy leaves) with the zero-init leaves N(0, std^2)."""
    rng = np.random.default_rng(seed)
    out = dict(jp, layers=dict(jp["layers"]))
    for path in ZERO_INIT:
        node = out["layers"] if path.startswith("layers/") else out
        name = path.split("/")[-1]
        node[name] = (rng.standard_normal(node[name].shape) * std).astype(
            node[name].dtype)
    return out


@functools.lru_cache(maxsize=None)
def _params(n_classes=0, **kw):
    """(JAX config, the JAX tree with random adaLN leaves, numpy)."""
    jcfg = jd.DiTConfig.tiny(n_classes=n_classes, **kw)
    jp = _jit(jd.dit_init, 1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, _with_random_adaln(jax.tree_util.tree_map(np.asarray, jp))


def _port(jnp_tree):
    return params_from_jax(jnp_tree, device="cpu")


def _x(b, cfg, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.input_size, cfg.input_size, cfg.channels)).astype(np.float32)


def _tcfg(jcfg, **kw):
    fields = {f: getattr(jcfg, f) for f in (
        "input_size", "patch_size", "channels", "dim", "n_layers",
        "n_heads", "hidden_dim", "n_classes", "time_freq_dim")}
    fields.update(kw)
    return td.DiTConfig.tiny(**fields)


def test_dit_init_tree_matches_jax_and_starts_at_zero():
    jcfg = jd.DiTConfig.tiny(n_classes=4)
    jp = _jit(jd.dit_init, 1)(jax.random.PRNGKey(0), jcfg)
    tcfg = _tcfg(jcfg)
    tp = td.dit_init(0, tcfg, device="cpu")
    flat_t = {"/".join(str(k.key) for k in path): leaf for path, leaf in
              jax.tree_util.tree_leaves_with_path(tp)}
    flat_j = {"/".join(str(k.key) for k in path): leaf for path, leaf in
              jax.tree_util.tree_leaves_with_path(jp)}
    assert {k: tuple(v.shape) for k, v in flat_t.items()} == \
        {k: v.shape for k, v in flat_j.items()}
    for path in ZERO_INIT:
        assert not flat_t[path].any(), path
    # carried over exactly
    for path, leaf in jax.tree_util.tree_leaves_with_path(_port(
            jax.tree_util.tree_map(np.asarray, jp))):
        key = "/".join(str(k.key) for k in path)
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(flat_j[key]))
    # adaLN-Zero: the untrained model predicts exactly zero
    x = torch.from_numpy(_x(2, tcfg))
    out = td.dit_forward(tp, x, torch.tensor([0.3, 0.7]), tcfg,
                         torch.tensor([1, 4]))
    assert out.dtype == torch.float32 and not out.any()


def test_timestep_schedule_and_patches_match_jax():
    t = np.array([0.0, 1e-4, 0.25, 0.5, 0.9999, 1.0], np.float32)
    np.testing.assert_allclose(
        td.timestep_embedding(torch.from_numpy(t), 16).numpy(),
        np.asarray(jd.timestep_embedding(jnp.asarray(t), 16)),
        rtol=1e-5, atol=2e-5)
    for got, want in zip(td.cosine_alpha_sigma(torch.from_numpy(t)),
                         jd.cosine_alpha_sigma(jnp.asarray(t))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    jcfg = jd.DiTConfig.tiny()
    x = _x(2, jcfg)
    tok = td._patchify(torch.from_numpy(x), _tcfg(jcfg))
    np.testing.assert_array_equal(
        tok.numpy(), np.asarray(jd._patchify(jnp.asarray(x), jcfg)))
    np.testing.assert_array_equal(
        td._unpatchify(tok, _tcfg(jcfg)).numpy(), x)


@pytest.mark.parametrize("n_classes,attention,remat", [
    (0, "reference", False), (4, "flash", False), (4, "reference", True)])
def test_dit_forward_matches_jax(n_classes, attention, remat):
    jcfg, jp = _params(n_classes)
    tcfg = _tcfg(jcfg, attention=attention, remat=remat)
    x = _x(3, jcfg, seed=1)
    t = np.array([0.05, 0.5, 0.95], np.float32)
    labels = np.array([0, 3, 4], np.int32) if n_classes else None
    want = _jit(jd.dit_forward, 3)(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x),
        jnp.asarray(t), jcfg, None if labels is None else
        jnp.asarray(labels))
    with torch.no_grad():
        got = td.dit_forward(_port(jp), torch.from_numpy(x),
                             torch.from_numpy(t), tcfg,
                             None if labels is None else
                             torch.from_numpy(labels).long())
    assert np.abs(np.asarray(want)).max() > 1e-2  # not the zero of init
    assert _rel_l2(got.numpy(), want) <= 1e-5


def _jax_draws(key, x0_shape):
    """The draws the reference's ``dit_loss`` makes from ``key``, under
    the port's names."""
    k_t, k_eps, k_drop = jax.random.split(key, 3)
    b = x0_shape[0]
    return {"t": jax.random.uniform(k_t, (b,), minval=1e-4,
                                    maxval=1.0 - 1e-4),
            "eps": jax.random.normal(k_eps, x0_shape, dtype=jnp.float32),
            "drop": jax.random.uniform(k_drop, (b,))}


@pytest.mark.parametrize("n_classes,label_drop,attention,remat", [
    (0, 0.1, "reference", False), (4, 0.5, "flash", True),
    (4, 0.0, "reference", False)])
def test_dit_loss_and_grads_match_jax(n_classes, label_drop, attention,
                                      remat):
    jcfg, jp = _params(n_classes)
    tcfg = _tcfg(jcfg, attention=attention, remat=remat)
    x0 = _x(4, jcfg, seed=2)
    labels = np.array([0, 1, 2, 3], np.int32) if n_classes else None
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, x0.shape)
    if n_classes and label_drop:
        # the replayed draws drop some labels and keep others
        dropped = np.asarray(draws["drop"]) < label_drop
        assert dropped.any() and not dropped.all()
    jloss, jgrads = _jit(jax.value_and_grad(
        lambda p, x, lab: jd.dit_loss(p, key, x, jcfg, lab, label_drop)))(
            jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x0),
            None if labels is None else jnp.asarray(labels))
    tp = _port(jp)
    for leaf in parameters(tp):
        leaf.requires_grad_(True)
    noise = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    tloss = td.dit_loss(tp, noise, torch.from_numpy(x0), tcfg,
                        None if labels is None else
                        torch.from_numpy(labels).long(), label_drop)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        node = tp
        for k in path:
            node = node[k.key]
        assert _rel_l2(node.grad.numpy(), g) <= 1e-4, path


@pytest.mark.parametrize("guidance_scale,x0_clip", [(0.0, 4.0), (1.5, 1.0)])
def test_dit_sample_matches_jax(guidance_scale, x0_clip):
    jcfg, jp = _params(4)
    tcfg = _tcfg(jcfg, attention="flash")
    key = jax.random.PRNGKey(3)
    labels = np.array([1, 2, 4], np.int32)
    n, steps = 3, 4
    want = _jit(jd.dit_sample, 2, 3, 4, 6, 7)(
        jax.tree_util.tree_map(jnp.asarray, jp), key, jcfg, n, steps,
        jnp.asarray(labels), guidance_scale, x0_clip)
    start = jax.random.normal(key, (n, jcfg.input_size, jcfg.input_size,
                                    jcfg.channels), dtype=jnp.float32)
    got = td.dit_sample(_port(jp), {"eps": torch.from_numpy(np.array(start))},
                        tcfg, n, steps, torch.from_numpy(labels).long(),
                        guidance_scale, x0_clip)
    assert np.isfinite(got.numpy()).all()
    assert _rel_l2(got.numpy(), want) <= 1e-5


def test_dit_sample_refuses_noise_of_another_shape():
    jcfg, jp = _params(0)
    with pytest.raises(ValueError, match="start noise"):
        td.dit_sample(_port(jp), {"eps": torch.zeros(2, 8, 8, 3)},
                      _tcfg(jcfg), 3, 2)


def test_draw_dit_noise_keys_and_ranges():
    gen = torch.Generator().manual_seed(0)
    noise = td.draw_dit_noise(gen, (64, 8, 8, 3), device="cpu")
    assert set(noise) == {"t", "eps", "drop"}
    assert tuple(noise["eps"].shape) == (64, 8, 8, 3)
    assert noise["t"].min() >= 1e-4 and noise["t"].max() <= 1 - 1e-4
    assert noise["drop"].min() >= 0 and noise["drop"].max() < 1
    again = td.draw_dit_noise(torch.Generator().manual_seed(0),
                              (64, 8, 8, 3), device="cpu")
    assert all(torch.equal(noise[k], again[k]) for k in noise)


def test_dit_flash_at_kernel_shape_matches_jax_pallas_interpret():
    """head_dim 128 and seq 256: the JAX side takes its Pallas kernel (in
    interpret mode), the port its flash path (plain on the CPU)."""
    _, jp = _params(0, input_size=32, dim=256, n_heads=2, n_layers=1)
    jcfg = jd.DiTConfig.tiny(input_size=32, dim=256, n_heads=2, n_layers=1,
                             attention="flash")
    assert jcfg.head_dim == 128 and jcfg.n_patches == 256
    x = _x(1, jcfg, seed=5)
    t = np.array([0.4], np.float32)
    prev = jatt._INTERPRET
    jatt._INTERPRET = True
    try:
        q = jnp.zeros((1, 256, 2, 128))
        assert jatt._kernel_plan(q, q) is not None  # the Pallas kernel
        want = jd.dit_forward(jax.tree_util.tree_map(jnp.asarray, jp),
                              jnp.asarray(x), jnp.asarray(t), jcfg)
    finally:
        jatt._INTERPRET = prev
    with torch.no_grad():
        got = td.dit_forward(_port(jp), torch.from_numpy(x),
                             torch.from_numpy(t), _tcfg(jcfg,
                                                        attention="flash"))
    assert _rel_l2(got.numpy(), want) <= 1e-5


def test_ada_ln_casts_like_jax_in_bf16():
    """LN in f32, cast to the model dtype, then the modulation in that
    dtype: the order of the casts is the reference's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 2
    shift = rng.standard_normal((2, 32)).astype(np.float32) * 0.3
    scale = rng.standard_normal((2, 32)).astype(np.float32) * 0.3
    want = jd._ada_ln(*(jnp.asarray(a).astype(jnp.bfloat16)
                        for a in (x, shift, scale)), 1e-6)
    got = td._ada_ln(*(torch.from_numpy(a).bfloat16()
                       for a in (x, shift, scale)), 1e-6)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
