"""head_dim 72 (DiT-XL/2's 1152 / 16) on the port's flash path, against
the JAX package on the CPU.

On the CPU the port's ``flash_attention`` runs its plain versions of K1
(forward) and K2/K3 (backward), which the card's kernels are held to;
the JAX side's ``flash_attention`` takes its jnp path at this head_dim
(``_kernel_plan`` covers multiples of 128 only), forward and
``jax.vjp``. Inputs come from a numpy seed; DiT weights are the JAX
package's, carried over by ``params_from_jax``, with the adaLN-Zero
leaves replaced by the same seeded noise on both sides (at init they are
zero, the blocks the identity and most grads zero). Everything runs in
f32 on one torch thread; each test states its tolerance.
"""

import dataclasses
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
from ray_tpu_torch.ops import attention as tatt
from ray_tpu_torch.scripts import bench_train
from ray_tpu_torch.scripts.bench_train import parameters

D72 = 72
ZERO_INIT = ("final_mod_w", "final_mod_b", "final_w", "layers/mod_w",
             "layers/mod_b")
# a DiT at head_dim 72: 2 heads of 72, 2 layers, 4 x 4 patches (S 16)
SMALL = dict(input_size=8, patch_size=2, channels=3, dim=2 * D72,
             n_layers=2, n_heads=2, hidden_dim=288, n_classes=4,
             time_freq_dim=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """``jax.jit`` with the config arguments static."""
    return jax.jit(fn, static_argnums=static)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# --- flash_attention at head_dim 72 ----------------------------------------

@pytest.mark.parametrize("sq,sk,h,kvh,causal", [
    (197, 197, 4, 4, False),   # ragged S (not a multiple of 64), full
    (197, 197, 4, 4, True),    # ragged S, causal
    (60, 90, 4, 2, True),      # Sq < Sk (causal offset), GQA group 2
    (130, 130, 4, 1, False),   # GQA group 4, full
])
def test_flash_attention_head_dim_72_and_grads_match_jax(sq, sk, h, kvh,
                                                         causal):
    """Output and the grads of q, k, v through ``_FlashAttention`` (the
    plain K1, K2 and K3) against JAX's ``flash_attention`` and its
    ``jax.vjp``, K/V repeated to every query head on the JAX side (its
    convention) so that dK/dV come back summed over each group. f32 on
    both sides: 1e-5."""
    rng = np.random.default_rng(sq + 7 * kvh + int(causal))
    b = 2
    q = rng.standard_normal((b, sq, h, D72)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, D72)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, D72)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, D72)).astype(np.float32)
    n_rep = h // kvh

    def ref(q_, k_, v_):
        return jatt.flash_attention(q_, jnp.repeat(k_, n_rep, axis=2),
                                    jnp.repeat(v_, n_rep, axis=2), causal)

    jargs = tuple(jnp.asarray(a) for a in (q, k, v))
    assert jatt._kernel_plan(jargs[0], jargs[0]) is None  # the jnp path
    jout, vjp = jax.vjp(ref, *jargs)
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tatt.flash_attention(tq, tk, tv, causal)
    assert out.grad_fn is not None  # through _FlashAttention
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    assert tk.grad.shape == (b, sk, kvh, D72)
    for name, got, want in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_flash_backward_plain_head_dim_72_matches_jax_vjp():
    """K2 and K3's plain versions, called as the card's wrappers are
    (from K1's o and lse and delta), at head_dim 72 in bf16: within a
    bf16 step of JAX's vjp of the same bf16 inputs computed in f32
    (the plain versions round P and dS to bf16 as the kernels do)."""
    rng = np.random.default_rng(3)
    b, s, h = 2, 100, 4
    q, k, v, do = (jnp.asarray(rng.standard_normal((b, s, h, D72)),
                               jnp.bfloat16) for _ in range(4))
    _, vjp = jax.vjp(lambda *a: jatt._attention_reference(*a, False),
                     *(a.astype(jnp.float32) for a in (q, k, v)))
    jgrads = vjp(do.astype(jnp.float32))

    def port(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()

    tq, tk, tv, tdo = map(port, (q, k, v, do))
    o, lse = tatt._flash_forward_reference(tq, tk, tv, False)
    delta = tatt._delta(o, tdo)
    dq = tatt.flash_attention_bwd_dq(tq, tk, tv, tdo, lse, delta, False)
    dk, dv = tatt.flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, delta, False)
    for name, got, want in zip("qkv", (dq, dk, dv), jgrads):
        assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, D72)
        assert _rel_l2(got.float().numpy(), want) <= 2e-2, name


def test_kernel_gate_takes_head_dim_72_and_names_the_others():
    """The card's wrappers check shapes before they launch: 72 passes
    the gate beside 64 and 128; any other head_dim raises, naming the
    three it takes (the check itself runs on any device)."""
    for d in (64, 72, 128):
        q = torch.zeros((1, 8, 2, d), dtype=torch.bfloat16)
        assert tatt._check_qkv(q, q, q, False) == (1, 8, 2, d, 8, 2)
    q = torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 64, 72 or 128, not 96"):
        tatt._check_qkv(q, q, q, False)


# --- a DiT at head_dim 72 ---------------------------------------------------

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
def _params():
    """(JAX config at head_dim 72, its tree with random adaLN leaves)."""
    jcfg = jd.DiTConfig.tiny(attention="flash", **SMALL)
    jp = _jit(jd.dit_init, 1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, _with_random_adaln(jax.tree_util.tree_map(np.asarray, jp))


def _tcfg(**kw):
    return td.DiTConfig.tiny(attention="flash", **SMALL, **kw)


def _x(b, cfg, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.input_size, cfg.input_size, cfg.channels)).astype(np.float32)


def test_dit_head_dim_72_forward_matches_jax():
    jcfg, jp = _params()
    tcfg = _tcfg()
    assert tcfg.head_dim == jcfg.head_dim == D72
    x = _x(3, jcfg, seed=1)
    t = np.array([0.05, 0.5, 0.95], np.float32)
    labels = np.array([0, 3, 4], np.int32)
    want = _jit(jd.dit_forward, 3)(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x),
        jnp.asarray(t), jcfg, jnp.asarray(labels))
    with torch.no_grad():
        got = td.dit_forward(params_from_jax(jp, device="cpu"),
                             torch.from_numpy(x), torch.from_numpy(t), tcfg,
                             torch.from_numpy(labels).long())
    assert np.abs(np.asarray(want)).max() > 1e-2  # not the zero of init
    assert _rel_l2(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("remat", [False, True])
def test_dit_head_dim_72_loss_and_grads_match_jax(remat):
    """The loss and every leaf's grad against ``jax.value_and_grad`` with
    the reference's draws replayed; rel L2 1e-4 per leaf, as the
    head_dim 64 DiT tests."""
    jcfg, jp = _params()
    tcfg = _tcfg(remat=remat)
    x0 = _x(4, jcfg, seed=2)
    labels = np.array([0, 1, 2, 3], np.int32)
    key = jax.random.PRNGKey(7)
    k_t, k_eps, k_drop = jax.random.split(key, 3)
    draws = {"t": jax.random.uniform(k_t, (4,), minval=1e-4,
                                     maxval=1.0 - 1e-4),
             "eps": jax.random.normal(k_eps, x0.shape, dtype=jnp.float32),
             "drop": jax.random.uniform(k_drop, (4,))}
    jloss, jgrads = _jit(jax.value_and_grad(
        lambda p, x, lab: jd.dit_loss(p, key, x, jcfg, lab, 0.5)))(
            jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x0),
            jnp.asarray(labels))
    tp = params_from_jax(jp, device="cpu")
    for leaf in parameters(tp):
        leaf.requires_grad_(True)
    noise = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    tloss = td.dit_loss(tp, noise, torch.from_numpy(x0), tcfg,
                        torch.from_numpy(labels).long(), 0.5)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        node = tp
        for k in path:
            node = node[k.key]
        assert _rel_l2(node.grad.numpy(), g) <= 1e-4, path


def test_dit_head_dim_72_sample_matches_jax():
    """DDIM with classifier-free guidance from the same start noise:
    rel L2 1e-5."""
    jcfg, jp = _params()
    key = jax.random.PRNGKey(3)
    labels = np.array([1, 2, 4], np.int32)
    n, steps, scale, clip = 3, 4, 1.5, 4.0
    want = _jit(jd.dit_sample, 2, 3, 4, 6, 7)(
        jax.tree_util.tree_map(jnp.asarray, jp), key, jcfg, n, steps,
        jnp.asarray(labels), scale, clip)
    start = jax.random.normal(key, (n, jcfg.input_size, jcfg.input_size,
                                    jcfg.channels), dtype=jnp.float32)
    got = td.dit_sample(params_from_jax(jp, device="cpu"),
                        {"eps": torch.from_numpy(np.array(start))}, _tcfg(),
                        n, steps, torch.from_numpy(labels).long(), scale,
                        clip)
    assert np.isfinite(got.numpy()).all()
    assert _rel_l2(got.numpy(), want) <= 1e-5


# --- DiT-XL/2 itself --------------------------------------------------------

def test_dit_xl_2_config_matches_the_reference():
    """Every field of ``DiTConfig.xl_2()`` equals the reference's (the
    dtype by name), and it defaults to the flash path at head_dim 72."""
    got, want = td.DiTConfig.xl_2(), jd.DiTConfig.xl_2()
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if field.name == "dtype":
            assert str(a).split(".")[-1] == jnp.dtype(b).name
        else:
            assert a == b, field.name
    assert (got.dim, got.n_heads, got.head_dim, got.n_layers) == \
        (1152, 16, D72, 28)
    assert got.attention == "flash" and got.n_patches == 256
    assert td.DiTConfig.xl_2(n_classes=1000).n_classes == \
        jd.DiTConfig.xl_2(n_classes=1000).n_classes


def test_setup_vision_builds_dit_xl_from_xl_2(monkeypatch):
    """``setup_vision("dit_xl")`` takes ``DiTConfig.xl_2(n_classes=1000)``
    at ``VISION_BATCH["dit_xl"]`` (32); here xl_2 is cut to 2 narrow
    layers at head_dim 72 so that two steps run on the CPU, and the loss
    falls."""
    assert bench_train.VISION_BATCH["dit_xl"] == 32
    asked = []

    def small_xl_2(**kw):
        asked.append(kw)
        return td.DiTConfig.tiny(**dict(SMALL, input_size=4, channels=4,
                                        attention="flash", remat=True,
                                        **kw))

    monkeypatch.setattr(bench_train.DiTConfig, "xl_2",
                        staticmethod(small_xl_2))
    monkeypatch.setitem(bench_train.VISION_BATCH, "dit_xl", 2)
    cfg, params, step = bench_train.setup_vision("dit_xl", "cpu")
    assert asked == [{"n_classes": 1000}]
    assert cfg.head_dim == D72 and cfg.attention == "flash"
    losses = [step().item() for _ in range(2)]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
